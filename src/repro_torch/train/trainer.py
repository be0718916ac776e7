"""Training loop of the port (port of the JAX package's
``train/trainer.py`` on one device: no mesh, no shardings, no checkpoints
yet).

* SIGTERM/SIGINT (a preemption notice) set a flag; the loop ends after
  the step in flight. The handlers are installed for `fit` (from the main
  thread only) and the previous ones restored after it.
* Straggler watch: per-step wall times feed a rolling median; steps slower
  than ``straggler_factor`` x median increment a counter and call
  ``on_straggler(step, ratio)``.
* ``metrics_history`` is a plain list of per-step host metric dicts,
  kept by an obs ``StepSeries``; ``obs_jsonl`` tees every step into a
  JSONL sink (``train_step`` records, source ``trainer``), and
  ``self.obs`` holds the ``train/step_time_s`` histogram.
"""
from __future__ import annotations

import signal
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.obs import JsonlSink, Registry, StepSeries
from repro_torch.obs.metrics import _host
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)


class Trainer:
    def __init__(self, run: RunConfig, loader: SyntheticLoader,
                 ckpt_dir: Optional[str] = None,
                 straggler_factor: float = 2.5,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 step_fn=None, device="cuda",
                 obs_jsonl: Optional[str] = None):
        if ckpt_dir is not None:
            raise NotImplementedError(
                "the port has no checkpoints yet (ROADMAP.md item 10); pass "
                "ckpt_dir=None")
        self.device = resolve_device(device)
        self.run = run
        self.loader = loader
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler or (lambda step, t: None)
        self.straggler_count = 0
        self._times: List[float] = []
        self._preempted = False
        self.step_fn = step_fn or make_train_step(run)
        self.state: Optional[TrainState] = None
        self.obs = Registry()
        self._sink = (JsonlSink(obs_jsonl, source="trainer")
                      if obs_jsonl else None)
        self._series = StepSeries(sink=self._sink, kind="train_step")

    @property
    def metrics_history(self) -> List[Dict[str, Any]]:
        """Per-step host metric dicts (the obs StepSeries' history)."""
        return self._series.history

    def close(self) -> None:
        """Close the JSONL sink (its records are flushed line by line)."""
        if self._sink is not None:
            self._sink.close()

    def init_or_restore(self) -> TrainState:
        """A fresh state from ``run.train.seed`` (nothing to restore until
        checkpoints are ported)."""
        self.state = init_train_state(self.run, seed=self.run.train.seed,
                                      device=self.device)
        return self.state

    def _install_preemption_handler(self) -> Dict[int, Any]:
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            self._preempted = True
        return {s: signal.signal(s, handler)
                for s in (signal.SIGTERM, signal.SIGINT)}

    def _watch_stragglers(self, step: int, dt: float):
        self._times.append(dt)
        window = self._times[-50:]
        if len(window) >= 5:
            med = statistics.median(window)
            if dt > self.straggler_factor * med:
                self.straggler_count += 1
                self.on_straggler(step, dt / med)

    def fit(self, num_steps: Optional[int] = None) -> Dict[str, Any]:
        if self.state is None:
            self.init_or_restore()
        previous = self._install_preemption_handler()
        target = num_steps if num_steps is not None else self.run.train.steps
        it = iter(self.loader)
        try:
            while self.state.step < target and not self._preempted:
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in next(it).items()}
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                # the host copy of the metrics waits for the step's device
                # work, so step_time_s covers compute, not only dispatch
                metrics = {k: _host(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self._watch_stragglers(self.state.step, dt)
                metrics["step_time_s"] = dt
                self.obs.histogram("train/step_time_s").record(dt)
                self._series.record(self.state.step, metrics)
        finally:
            for s, h in previous.items():
                signal.signal(s, h)
        return {"steps": self.state.step,
                "preempted": self._preempted,
                "stragglers": self.straggler_count,
                "final_loss": (self.metrics_history[-1]["loss"]
                               if self.metrics_history else None)}
