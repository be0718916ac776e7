"""Training loop of the port (port of the JAX package's
``train/trainer.py``; data-parallel over the default process group, and on
a ``mesh`` with a model axis tensor-parallel too).

* `fit` resumes from the latest complete checkpoint of ``ckpt_dir``
  (atomic rename commit: a torn save is invisible), restoring parameters,
  centroids, optimizer state, step, error-feedback residuals AND the data
  loader's cursor, so a killed and restarted run takes the same steps as
  an uninterrupted one, bit for bit. It checkpoints every ``ckpt_every``
  steps (``async_ckpt``: the host copy is taken before the next step, the
  file written by a thread) and, synchronously, at its end.
* SIGTERM/SIGINT (a preemption notice) set a flag; the loop ends after
  the step in flight and the final synchronous checkpoint saves it. The
  handlers are installed for `fit` (from the main thread only) and the
  previous ones restored after it.
* With D > 1 ranks every rank runs the loop on the same global batches
  (the step takes its own rows); the residual rows are gathered into the
  checkpoint's (D, *shape) leaves, rank 0 writes, and each rank restores
  its own row (a checkpoint of another D re-zeros them).
* On a mesh whose model axis holds M > 1 ranks (``mesh=``, with
  ``constrain_fn`` from `dist.sharding.make_constrain_fn`) every rank holds
  its shards; a checkpoint is written in the JAX package's format from the
  gathered full arrays, by rank 0, and a restore cuts the full arrays for
  the current mesh, so a checkpoint moves between meshes.
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
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.dist import compression as comp
from repro_torch.dist import sharding as shd
from repro_torch.obs import JsonlSink, Registry, StepSeries
from repro_torch.obs.metrics import _host
from repro_torch.tree import tree_map
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)


class Trainer:
    def __init__(self, run: RunConfig, loader: SyntheticLoader,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 straggler_factor: float = 2.5,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 async_ckpt: bool = True, step_fn=None, device="cuda",
                 obs_jsonl: Optional[str] = None, mesh=None,
                 constrain_fn=None):
        self.device = resolve_device(device)
        self.run = run
        self.mesh = mesh
        self.tp = mesh is not None and mesh.size("model") > 1
        self.loader = loader
        self.ckpt_every = ckpt_every
        self.async_ckpt = async_ckpt
        self.mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler or (lambda step, t: None)
        self.straggler_count = 0
        self._times: List[float] = []
        self._preempted = False
        self.step_fn = step_fn or make_train_step(
            run, constrain_fn=constrain_fn, mesh=mesh)
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
        """The latest checkpoint's state (and loader cursor), or a fresh
        state from ``run.train.seed`` when there is none; on a model axis,
        this rank's shards of either."""
        resume = self.mgr is not None and self.mgr.latest_step() is not None
        state = init_train_state(
            self.run, seed=self.run.train.seed, device=self.device,
            mesh=None if resume else self.mesh)
        if resume:
            D, r = comp.world_size(), comp.rank()
            if any(k.split("/", 1)[0] == "params" for k in self.mgr.keys()):
                # the field-named layout: leaves keyed "params/...",
                # "ef_state/..." (all D ranks' rows)
                like = state._replace(ef_state=None if state.ef_state is None
                                      else tree_map(lambda e: e.expand(
                                          D, *e.shape[1:]), state.ef_state))
                d, extra = self.mgr.restore(like._asdict())
                ef = d["ef_state"]
                if ef is not None and D > 1:
                    ef = tree_map(lambda e: e[r:r + 1].clone(), ef)
                state = TrainState(**dict(d, ef_state=ef))
            else:
                # the legacy layout (the bare tuple's ".params/..." keys),
                # which never holds a residual: the four-field part, and
                # the fresh zero residuals
                legacy, extra = self.mgr.restore(
                    state._replace(ef_state=None))
                state = legacy._replace(ef_state=state.ef_state)
            if "loader" in extra:
                self.loader.restore(extra["loader"])
            if self.tp:
                state = shd.shard_state(state, self.run.model, self.mesh)
        self.state = state
        return state

    def _install_preemption_handler(self) -> Dict[int, Any]:
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            self._preempted = True
        return {s: signal.signal(s, handler)
                for s in (signal.SIGTERM, signal.SIGINT)}

    def _checkpoint(self, blocking: bool = False) -> None:
        """Save the state at its step: every rank takes part in gathering
        the residual rows, rank 0 writes; a blocking save returns on every
        rank once the checkpoint is committed."""
        if self.mgr is None or self.state is None:
            return
        D = comp.world_size()
        state = self.state
        if self.tp:
            state = shd.gather_state(state, self.run.model, self.mesh)
        if state.ef_state is not None and D > 1:
            state = state._replace(ef_state=tree_map(
                lambda e: comp.all_gather_rows(e[0]), state.ef_state))
        blocking = blocking or not self.async_ckpt
        if comp.rank() == 0:
            self.mgr.save(state.step, state._asdict(),
                          extra={"loader": self.loader.state()},
                          blocking=blocking)
        if blocking and D > 1:
            dist.barrier()

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
                if (self.mgr is not None
                        and self.state.step % self.ckpt_every == 0):
                    self._checkpoint()
            # the final (or preemption) checkpoint: synchronous
            self._checkpoint(blocking=True)
            if self.mgr is not None:
                self.mgr.wait()
        finally:
            for s, h in previous.items():
                signal.signal(s, h)
        return {"steps": self.state.step,
                "preempted": self._preempted,
                "stragglers": self.straggler_count,
                "final_loss": (self.metrics_history[-1]["loss"]
                               if self.metrics_history else None)}
