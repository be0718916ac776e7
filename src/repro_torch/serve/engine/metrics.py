"""Engine observability of the port (a copy of the JAX package's
engine metrics): per-request TTFT, decode throughput, occupancy.

All counters are plain python updated on the host side of the step loop;
``decode_tokens`` counts only *useful* tokens (active slots), so
``decode_tokens_per_s`` is the aggregate goodput number the continuous
batcher is supposed to move versus lock-step batching, and
``tokens_per_step`` is its hardware-independent proxy (each decode step
costs the same whole-pool call regardless of how many slots are active).

Latency distributions are backed by ``repro_torch.obs`` histograms:
  engine/ttft_s          per-request time to first token
  engine/decode_step_s   wall time of each batched decode dispatch
  engine/itl_s           per-request mean inter-token latency
                         (finish - first token) / (n_generated - 1),
                         recorded at finish for requests with >= 2 tokens
``summary()`` reports the counters and their p50/p90/p99.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.obs import Registry


@dataclass
class RequestStats:
    uid: int
    prompt_len: int
    submit_time: float
    arrival_step: int = 0
    slot: Optional[int] = None
    prefill_step: Optional[int] = None      # engine step of the first token
    first_token_time: Optional[float] = None
    finish_step: Optional[int] = None
    finish_time: Optional[float] = None
    n_generated: int = 0
    parks: int = 0                          # times parked to the KV store
    resumes: int = 0                        # times resumed from it

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def itl_s(self) -> Optional[float]:
        """Mean inter-token latency over this request's decode phase."""
        if (self.finish_time is None or self.first_token_time is None
                or self.n_generated < 2):
            return None
        return ((self.finish_time - self.first_token_time)
                / (self.n_generated - 1))


class EngineMetrics:
    """Counters updated by the engine; ``summary()`` for reporting."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.requests: Dict[int, RequestStats] = {}
        self.decode_steps = 0
        self.decode_tokens = 0          # useful (active-slot) tokens
        self.decode_time_s = 0.0
        self.prefill_tokens = 0
        self.prefill_time_s = 0.0
        self.occupancy_sum = 0          # active slots summed over decode steps
        self.obs = Registry()
        self._ttft = self.obs.histogram("engine/ttft_s")
        self._decode_step = self.obs.histogram("engine/decode_step_s")
        self._itl = self.obs.histogram("engine/itl_s")

    def on_submit(self, uid: int, prompt_len: int, step: int) -> None:
        self.requests[uid] = RequestStats(uid, prompt_len, self.clock(),
                                          arrival_step=step)

    def on_prefill(self, uid: int, slot: int, step: int, n_tokens: int,
                   dt_s: float) -> None:
        r = self.requests[uid]
        r.slot, r.prefill_step = slot, step
        r.first_token_time = self.clock()
        self._ttft.record(r.first_token_time - r.submit_time)
        self.prefill_tokens += n_tokens
        self.prefill_time_s += dt_s

    def on_decode_step(self, n_active: int, dt_s: float) -> None:
        self.decode_steps += 1
        self.decode_tokens += n_active
        self.decode_time_s += dt_s
        self.occupancy_sum += n_active
        self._decode_step.record(dt_s)

    def on_token(self, uid: int) -> None:
        self.requests[uid].n_generated += 1

    def on_park(self, uid: int, step: int) -> None:
        self.requests[uid].parks += 1

    def on_resume(self, uid: int, slot: int, step: int) -> None:
        r = self.requests[uid]
        r.resumes += 1
        r.slot = slot

    def on_finish(self, uid: int, step: int) -> None:
        r = self.requests[uid]
        r.finish_step = step
        r.finish_time = self.clock()
        if r.itl_s is not None:
            self._itl.record(r.itl_s)

    @property
    def decode_tokens_per_s(self) -> float:
        return (self.decode_tokens / self.decode_time_s
                if self.decode_time_s else 0.0)

    @property
    def tokens_per_step(self) -> float:
        return (self.decode_tokens / self.decode_steps
                if self.decode_steps else 0.0)

    @property
    def mean_occupancy(self) -> float:
        return (self.occupancy_sum / self.decode_steps
                if self.decode_steps else 0.0)

    def mean_ttft_s(self) -> Optional[float]:
        ts = [r.ttft_s for r in self.requests.values() if r.ttft_s is not None]
        return sum(ts) / len(ts) if ts else None

    def summary(self) -> dict:
        out = {
            "requests": len(self.requests),
            "finished": sum(1 for r in self.requests.values()
                            if r.finish_step is not None),
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": self.decode_tokens_per_s,
            "tokens_per_step": self.tokens_per_step,
            "mean_occupancy": self.mean_occupancy,
            "mean_ttft_s": self.mean_ttft_s(),
            "prefill_tokens": self.prefill_tokens,
            "parks": sum(r.parks for r in self.requests.values()),
            "resumes": sum(r.resumes for r in self.requests.values()),
        }
        for hname, h in (("ttft", self._ttft), ("itl", self._itl),
                         ("decode_step", self._decode_step)):
            if h.count:
                for p in (50, 90, 99):
                    out[f"{hname}_p{p}_s"] = h.percentile(p)
        return out
