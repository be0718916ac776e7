"""Continuous-batching inference engine of the port (counterpart of the
JAX package's ``repro.serve.engine``).

Public surface:
  InferenceEngine, Request      — request lifecycle + step loop
  SessionHandle                 — what submit() returns: uid + state +
                                  park()/resume()/cancel()
  SamplingParams                — per-request decode sampling knobs
  FCFSScheduler                 — admission / backpressure policy
  EngineMetrics                 — TTFT / throughput / occupancy counters
  init_pool, write_slot, reset_slot, read_slot — slot-pooled cache lanes
  (the tiered KV store behind the pool lives in repro_torch.serve.kvstore;
  export_session / import_session move sessions between engines)
"""
from repro_torch.serve.engine.engine import (CANCELLED, DECODE, EXPORTED,
                                             FINISHED, PARKED, PREFILL,
                                             WAITING, InferenceEngine,
                                             Request, SessionHandle)
from repro_torch.serve.engine.metrics import EngineMetrics, RequestStats
from repro_torch.serve.engine.pool import (init_pool, read_slot, reset_slot,
                                           write_slot)
from repro_torch.serve.engine.sampling import (SamplingParams, request_key,
                                               sample_tokens)
from repro_torch.serve.engine.scheduler import (PRIORITY_BATCH,
                                                PRIORITY_INTERACTIVE,
                                                PRIORITY_NORMAL,
                                                FCFSScheduler)

__all__ = [
    "InferenceEngine", "Request", "SessionHandle", "SamplingParams",
    "FCFSScheduler", "EngineMetrics", "RequestStats", "init_pool",
    "write_slot", "reset_slot", "read_slot", "request_key", "sample_tokens",
    "WAITING", "PREFILL", "DECODE", "FINISHED", "PARKED", "CANCELLED",
    "EXPORTED", "PRIORITY_BATCH", "PRIORITY_NORMAL", "PRIORITY_INTERACTIVE",
]
