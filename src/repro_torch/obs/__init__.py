"""repro_torch.obs — the port's observability layer (counterpart of the
JAX package's ``repro.obs``; its routing-health stats, ``JsonlSink``,
``StepSeries`` and ``profile()`` are ROADMAP.md item 9).

  metrics   Counter/Gauge/Histogram + Registry
  trace     span(name): a torch.profiler.record_function around engine
            phases
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     Registry)
from repro_torch.obs.trace import span  # noqa: F401
