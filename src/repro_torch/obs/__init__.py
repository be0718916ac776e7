"""repro_torch.obs — the port's observability layer (counterpart of the JAX
package's ``repro.obs``).

Three layers, all importable from here:

  metrics   Counter/Gauge/Histogram + Registry, JsonlSink (schema-
            versioned one-line-per-event records), StepSeries (the
            trainer's history adapter)
  routing   RoutingStats — the routing-health stats each routing layer
            computes when ``RoutingConfig.stats`` is on (occupancy
            entropy, dead clusters, centroid drift, balanced-vs-nearest
            mismatch, sampled attention recall) — plus the
            summarize/flatten folds and the serving-side pages_health
            reader
  trace     span(name) — a torch.profiler.record_function around kernels
            and train/engine phases; profile(log_dir) — a Chrome-trace
            capture behind --profile-dir flags

This package imports torch, numpy and the standard library only: core/,
train/, serve/ and kernels/ all report through it, so it never imports
them. Validate emitted JSONL with
``python -m repro_torch.obs.schema file.jsonl``.
"""
from repro_torch.obs import routing_stats  # noqa: F401
from repro_torch.obs.metrics import (SCHEMA_VERSION, Counter,  # noqa: F401
                                     Gauge, Histogram, JsonlSink, Registry,
                                     StepSeries, default_registry)
from repro_torch.obs.routing_stats import (RoutingStats,  # noqa: F401
                                           compute_routing_stats,
                                           pages_health)
from repro_torch.obs.schema import (SchemaError, validate_jsonl,  # noqa: F401
                                    validate_record)
from repro_torch.obs.trace import profile, span  # noqa: F401
