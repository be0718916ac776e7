"""Metrics core of the port: counters, gauges, histograms, a registry, the
JSONL sink and the per-step series (a copy of the JAX package's
``obs/metrics.py``, tensors taken where it takes device arrays).

  Counter    monotonically increasing float (``inc``)
  Gauge      last-written value (``set``)
  Histogram  the observed values with percentile queries (p50/p90/p99),
             which back the engine's latency percentiles

``Registry`` is a typed name -> instrument map with ``summary()`` (a flat
dict, histograms expanded to count/mean/min/max/p50/p90/p99) and
``to_csv()``. Subsystems that own a lifecycle (the engine's metrics, the
KV store, the prefix cache, the trainer) hold their own Registry; one
process-wide default registry exists for code with no better home.

``JsonlSink`` writes one schema-versioned JSON line per event (see
`repro_torch.obs.schema` for the record contract and the validating CLI;
the JAX package's validator takes the same lines). ``StepSeries`` is the
trainer's adapter: an append-only history of per-step metric dicts
(tensors converted to host floats and lists) that optionally tees every
record into a sink. Imports the standard library only, so every layer of
the port can report through it.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1


def _host(v):
    """A tensor, numpy or python value -> a JSON-able python value."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if hasattr(v, "ndim"):
        if hasattr(v, "detach"):
            v = v.detach().cpu()
        if v.ndim == 0:
            f = float(v)
            return f if math.isfinite(f) else None
        return [_host(x) for x in list(v)]
    if isinstance(v, (list, tuple)):
        return [_host(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _host(x) for k, x in v.items()}
    f = float(v)
    return f if math.isfinite(f) else None


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact histogram for the cardinalities recorded (requests, steps);
    percentile() is linear-interpolated on the sorted sample like numpy's
    default."""

    __slots__ = ("name", "_vals", "_sorted")

    def __init__(self, name: str):
        self.name = name
        self._vals: List[float] = []
        self._sorted = True

    def record(self, v: float) -> None:
        v = float(v)
        if self._vals and v < self._vals[-1]:
            self._sorted = False
        self._vals.append(v)

    @property
    def count(self) -> int:
        return len(self._vals)

    @property
    def sum(self) -> float:
        return float(sum(self._vals))

    def percentile(self, p: float) -> Optional[float]:
        if not self._vals:
            return None
        if not self._sorted:
            self._vals.sort()
            self._sorted = True
        xs = self._vals
        if len(xs) == 1:
            return xs[0]
        rank = (p / 100.0) * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> Dict[str, Optional[float]]:
        if not self._vals:
            return {"count": 0, "mean": None, "min": None, "max": None,
                    "p50": None, "p90": None, "p99": None}
        return {"count": self.count, "mean": self.sum / self.count,
                "min": min(self._vals), "max": max(self._vals),
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class Registry:
    """Typed name -> instrument map. Get-or-create accessors; asking for
    an existing name with a different type is a bug and raises."""

    def __init__(self):
        self._items: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        inst = self._items.get(name)
        if inst is None:
            inst = self._items[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} is {type(inst).__name__}, "
                            f"requested as {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        return sorted(self._items)

    def reset(self) -> None:
        self._items.clear()

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in self.names():
            inst = self._items[name]
            if isinstance(inst, Histogram):
                for k, v in inst.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = inst.value
        return out

    def to_csv(self) -> str:
        lines = ["name,value"]
        for k, v in self.summary().items():
            lines.append(f"{k},{'' if v is None else v}")
        return "\n".join(lines) + "\n"


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


class JsonlSink:
    """One JSON object per line, schema-versioned (`repro_torch.obs.schema`).

    Record shape::

        {"v": 1, "kind": "train_step", "t": <unix s>, "source": "...",
         "step": 12, "metrics": {...}}

    Opened in append mode so a train loop and a serve loop may share one
    file; every line is flushed (records are small; losing them in a crash
    is the failure that matters). Tensors in a record are copied to the
    host, which waits for the work that produced them.
    """

    def __init__(self, path: str, source: str = "", clock=time.time):
        self.path = path
        self.source = source
        self.clock = clock
        self._f = open(path, "a")
        self.lines = 0

    def emit(self, kind: str, metrics: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None, **extra) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"v": SCHEMA_VERSION, "kind": str(kind),
                               "t": float(self.clock())}
        if self.source:
            rec["source"] = self.source
        if step is not None:
            rec["step"] = int(step)
        if metrics is not None:
            rec["metrics"] = {str(k): _host(v) for k, v in metrics.items()}
        for k, v in extra.items():
            rec[k] = _host(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.lines += 1
        return rec

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StepSeries:
    """Per-step metric history (a list of host-value dicts) and an optional
    sink: ``record`` converts the tensors once (0-d -> float, arrays ->
    nested lists), so history entries stay the plain dicts consumers
    index, and tees the same record to the sink when one is attached."""

    def __init__(self, sink: Optional[JsonlSink] = None,
                 kind: str = "train_step"):
        self.history: List[Dict[str, Any]] = []
        self.sink = sink
        self.kind = kind

    def record(self, step: int, metrics: Dict[str, Any]) -> Dict[str, Any]:
        rec = {str(k): _host(v) for k, v in metrics.items()}
        self.history.append(rec)
        if self.sink is not None:
            self.sink.emit(self.kind, metrics=rec, step=step)
        return rec
