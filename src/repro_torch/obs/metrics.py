"""Metrics core of the port: counters, gauges, histograms and a registry
(a copy of that part of the JAX package's ``obs/metrics.py``).

  Counter    monotonically increasing float (``inc``)
  Gauge      last-written value (``set``)
  Histogram  the observed values with percentile queries (p50/p90/p99),
             which back the engine's latency percentiles

``Registry`` is a typed name -> instrument map with ``summary()`` (a flat
dict, histograms expanded to count/mean/min/max/p50/p90/p99) and
``to_csv()``. Subsystems that own a lifecycle (the engine's metrics, the
KV store, the prefix cache) hold their own Registry. Imports the standard
library only, so every layer of the port can report through it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional


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
