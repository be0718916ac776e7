"""Trace spans of the port.

``span(name)`` brackets a host-side region with
``torch.profiler.record_function``, so a ``torch.profiler`` capture
(``chip_smoke.py --out``) names it on the host timeline with the device
work it launched beneath it. Span names follow ``<subsystem>/<phase>``:
``engine/admit``, ``engine/prefill``, ``engine/prefill_chunk``,
``engine/prefill_stage``, ``engine/decode``, ``engine/park``,
``engine/resume``. Outside a capture a span costs one profiler check.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def span(name: str):
    """Name a region in a torch.profiler capture."""
    with torch.profiler.record_function(name):
        yield
