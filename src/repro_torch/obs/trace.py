"""Trace spans and on-demand profiler capture of the port.

``span(name)`` brackets a host-side region with
``torch.profiler.record_function``, so a ``torch.profiler`` capture names
it on the host timeline with the device work it launched beneath it. Span
names follow ``<subsystem>/<phase>``: ``train/grad``, ``train/optimizer``,
``kernels/local_attention``, ``kernels/routed_attention_fused``,
``kernels/routed_attention_blocks``, ``kernels/flash_attention`` (and
their backward ``..._bwd``), ``engine/admit``, ``engine/prefill``,
``engine/prefill_chunk``, ``engine/prefill_stage``, ``engine/decode``,
``engine/park``, ``engine/resume``. A span launches nothing on the card,
and outside a capture it costs one check of the profiler's state, not a
``record_function`` (a dispatcher call each way, host time on the order
of a small kernel's launch). A span also decorates a function
(``@span("kernels/...")``).

``profile(log_dir)`` is the counterpart of the JAX package's
``obs.trace.profile``: a context manager that captures its body with
``torch.profiler`` (host activity, and the card's when one is present)
and writes a Chrome trace (``trace.json``, for chrome://tracing or
Perfetto) into ``log_dir``, where the JAX package writes an xplane; a
no-op when ``log_dir`` is falsy, so a ``--profile-dir`` flag threads
straight through.
"""
from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


class span(contextlib.ContextDecorator):
    """Name a region in a torch.profiler capture (a no-op outside one)."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def _recreate_cm(self):
        # a decorated function's calls each get their own span
        return span(self.name)

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


@contextlib.contextmanager
def profile(log_dir, enabled: bool = True):
    """Capture a torch.profiler trace of the body into
    ``log_dir/trace.json`` (no-op when ``log_dir`` is falsy or ``enabled``
    is False)."""
    if not log_dir or not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(log_dir), TRACE_FILE))
