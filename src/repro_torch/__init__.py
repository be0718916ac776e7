"""repro_torch — the PyTorch/CUDA port of the Routing Transformer system.

A package of its own beside the JAX package ``repro`` (the reference): it
imports ``torch`` and never ``jax`` or ``repro``. Slice 1 serves the paper's
rt-enwik8 model (``serve.serving``: ``init_cache``, ``prefill``,
``make_serve_step``) through hand-written CUDA kernels for the local-window
prefill, the fused routing prefill and the paged routing decode
(``kernels/``, sources in ``csrc/``).
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point builds on. CUDA is the default of every
    entry point; with no card it raises instead of running on the CPU
    (callers that want the CPU pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev
