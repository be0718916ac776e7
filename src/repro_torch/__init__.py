"""repro_torch — the PyTorch/CUDA port of the Routing Transformer system.

A package of its own beside the JAX package ``repro`` (the reference): it
imports ``torch`` and never ``jax`` or ``repro``. It serves the paper's
rt-enwik8 model (``serve.serving``: ``init_cache``, ``prefill``,
``make_serve_step``) and trains it and the dense full-attention models
such as qwen2-0.5b (``train.train_step``: ``init_train_state``,
``make_train_step``; ``train.trainer.Trainer``; ``launch.train``) through
hand-written CUDA kernels: the local-window, the fused routing and the
dense flash attention, forward and backward, and the paged routing decode
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
