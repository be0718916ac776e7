"""Top-level model of the port: embed -> stack -> final norm -> logits.

`init_model` builds random weights from a seed with the JAX package's
shapes and tree layout (``params["embed"]``, ``params["final_norm"]``,
``params["stack"]`` per segment stacked over groups) and the k-means
centroids per segment. It draws from a ``torch.Generator``, so its numbers
differ from the JAX package's ``init_model``; tests carry JAX weights
across with `repro_torch.interop` instead.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """(params, kstate) on ``device`` (default the card; raises without
    one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {
        "embed": L.init_embed(gen, cfg.padded_vocab, cfg.d_model, dt, dev,
                              cfg.tie_embeddings),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
    }
    params["stack"], kstate = T.init_stack(gen, cfg, dev)
    return params, kstate


def mask_vocab_pad(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rows of the 256-aligned embedding table past the vocabulary never
    win: their logits are set to -1e9."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) < \
        cfg.vocab_size
    return logits.masked_fill(~valid, -1e9)
