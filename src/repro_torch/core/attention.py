"""Dense (full) attention, one-shot softmax (port of the non-causal,
unchunked case of the JAX package's ``core/attention.py``).

The serving path uses it for the local half of decode: one query token
against the 2W ring of the local cache (`attn.backends._local_decode`).
GQA-native (k/v carry Hkv heads, no materialized repeat); fp32 softmax.
"""
from __future__ import annotations

from typing import Optional

import torch

_BIG_NEG = -1e9


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,H,N,dh); k,v: (B,Hkv,M,dh) -> (B,H,N,dh), no causal mask
    (decode masks through ``pad_mask``, (B, M) bool over keys)."""
    B, H, N, dh = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, N, dh)
    logits = torch.einsum("bhgnd,bhmd->bhgnm", qg, k).float() / float(dh) ** 0.5
    if pad_mask is not None:
        logits = logits.masked_fill(~pad_mask[:, None, None, None, :],
                                    _BIG_NEG)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgnm,bhmd->bhgnd", attn.to(v.dtype), v)
    return out.reshape(B, H, N, dh)
