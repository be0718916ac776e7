"""Blocked local (sliding-window) attention — the paper's local heads.

Port of the JAX package's ``core/local.py``, and the plain PyTorch version
of the CUDA local-window kernel (`kernels.local_attention`). The sequence
is cut into blocks of `window` tokens; a query block attends itself and the
previous block (plus the next one in encoder mode), masked on absolute
positions. GQA-native, fp32 softmax, O(N * w) memory.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_BIG_NEG = -1e9


def _shift_blocks(x: torch.Tensor, direction: int, axis: int) -> torch.Tensor:
    """Shift the block axis by one (-1: previous block, +1: next block),
    filling the vacated block with zeros."""
    body = x.narrow(axis, 0, x.shape[axis] - 1) if direction == -1 else \
        x.narrow(axis, 1, x.shape[axis] - 1)
    zeros = torch.zeros_like(x.narrow(axis, 0, 1))
    parts = [zeros, body] if direction == -1 else [body, zeros]
    return torch.cat(parts, dim=axis)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, causal: bool = True,
                    pad_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q: (B,H,N,dh); k,v: (B,Hkv,N,dh) -> out (B,H,N,dh), and with
    ``return_lse`` also the per-row log-sum-exp (B,H,N) fp32 the kernel
    emits. Rows with no attendable key output 0."""
    B, H, N, dh = q.shape
    Hkv = k.shape[1]
    w = min(window, N)
    nb = -(-N // w)
    Np = nb * w
    pm = (torch.ones((B, N), dtype=torch.bool, device=q.device)
          if pad_mask is None else pad_mask)
    if Np != N:
        q = F.pad(q, (0, 0, 0, Np - N))
        k = F.pad(k, (0, 0, 0, Np - N))
        v = F.pad(v, (0, 0, 0, Np - N))
        pm = F.pad(pm, (0, Np - N), value=False)

    qb = q.reshape(B, Hkv, H // Hkv, nb, w, dh)
    kb = k.reshape(B, Hkv, nb, w, dh)
    vb = v.reshape(B, Hkv, nb, w, dh)
    pmb = pm.reshape(B, nb, w)

    pos_own = (torch.arange(nb, device=q.device)[:, None] * w
               + torch.arange(w, device=q.device)[None, :])
    k_cat, v_cat = [_shift_blocks(kb, -1, 2), kb], [_shift_blocks(vb, -1, 2),
                                                    vb]
    pm_cat, pos_cat = [_shift_blocks(pmb, -1, 1), pmb], [pos_own - w, pos_own]
    if not causal:
        k_cat.append(_shift_blocks(kb, +1, 2))
        v_cat.append(_shift_blocks(vb, +1, 2))
        pm_cat.append(_shift_blocks(pmb, +1, 1))
        pos_cat.append(pos_own + w)
    kc = torch.cat(k_cat, dim=-2)                        # (B,Hkv,nb,cw,dh)
    vc = torch.cat(v_cat, dim=-2)
    pmc = torch.cat(pm_cat, dim=-1)                      # (B,nb,cw)
    pos_k = torch.cat(pos_cat, dim=-1)                   # (nb,cw)

    logits = torch.einsum("bhgnwd,bhnud->bhgnwu", qb, kc).float()
    logits = logits / float(dh) ** 0.5
    keep = (pos_k[:, None, :] >= 0) & (pos_k[:, None, :] < Np)
    if causal:
        keep = keep & (pos_own[:, :, None] >= pos_k[:, None, :])
    keep = keep[None, None, None] & pmc[:, None, None, :, None, :]
    logits = logits.masked_fill(~keep, _BIG_NEG)
    attn = torch.softmax(logits, dim=-1)
    any_keep = keep.any(-1, keepdim=True)
    attn = torch.where(any_keep, attn, 0.0)
    out = torch.einsum("bhgnwu,bhnud->bhgnwd", attn.to(vc.dtype), vc)
    out = out.reshape(B, H, Np, dh)[:, :, :N]
    if not return_lse:
        return out
    m = logits.amax(-1, keepdim=True)
    l = torch.where(keep, torch.exp(logits - m), 0.0).sum(-1, keepdim=True)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse.reshape(B, H, Np)[:, :, :N]
