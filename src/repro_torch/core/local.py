"""Blocked local (sliding-window) attention — the paper's local heads.

Port of the JAX package's ``core/local.py``, and the plain PyTorch version
of the CUDA local-window kernels (`kernels.local_attention`): the forward
and the two backward kernels (`local_attention_bwd_dq`,
`local_attention_bwd_dkv`, which recompute p from the saved lse). The
sequence is cut into blocks of `window` tokens; a query block attends
itself and the previous block (plus the next one in encoder mode), masked
on absolute positions. GQA-native, fp32 softmax, O(N * w) memory.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import upcast

_BIG_NEG = -1e9


def _shift_blocks(x: torch.Tensor, direction: int, axis: int) -> torch.Tensor:
    """Shift the block axis by one (-1: previous block, +1: next block),
    filling the vacated block with zeros."""
    body = x.narrow(axis, 0, x.shape[axis] - 1) if direction == -1 else \
        x.narrow(axis, 1, x.shape[axis] - 1)
    zeros = torch.zeros_like(x.narrow(axis, 0, 1))
    parts = [zeros, body] if direction == -1 else [body, zeros]
    return torch.cat(parts, dim=axis)


class _Blocks(NamedTuple):
    """The blocked layout of one call: q (B,Hkv,g,nb,w,dh), the keys and
    values each query block sees (B,Hkv,nb,cw,dh) with cw = 2w (3w
    non-causal: previous, own[, next] block) and their mask
    (B,1,1,nb,w,cw)."""
    qb: torch.Tensor
    kc: torch.Tensor
    vc: torch.Tensor
    keep: torch.Tensor
    w: int
    Np: int


def _blocks(q, k, v, window: int, causal: bool,
            pad_mask: Optional[torch.Tensor]) -> _Blocks:
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
    keep = (pos_k[:, None, :] >= 0) & (pos_k[:, None, :] < Np)
    if causal:
        keep = keep & (pos_own[:, :, None] >= pos_k[:, None, :])
    keep = keep[None, None, None] & pmc[:, None, None, :, None, :]
    return _Blocks(qb, kc, vc, keep, w, Np)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, causal: bool = True,
                    pad_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False,
                    scale: Optional[float] = None):
    """q: (B,H,N,dh); k,v: (B,Hkv,N,dh) -> out (B,H,N,dh), and with
    ``return_lse`` also the per-row log-sum-exp (B,H,N) fp32 the kernel
    emits. Rows with no attendable key output 0. ``scale`` (default
    1 / sqrt(dh)) multiplies the scores: the kernel wrappers pass the true
    head dim's when they pad the head dim with zero columns."""
    B, H, N, dh = q.shape
    bl = _blocks(q, k, v, window, causal, pad_mask)
    keep = bl.keep
    logits = upcast(torch.einsum("bhgnwd,bhnud->bhgnwu", bl.qb, bl.kc))
    logits = (logits / float(dh) ** 0.5 if scale is None
              else logits * scale)
    logits = logits.masked_fill(~keep, _BIG_NEG)
    attn = torch.softmax(logits, dim=-1)
    any_keep = keep.any(-1, keepdim=True)
    attn = torch.where(any_keep, attn, 0.0)
    out = torch.einsum("bhgnwu,bhnud->bhgnwd", attn.to(bl.vc.dtype), bl.vc)
    out = out.reshape(B, H, bl.Np, dh)[:, :, :N].contiguous()
    if not return_lse:
        return out
    m = logits.amax(-1, keepdim=True)
    l = torch.where(keep, torch.exp(logits - m), 0.0).sum(-1, keepdim=True)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse.reshape(B, H, bl.Np)[:, :, :N].contiguous()


# ---------------------------------------------------------------------------
# Backward (the plain version of the two backward kernels)
# ---------------------------------------------------------------------------
def _bwd_blocks(q, k, v, do, lse, dsum, window, causal, pad_mask, scale):
    """The recurrence both backward kernels run, in the blocked layout:
    p = keep ? exp(s - lse) : 0 (masked explicitly: a row with no key has
    lse ~ -1e9, where exp(s - lse) of a masked score would read ~1) and
    ds = p * (do.v^T - D) * scale, with D = rowsum(do * out) and scale
    1 / sqrt(dh) unless given."""
    B, H, N, dh = q.shape
    bl = _blocks(q, k, v, window, causal, pad_mask)
    Hkv, g, nb, w = bl.qb.shape[1:5]
    pad = bl.Np - N
    dob = upcast(F.pad(do, (0, 0, 0, pad))).reshape(B, Hkv, g, nb, w, dh)
    lseb = F.pad(lse, (0, pad)).reshape(B, Hkv, g, nb, w, 1)
    db = F.pad(upcast(dsum), (0, pad)).reshape(B, Hkv, g, nb, w, 1)
    if scale is None:
        scale = 1.0 / float(dh) ** 0.5
    s = torch.einsum("bhgnwd,bhnud->bhgnwu", upcast(bl.qb),
                     upcast(bl.kc)) * scale
    p = torch.where(bl.keep, torch.exp(s - lseb), 0.0)
    dp = torch.einsum("bhgnwd,bhnud->bhgnwu", dob, upcast(bl.vc))
    return bl, dob, p, p * (dp - db) * scale


def local_attention_bwd_dq(q, k, v, do, lse, dsum, window: int,
                           causal: bool = True, pad_mask=None, scale=None):
    """dq (B,H,N,dh) in at least fp32 from the saved lse and D (B,H,N)."""
    B, H, N, dh = q.shape
    bl, _, _, ds = _bwd_blocks(q, k, v, do, lse, dsum, window, causal,
                               pad_mask, scale)
    dq = torch.einsum("bhgnwu,bhnud->bhgnwd", ds, upcast(bl.kc))
    return dq.reshape(B, H, bl.Np, dh)[:, :, :N]


def _fold_keys(x_cat: torch.Tensor, w: int) -> torch.Tensor:
    """Per-query-block key gradients (B,Hkv,g,nb,cw,dh) back onto the key
    blocks they came from: block n collects its own chunk, the previous
    chunk of block n+1 and (non-causal) the next chunk of block n-1."""
    parts = x_cat.split(w, dim=-2)
    out = parts[1] + _shift_blocks(parts[0], +1, 3)
    if len(parts) == 3:
        out = out + _shift_blocks(parts[2], -1, 3)
    return out


def local_attention_bwd_dkv(q, k, v, do, lse, dsum, window: int,
                            causal: bool = True, pad_mask=None, scale=None):
    """(dk, dv) per *query* head (B,H,N,dh) in at least fp32; the caller
    sums them over each kv head's query group (GQA)."""
    B, H, N, dh = q.shape
    bl, dob, p, ds = _bwd_blocks(q, k, v, do, lse, dsum, window, causal,
                                 pad_mask, scale)
    dk = _fold_keys(torch.einsum("bhgnwu,bhgnwd->bhgnud", ds,
                                 upcast(bl.qb)), bl.w)
    dv = _fold_keys(torch.einsum("bhgnwu,bhgnwd->bhgnud", p, dob), bl.w)
    return (dk.reshape(B, H, bl.Np, dh)[:, :, :N],
            dv.reshape(B, H, bl.Np, dh)[:, :, :N])
