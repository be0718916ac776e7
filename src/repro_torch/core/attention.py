"""Dense (full) causal/bidirectional GQA attention (port of the JAX
package's ``core/attention.py``), and the plain PyTorch version of the
CUDA flash-attention kernels (`kernels.flash_attention`).

Two implementations with the same math:
  * ``full_attention(..., chunk=0)``: one-shot softmax (small N);
  * ``full_attention(..., chunk=c)``: a loop over KV chunks with a running
    online-softmax accumulator (the flash recurrence), each chunk under
    `torch.utils.checkpoint`, so the backward keeps only the (m, l, acc)
    chain and not every chunk's fp32 scores: memory O(N*c), not O(N^2).

The causal mask compares query ``positions`` (default arange(N)) with
key indices arange(M). The serving path uses the non-causal one-shot form
for the local half of decode; the full-attention backends use all of it.
GQA-native (k/v carry Hkv heads, no materialized repeat); fp32 softmax.

`full_attention_bwd_dq` / `full_attention_bwd_dkv` are the plain versions
of the two backward kernels: they recompute p from the forward's lse with
the kernels' row-index causal mask (positions = arange).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import upcast

_BIG_NEG = -1e9


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    B, H, N, dh = q.shape
    return q.reshape(B, num_kv, H // num_kv, N, dh)


def _keep(B, N, k0, nk, causal, positions, pad_mask, device):
    """Bool, broadcastable to (B,1,1,N,nk): query n may attend key k0 + j;
    None when every query may attend every key."""
    keep = None
    if causal:
        pos_q = (positions if positions is not None
                 else torch.arange(N, device=device).expand(B, N))
        pos_k = k0 + torch.arange(nk, device=device)
        keep = pos_q[:, None, None, :, None] >= pos_k
    if pad_mask is not None:
        pm = pad_mask[:, None, None, None, k0:k0 + nk]
        keep = pm if keep is None else keep & pm
    return keep


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   pad_mask: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   chunk: int = 0, return_lse: bool = False,
                   scale: Optional[float] = None):
    """q: (B,H,N,dh); k,v: (B,Hkv,M,dh) -> (B,H,N,dh).

    pad_mask: (B, M) bool over keys. positions: (B, N) query positions for
    the causal mask (default arange(N), the row index). With
    ``return_lse`` (one-shot only) also the per-row log-sum-exp (B,H,N)
    in at least fp32, as the flash kernel emits it. ``scale`` (default
    1 / sqrt(dh)): the flash wrapper passes that of the true head dim when
    it runs zero-padded heads.
    """
    if chunk:
        return _chunked_attention(q, k, v, causal, pad_mask, positions,
                                  chunk, scale)
    B, H, N, dh = q.shape
    Hkv, M = k.shape[1], k.shape[2]
    qg = _split_gqa(q, Hkv)
    logits = upcast(torch.einsum("bhgnd,bhmd->bhgnm", qg, k))
    logits = (logits / float(dh) ** 0.5 if scale is None
              else logits * scale)
    keep = _keep(B, N, 0, M, causal, positions, pad_mask, q.device)
    if keep is not None:
        logits = logits.masked_fill(~keep, _BIG_NEG)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgnm,bhmd->bhgnd", attn.to(v.dtype), v)
    out = out.reshape(B, H, N, dh)
    if not return_lse:
        return out
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = (p if keep is None else torch.where(keep, p, 0.0)).sum(-1,
                                                               keepdim=True)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse.reshape(B, H, N)


def _chunk_step(m, l, acc, qg, kb, vb, keep, scale):
    """One KV chunk of the online softmax: (m, l, acc) -> updated."""
    logits = upcast(torch.einsum("bhgnd,bhcd->bhgnc", qg, kb)) * scale
    if keep is not None:
        logits = logits.masked_fill(~keep, _BIG_NEG)
    m_new = torch.maximum(m, logits.amax(-1))
    p = torch.exp(logits - m_new[..., None])
    if keep is not None:
        p = p * keep
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = (acc * corr[..., None]
               + torch.einsum("bhgnc,bhcd->bhgnd", p, upcast(vb)))
    return m_new, l_new, acc_new


def _chunked_attention(q, k, v, causal, pad_mask, positions, chunk,
                       scale=None):
    """Online-softmax loop over KV chunks (the flash recurrence in plain
    PyTorch)."""
    B, H, N, dh = q.shape
    if scale is None:
        scale = 1.0 / float(dh) ** 0.5
    Hkv, M = k.shape[1], k.shape[2]
    qg = _split_gqa(q, Hkv)
    acc_dt = upcast(q).dtype
    m = torch.full((B, Hkv, H // Hkv, N), _BIG_NEG, dtype=acc_dt,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, H // Hkv, N, dh), dtype=acc_dt,
                      device=q.device)
    for k0 in range(0, M, chunk):
        nk = min(chunk, M - k0)
        keep = _keep(B, N, k0, nk, causal, positions, pad_mask, q.device)
        # only the carried (m, l, acc) are kept for the backward; the
        # chunk's scores and probabilities are recomputed there
        m, l, acc = checkpoint(_chunk_step, m, l, acc, qg,
                               k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk],
                               keep, scale, use_reentrant=False,
                               preserve_rng_state=False)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, N, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Backward (the plain version of the two flash backward kernels)
# ---------------------------------------------------------------------------
def _bwd_probs(q, k, v, do, lse, dsum, causal, scale):
    """The recurrence both backward kernels run: p = keep ? exp(s - lse)
    : 0 (masked explicitly) and ds = p * (do.v^T - D) * scale, with
    D = rowsum(do * out); causal on row indices; scale 1 / sqrt(dh) by
    default."""
    B, H, N, dh = q.shape
    Hkv, M = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / float(dh) ** 0.5
    qg, dog = _split_gqa(upcast(q), Hkv), _split_gqa(upcast(do), Hkv)
    s = torch.einsum("bhgnd,bhmd->bhgnm", qg, upcast(k)) * scale
    p = torch.exp(s - _split_gqa(lse[..., None], Hkv))
    if causal:
        p = torch.where(_keep(B, N, 0, M, True, None, None, q.device), p,
                        0.0)
    dp = torch.einsum("bhgnd,bhmd->bhgnm", dog, upcast(v))
    ds = p * (dp - _split_gqa(upcast(dsum)[..., None], Hkv)) * scale
    return qg, dog, p, ds


def full_attention_bwd_dq(q, k, v, do, lse, dsum, causal: bool = True,
                          scale: Optional[float] = None):
    """dq (B,H,N,dh) in at least fp32 from the saved lse and D (B,H,N)."""
    B, H, N, dh = q.shape
    _, _, _, ds = _bwd_probs(q, k, v, do, lse, dsum, causal, scale)
    return torch.einsum("bhgnm,bhmd->bhgnd", ds,
                        upcast(k)).reshape(B, H, N, dh)


def full_attention_bwd_dkv(q, k, v, do, lse, dsum, causal: bool = True,
                           scale: Optional[float] = None):
    """(dk, dv) per *query* head (B,H,M,dh) in at least fp32; the caller
    sums them over each kv head's query group (GQA)."""
    B, H, _, dh = q.shape
    M = k.shape[2]
    qg, dog, p, ds = _bwd_probs(q, k, v, do, lse, dsum, causal, scale)
    dk = torch.einsum("bhgnm,bhgnd->bhgmd", ds, qg)
    dv = torch.einsum("bhgnm,bhgnd->bhgmd", p, dog)
    return dk.reshape(B, H, M, dh), dv.reshape(B, H, M, dh)
