"""Routing attention — Algorithm 1 of Roy et al. 2020, batched + multi-head
(PyTorch port of the JAX package's ``core/routing.py``).

Per head: routing vectors r = LN_no-scale-bias(q) (shared-QK in the causal
LM setting), affinities S = r @ mu^T, balanced per-centroid top-w
membership (indices sorted ascending), intra-cluster attention with a
causal mask on *original* positions, scatter-mean back to sequence order,
and optionally the EMA centroid update.

``impl="torch"`` gathers the (B,H,k,w,dh) member blocks and runs the plain
block attention (differentiable by autograd); ``impl="cuda_fused"`` hands
sequence-layout q/k/v plus the membership indices to the fused CUDA
kernels (`kernels.routing_attention.RoutedAttentionFused`, forward and
backward), which pull member rows themselves; ``impl="cuda_gathered"``
gathers the blocks here, as XLA does for the JAX package's gathered
kernel, and runs the gathered CUDA kernels on them
(`kernels.routing_gathered.attend_blocks`; the scatter back to sequence
layout is the backward of the gather). `block_attention`, `block_bwd_dq`
and `block_bwd_dkv` are the plain versions of the block kernels,
`routed_attention_bwd_dq` and `routed_attention_bwd_dkv` those of the
fused backward kernels. The centroids carry no gradient. The segment fold
(``RoutingConfig.segments > 1``) and the routing-health stats of the JAX
package are not ported yet and raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import RoutingConfig
from repro_torch.core import upcast
from repro_torch.core.kmeans import (KMeansState, cluster_scores, ema_update,
                                     normalize_routing)

_BIG_NEG = -1e9
IMPLS = ("torch", "cuda_fused", "cuda_gathered")


class RoutingOutput(NamedTuple):
    out: torch.Tensor           # (B, H, N, dh)
    state: KMeansState          # updated (or unchanged) centroids
    r_q: torch.Tensor           # (B, H, N, dh) routing vectors of q
    scores: torch.Tensor        # (B, H, N, k) fp32 centroid affinities of r_q


def balanced_topk(scores: torch.Tensor, window: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-centroid balanced top-w membership (Algorithm 1 lines 12-18).

    scores: (B, H, N, k); valid: (B, N) bool, padding pushed to -1e9 so it
    is only taken once every real token is. Returns sorted int64 indices
    (B, H, k, w). Ties go to the lower token index, as `jax.lax.top_k`
    orders them (pad tokens all tie at -1e9): a stable descending sort,
    not `torch.topk`, whose tie order is unspecified.
    """
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, :, None], _BIG_NEG)
    per_centroid = scores.transpose(-1, -2)              # (B,H,k,N)
    idx = torch.sort(per_centroid, dim=-1, descending=True,
                     stable=True).indices[..., :window]
    return torch.sort(idx, dim=-1).values


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B,H,N,d), idx: (B,H,k,w) -> (B,H,k,w,d)."""
    B, H, N, d = x.shape
    k, w = idx.shape[2], idx.shape[3]
    flat = idx.reshape(B, H, k * w, 1).expand(B, H, k * w, d)
    return torch.gather(x, 2, flat).reshape(B, H, k, w, d)


def _flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B,H,k,w) membership -> row numbers of the flat (B*H*n) plane."""
    B, H = idx.shape[:2]
    return (torch.arange(B * H, device=idx.device)[:, None] * n
            + idx.reshape(B * H, -1)).reshape(-1)


def _add_rows(og: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """og (B,H,k,w,d) summed onto the flat ``rows`` of a (B,H,n,d) plane,
    in at least fp32. Deterministic: ``index_put_`` with ``accumulate``
    sorts the rows (stably) and adds the copies of a row in the order
    they appear in ``rows``, on the card too, where ``index_add_`` adds
    them by atomics in an order that changes from run to run."""
    B, H, k, w, d = og.shape
    out = torch.zeros((B * H * n, d), device=og.device,
                      dtype=torch.promote_types(og.dtype, torch.float32))
    out.index_put_((rows,), upcast(og).reshape(-1, d), accumulate=True)
    return out.reshape(B, H, n, d)


def scatter_add_rows(og: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """The transpose of `_gather_rows`: per-cluster rows og (B,H,k,w,d) are
    summed into (B,H,n,d) in at least fp32; a token in several clusters
    gets the sum of its copies, added in cluster order (`_add_rows`)."""
    return _add_rows(og, _flat_rows(idx, n), n)


def _scatter_rows(og: torch.Tensor, idx: torch.Tensor, n: int,
                  mode: str) -> torch.Tensor:
    """Scatter per-cluster outputs og (B,H,k,w,d) back to (B,H,n,d).

    mode="mean": the `_add_rows` sum divided by the membership count
    (summed in the same call, as a column of ones), then cast back.
    mode="last": plain scatter; with duplicate memberships the winner is
    unspecified (as in the JAX reference), so use it only without them.
    """
    B, H, k, w, d = og.shape
    rows = _flat_rows(idx, n)
    if mode == "last":
        out = torch.zeros((B * H * n, d), dtype=og.dtype, device=og.device)
        out[rows] = og.reshape(-1, d)
        return out.reshape(B, H, n, d)
    if mode != "mean":
        raise ValueError(f"unknown scatter mode {mode!r}")
    ones = torch.ones(og.shape[:-1] + (1,), dtype=og.dtype, device=og.device)
    out, cnt = _add_rows(torch.cat([og, ones], -1), rows, n).split(d, -1)
    return (out / cnt.clamp_min(1.0)).to(og.dtype)


def block_keep(pos_q, pos_k, causal: bool,
               valid_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attendable (query, key) pairs of each cluster block (B,H,k,w,w):
    causal on original positions, padded keys never."""
    shape = pos_q.shape + pos_k.shape[-1:]
    keep = torch.ones(shape, dtype=torch.bool, device=pos_q.device)
    if causal:
        keep = keep & (pos_q[..., :, None] >= pos_k[..., None, :])
    if valid_k is not None:
        keep = keep & valid_k[..., None, :]
    return keep


def block_attention(qg, kg, vg, pos_q, pos_k, causal: bool,
                    valid_k: Optional[torch.Tensor] = None,
                    return_lse: bool = False,
                    scale: Optional[float] = None):
    """Intra-cluster attention on gathered blocks (..., w, dh) with their
    (..., w) positions: the plain math of the fused and the gathered
    kernels. Queries whose cluster holds no attendable key output 0. With
    ``return_lse`` also the per-row log-sum-exp. ``scale`` (default
    1 / sqrt(dh)) multiplies the scores: the fused kernels' wrappers pass
    the true head dim's when they pad the head dim with zero columns."""
    dh = qg.shape[-1]
    logits = upcast(torch.einsum("...wd,...ud->...wu", qg, kg))
    logits = (logits / float(dh) ** 0.5 if scale is None
              else logits * scale)
    keep = block_keep(pos_q, pos_k, causal, valid_k)
    logits = logits.masked_fill(~keep, _BIG_NEG)
    attn = torch.softmax(logits, dim=-1)
    attn = torch.where(keep.any(-1, keepdim=True), attn, 0.0)
    og = torch.einsum("...wu,...ud->...wd", attn.to(vg.dtype), vg)
    if not return_lse:
        return og
    m = logits.amax(-1, keepdim=True)
    l = torch.where(keep, torch.exp(logits - m), 0.0).sum(-1, keepdim=True)
    return og, (m + torch.log(l.clamp_min(1e-30)))[..., 0]


def gather_blocks(q, k, v, q_idx, k_idx, positions, kvalid=None):
    """Member blocks of sequence-layout q/k/v: (qg, kg, vg) (B,H,k,w,dh)
    (kg is qg for shared-QK, ``k=None``), their original positions
    (pos_q, pos_k) (B,H,k,w) and the keys' validity (None without
    ``kvalid``)."""
    B, H, N, _ = q.shape
    kc, w = q_idx.shape[2], q_idx.shape[3]
    qg = _gather_rows(q, q_idx)
    kg = qg if k is None else _gather_rows(k, k_idx)
    vg = _gather_rows(v, k_idx)
    pos = positions[:, None, :].expand(B, H, N)
    pos_q = torch.gather(pos, 2, q_idx.reshape(B, H, -1)).reshape(B, H, kc, w)
    pos_k = torch.gather(pos, 2, k_idx.reshape(B, H, -1)).reshape(B, H, kc, w)
    valid_k = None
    if kvalid is not None:
        vm = kvalid[:, None, :].expand(B, H, N)
        valid_k = torch.gather(vm, 2, k_idx.reshape(B, H, -1)).reshape(
            B, H, kc, w)
    return qg, kg, vg, pos_q, pos_k, valid_k


def gathered_block_attention(q, k, v, q_idx, k_idx, positions, causal=True,
                             kvalid=None, return_lse=False, scale=None):
    """Routed attention on sequence-layout q/k/v through gathered blocks.

    q/v: (B,H,N,dh); k: like q, or None for shared-QK (keys are q's rows).
    q_idx/k_idx: (B,H,k,w) membership. positions: (B,N) original positions.
    kvalid: (B,N) bool, False = padded key. Returns per-cluster outputs
    (B,H,k,w,dh) (and the lse (B,H,k,w) with ``return_lse``).
    """
    qg, kg, vg, pos_q, pos_k, valid_k = gather_blocks(
        q, k, v, q_idx, k_idx, positions, kvalid)
    return block_attention(qg, kg, vg, pos_q, pos_k, causal, valid_k,
                           return_lse, scale)


def block_bwd(qg, kg, vg, pos_q, pos_k, do, lse, dsum, causal, valid_k,
              scale=None):
    """The recurrence the backward kernels run, on gathered blocks
    (..., w, dh): p = keep ? exp(s - lse) : 0 (masked explicitly: a row
    with no key has lse ~ -1e9, where exp(s - lse) of a masked score would
    read ~1) and ds = p * (do.v^T - D) * scale (1 / sqrt(dh) unless
    given). do (..., w, dh), lse/D (..., w). Returns (p, ds)."""
    if scale is None:
        scale = 1.0 / float(qg.shape[-1]) ** 0.5
    s = torch.einsum("...wd,...ud->...wu", upcast(qg), upcast(kg)) * scale
    keep = block_keep(pos_q, pos_k, causal, valid_k)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("...wd,...ud->...wu", upcast(do), upcast(vg))
    return p, p * (dp - upcast(dsum)[..., None]) * scale


def block_bwd_dq(qg, kg, vg, pos_q, pos_k, do, lse, dsum, causal,
                 valid_k=None, scale=None):
    """dq blocks (..., w, dh) in at least fp32."""
    _, ds = block_bwd(qg, kg, vg, pos_q, pos_k, do, lse, dsum, causal,
                      valid_k, scale)
    return torch.einsum("...wu,...ud->...wd", ds, upcast(kg))


def block_bwd_dkv(qg, kg, vg, pos_q, pos_k, do, lse, dsum, causal,
                  valid_k=None, scale=None):
    """(dk, dv) blocks (..., w, dh) in at least fp32."""
    p, ds = block_bwd(qg, kg, vg, pos_q, pos_k, do, lse, dsum, causal,
                      valid_k, scale)
    return (torch.einsum("...wu,...wd->...ud", ds, upcast(qg)),
            torch.einsum("...wu,...wd->...ud", p, upcast(do)))


def routed_attention_bwd_dq(q, k, v, q_idx, k_idx, positions, do, lse, dsum,
                            causal=True, kvalid=None, scale=None):
    """Per-cluster dq blocks (B,H,k,w,dh) in at least fp32, from
    sequence-layout q/k/v (the plain version of the fused dq kernel)."""
    qg, kg, vg, pos_q, pos_k, valid_k = gather_blocks(
        q, k, v, q_idx, k_idx, positions, kvalid)
    return block_bwd_dq(qg, kg, vg, pos_q, pos_k, do, lse, dsum, causal,
                        valid_k, scale)


def routed_attention_bwd_dkv(q, k, v, q_idx, k_idx, positions, do, lse,
                             dsum, causal=True, kvalid=None, scale=None):
    """Per-cluster (dk, dv) blocks (B,H,k,w,dh) in at least fp32, from
    sequence-layout q/k/v (the plain version of the fused dk/dv kernel)."""
    qg, kg, vg, pos_q, pos_k, valid_k = gather_blocks(
        q, k, v, q_idx, k_idx, positions, kvalid)
    return block_bwd_dkv(qg, kg, vg, pos_q, pos_k, do, lse, dsum, causal,
                         valid_k, scale)


def routed_attention(q: torch.Tensor, k: Optional[torch.Tensor],
                     v: torch.Tensor, state: KMeansState, cfg: RoutingConfig,
                     positions: Optional[torch.Tensor] = None,
                     pad_mask: Optional[torch.Tensor] = None,
                     update_state: bool = True,
                     impl: str = "torch") -> RoutingOutput:
    """Content-routed sparse attention.

    q, v: (B, H, N, dh); k: same or None (shared-QK causal mode).
    positions: (B, N) original positions (default arange) for the causal
    mask. pad_mask: (B, N) bool, True = real token; padding is excluded
    from top-k selection, attention and the centroid update.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown routing impl {impl!r}; expected {IMPLS}")
    if cfg.segments > 1 or cfg.stats:
        raise NotImplementedError(
            "the port's routed_attention has no segment fold and no "
            "routing-health stats yet (RoutingConfig.segments=1, stats=False)")
    B, H, N, dh = q.shape
    if positions is None:
        positions = torch.arange(N, device=q.device).expand(B, N)
    w = min(cfg.window or max(1, N // cfg.num_clusters), N)
    shared = cfg.share_qk and cfg.causal

    r_q = normalize_routing(q)
    if shared:
        r_k = k_attn = r_q
    else:
        r_k = k_attn = normalize_routing(k if k is not None else q)
    scores_q = cluster_scores(r_q, state.mu)
    q_idx = balanced_topk(scores_q, w, pad_mask)
    k_idx = q_idx if shared else balanced_topk(
        cluster_scores(r_k, state.mu), w, pad_mask)

    k_in = None if shared else k_attn
    if impl == "cuda_fused":
        from repro_torch.kernels.routing_attention import RoutedAttentionFused
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        og, _ = RoutedAttentionFused.apply(
            r_q.contiguous(), None if k_in is None else k_in.contiguous(),
            v.contiguous(), i32(q_idx), i32(k_idx), i32(positions),
            cfg.causal, pad_mask)
    elif impl == "cuda_gathered":
        from repro_torch.kernels.routing_gathered import attend_blocks
        qg, kg, vg, pos_q, pos_k, valid_k = gather_blocks(
            r_q, k_in, v, q_idx, k_idx, positions, pad_mask)
        og = attend_blocks(qg, kg, vg, pos_q, pos_k, cfg.causal, valid_k)
    else:
        og = gathered_block_attention(r_q, k_in, v, q_idx, k_idx, positions,
                                      cfg.causal, pad_mask)
    out = _scatter_rows(og, q_idx, N, cfg.scatter_mode)
    new_state = state
    if update_state:
        new_state = ema_update(state, r_q, None if shared else r_k,
                               pad_mask, cfg.decay)
    return RoutingOutput(out=out, state=new_state, r_q=r_q, scores=scores_q)
