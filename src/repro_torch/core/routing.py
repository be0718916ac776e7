"""Routing attention — Algorithm 1 of Roy et al. 2020, batched + multi-head
(PyTorch port of the JAX package's ``core/routing.py``).

Per head: routing vectors r = LN_no-scale-bias(q) (shared-QK in the causal
LM setting), affinities S = r @ mu^T, balanced per-centroid top-w
membership (indices sorted ascending), intra-cluster attention with a
causal mask on *original* positions, scatter-mean back to sequence order,
and optionally the EMA centroid update.

``impl="torch"`` gathers the (B,H,k,w,dh) member blocks and runs the plain
block attention; ``impl="cuda_fused"`` hands sequence-layout q/k/v plus
the membership indices to the fused CUDA kernel
(`kernels.routing_attention`), which pulls member rows itself. The
segment fold (``RoutingConfig.segments > 1``) and the routing-health
stats of the JAX package are not ported yet and raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import RoutingConfig
from repro_torch.core.kmeans import (KMeansState, cluster_scores, ema_update,
                                     normalize_routing)

_BIG_NEG = -1e9
IMPLS = ("torch", "cuda_fused")


class RoutingOutput(NamedTuple):
    out: torch.Tensor           # (B, H, N, dh)
    state: KMeansState          # updated (or unchanged) centroids


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


def _scatter_rows(og: torch.Tensor, idx: torch.Tensor, n: int,
                  mode: str) -> torch.Tensor:
    """Scatter per-cluster outputs og (B,H,k,w,d) back to (B,H,n,d).

    mode="mean": scatter-add in fp32 and divide by the membership count
    (`index_add_`; on CUDA its atomics sum a token's <= k cluster copies in
    run-dependent order, a few fp32 ulps before the cast back).
    mode="last": plain scatter; with duplicate memberships the winner is
    unspecified (as in the JAX reference), so use it only without them.
    """
    B, H, k, w, d = og.shape
    rows = (torch.arange(B * H, device=og.device)[:, None] * n
            + idx.reshape(B * H, k * w)).reshape(-1)
    flat_og = og.reshape(B * H * k * w, d)
    if mode == "last":
        out = torch.zeros((B * H * n, d), dtype=og.dtype, device=og.device)
        out[rows] = flat_og
        return out.reshape(B, H, n, d)
    if mode != "mean":
        raise ValueError(f"unknown scatter mode {mode!r}")
    out = torch.zeros((B * H * n, d), dtype=torch.float32, device=og.device)
    out.index_add_(0, rows, flat_og.float())
    cnt = torch.zeros((B * H * n,), dtype=torch.float32, device=og.device)
    cnt.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float32))
    out = out / cnt.clamp_min(1.0)[:, None]
    return out.reshape(B, H, n, d).to(og.dtype)


def _block_attention(qg, kg, vg, pos_q, pos_k, causal: bool,
                     valid_k: Optional[torch.Tensor] = None,
                     return_lse: bool = False):
    """Intra-cluster attention on gathered blocks (B,H,k,w,dh); the plain
    math of the fused kernel. Queries whose cluster holds no attendable
    key output 0. With ``return_lse`` also the per-row log-sum-exp."""
    dh = qg.shape[-1]
    logits = torch.einsum("bhkwd,bhkud->bhkwu", qg, kg).float()
    logits = logits / float(dh) ** 0.5
    keep = torch.ones(logits.shape, dtype=torch.bool, device=qg.device)
    if causal:
        keep = keep & (pos_q[..., :, None] >= pos_k[..., None, :])
    if valid_k is not None:
        keep = keep & valid_k[..., None, :]
    logits = logits.masked_fill(~keep, _BIG_NEG)
    attn = torch.softmax(logits, dim=-1)
    attn = torch.where(keep.any(-1, keepdim=True), attn, 0.0)
    og = torch.einsum("bhkwu,bhkud->bhkwd", attn.to(vg.dtype), vg)
    if not return_lse:
        return og
    m = logits.amax(-1, keepdim=True)
    l = torch.where(keep, torch.exp(logits - m), 0.0).sum(-1, keepdim=True)
    return og, (m + torch.log(l.clamp_min(1e-30)))[..., 0]


def gathered_block_attention(q, k, v, q_idx, k_idx, positions, causal=True,
                             kvalid=None, return_lse=False):
    """Routed attention on sequence-layout q/k/v through gathered blocks.

    q/v: (B,H,N,dh); k: like q, or None for shared-QK (keys are q's rows).
    q_idx/k_idx: (B,H,k,w) membership. positions: (B,N) original positions.
    kvalid: (B,N) bool, False = padded key. Returns per-cluster outputs
    (B,H,k,w,dh) (and the lse (B,H,k,w) with ``return_lse``).
    """
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
    return _block_attention(qg, kg, vg, pos_q, pos_k, causal, valid_k,
                            return_lse)


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
    q_idx = balanced_topk(cluster_scores(r_q, state.mu), w, pad_mask)
    k_idx = q_idx if shared else balanced_topk(
        cluster_scores(r_k, state.mu), w, pad_mask)

    if impl == "cuda_fused":
        from repro_torch.kernels.routing_attention import \
            routed_attention_fused
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        og, _ = routed_attention_fused(
            r_q.contiguous(), None if shared else k_attn.contiguous(),
            v.contiguous(), i32(q_idx), i32(k_idx), i32(positions),
            causal=cfg.causal, kvalid=pad_mask)
    else:
        og = gathered_block_attention(r_q, None if shared else k_attn, v,
                                      q_idx, k_idx, positions, cfg.causal,
                                      pad_mask)
    out = _scatter_rows(og, q_idx, N, cfg.scatter_mode)
    new_state = state
    if update_state:
        new_state = ema_update(state, r_q, None if shared else r_k,
                               pad_mask, cfg.decay)
    return RoutingOutput(out=out, state=new_state)
