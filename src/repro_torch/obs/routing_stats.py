"""Routing-health statistics for content-based sparse attention (port of
the JAX package's ``obs/routing_stats.py``).

The paper's complexity bound and its quality both assume the online
k-means stays healthy: balanced occupancy (collapse breaks the O(n^1.5)
cost), live centroids, and a routed pattern that captures the attention
mass a dense model would spend. `compute_routing_stats` reads those
signals off intermediates the routing layer already has (scores, balanced
membership); its largest cost is one (P, N) probe softmax with
P = ``stats_probes`` rows.

Per routing layer (leaves shaped over that layer's routing heads H):

  occupancy  (H, k)  batch-mean token count per centroid (argmax
                     assignment, padding excluded)
  entropy    (H,)    occupancy entropy in nats; log(k) = balanced,
                     0 = collapsed
  dead       (H,)    centroids with no assigned token (batch mean)
  drift      (H,)    mean_k ||mu_t - mu_{t-1}||_2: centroid movement of
                     this step's EMA update (0 when update_state=False)
  mismatch   (H,)    fraction of tokens whose argmax centroid did NOT
                     select them under balanced top-w membership
  recall     (H,)    sampled attention recall: on P strided probe
                     queries, the fraction of full-softmax attention mass
                     (same normalized q/k, same causal and pad masks) on
                     keys the routed pattern reaches

Everything is fp32 and computed under ``torch.no_grad()``: stats never
reach a gradient, and nothing is written in place into the layer's
tensors. The membership masks are built by ``scatter_`` into (B, H, k, N),
not as the JAX package's one-hot over (B, H, k, w, N), which at
rt-enwik8's train shape would take 2.1 GB per layer; the 0/1 values are
the same. Imports torch and the standard library only.

Host-side helpers at the bottom (`summarize`, `flatten`, `pages_health`)
fold stats trees into scalar metric dicts and read cluster-page occupancy
off a serving cache's ``rlen`` leaves.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

_BIG_NEG = -1e9
_EPS = 1e-12

SCALAR_FIELDS = ("entropy", "dead", "drift", "mismatch", "recall")


class RoutingStats(NamedTuple):
    occupancy: torch.Tensor    # (H, k)
    entropy: torch.Tensor      # (H,)
    dead: torch.Tensor         # (H,)
    drift: torch.Tensor        # (H,)
    mismatch: torch.Tensor     # (H,)
    recall: torch.Tensor       # (H,)


def _probe_idx(n: int, probes: int):
    """Strided probe positions: the last token of each of P equal chunks
    (later tokens have a longer causal history)."""
    p = max(1, min(int(probes), n))
    stride = n // p
    return tuple(int((i + 1) * stride - 1) for i in range(p))


def _membership(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B,H,k,w) member indices -> (B,H,k,n) fp32 0/1: token n is in
    cluster c."""
    B, H, kc, _ = idx.shape
    memb = torch.zeros((B, H, kc, n), dtype=torch.float32, device=idx.device)
    return memb.scatter_(3, idx.long(), 1.0)


@torch.no_grad()
def compute_routing_stats(r_q, k_attn, mu_prev, mu_new, scores_q, q_idx,
                          k_idx, positions, pad_mask, causal: bool,
                          probes: int = 8) -> RoutingStats:
    """All inputs are the routing layer's own intermediates:

    r_q/k_attn (B,H,N,dh) normalized routing vectors / attention keys,
    mu_prev/mu_new (H,k,dh) centroids before/after the EMA update,
    scores_q (B,H,N,k) centroid affinities, q_idx/k_idx (B,H,k,w)
    balanced memberships, positions (B,N), pad_mask (B,N) bool or None.
    """
    B, H, N, dh = r_q.shape
    kc = scores_q.shape[-1]
    f32 = torch.float32
    dev = r_q.device
    valid = (torch.ones((B, N), dtype=f32, device=dev) if pad_mask is None
             else pad_mask.to(f32))                        # (B,N)

    # --- occupancy / entropy / dead (argmax assignment, pad excluded)
    assign = scores_q.argmax(-1)                            # (B,H,N)
    counts = torch.zeros((B, H, kc), dtype=f32, device=dev).scatter_add_(
        2, assign, valid[:, None, :].expand(B, H, N))       # (B,H,k)
    total = counts.sum(-1, keepdim=True).clamp_min(1.0)
    p = counts / total
    entropy = -(p * torch.log(p.clamp_min(_EPS))).sum(-1)   # (B,H)
    dead = (counts <= 0.0).to(f32).sum(-1)                  # (B,H)

    # --- centroid drift of this step's EMA update
    drift = torch.linalg.vector_norm(
        mu_new.to(f32) - mu_prev.to(f32), dim=-1).mean(-1)  # (H,)

    # --- balanced-vs-nearest mismatch
    memb_q = _membership(q_idx, N)                          # (B,H,k,N)
    taken = memb_q.gather(2, assign[:, :, None, :])[:, :, 0, :]  # (B,H,N)
    n_valid = valid.sum().clamp_min(1.0)
    mismatch = 1.0 - (taken * valid[:, None, :]).sum((0, 2)) / n_valid

    # --- sampled attention recall on strided probe queries
    pidx = torch.tensor(_probe_idx(N, probes), device=dev)  # (P,)
    rq_p = r_q.index_select(2, pidx).to(f32)                # (B,H,P,dh)
    logits = torch.einsum("bhpd,bhnd->bhpn", rq_p,
                          k_attn.to(f32)) / math.sqrt(dh)
    keep = (valid[:, None, None, :] > 0).expand(logits.shape)
    if causal:
        pos_p = positions.index_select(1, pidx)             # (B,P)
        keep = keep & (pos_p[:, None, :, None]
                       >= positions[:, None, None, :])
    attn = torch.softmax(logits.masked_fill(~keep, _BIG_NEG), dim=-1)
    attn = torch.where(keep.any(-1, keepdim=True), attn, 0.0)
    memb_k = memb_q if k_idx is q_idx else _membership(k_idx, N)
    memb_q_p = memb_q.index_select(3, pidx)                 # (B,H,k,P)
    pattern = torch.einsum("bhcp,bhcn->bhpn", memb_q_p, memb_k) > 0
    captured = (attn * pattern).sum(-1)                     # (B,H,P)
    pv = valid.index_select(1, pidx)                        # (B,P)
    recall = ((captured * pv[:, None, :]).sum((0, 2))
              / pv.sum().clamp_min(1.0))                    # (H,)

    return RoutingStats(occupancy=counts.mean(0), entropy=entropy.mean(0),
                        dead=dead.mean(0), drift=drift, mismatch=mismatch,
                        recall=recall)


# ---------------------------------------------------------------------------
# Tree folding (train-step metrics / engine records)
# ---------------------------------------------------------------------------
def stack_stats(groups: List[Dict[str, RoutingStats]]
                ) -> Dict[str, RoutingStats]:
    """Per-group ``{layer: RoutingStats}`` dicts -> one dict whose leaves
    carry a leading (G,) group axis (the JAX package's scan ys)."""
    return {li: RoutingStats(*(torch.stack([getattr(g[li], f)
                                            for g in groups])
                               for f in RoutingStats._fields))
            for li in groups[0]}


def stats_leaves(tree) -> list:
    """Every RoutingStats instance anywhere in ``tree`` (dicts, lists and
    tuples), in order."""
    if isinstance(tree, RoutingStats):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in stats_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in stats_leaves(v)]
    return []


def summarize(tree) -> Dict[str, torch.Tensor]:
    """Model-wide scalar means over every RoutingStats in ``tree``:
    {"routing/entropy": ..., "routing/dead": ..., ...}. Empty dict when the
    tree holds no stats."""
    leaves = stats_leaves(tree)
    if not leaves:
        return {}
    return {f"routing/{f}": torch.cat(
        [getattr(s, f).to(torch.float32).reshape(-1) for s in leaves]).mean()
        for f in SCALAR_FIELDS}


def flatten(seg_stats, prefix: str = "rt") -> Dict[str, torch.Tensor]:
    """Per-layer detail from the stack's stats structure (a list over
    segments of {layer_index_str: RoutingStats}, leaves stacked over the
    segment's groups): "rt/{seg}/{layer}/{field}" -> tensor."""
    out: Dict[str, torch.Tensor] = {}
    for si, seg in enumerate(seg_stats):
        for li in sorted(seg):
            st = seg[li]
            for f in SCALAR_FIELDS:
                out[f"{prefix}/{si}/{li}/{f}"] = getattr(st, f)
    return out


# ---------------------------------------------------------------------------
# Serving-side pages health (host, numpy)
# ---------------------------------------------------------------------------
def _rlen_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in ([v] if k == "rlen" else _rlen_leaves(v))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _rlen_leaves(v)]
    return []


def pages_health(cache, active=None) -> Optional[Dict[str, Any]]:
    """Cluster-page occupancy health off a serving cache.

    Walks ``cache`` (the engine pool or a single lane) for ``rlen`` leaves
    ((G, B, Hr, kc) per-page token counts of the cluster-paged routing
    cache; tensors are copied to the host, which waits for the card) and
    returns the batch-mean occupancy entropy (nats) and dead-page count
    over the ``active`` slots, in float64 as the JAX package does. None
    when the stack has no routing pages or no slot is active.
    """
    rlens = [np.asarray(r.cpu() if isinstance(r, torch.Tensor) else r)
             for r in _rlen_leaves(cache)]
    if not rlens:
        return None
    ents, deads = [], []
    for rl in rlens:                       # (G,B,Hr,kc)
        rl = rl.astype(np.float64)
        if active is not None:
            rl = rl[:, np.asarray(active, bool)]
        if rl.size == 0 or rl.shape[1] == 0:
            continue
        tot = rl.sum(-1)                   # (G,B,Hr)
        occupied = tot > 0
        if not occupied.any():
            continue
        p = rl / np.maximum(tot, 1.0)[..., None]
        ent = -(p * np.log(np.maximum(p, _EPS))).sum(-1)
        ents.append(ent[occupied])
        deads.append((rl <= 0).sum(-1)[occupied])
    if not ents:
        return None
    return {"routing/entropy": float(np.concatenate(ents).mean()),
            "routing/dead": float(np.concatenate(deads).mean())}
