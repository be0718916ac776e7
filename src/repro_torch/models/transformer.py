"""Transformer stack of the port, dense family (port of the ``attn``-layer
part of the JAX package's ``models/transformer.py``).

The stack is a list of *segments*; each is a repeating pattern of layer
specs run ``n_groups`` times. Parameters, centroids and caches keep the JAX
layout: every leaf of a segment is stacked over its groups on a leading
(G, ...) axis, and the JAX ``lax.scan`` over groups is a Python loop here.
A layer is norm -> self-attention -> dropout -> residual -> norm -> FFN ->
dropout -> residual.

Dropout draws from a generator seeded per (step seed, layer, site) inside
the layer, as the JAX package folds its key in: `torch.utils.checkpoint`
restores only the default generators' state, so a generator carried into
a rematerialized group would draw new masks on recompute. Masks cannot
equal the JAX package's bits (another generator), so parity is held at
dropout 0 and dropout by its statistics.

Tensor parallelism (a `dist.tensor_parallel.ModelAxis` of M > 1 ranks):
each rank holds its shards of the rule table's placements
(`dist.sharding`) and runs the layer on them, Megatron-style: the
attention and FFN inputs enter the column-parallel products through
`ModelAxis.enter`, the row-parallel products' partial sums leave through
`ModelAxis.exit`, and the attention is one single-device call on the
rank's heads (`attn.head_shard`), so the CUDA kernels run there. A
local+routing layer's rank takes ``Hl / M`` local and ``Hr / M`` routing
heads (with their KV heads), not a contiguous column block of ``wq``: a
contiguous cut would give rank 0 every local head and the last rank every
routing head, while the centroids (`kstate_sharding`) split the routing
heads evenly. So `dist.sharding.shard_tree` groups the attention leaves'
head axis by rank before it cuts (`dist.sharding.head_groups`); the rule
table's sharded dims stay the JAX package's, only the order of the heads
inside them differs. With sequence parallelism the residual stream is the
rank's N / M slice of the sequence: `enter` gathers it, `exit`
reduce-scatters it, and the dropout mask is drawn for the whole sequence
(the same on every rank) and sliced.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import attn as attn_api
from repro_torch.attn.spec import head_split, spec_for_layer, variant_for_layer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kmeans import init_kmeans
from repro_torch.models import layers as L
from repro_torch.obs.routing_stats import stack_stats
from repro_torch.tree import (tree_leaves, tree_map, tree_stack,
                              tree_unflatten)

REMAT_POLICIES = ("none", "full")


@dataclass(frozen=True)
class LayerSpec:
    kind: str                 # attn (the only kind ported so far)
    attn: str = "full"        # attention variant of the layer


def per_layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family only, not {cfg.family!r}")
    return [LayerSpec("attn", variant_for_layer(cfg, i))
            for i in range(cfg.num_layers)]


def build_segments(cfg: ModelConfig) -> List[Tuple[Tuple[LayerSpec, ...],
                                                   int]]:
    """Compress the per-layer spec list into (pattern, n_groups) segments
    (dense family: period 1, so runs of identical layers)."""
    specs = per_layer_specs(cfg)
    segments: List[Tuple[Tuple[LayerSpec, ...], int]] = []
    i = 0
    while i < len(specs):
        g = 1
        while i + g < len(specs) and specs[i + g] == specs[i]:
            g += 1
        segments.append(((specs[i],), g))
        i += g
    return segments


def where_active(active: torch.Tensor, new_tree, old_tree,
                 batch_axis: int = 1):
    """Row-select between two cache trees along the batch axis: rows where
    ``active`` (B,) is False keep their old leaves."""
    def sel(n, o):
        shape = [1] * n.dim()
        shape[batch_axis] = -1
        return torch.where(active.reshape(shape), n, o)
    return tree_map(sel, new_tree, old_tree)


def init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
               device):
    dt = getattr(torch, cfg.dtype)
    return {"ln1": L.init_norm(cfg.d_model, cfg.norm, dt, device),
            "attn": L.init_attn_proj(gen, cfg, device),
            "ln2": L.init_norm(cfg.d_model, cfg.norm, dt, device),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                              device)}


def layer_kstate(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
                 device):
    """Centroids (Hr, k, dh) of a layer, or None without routing heads."""
    if "routing" not in spec.attn:
        return None
    Hr = cfg.num_heads if spec.attn == "routing" else head_split(cfg)[1]
    return init_kmeans(Hr, cfg.routing.num_clusters, cfg.head_dim_,
                       generator=gen, device=device).mu


def init_stack(gen: torch.Generator, cfg: ModelConfig, device):
    """(seg_params, seg_kstate): per segment a tuple over the pattern of
    layer param dicts and a {layer: mu} dict, leaves stacked (G, ...)."""
    seg_params, seg_kstate = [], []
    for pattern, G in build_segments(cfg):
        groups_p, groups_k = [], []
        for _ in range(G):
            groups_p.append(tuple(init_layer(gen, s, cfg, device)
                                  for s in pattern))
            kst = {}
            for i, s in enumerate(pattern):
                mu = layer_kstate(gen, s, cfg, device)
                if mu is not None:
                    kst[str(i)] = mu
            groups_k.append(kst)
        seg_params.append(tree_stack(groups_p))
        seg_kstate.append(tree_stack(groups_k))
    return seg_params, seg_kstate


def fold_seed(seed: int, *data: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``data`` (the port's
    counterpart of ``jax.random.fold_in``)."""
    h = hashlib.blake2b(repr((seed,) + data).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int],
             rows: Optional[Tuple[int, int]] = None):
    """Inverted dropout with a mask drawn from a generator seeded with
    ``seed``: the same seed gives the same mask, so a recomputed layer
    reproduces its forward. ``rows`` (offset, full length): x holds those
    rows of a longer sequence (a sequence-parallel rank's slice); the mask
    is drawn for the full length and sliced, so it is the unsharded
    stream's."""
    if seed is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    shape = list(x.shape)
    if rows is not None:
        shape[1] = rows[1]
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    if rows is not None:
        keep = keep.narrow(1, rows[0], x.shape[1])
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def apply_layer(spec: LayerSpec, p, kmu, x, cfg: ModelConfig, *,
                positions=None, pad_mask=None, update_state=True,
                impl=None, cache=None, drop_seed: Optional[int] = None,
                axis=None):
    """One ``attn`` layer, with dropout (rate ``cfg.dropout``) on the
    attention and FFN outputs when ``drop_seed`` is given.

    Returns (x, new_kmu, new_cache, stats). With ``cache`` (the layer's
    decode-cache leaves, prefill) the cache is filled from what the
    attention computed (roped keys, routing vectors, centroid scores),
    which needs ``positions``; else new_cache is None. ``stats`` is the
    obs.RoutingStats of a routing layer with ``RoutingConfig.stats`` on,
    else None. ``axis`` (a `ModelAxis`): ``p`` and ``kmu`` are this rank's
    shards, x its part of the residual stream.
    """
    seeds = ((None, None) if drop_seed is None
             else (fold_seed(drop_seed, 0), fold_seed(drop_seed, 1)))
    tp = axis is not None and axis.size > 1
    enter = axis.enter if tp else (lambda t: t)
    leave = axis.exit if tp else (lambda t: t)
    rows = axis.seq_rows(x.shape[1]) if tp and axis.seq_parallel else None
    a_spec = spec_for_layer(cfg, spec.attn)
    if tp:
        a_spec = attn_api.head_shard(a_spec, axis.size)
    h = enter(L.apply_norm(p["ln1"], x, cfg.norm))
    q, k, v = L.qkv_project(p["attn"], h, cfg)
    out = attn_api.attend(a_spec, q, k, v,
                          state=kmu, positions=positions, pad_mask=pad_mask,
                          update_state=update_state, impl=impl, fill=cache)
    x = x + _dropout(leave(L.out_project(p["attn"], out.out)), cfg.dropout,
                     seeds[0], rows)
    h2 = enter(L.apply_norm(p["ln2"], x, cfg.norm))
    x = x + _dropout(leave(L.apply_mlp(p["ffn"], h2, cfg.act)), cfg.dropout,
                     seeds[1], rows)
    return x, out.state, out.cache, out.stats


def _unstack(tree, G: int):
    """The G group slices of a (G, ...)-stacked tree, each leaf unbound
    once: indexing every leaf per group would make each slice's backward
    write a zero-filled (G, ...) gradient, G times the parameter bytes per
    step; the backward of `torch.unbind` stacks the slices' gradients
    once."""
    slices = [torch.unbind(leaf, 0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [s[g] for s in slices]) for g in range(G)]


def apply_stack(seg_params, seg_kstate, x, cfg: ModelConfig, *,
                positions=None, pad_mask=None, impl=None,
                remat: str = "none", drop_seed: Optional[int] = None,
                return_stats: bool = False, constrain_fn=None, axis=None):
    """The whole stack over x (B,N,d) -> (x, new_seg_kstate), with each
    routing layer's EMA centroid update. ``return_stats`` adds a third
    element: the routing-health stats, a list over segments of
    {layer: obs.RoutingStats} with leaves stacked over the segment's
    groups (G, ...), or None when no layer computes them
    (``RoutingConfig.stats`` off).

    ``remat="full"`` recomputes each group in the backward
    (`torch.utils.checkpoint`, non-reentrant), as the JAX package's
    ``jax.checkpoint`` per scan group: its forward kernels then run twice
    per step (their stats, no-grad outputs of the checkpointed group, are
    computed again there and dropped). ``drop_seed`` (with
    ``cfg.dropout > 0``) turns dropout on; layer ``n`` of the stack draws
    from ``fold_seed(drop_seed, n)``.

    ``axis`` (a `dist.tensor_parallel.ModelAxis`) runs the layers on this
    rank's shards (see the module's docstring); ``constrain_fn``
    (`dist.sharding.make_constrain_fn`) is applied to the residual stream
    at entry and after each group, as in the JAX package.
    """
    if remat == "save_dots":
        raise NotImplementedError(
            "remat='save_dots' is not ported yet; use 'full' or 'none'")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    dropout_on = drop_seed is not None and cfg.dropout > 0
    constrain = constrain_fn or (lambda t: t)
    x = constrain(x)
    new_seg_kstate, seg_stats = [], []
    layer = 0
    for si, (pattern, G) in enumerate(build_segments(cfg)):

        def group_fn(x, p_group, k_group, base, pattern=pattern):
            new_k, stats_g = {}, {}
            for i, spec in enumerate(pattern):
                seed = fold_seed(drop_seed, base + i) if dropout_on else None
                x, nk, _, st = apply_layer(
                    spec, p_group[i], k_group.get(str(i)), x, cfg,
                    positions=positions, pad_mask=pad_mask,
                    update_state=True, impl=impl, drop_seed=seed,
                    axis=axis)
                if str(i) in k_group:
                    new_k[str(i)] = nk
                if st is not None:
                    stats_g[str(i)] = st
            return constrain(x), new_k, stats_g

        groups, stats = [], []
        for p_group, k_group in zip(_unstack(seg_params[si], G),
                                    _unstack(seg_kstate[si], G)):
            if remat == "full":
                # the layer draws nothing from the default generators, so
                # their state need not be saved for the recompute
                x, new_k, stats_g = checkpoint(
                    group_fn, x, p_group, k_group, layer,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, new_k, stats_g = group_fn(x, p_group, k_group, layer)
            groups.append(new_k)
            stats.append(stats_g)
            layer += len(pattern)
        new_seg_kstate.append(tree_stack(groups))
        seg_stats.append(stack_stats(stats) if stats[0] else {})
    if not return_stats:
        return x, new_seg_kstate
    return x, new_seg_kstate, (seg_stats if any(seg_stats) else None)
