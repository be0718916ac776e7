"""Transformer stack of the port, dense family (port of the ``attn``-layer
part of the JAX package's ``models/transformer.py``).

The stack is a list of *segments*; each is a repeating pattern of layer
specs run ``n_groups`` times. Parameters, centroids and caches keep the JAX
layout: every leaf of a segment is stacked over its groups on a leading
(G, ...) axis, and the JAX ``lax.scan`` over groups is a Python loop here.
A layer is norm -> self-attention -> residual -> norm -> FFN -> residual.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch import attn as attn_api
from repro_torch.attn.spec import head_split, spec_for_layer, variant_for_layer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kmeans import init_kmeans
from repro_torch.models import layers as L
from repro_torch.tree import tree_map, tree_stack


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


def apply_layer(spec: LayerSpec, p, kmu, x, cfg: ModelConfig, *,
                positions=None, pad_mask=None, update_state=True,
                impl=None, cache=None):
    """One ``attn`` layer (no dropout: the port runs inference only).

    Returns (x, new_kmu, new_cache). With ``cache`` (the layer's
    decode-cache leaves, prefill) the cache is filled from the same q/k/v
    the attention runs on, which needs ``positions``; else new_cache is
    None.
    """
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    q, k, v = L.qkv_project(p["attn"], h, cfg)
    aspec = spec_for_layer(cfg, spec.attn)
    new_cache = None if cache is None else attn_api.prefill_cache(
        aspec, cache, q, k, v, positions=positions, state=kmu)
    out = attn_api.attend(aspec, q, k, v, state=kmu, positions=positions,
                          pad_mask=pad_mask, update_state=update_state,
                          impl=impl)
    x = x + L.out_project(p["attn"], out.out)
    h2 = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["ffn"], h2, cfg.act), out.state, new_cache
