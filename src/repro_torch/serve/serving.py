"""Serving of the port: KV caches, prefill and single-token decode for the
dense family (port of that path of the JAX package's ``serve/serving.py``).

Cache layout (per segment, leaves stacked over groups G), as declared by
the resolved decode backend of each layer's variant
(`attn.backends.RING_LAYOUT` for ``local`` layers, `PAGES_LAYOUT` for
``routing`` layers, `MIXED_LAYOUT` for ``local+routing`` layers: rt-cifar10
holds rings on layers 0-7 and rings + pages on 8-11):
  local heads     ring of 2W slots + stored absolute positions (lk, lv,
                  lpos): decode reproduces the blocked prefill semantics
  routing heads   cluster pages (rk, rv: (G,B,Hr,kc,cap,dh), rlen): a
                  decoded token routes to its argmax centroid and attends
                  only that page, O(cap * dh) per step

On CUDA tensors prefill runs the local-window and the fused routing kernels
and decode runs the paged decode kernel; ``impl="torch"`` forces the plain
PyTorch path (the comparison `chip_smoke.py` makes on the card). A prefill
fills each layer's cache from what that layer's attention computed.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch import attn as attn_api
from repro_torch import resolve_device
from repro_torch.attn.spec import spec_for_layer
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import mask_vocab_pad
from repro_torch.models.transformer import (apply_layer, build_segments,
                                            where_active)
from repro_torch.tree import tree_index, tree_map, tree_stack


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device="cuda") -> List[Dict]:
    """Per segment {layer: {leaf: (G, B, ...)}} on ``device`` (default the
    card; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    out = []
    for pattern, G in build_segments(cfg):
        slot = {str(i): attn_api.init_decode_cache(
            spec_for_layer(cfg, s.attn), B, max_len, dt, dev)
            for i, s in enumerate(pattern)}
        out.append(tree_map(
            lambda x: x[None].expand((G,) + x.shape).clone(), slot))
    return out


# ---------------------------------------------------------------------------
# serve_step: one token for the whole stack
# ---------------------------------------------------------------------------
def _decode_layer(spec, p, kmu, cache, x, cfg, pos, impl):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    q, k, v = L.qkv_project(p["attn"], h, cfg)
    out = attn_api.attend(spec_for_layer(cfg, spec.attn), q, k, v, state=kmu,
                          cache=cache, pos=pos, impl=impl)
    x = x + L.out_project(p["attn"], out.out)
    h2 = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["ffn"], h2, cfg.act), out.cache


def make_serve_step(cfg: ModelConfig, impl: Optional[str] = None):
    segments = build_segments(cfg)

    @torch.no_grad()
    def serve_step(params, kstate, cache, tokens, pos, active=None):
        """tokens: (B,) int; pos: (B,) int -> (logits (B,V), new_cache).

        ``active`` (B,) bool, optional: rows where it is False come back
        with their cache lanes unchanged (their logits are garbage)."""
        x = L.embed(params["embed"], tokens[:, None])
        new_cache = []
        for si, (pattern, G) in enumerate(segments):
            groups = []
            for g in range(G):
                p_group = tree_index(params["stack"][si], g)
                k_group = tree_index(kstate[si], g)
                c_group = tree_index(cache[si], g)
                new_c = {}
                for i, spec in enumerate(pattern):
                    x, new_c[str(i)] = _decode_layer(
                        spec, p_group[i], k_group.get(str(i)),
                        c_group[str(i)], x, cfg, pos, impl)
                groups.append(new_c)
            new_cache.append(tree_stack(groups))
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        logits = L.logits_out(params["embed"], x, cfg.tie_embeddings,
                              cfg.logit_softcap)
        if active is not None:
            new_cache = where_active(active, new_cache, cache, batch_axis=1)
        return mask_vocab_pad(logits, cfg)[:, 0], new_cache

    return serve_step


# ---------------------------------------------------------------------------
# Prefill, built from depth stages: embed -> one stage per segment -> head.
# (The JAX package also slices a segment's groups into several stages for
# its engine's chunked prefill; the port has no engine yet.)
# ---------------------------------------------------------------------------
class PrefillStage(NamedTuple):
    """All groups of segment si. ``fn(params, kstate, seg_cache, x,
    positions, batch)`` returns (x, new_seg_cache)."""
    si: int
    fn: Callable


def make_prefill_stages(cfg: ModelConfig, impl: Optional[str] = None):
    """``(embed_stage, stages, head_stage)``: one whole-segment stage per
    segment (the JAX package's ``groups_per_stage=None``)."""
    segments = build_segments(cfg)

    def embed_stage(params, batch):
        tokens = batch["tokens"]
        B, N = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(N, device=tokens.device).expand(B, N)
        return L.embed(params["embed"], tokens), positions

    def make_stage(si, pattern, G):
        @torch.no_grad()
        def stage(params, kstate, seg_cache, x, positions, batch):
            groups = []
            for g in range(G):
                p_group = tree_index(params["stack"][si], g)
                k_group = tree_index(kstate[si], g)
                c_group = tree_index(seg_cache, g)
                new_c = {}
                for i, spec in enumerate(pattern):
                    x, _, new_c[str(i)] = apply_layer(
                        spec, p_group[i], k_group.get(str(i)), x, cfg,
                        positions=positions, pad_mask=batch.get("pad_mask"),
                        update_state=False, impl=impl,
                        cache=c_group[str(i)])
                groups.append(new_c)
            return x, tree_stack(groups)

        return PrefillStage(si, stage)

    stages = [make_stage(si, pattern, G)
              for si, (pattern, G) in enumerate(segments)]

    @torch.no_grad()
    def head_stage(params, x):
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        logits = L.logits_out(params["embed"], x, cfg.tie_embeddings,
                              cfg.logit_softcap)
        return mask_vocab_pad(logits, cfg)

    return embed_stage, stages, head_stage


def prefill(params, kstate, cache, batch, cfg: ModelConfig,
            impl: Optional[str] = None):
    """Forward over the prompt ``batch["tokens"]`` (B,N), returning
    (logits (B,N,V), filled cache)."""
    embed_stage, stages, head_stage = make_prefill_stages(cfg, impl=impl)
    with torch.no_grad():
        x, positions = embed_stage(params, batch)
    new_cache = []
    for st in stages:
        x, nc = st.fn(params, kstate, cache[st.si], x, positions, batch)
        new_cache.append(nc)
    return head_stage(params, x), new_cache
