"""Serving of the port: KV caches, prefill and single-token decode for the
dense family (port of that path of the JAX package's ``serve/serving.py``):
every model the port trains, the paper's and the full-attention ones.

Cache layout (per segment, leaves stacked over groups G), as declared by
the resolved decode backend of each layer's variant
(`attn.backends.APPEND_LAYOUT` for ``full`` layers, `RING_LAYOUT` for
``local`` layers, `PAGES_LAYOUT` for ``routing`` layers, `MIXED_LAYOUT` for
``local+routing`` layers: rt-cifar10 holds rings on layers 0-7 and rings +
pages on 8-11):
  full heads      keys and values at their positions (k, v:
                  (G,B,Hkv,max_len,dh), GQA kv heads): decode writes the
                  token at ``pos`` and attends the cache causally
  local heads     ring of 2W slots + stored absolute positions (lk, lv,
                  lpos): decode reproduces the blocked prefill semantics
  routing heads   cluster pages (rk, rv: (G,B,Hr,kc,cap,width), rlen): a
                  decoded token routes to its argmax centroid and attends
                  only that page, O(cap * dh) per step; rows stored at the
                  decode kernel's width (rt-pg19's dh 129 at 192, the pad
                  columns zero)

On CUDA tensors prefill runs the local-window and the fused routing kernels
and decode runs the paged decode kernel; ``impl="torch"`` forces the plain
PyTorch path (the comparison `chip_smoke.py` makes on the card). A full
model (qwen2-0.5b: GQA 14:2, qkv bias, tied embeddings) is served by plain
PyTorch on the card too, by the reference's own design: its prefill passes
positions, which the flash kernel (row-index causal mask) does not take,
and the JAX package has no decode kernel for it (its ``full/xla``; the
port's ``full/torch``). A prefill fills each layer's cache from what that
layer's attention computed.
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


def decode_backends(cfg: ModelConfig, impl: Optional[str] = None,
                    platform: Optional[str] = None) -> Dict[str, str]:
    """variant -> "variant/impl(cache_layout)" for every attention variant
    of the stack, as decode resolves it on ``platform`` (the engine records
    it; `attn.decode_backend` picks the platform when None)."""
    out: Dict[str, str] = {}
    for pattern, _ in build_segments(cfg):
        for s in pattern:
            b = attn_api.decode_backend(spec_for_layer(cfg, s.attn),
                                        impl=impl, platform=platform)
            out[s.attn] = f"{b.name}({b.layout.name})"
    return out


def decode_cache_layouts(cfg: ModelConfig, impl: Optional[str] = None,
                         platform: Optional[str] = None) -> set:
    """The cache-layout names the decode stack uses (e.g. {"append"},
    {"ring+pages"}). Teacher-forcing a prompt tail over a cached prefix
    writes what a prefill writes only for {"append", "ring"}: cluster
    pages route a prefill by balanced top-k and a decode by argmax."""
    return {attn_api.decode_backend(spec_for_layer(cfg, s.attn), impl=impl,
                                    platform=platform).layout.name
            for pattern, _ in build_segments(cfg) for s in pattern}


# ---------------------------------------------------------------------------
# Prefill, built from resumable depth stages: embed -> one stage per slice
# of each segment's groups -> head. Composing every stage in order is the
# forward (`prefill` does so with whole-segment stages); the engine's
# chunked prefill runs one group per stage and advances a few stages per
# step, so a long prompt's prefill interleaves with the decode steps.
# Chunking over depth, not over the sequence, keeps every stage's result
# that of the uninterrupted forward: routing membership is balanced top-k
# over the whole prompt.
# ---------------------------------------------------------------------------
class PrefillStage(NamedTuple):
    """Groups [g0, g1) of segment si. ``fn(params, kstate, cache_chunk, x,
    positions, batch)`` returns (x, new_cache_chunk), the chunk being the
    segment's cache leaves sliced to rows g0:g1 of the group axis."""
    si: int
    g0: int
    g1: int
    fn: Callable


def make_prefill_stages(cfg: ModelConfig, impl: Optional[str] = None,
                        groups_per_stage: Optional[int] = None):
    """``(embed_stage, stages, head_stage)``. ``groups_per_stage=None``
    gives one whole-segment stage per segment (what `prefill` composes);
    ``groups_per_stage=k`` slices each segment's groups into ceil(G / k)
    stages (the engine's chunked prefill takes k = 1)."""
    segments = build_segments(cfg)

    def embed_stage(params, batch):
        tokens = batch["tokens"]
        B, N = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(N, device=tokens.device).expand(B, N)
        return L.embed(params["embed"], tokens), positions

    def make_stage(si, pattern, g0, g1):
        @torch.no_grad()
        def stage(params, kstate, cache_chunk, x, positions, batch):
            groups = []
            for g in range(g0, g1):
                p_group = tree_index(params["stack"][si], g)
                k_group = tree_index(kstate[si], g)
                c_group = tree_index(cache_chunk, g - g0)
                new_c = {}
                for i, spec in enumerate(pattern):
                    x, _, new_c[str(i)] = apply_layer(
                        spec, p_group[i], k_group.get(str(i)), x, cfg,
                        positions=positions, pad_mask=batch.get("pad_mask"),
                        update_state=False, impl=impl,
                        cache=c_group[str(i)])
                groups.append(new_c)
            return x, tree_stack(groups)

        return PrefillStage(si, g0, g1, stage)

    stages = []
    for si, (pattern, G) in enumerate(segments):
        gps = G if groups_per_stage is None else max(1, groups_per_stage)
        for g0 in range(0, G, gps):
            stages.append(make_stage(si, pattern, g0, min(g0 + gps, G)))

    @torch.no_grad()
    def head_stage(params, x):
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        logits = L.logits_out(params["embed"], x, cfg.tie_embeddings,
                              cfg.logit_softcap)
        return mask_vocab_pad(logits, cfg)

    return embed_stage, stages, head_stage


def slice_cache_groups(seg_cache, g0: int, g1: int):
    """Rows [g0, g1) of a segment cache's group axis (a stage's input)."""
    return tree_map(lambda a: a[g0:g1], seg_cache)


def assemble_prefill_cache(stages, chunks) -> List[Dict]:
    """Stitch per-stage cache chunks (aligned with ``stages``) back into
    the per-segment cache list: the inverse of `slice_cache_groups`."""
    by_seg: Dict[int, list] = {}
    for st, nc in zip(stages, chunks):
        by_seg.setdefault(st.si, []).append(nc)
    return [cs[0] if len(cs) == 1
            else tree_map(lambda *xs: torch.cat(xs, 0), *cs)
            for _, cs in sorted(by_seg.items())]


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
