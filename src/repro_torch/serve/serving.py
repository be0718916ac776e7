"""Serving of the port: KV caches, prefill and single-token decode for the
dense, ssm and hybrid families (port of that path of the JAX package's
``serve/serving.py``): every model the port trains, the paper's, the
full-attention ones, mamba2-780m and recurrentgemma-9b.

Cache layout (per segment, leaves stacked over groups G), as declared by
the resolved decode backend of each attention layer's variant
(`attn.backends.APPEND_LAYOUT` for ``full`` layers, `RING_LAYOUT` for
``local`` layers, `PAGES_LAYOUT` for ``routing`` layers, `MIXED_LAYOUT` for
``local+routing`` layers: rt-cifar10 holds rings on layers 0-7 and rings +
pages on 8-11), or by the recurrent mixer of an ssd or rglru layer:
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
  ssd             the causal conv's last K-1 inputs (conv: (G,B,K-1,
                  d_inner + 2N), model dtype) and the SSD state (state:
                  (G,B,H,N,P) fp32)
  rglru           the causal conv's last 3 inputs (conv: (G,B,3,w)) and
                  the RG-LRU state (h: (G,B,w) fp32)
A prefill leaves each recurrent cache as the state after the prompt, and
a decode step advances it by one token (the mixers' step recurrence); as
every cache leaf, an inactive lane's comes back bit for bit.

On CUDA tensors prefill runs the local-window and the fused routing kernels
and decode runs the paged decode kernel; ``impl="torch"`` forces the plain
PyTorch path (the comparison `chip_smoke.py` makes on the card). A full
model (qwen2-0.5b: GQA 14:2, qkv bias, tied embeddings) is served by plain
PyTorch on the card too, by the reference's own design: its prefill passes
positions, which the flash kernel (row-index causal mask) does not take,
and the JAX package has no decode kernel for it (its ``full/xla``; the
port's ``full/torch``). A prefill fills each layer's cache from what that
layer's attention computed.

On a (data, model) mesh (``mesh=``, a `launch.mesh.Mesh` whose model axis
holds M ranks) every function runs this rank's part, as the JAX package's
functions run under its mesh: the params are this rank's shards
(`dist.sharding.shard_tree` by the rule table), the centroids the whole
model's (each layer reads its rank's routing heads' rows, `_rank_rows`:
the JAX engine keeps them replicated), a cache holds the rank's heads
only (`attn.head_shard`: ``Hl / M`` local and ``Hr / M`` routing heads)
and, where the slot count divides, its data coordinate's slots. Each
layer's attention is one single-device call on the rank's heads, so on
the card the local and fused forward kernels prefill and the decode
kernel decodes there; the projections are column- and row-parallel over
the model group (`dist.tensor_parallel.ModelAxis`) and the logits come
back whole on every rank (`models.model.vocab_logits`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch import attn as attn_api
from repro_torch import resolve_device
from repro_torch.attn.spec import head_shard, spec_for_layer
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import slot_block
from repro_torch.dist.tensor_parallel import ModelAxis, gather_head_stats
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.model import model_axis, vocab_logits
from repro_torch.models.transformer import (apply_layer, build_segments,
                                            where_active)
from repro_torch.obs.routing_stats import stack_stats
from repro_torch.tree import tree_index, tree_map, tree_stack


def _rank_spec(cfg: ModelConfig, variant: str, mesh=None):
    """The AttentionSpec of this rank's head shard of a layer."""
    spec = spec_for_layer(cfg, variant)
    return spec if mesh is None else head_shard(spec, mesh.size("model"))


def _rank_rows(kmu, axis: Optional[ModelAxis]):
    """This rank's routing heads' rows of a layer's whole centroids (Hr, k,
    dh): block ``axis.rank`` of M, the heads `head_shard` gives it."""
    if kmu is None or axis is None:
        return kmu
    n = kmu.shape[0] // axis.size
    return kmu.narrow(0, axis.rank * n, n)


def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda",
               mesh=None) -> List[Dict]:
    """Per segment {layer: {leaf: (G, B, ...)}} on ``device`` (default the
    card; raises without one unless ``device="cpu"``). On a ``mesh``, this
    rank's part (`dist.sharding.shard_cache` of the whole cache): its
    heads, and B / D slots where B divides over the D data ranks. An
    encoder has no decode (as the JAX package's dry run skips its decode
    cells), so its config raises `ValueError`."""
    if cfg.family == "encoder":
        raise ValueError(f"{cfg.name}: an encoder has no decode cache (it "
                         f"reads frame features and predicts codebook "
                         f"targets; nothing is decoded token by token)")
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    B, _ = slot_block(mesh, B)
    out = []
    for pattern, G in build_segments(cfg):
        slot = {str(i): _slot_cache(s, cfg, B, max_len, dt, dev, mesh)
                for i, s in enumerate(pattern)}
        out.append(tree_map(
            lambda x: x[None].expand((G,) + x.shape).clone(), slot))
    return out


def _slot_cache(spec, cfg: ModelConfig, B: int, max_len: int, dt, dev,
                mesh=None) -> Dict:
    """One layer's cache leaves for B slots: an ssd or rglru layer's
    recurrent state (zeros), else what the decode backend of its
    attention variant declares."""
    if spec.kind == "attn":
        return attn_api.init_decode_cache(_rank_spec(cfg, spec.attn, mesh),
                                          B, max_len, dt, dev)
    if mesh is not None and mesh.size("model") > 1:
        raise NotImplementedError(
            f"a model axis on {spec.kind} layers is ROADMAP item 12b's")
    f32 = dict(dtype=torch.float32, device=dev)
    if spec.kind == "ssd":
        s = ssm_mod.ssm_spec(cfg)
        return {"conv": torch.zeros((B, s.conv - 1, s.d_inner + 2 * s.nstate),
                                    dtype=dt, device=dev),
                "state": torch.zeros((B, s.nheads, s.nstate, s.headdim),
                                     **f32)}
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((B, 3, w), dtype=dt, device=dev),
            "h": torch.zeros((B, w), **f32)}


# ---------------------------------------------------------------------------
# serve_step: one token for the whole stack
# ---------------------------------------------------------------------------
def _decode_layer(spec, p, kmu, cache, x, cfg, pos, impl,
                  axis: Optional[ModelAxis] = None):
    """One layer of a decode step; with ``axis`` on this rank's shards
    (the row-parallel products' partial sums added over the model
    group)."""
    if spec.kind != "attn":
        if axis is not None:
            raise NotImplementedError(
                f"a model axis on {spec.kind} layers is ROADMAP item 12b's")
        return _decode_mixer(spec, p, cache, x, cfg)
    leave = (lambda t: t) if axis is None else axis.exit
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    q, k, v = L.qkv_project(p["attn"], h, cfg)
    out = attn_api.attend(_rank_spec(cfg, spec.attn,
                                     None if axis is None else axis.mesh),
                          q, k, v, state=_rank_rows(kmu, axis),
                          cache=cache, pos=pos, impl=impl)
    x = x + leave(L.out_project(p["attn"], out.out))
    h2 = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + leave(L.apply_mlp(p["ffn"], h2, cfg.act)), out.cache


def _decode_mixer(spec, p, cache, x, cfg):
    """One decode step of an ssd or rglru layer from its cached states."""
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    if spec.kind == "ssd":
        y, (conv, state) = ssm_mod.apply_ssd(
            p["mixer"], h, cfg, conv_state=cache["conv"],
            ssm_state=cache["state"], decode=True)
        return x + y, {"conv": conv, "state": state}
    y, (conv, state) = rglru_mod.apply_rglru(
        p["mixer"], h, cfg, conv_state=cache["conv"], h_state=cache["h"],
        decode=True)
    x = x + y
    h2 = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["ffn"], h2, cfg.act), {"conv": conv, "h": state}


def make_serve_step(cfg: ModelConfig, impl: Optional[str] = None,
                    mesh=None):
    segments = build_segments(cfg)
    axis = model_axis(mesh)

    @torch.no_grad()
    def serve_step(params, kstate, cache, tokens, pos, active=None):
        """tokens: (B,) int; pos: (B,) int -> (logits (B,V), new_cache).

        ``active`` (B,) bool, optional: rows where it is False come back
        with their cache lanes unchanged (their logits are garbage). On a
        mesh the logits are the whole vocabulary's, fp32, on every model
        rank."""
        x = L.embed(params["embed"], tokens[:, None], axis)
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
                        c_group[str(i)], x, cfg, pos, impl, axis)
                groups.append(new_c)
            new_cache.append(tree_stack(groups))
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        logits = L.logits_out(params["embed"], x, cfg.tie_embeddings,
                              cfg.logit_softcap)
        if active is not None:
            new_cache = where_active(active, new_cache, cache, batch_axis=1)
        return vocab_logits(logits, cfg, axis)[:, 0], new_cache

    return serve_step


def decode_backends(cfg: ModelConfig, impl: Optional[str] = None,
                    platform: Optional[str] = None,
                    mesh=None) -> Dict[str, str]:
    """variant -> "variant/impl(cache_layout)" for every attention variant
    of the stack, as decode resolves it on ``platform`` (the engine records
    it; `attn.decode_backend` picks the platform when None), on a
    ``mesh`` for a rank's head shard (`ValueError` where the model axis
    does not divide a head count)."""
    out: Dict[str, str] = {}
    for pattern, _ in build_segments(cfg):
        for s in pattern:
            if s.kind != "attn":
                continue
            b = attn_api.decode_backend(spec_for_layer(cfg, s.attn),
                                        impl=impl, platform=platform,
                                        mesh=mesh)
            out[s.attn] = f"{b.name}({b.layout.name})"
    return out


def decode_cache_layouts(cfg: ModelConfig, impl: Optional[str] = None,
                         platform: Optional[str] = None,
                         mesh=None) -> set:
    """The cache-layout names the decode stack uses (e.g. {"append"},
    {"ring+pages"}). Teacher-forcing a prompt tail over a cached prefix
    writes what a prefill writes only for {"append", "ring"}: cluster
    pages route a prefill by balanced top-k and a decode by argmax. The
    recurrent layers' states (ssd, rglru) are no attention layout and are
    not listed."""
    return {attn_api.decode_backend(spec_for_layer(cfg, s.attn), impl=impl,
                                    platform=platform, mesh=mesh).layout.name
            for pattern, _ in build_segments(cfg) for s in pattern
            if s.kind == "attn"}


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
    positions, batch)`` returns (x, new_cache_chunk, stats), the chunk
    being the segment's cache leaves sliced to rows g0:g1 of the group
    axis and ``stats`` the stage's {layer: obs.RoutingStats} (leaves
    stacked over its groups; empty unless ``RoutingConfig.stats``)."""
    si: int
    g0: int
    g1: int
    fn: Callable


def make_prefill_stages(cfg: ModelConfig, impl: Optional[str] = None,
                        groups_per_stage: Optional[int] = None, mesh=None):
    """``(embed_stage, stages, head_stage)``. ``groups_per_stage=None``
    gives one whole-segment stage per segment (what `prefill` composes);
    ``groups_per_stage=k`` slices each segment's groups into ceil(G / k)
    stages (the engine's chunked prefill takes k = 1). On a ``mesh`` the
    stages run this rank's part (the module's docstring): a stage's
    stats are its routing heads', the head stage's logits the whole
    vocabulary's."""
    segments = build_segments(cfg)
    axis = model_axis(mesh)

    def embed_stage(params, batch):
        tokens = batch["tokens"]
        B, N = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(N, device=tokens.device).expand(B, N)
        return L.embed(params["embed"], tokens, axis), positions

    def make_stage(si, pattern, g0, g1):
        @torch.no_grad()
        def stage(params, kstate, cache_chunk, x, positions, batch):
            groups, stats = [], []
            for g in range(g0, g1):
                p_group = tree_index(params["stack"][si], g)
                k_group = tree_index(kstate[si], g)
                c_group = tree_index(cache_chunk, g - g0)
                new_c, stats_g = {}, {}
                for i, spec in enumerate(pattern):
                    x, _, new_c[str(i)], st = apply_layer(
                        spec, p_group[i], _rank_rows(k_group.get(str(i)),
                                                     axis), x, cfg,
                        positions=positions, pad_mask=batch.get("pad_mask"),
                        update_state=False, impl=impl,
                        cache=c_group[str(i)], axis=axis)
                    if st is not None:
                        stats_g[str(i)] = st
                groups.append(new_c)
                stats.append(stats_g)
            return (x, tree_stack(groups),
                    stack_stats(stats) if stats[0] else {})

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
        return vocab_logits(logits, cfg, axis)

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
            impl: Optional[str] = None, return_stats: bool = False,
            mesh=None):
    """Forward over the prompt ``batch["tokens"]`` (B,N), returning
    (logits (B,N,V), filled cache). ``return_stats`` adds a third element:
    the routing-health stats of the prompt's forward (with
    ``RoutingConfig.stats`` on), a list over segments of {layer:
    obs.RoutingStats} with leaves stacked over groups, the structure the
    train stack returns. On a ``mesh`` the cache is this rank's part and
    the stats the whole model's (the ranks' heads gathered)."""
    embed_stage, stages, head_stage = make_prefill_stages(cfg, impl=impl,
                                                          mesh=mesh)
    with torch.no_grad():
        x, positions = embed_stage(params, batch)
    new_cache, seg_stats = [], []
    for st in stages:                   # one whole-segment stage each
        x, nc, st_g = st.fn(params, kstate, cache[st.si], x, positions,
                            batch)
        new_cache.append(nc)
        seg_stats.append(st_g)
    logits = head_stage(params, x)
    if return_stats:
        return logits, new_cache, gather_head_stats(seg_stats, mesh)
    return logits, new_cache
