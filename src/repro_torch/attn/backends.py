"""The port's attention backends (port of the JAX package's
``attn/backends.py`` for the variants the port serves and trains: the
paper's ``local``, ``routing`` and ``local+routing`` attention and dense
``full`` attention).

Registered pairs (variant, impl):

  full/torch            plain PyTorch: one-shot or KV-chunked online
                        softmax (`core.attention.full_attention`), causal on
                        the given positions, pad mask; append-cache decode
                        (the JAX package's full/xla: it has no decode
                        kernel, and its flash kernel takes no positions, so
                        a serving prefill and every decode step of a full
                        model run here on the card too)
  full/cuda             the hand-written CUDA flash kernels, forward and
                        backward (`kernels.flash_attention.FlashAttention`;
                        priority 10, needs_cuda; the counterpart of the JAX
                        package's full/pallas, with its capabilities: the
                        causal mask is on row indices, so no positions, no
                        pad mask, no decode)
  local/torch           blocked-window reference; ring decode
  local/cuda            the local-window kernels forward and backward
                        (`kernels.local_attention.LocalAttention`; priority
                        10); ring decode (plain ops in both packages: there
                        is no local decode kernel)
  routing/torch         gathered-block routing reference; page-gather decode
  routing/cuda          the fused gather-free routing kernels forward and
                        backward (`kernels.routing_attention`), the paged
                        decode kernel (priority 20; the JAX package's
                        routing/pallas_paged)
  local+routing/torch   both references on the two head groups
  local+routing/cuda    the local-window and the fused routing kernels, the
                        paged decode kernel (priority 20; the JAX
                        package's local+routing/pallas_paged)
  {local, routing, local+routing}/cuda_gathered
                        the gathered routing kernels
                        (`kernels.routing_gathered`) on the routing heads,
                        the local-window kernels on the local heads: the JAX
                        package's local/pallas, routing/pallas and
                        local+routing/pallas, which only a forced
                        ``impl="pallas"`` reaches. Priority 0 and no
                        decode: auto-selection never takes them.

Every kernel backend has ``needs_cuda``. All apply paths are
differentiable: the plain ones through autograd of their PyTorch ops, the
kernel ones through the Functions' backward kernels. The centroids they
return carry no gradient (the EMA update is detached).

Cache layouts: keys and values at their positions for full attention
(`APPEND_LAYOUT`), a 2W ring for local heads (`RING_LAYOUT`), cluster pages
for routing heads (`PAGES_LAYOUT`, stored at the paged decode kernel's
width, `routing_decode.page_width`: rt-pg19's head dim 129 at 192, the pad
columns zero), both for the head split (`MIXED_LAYOUT`); the plain and the
kernel backend of a variant share its layout, its decode glue (ring-local
decode, token routing, page-slot write) and its fill, so the two paths
walk the same cache trajectory. Every apply returns, beside its output and
centroids, the `Prefix` its attention computed (the full heads' and the
local heads' roped keys, the routing heads' routing vectors and centroid
scores): a prefill fills the cache from it instead of computing it
again.
Rope is applied here to local heads only; routing heads are content.
Decode updates return new cache leaves (clone, then write) rather than
writing in place, as the JAX functions do: the serve step's ``active`` mask
then selects between old and new leaves.
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.attn import registry
from repro_torch.attn.registry import Backend, CacheLayout, Capabilities
from repro_torch.attn.spec import AttentionSpec, head_split, resolve_chunk
from repro_torch.core.attention import full_attention
from repro_torch.core.kmeans import KMeansState, normalize_routing
from repro_torch.core.local import local_attention
from repro_torch.core.routing import routed_attention
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import local_attention as local_kernel
from repro_torch.kernels import routing_decode as decode_kernel
from repro_torch.models import layers as L


class Prefix(NamedTuple):
    """What a prefill's attention computed that the cache fill reuses:
    ``append`` full attention's (roped keys, values) (B,Hkv,N,dh); ``ring``
    the local heads' (roped keys, values) (B,Hkv,N,dh); ``pages`` the
    routing heads' (routing vectors (B,Hr,N,dh), centroid scores (B,Hr,N,k)
    fp32, values expanded to Hr heads)."""
    ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    pages: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    append: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


# ---------------------------------------------------------------------------
# Shared glue
# ---------------------------------------------------------------------------
def _rope_qk(spec: AttentionSpec, q, k, positions):
    if spec.rope_theta is None:
        return q, k
    B, _, N, _ = q.shape
    if positions is None:
        positions = torch.arange(N, device=q.device).expand(B, N)
    q = L.apply_rope(q, positions, spec.rope_theta)
    if k is not None:
        k = L.apply_rope(k, positions, spec.rope_theta)
    return q, k


def _expand_kv(x: torch.Tensor, reps: int) -> torch.Tensor:
    return x.repeat_interleave(reps, dim=1) if reps > 1 else x


def _split_heads(spec: AttentionSpec, q, k, v):
    """(local, routing) halves of q/k/v, local heads first."""
    Hl, Hr, kvl, kvr = head_split(spec)
    if spec.num_kv_heads == 1:
        kl = kr = k
        vl = vr = v
    else:
        kl, kr = (None, None) if k is None else (k[:, :kvl], k[:, kvl:])
        vl, vr = v[:, :kvl], v[:, kvl:]
    return (q[:, :Hl], kl, vl), (q[:, Hl:], kr, vr)


def _local_subspec(spec: AttentionSpec) -> AttentionSpec:
    Hl, _, kvl, _ = head_split(spec)
    return replace(spec, variant="local", num_heads=Hl, num_kv_heads=kvl,
                   routing=None, routing_heads=0)


def _routing_subspec(spec: AttentionSpec) -> AttentionSpec:
    _, Hr, _, kvr = head_split(spec)
    return replace(spec, variant="routing", num_heads=Hr, num_kv_heads=kvr,
                   window=0, routing_heads=0)


# ---------------------------------------------------------------------------
# Apply (train / prefill) paths: (out, new_state, Prefix)
# ---------------------------------------------------------------------------
def _full_torch_apply(spec, q, k, v, *, state=None, positions=None,
                      pad_mask=None, update_state=True):
    qr, kr = _rope_qk(spec, q, k, positions)
    out = full_attention(qr, kr, v, spec.causal, pad_mask, positions,
                         chunk=resolve_chunk(spec, q.shape[2]))
    return out, state, Prefix(append=(kr, v))


def _full_cuda_apply(spec, q, k, v, *, state=None, positions=None,
                     pad_mask=None, update_state=True):
    qr, kr = _rope_qk(spec, q, k, positions)
    out = flash_kernel.FlashAttention.apply(qr.contiguous(), kr.contiguous(),
                                            v.contiguous(), spec.causal)
    return out, state, Prefix(append=(kr, v))


def _make_local_apply(kernel: bool):
    """Local-window attention: the plain reference, or (``kernel``) the
    kernels forward and backward (`local_kernel.LocalAttention`, any N,
    any pad mask)."""
    def apply(spec, q, k, v, *, state=None, positions=None, pad_mask=None,
              update_state=True):
        qr, kr = _rope_qk(spec, q, k, positions)
        if kernel:
            out, _ = local_kernel.LocalAttention.apply(
                qr.contiguous(), kr.contiguous(), v.contiguous(),
                spec.window, spec.causal, pad_mask)
        else:
            out = local_attention(qr, kr, v, spec.window, spec.causal,
                                  pad_mask)
        return out, state, Prefix(ring=(kr, v))
    return apply


def _make_routing_apply(routing_impl: str):
    """Routed attention on every head of ``spec`` through
    `core.routing.routed_attention` with ``impl=routing_impl``."""
    def apply(spec, q, k, v, *, state=None, positions=None, pad_mask=None,
              update_state=True):
        rc = spec.routing
        g = spec.q_per_kv
        v_e = _expand_kv(v, g).contiguous()
        k_in = (None if (rc.share_qk and spec.causal) or k is None
                else _expand_kv(k, g).contiguous())
        ro = routed_attention(q.contiguous(), k_in, v_e,
                              KMeansState(mu=state), rc, positions, pad_mask,
                              update_state, impl=routing_impl)
        prefix = Prefix(pages=(ro.r_q, ro.scores, v_e))
        if ro.stats is None:
            return ro.out, ro.state.mu, prefix
        # the routing-health stats (RoutingConfig.stats): attend() takes
        # a 3- or a 4-tuple
        return ro.out, ro.state.mu, prefix, ro.stats
    return apply


def _make_mixed_apply(local_apply, routing_apply):
    """local+routing: ``local_apply`` on the local heads, ``routing_apply``
    on the routing heads, outputs concatenated local first."""
    def apply(spec, q, k, v, *, state=None, positions=None, pad_mask=None,
              update_state=True):
        (ql, kl, vl), (qr, kr, vr) = _split_heads(spec, q, k, v)
        o_l, _, pl = local_apply(_local_subspec(spec), ql, kl, vl,
                                 positions=positions, pad_mask=pad_mask)
        o_r, mu, pr, *stats = routing_apply(
            _routing_subspec(spec), qr, kr, vr, state=state,
            positions=positions, pad_mask=pad_mask,
            update_state=update_state)
        return (torch.cat([o_l, o_r], dim=1), mu,
                Prefix(ring=pl.ring, pages=pr.pages), *stats)
    return apply


# ---------------------------------------------------------------------------
# Decode paths + cache layouts
# ---------------------------------------------------------------------------
def _page_dims(spec, max_len):
    kc = spec.routing.num_clusters
    return kc, spec.routing.window or max(1, max_len // kc)


def _append_cache(spec, B, max_len, dtype, device):
    """Keys and values of a full (sub)spec's kv heads at their positions."""
    dh, kv = spec.head_dim, spec.num_kv_heads
    z = dict(dtype=dtype, device=device)
    return {"k": torch.zeros((B, kv, max_len, dh), **z),
            "v": torch.zeros((B, kv, max_len, dh), **z)}


def _ring_cache(spec, B, max_len, dtype, device):
    """2W ring of a local (sub)spec's kv heads."""
    dh, W, kv = spec.head_dim, spec.window, spec.num_kv_heads
    z = dict(dtype=dtype, device=device)
    return {"lk": torch.zeros((B, kv, 2 * W, dh), **z),
            "lv": torch.zeros((B, kv, 2 * W, dh), **z),
            "lpos": torch.full((B, 2 * W), -1, dtype=torch.int32,
                               device=device)}


def _pages_cache(spec, B, max_len, dtype, device):
    """Cluster pages of a routing (sub)spec's heads, each row stored at the
    decode kernel's width (`decode_kernel.page_width`; the pad columns stay
    zero: the fill and the slot write write the first dh)."""
    width, Hr = decode_kernel.page_width(spec.head_dim), spec.num_heads
    kc, cap = _page_dims(spec, max_len)
    z = dict(dtype=dtype, device=device)
    return {"rk": torch.zeros((B, Hr, kc, cap, width), **z),
            "rv": torch.zeros((B, Hr, kc, cap, width), **z),
            "rlen": torch.zeros((B, Hr, kc), dtype=torch.int32,
                                device=device)}


def _mixed_cache(spec, B, max_len, dtype, device):
    return {**_ring_cache(_local_subspec(spec), B, max_len, dtype, device),
            **_pages_cache(_routing_subspec(spec), B, max_len, dtype,
                           device)}


def _full_decode(spec, q, k, v, *, cache, pos, state=None):
    """Append k/v at ``pos`` and attend the whole cache, causal on the
    query's position (keys past it, unwritten, are masked)."""
    qr, kr = _rope_qk(spec, q, k, pos[:, None])
    bi = torch.arange(kr.shape[0], device=q.device)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[bi, :, pos] = kr[:, :, 0].to(ck.dtype)
    cv[bi, :, pos] = v[:, :, 0].to(cv.dtype)
    o = full_attention(qr, ck, cv, causal=True, positions=pos[:, None])
    return o, {"k": ck, "v": cv}


def _local_decode(spec, q, k, v, *, cache, pos, state=None):
    """Blocked-local decode over the 2W ring: attend keys whose stored
    absolute position lies in blocks b-1, b of the query position."""
    qr, kr = _rope_qk(spec, q, k, pos[:, None])
    window = spec.window
    B = kr.shape[0]
    S2 = cache["lk"].shape[2]
    slot = pos % S2
    bi = torch.arange(B, device=q.device)
    ck, cv, cp = cache["lk"].clone(), cache["lv"].clone(), cache["lpos"].clone()
    ck[bi, :, slot] = kr[:, :, 0].to(ck.dtype)
    cv[bi, :, slot] = v[:, :, 0].to(cv.dtype)
    cp[bi, slot] = pos.to(cp.dtype)
    lo = (pos // window - 1) * window      # start of block b-1
    valid = ((cp >= lo.clamp_min(0)[:, None]) & (cp >= 0)
             & (cp <= pos[:, None]))
    o = full_attention(qr, ck, cv, causal=False, pad_mask=valid)
    return o, {"lk": ck, "lv": cv, "lpos": cp}


def _route_token(q, mu, cache):
    """Stage 1 of cluster-paged decode, shared by both paths: normalize
    the token's routing vector, argmax it against the centroids, read the
    selected page's write counter."""
    r = normalize_routing(q)[:, :, 0]                     # (B,Hr,dh)
    scores = torch.einsum("bhd,hkd->bhk", r.float(), mu.float())
    c = scores.argmax(-1)                                 # (B,Hr)
    plen = torch.gather(cache["rlen"], 2, c[:, :, None])[..., 0]
    return r, c, plen


def _write_page_slot(cache, r, v0, c, plen):
    """Ring-overwrite the new token into slot plen % cap of page c (its
    first dh columns)."""
    B, Hr = c.shape
    cap, dh = cache["rk"].shape[3], r.shape[-1]
    wslot = (plen % cap).long()
    bi = torch.arange(B, device=c.device)[:, None]
    hi = torch.arange(Hr, device=c.device)[None, :]
    ck, cv, cl = cache["rk"].clone(), cache["rv"].clone(), cache["rlen"].clone()
    ck[bi, hi, c, wslot, :dh] = r.to(ck.dtype)
    cv[bi, hi, c, wslot, :dh] = v0.to(cv.dtype)
    cl[bi, hi, c] = (plen + 1).to(cl.dtype)
    return {"rk": ck, "rv": cv, "rlen": cl}


def _make_routing_decode(page_attention):
    """Cluster-paged routing decode: the token routes to its argmax
    centroid and attends only that page (+ itself) through
    ``page_attention`` (plain or kernel)."""
    def decode(spec, q, k, v, *, cache, pos, state=None):
        v0 = _expand_kv(v, spec.q_per_kv)[:, :, 0].contiguous()
        r, c, plen = _route_token(q, state, cache)
        o = page_attention(r.contiguous(), v0, cache["rk"], cache["rv"],
                           cache["rlen"], c.to(torch.int32))
        return o[:, :, None, :], _write_page_slot(cache, r, v0, c, plen)
    return decode


def _make_mixed_decode(routing_decode):
    """local+routing decode: ring-local half + cluster-paged routing
    half."""
    def decode(spec, q, k, v, *, cache, pos, state=None):
        (ql, kl, vl), (qr, kr, vr) = _split_heads(spec, q, k, v)
        o_l, ring = _local_decode(_local_subspec(spec), ql, kl, vl,
                                  cache=cache, pos=pos)
        o_r, pages = routing_decode(_routing_subspec(spec), qr, kr, vr,
                                    cache=cache, pos=pos, state=state)
        return torch.cat([o_l, o_r], dim=1), {**ring, **pages}
    return decode


# ---------------------------------------------------------------------------
# Prefill cache fill, from the attention's Prefix
# ---------------------------------------------------------------------------
def _append_fill(cache, prefix: Prefix, *, positions):
    """Write the prompt's roped keys and values at positions [0, N)."""
    k, v = prefix.append
    N = k.shape[2]
    out = {n: cache[n].clone() for n in ("k", "v")}
    out["k"][:, :, :N] = k.to(out["k"].dtype)
    out["v"][:, :, :N] = v.to(out["v"].dtype)
    return out


def _ring_fill(cache, prefix: Prefix, *, positions):
    """Place token t at ring slot t % 2W; keep the last 2W tokens."""
    kr, v = prefix.ring
    B, N = positions.shape
    S2 = cache["lk"].shape[2]
    take = min(N, S2)
    tail_pos = positions[:, -take:]
    slots = tail_pos % S2                                  # (B,take)
    bi = torch.arange(B, device=kr.device)[:, None]
    out = {n: cache[n].clone() for n in ("lk", "lv", "lpos")}
    # (B,take,Hkv,dh) rows land at [b, :, slot]
    out["lk"][bi, :, slots] = kr[:, :, -take:].transpose(1, 2).to(
        out["lk"].dtype)
    out["lv"][bi, :, slots] = v[:, :, -take:].transpose(1, 2).to(
        out["lv"].dtype)
    out["lpos"][bi, slots] = tail_pos.to(out["lpos"].dtype)
    return out


def _pages_fill(cache, prefix: Prefix, *, positions):
    """Route every prefix token to its argmax page, keeping the most
    recent ``cap`` per page at the ring slots sequential decode would
    have used (the first dh columns of each row)."""
    r, scores, vr = prefix.pages
    B, Hr, _, dh = r.shape
    kc, cap = cache["rk"].shape[2], cache["rk"].shape[3]
    assign = scores.argmax(-1)                             # (B,Hr,N)
    memb = torch.nn.functional.one_hot(assign, kc)         # (B,Hr,N,kc)
    rank_from_end = memb.flip(2).cumsum(2).flip(2)
    rank_from_end = (rank_from_end * memb).amax(-1)        # 1-based
    keep = (rank_from_end >= 1) & (rank_from_end <= cap)
    counts = memb.sum(2)                                   # (B,Hr,kc)
    write_slot = torch.where(
        keep, (torch.gather(counts, 2, assign) % cap - rank_from_end) % cap,
        cap)                                               # cap = trash
    bi = torch.arange(B, device=r.device)[:, None, None]
    hi = torch.arange(Hr, device=r.device)[None, :, None]
    pad = torch.zeros_like(cache["rk"][:, :, :, :1])
    rk = torch.cat([cache["rk"], pad], 3)
    rv = torch.cat([cache["rv"], pad], 3)
    rk[bi, hi, assign, write_slot, :dh] = r.to(rk.dtype)
    rv[bi, hi, assign, write_slot, :dh] = vr.to(rv.dtype)
    return {"rk": rk[:, :, :, :cap].contiguous(),
            "rv": rv[:, :, :, :cap].contiguous(),
            "rlen": counts.to(torch.int32)}


def _mixed_fill(cache, prefix: Prefix, *, positions):
    return {**_ring_fill(cache, prefix, positions=positions),
            **_pages_fill(cache, prefix, positions=positions)}


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------
_RING_FILLS = {"lpos": -1}
_RING_AXES = {"lk": 2, "lv": 2}
_PAGE_AXES = {"rk": 2, "rv": 2, "rlen": 2}
_PAGE_LEAVES = ("rk", "rv")
APPEND_LAYOUT = CacheLayout(name="append", init=_append_cache,
                            fill=_append_fill, head_axes={"k": 2, "v": 2})
RING_LAYOUT = CacheLayout(name="ring", init=_ring_cache, fill=_ring_fill,
                          reset_values=_RING_FILLS, head_axes=_RING_AXES)
PAGES_LAYOUT = CacheLayout(name="pages", init=_pages_cache, fill=_pages_fill,
                           head_axes=_PAGE_AXES, pageable_leaves=_PAGE_LEAVES,
                           page_len_leaf="rlen")
MIXED_LAYOUT = CacheLayout(name="ring+pages", init=_mixed_cache,
                           fill=_mixed_fill, reset_values=_RING_FILLS,
                           head_axes={**_RING_AXES, **_PAGE_AXES},
                           pageable_leaves=_PAGE_LEAVES, page_len_leaf="rlen")

registry.register(Backend(
    variant="full", impl="torch", apply=_full_torch_apply,
    decode=_full_decode, layout=APPEND_LAYOUT,
    caps=Capabilities(supports_decode=True, supports_grad=True)))

# supports_positions=False: the flash kernels mask causality by row index,
# so a call with positions (a prefill) goes to full/torch; no decode (as the
# JAX package's full/pallas), so a decode step goes there too
registry.register(Backend(
    variant="full", impl="cuda", apply=_full_cuda_apply, priority=10,
    caps=Capabilities(supports_pad_mask=False, supports_positions=False,
                      supports_grad=True, needs_cuda=True)))

_CAPS = dict(supports_pad_mask=True, supports_positions=True,
             supports_grad=True)


def _register(variant, impl, apply, priority=0, decode=None, layout=None,
              decode_max_head_dim=None):
    """A backend of the paper's variants: every impl but ``torch`` runs
    kernels (needs_cuda); a backend with a decode path owns ``layout``;
    one whose decode runs the paged decode kernel takes head dims up to
    its widest instance (``decode_max_head_dim``)."""
    registry.register(Backend(
        variant=variant, impl=impl, apply=apply, decode=decode,
        layout=layout, priority=priority,
        caps=Capabilities(supports_decode=decode is not None,
                          needs_cuda=impl != "torch",
                          decode_max_head_dim=decode_max_head_dim,
                          **_CAPS)))


_local_torch = _make_local_apply(kernel=False)
_local_cuda = _make_local_apply(kernel=True)
_routing_torch = _make_routing_apply("torch")
_routing_fused = _make_routing_apply("cuda_fused")
_routing_gathered = _make_routing_apply("cuda_gathered")
_decode_plain = _make_routing_decode(decode_kernel.paged_routing_decode_plain)
_decode_kernel = _make_routing_decode(decode_kernel.paged_routing_decode)

# cuda_gathered: priority 0, registered after torch (which wins the tie)
# and without decode, so auto-selection never takes it
_register("local", "torch", _local_torch, 0, _local_decode, RING_LAYOUT)
_register("local", "cuda", _local_cuda, 10, _local_decode, RING_LAYOUT)
_register("local", "cuda_gathered", _local_cuda)

_register("routing", "torch", _routing_torch, 0, _decode_plain, PAGES_LAYOUT)
_register("routing", "cuda", _routing_fused, 20, _decode_kernel,
          PAGES_LAYOUT, decode_kernel.MAX_HEAD_DIM)
_register("routing", "cuda_gathered", _routing_gathered)

_register("local+routing", "torch",
          _make_mixed_apply(_local_torch, _routing_torch), 0,
          _make_mixed_decode(_decode_plain), MIXED_LAYOUT)
_register("local+routing", "cuda",
          _make_mixed_apply(_local_cuda, _routing_fused), 20,
          _make_mixed_decode(_decode_kernel), MIXED_LAYOUT,
          decode_kernel.MAX_HEAD_DIM)
_register("local+routing", "cuda_gathered",
          _make_mixed_apply(_local_cuda, _routing_gathered))
