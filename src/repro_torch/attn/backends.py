"""The port's attention backends for the paper's ``local+routing`` head split
(port of the part of the JAX package's ``attn/backends.py`` that serving
and training rt-enwik8 run).

Registered pairs (variant, impl):

  local+routing/torch   plain PyTorch: blocked-window reference for the
                        local heads, gathered-block routing reference for
                        the routing heads, page-gather decode
  local+routing/cuda    the hand-written CUDA kernels: local window kernels,
                        fused gather-free routing kernels (forward and
                        backward, as autograd Functions), paged decode
                        kernel (priority 20, needs_cuda; the counterpart of
                        the JAX package's local+routing/pallas_paged)

Both apply paths are differentiable: the plain one through autograd of its
PyTorch ops, the kernel one through the Functions' backward kernels. The
centroids they return carry no gradient (the EMA update is detached).

Both share one cache layout (`MIXED_LAYOUT`: a 2W ring for the local heads,
cluster pages for the routing heads) and the same cache fill, ring-local
decode, token routing and page-slot write, so the two paths walk the same
cache trajectory. Rope is applied here to the local heads only; routing
heads are content. Decode updates return new cache leaves (clone, then
write) rather than writing in place, as the JAX functions do: the serve
step's ``active`` mask then selects between old and new leaves.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.attn import registry
from repro_torch.attn.registry import Backend, CacheLayout
from repro_torch.attn.spec import AttentionSpec, head_split
from repro_torch.core.attention import full_attention
from repro_torch.core.kmeans import KMeansState, normalize_routing
from repro_torch.core.local import local_attention
from repro_torch.core.routing import routed_attention
from repro_torch.kernels import local_attention as local_kernel
from repro_torch.kernels import routing_decode as decode_kernel
from repro_torch.models import layers as L


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
# Apply (prefill) paths
# ---------------------------------------------------------------------------
def _local_torch(spec, q, k, v, positions, pad_mask):
    qr, kr = _rope_qk(spec, q, k, positions)
    return local_attention(qr, kr, v, spec.window, spec.causal, pad_mask)


def _local_cuda(spec, q, k, v, positions, pad_mask):
    """Every call takes the kernels (any N, any pad mask), forward and
    backward (`local_kernel.LocalAttention`)."""
    qr, kr = _rope_qk(spec, q, k, positions)
    out, _ = local_kernel.LocalAttention.apply(
        qr.contiguous(), kr.contiguous(), v.contiguous(), spec.window,
        spec.causal, pad_mask)
    return out


def _make_mixed_apply(local_fn, routing_impl: str):
    def apply(spec, q, k, v, *, state=None, positions=None, pad_mask=None,
              update_state=True):
        (ql, kl, vl), (qr, kr, vr) = _split_heads(spec, q, k, v)
        o_l = local_fn(_local_subspec(spec), ql, kl, vl, positions, pad_mask)
        rspec = _routing_subspec(spec)
        rc = rspec.routing
        g = rspec.q_per_kv
        k_in = (None if (rc.share_qk and rspec.causal) or kr is None
                else _expand_kv(kr, g).contiguous())
        ro = routed_attention(qr.contiguous(), k_in,
                              _expand_kv(vr, g).contiguous(),
                              KMeansState(mu=state), rc, positions, pad_mask,
                              update_state, impl=routing_impl)
        return torch.cat([o_l, ro.out], dim=1), ro.state.mu
    return apply


# ---------------------------------------------------------------------------
# Decode paths + cache layout
# ---------------------------------------------------------------------------
def _page_dims(spec, max_len):
    kc = spec.routing.num_clusters
    return kc, spec.routing.window or max(1, max_len // kc)


def _mixed_cache(spec, B, max_len, dtype, device):
    dh, W = spec.head_dim, spec.window
    _, Hr, kvl, _ = head_split(spec)
    kc, cap = _page_dims(spec, max_len)
    z = dict(dtype=dtype, device=device)
    return {"lk": torch.zeros((B, kvl, 2 * W, dh), **z),
            "lv": torch.zeros((B, kvl, 2 * W, dh), **z),
            "lpos": torch.full((B, 2 * W), -1, dtype=torch.int32,
                               device=device),
            "rk": torch.zeros((B, Hr, kc, cap, dh), **z),
            "rv": torch.zeros((B, Hr, kc, cap, dh), **z),
            "rlen": torch.zeros((B, Hr, kc), dtype=torch.int32,
                                device=device)}


def _local_decode(spec, q, k, v, *, cache, pos):
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
    o = full_attention(qr, ck, cv, pad_mask=valid)
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
    """Ring-overwrite the new token into slot plen % cap of page c."""
    B, Hr = c.shape
    cap = cache["rk"].shape[3]
    wslot = (plen % cap).long()
    bi = torch.arange(B, device=c.device)[:, None]
    hi = torch.arange(Hr, device=c.device)[None, :]
    ck, cv, cl = cache["rk"].clone(), cache["rv"].clone(), cache["rlen"].clone()
    ck[bi, hi, c, wslot] = r.to(ck.dtype)
    cv[bi, hi, c, wslot] = v0.to(cv.dtype)
    cl[bi, hi, c] = (plen + 1).to(cl.dtype)
    return {"rk": ck, "rv": cv, "rlen": cl}


def _make_mixed_decode(page_attention):
    """local+routing decode: ring-local half + cluster-paged routing half,
    whose page attention is ``page_attention`` (plain or kernel)."""
    def decode(spec, q, k, v, *, cache, pos, state=None):
        (ql, kl, vl), (qr, _, vr) = _split_heads(spec, q, k, v)
        o_l, ring = _local_decode(_local_subspec(spec), ql, kl, vl,
                                  cache=cache, pos=pos)
        rspec = _routing_subspec(spec)
        v0 = _expand_kv(vr, rspec.q_per_kv)[:, :, 0].contiguous()
        r, c, plen = _route_token(qr, state, cache)
        o_r = page_attention(r.contiguous(), v0, cache["rk"], cache["rv"],
                             cache["rlen"], c.to(torch.int32))
        pages = _write_page_slot(cache, r, v0, c, plen)
        return torch.cat([o_l, o_r[:, :, None, :]], dim=1), {**ring, **pages}
    return decode


# ---------------------------------------------------------------------------
# Prefill cache fill
# ---------------------------------------------------------------------------
def _ring_fill(spec, cache, k, v, *, positions):
    """Place token t at ring slot t % 2W; keep the last 2W tokens."""
    B, N = positions.shape
    kr = k if spec.rope_theta is None else L.apply_rope(k, positions,
                                                         spec.rope_theta)
    S2 = cache["lk"].shape[2]
    take = min(N, S2)
    tail_pos = positions[:, -take:]
    slots = tail_pos % S2                                  # (B,take)
    bi = torch.arange(B, device=k.device)[:, None]
    out = {n: cache[n].clone() for n in ("lk", "lv", "lpos")}
    # (B,take,Hkv,dh) rows land at [b, :, slot]
    out["lk"][bi, :, slots] = kr[:, :, -take:].transpose(1, 2).to(
        out["lk"].dtype)
    out["lv"][bi, :, slots] = v[:, :, -take:].transpose(1, 2).to(
        out["lv"].dtype)
    out["lpos"][bi, slots] = tail_pos.to(out["lpos"].dtype)
    return out


def _pages_fill(spec, cache, q, v, *, state):
    """Route every prefix token to its argmax page, keeping the most
    recent ``cap`` per page at the ring slots sequential decode would
    have used."""
    B = q.shape[0]
    vr = _expand_kv(v, spec.q_per_kv)
    r = normalize_routing(q)                               # (B,Hr,N,dh)
    kc, cap = cache["rk"].shape[2], cache["rk"].shape[3]
    Hr = r.shape[1]
    scores = torch.einsum("bhnd,hkd->bhnk", r.float(), state.float())
    assign = scores.argmax(-1)                             # (B,Hr,N)
    memb = torch.nn.functional.one_hot(assign, kc)         # (B,Hr,N,kc)
    rank_from_end = memb.flip(2).cumsum(2).flip(2)
    rank_from_end = (rank_from_end * memb).amax(-1)        # 1-based
    keep = (rank_from_end >= 1) & (rank_from_end <= cap)
    counts = memb.sum(2)                                   # (B,Hr,kc)
    write_slot = torch.where(
        keep, (torch.gather(counts, 2, assign) % cap - rank_from_end) % cap,
        cap)                                               # cap = trash
    bi = torch.arange(B, device=q.device)[:, None, None]
    hi = torch.arange(Hr, device=q.device)[None, :, None]
    pad = torch.zeros_like(cache["rk"][:, :, :, :1])
    rk = torch.cat([cache["rk"], pad], 3)
    rv = torch.cat([cache["rv"], pad], 3)
    rk[bi, hi, assign, write_slot] = r.to(rk.dtype)
    rv[bi, hi, assign, write_slot] = vr.to(rv.dtype)
    return {"rk": rk[:, :, :, :cap].contiguous(),
            "rv": rv[:, :, :, :cap].contiguous(),
            "rlen": counts.to(torch.int32)}


def _mixed_fill(spec, cache, q, k, v, *, positions, state=None):
    (_, kl, vl), (qr, _, vr) = _split_heads(spec, q, k, v)
    ring = _ring_fill(_local_subspec(spec), cache, kl, vl,
                      positions=positions)
    pages = _pages_fill(_routing_subspec(spec), cache, qr, vr, state=state)
    return {**ring, **pages}


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------
MIXED_LAYOUT = CacheLayout(name="ring+pages", init=_mixed_cache,
                           fill=_mixed_fill)

registry.register(Backend(
    variant="local+routing", impl="torch",
    apply=_make_mixed_apply(_local_torch, "torch"),
    decode=_make_mixed_decode(decode_kernel.paged_routing_decode_plain),
    layout=MIXED_LAYOUT))

registry.register(Backend(
    variant="local+routing", impl="cuda",
    apply=_make_mixed_apply(_local_cuda, "cuda_fused"),
    decode=_make_mixed_decode(decode_kernel.paged_routing_decode),
    layout=MIXED_LAYOUT, needs_cuda=True, priority=20))
