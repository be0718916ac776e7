"""The plain backward of each ported kernel against the JAX package's VJP.

Beside each backward kernel wrapper sits its plain PyTorch version, which
recomputes p from the forward's saved lse as the kernel does; on CPU
tensors the wrappers (and the autograd Functions over them) run it. Here:

* local window: `local_attention_bwd_plain` against ``jax.vjp`` of the
  Pallas `local_attention_kernel` in interpret mode (causal and encoder,
  GQA), and against autograd of the plain forward for what the Pallas
  kernel does not take (ragged N, pad mask, rows with no valid key);
* fused routing: `routed_attention_fused_bwd_plain` (per-cluster blocks,
  scatter-added to sequence layout here) and the `RoutedAttentionFused`
  Function against ``jax.vjp`` of `routed_attention_fused` in interpret
  mode, in both memory plans: shared and separate QK, causal and not,
  padded keys;
* both Functions pass ``torch.autograd.gradcheck`` in float64.

Tolerance: fp32 inputs, gradients within 1e-4 absolute of the JAX VJP
(gradients reach ~10 here; the frameworks sum the same fp32 products in
different orders) and within 1e-5 of autograd of the plain forward (the
same ops, p recomputed from the lse instead of kept).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import local_attention as jax_local_kernel
from repro.kernels import routing_attention as jax_routing_kernel
from repro_torch.core import local as local_ref
from repro_torch.core import routing as routing_ref
from repro_torch.kernels import common
from repro_torch.kernels import local_attention as local_k
from repro_torch.kernels import routing_attention as routing_k

VJP_TOL = 1e-4
AUTOGRAD_TOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# local window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_local_bwd_plain_matches_pallas_vjp(causal, H, Hkv):
    rng = np.random.default_rng(11)
    B, N, dh, w = 2, 64, 16, 16
    q, do = _rand(rng, B, H, N, dh), _rand(rng, B, H, N, dh)
    k, v = _rand(rng, B, Hkv, N, dh), _rand(rng, B, Hkv, N, dh)
    _, vjp = jax.vjp(lambda a, b, c: jax_local_kernel.local_attention_kernel(
        a, b, c, w, causal, interpret=True), *map(jnp.asarray, (q, k, v)))
    j_grads = vjp(jnp.asarray(do))
    out, lse = local_k.local_attention(_t(q), _t(k), _t(v), w, causal)
    p_grads = local_k.local_attention_bwd_plain(_t(q), _t(k), _t(v), out,
                                                lse, _t(do), w, causal)
    for p, j in zip(p_grads, j_grads):
        assert p.shape == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=VJP_TOL)


def _plain_autograd_local(q, k, v, do, w, causal, pm):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = local_ref.local_attention(*leaves, w, causal, pm)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("N,padded", [(50, False), (64, True), (37, True)])
def test_local_bwd_ragged_and_padded(causal, N, padded):
    """Ragged last block and key pad masks (with rows that see no valid
    key): the plain backward, the wrappers and the Function against
    autograd of the plain forward."""
    rng = np.random.default_rng(12)
    B, H, Hkv, dh, w = 2, 4, 2, 16, 16
    q, do = _t(_rand(rng, B, H, N, dh)), _t(_rand(rng, B, H, N, dh))
    k, v = _t(_rand(rng, B, Hkv, N, dh)), _t(_rand(rng, B, Hkv, N, dh))
    pm = None
    if padded:
        pm = _t(rng.random((B, N)) > 0.3)
        pm[1, :20] = False
    want = _plain_autograd_local(q, k, v, do, w, causal, pm)
    out, lse = local_k.local_attention(q, k, v, w, causal, pm)
    plain = local_k.local_attention_bwd_plain(q, k, v, out, lse, do, w,
                                              causal, pm)
    wrapped = local_k.local_attention_bwd(q, k, v, out, lse, do, w, causal,
                                          pm)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, _ = local_k.LocalAttention.apply(*leaves, w, causal, pm)
    fn = torch.autograd.grad(o, leaves, do)
    for got in (plain, wrapped, fn):
        for g, e in zip(got, want):
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), e.numpy(),
                                       atol=AUTOGRAD_TOL)


# ---------------------------------------------------------------------------
# fused routing
# ---------------------------------------------------------------------------
def _routing_inputs(rng, shared, padded, B=2, H=2, N=64, dh=16, kc=4):
    w = N // kc
    q, v = _rand(rng, B, H, N, dh), _rand(rng, B, H, N, dh)
    k = None if shared else _rand(rng, B, H, N, dh)
    mu = _rand(rng, H, kc, dh)
    kvalid = None
    if padded:
        kvalid = np.ones((B, N), bool)
        kvalid[0, -9:] = False
        kvalid[1, :5] = False
    tq = _t(q)
    tv = None if kvalid is None else _t(kvalid)
    q_idx = routing_ref.balanced_topk(
        torch.einsum("bhnd,hkd->bhnk", tq, _t(mu)), w, tv)
    k_idx = q_idx if shared else routing_ref.balanced_topk(
        torch.einsum("bhnd,hkd->bhnk", _t(k), _t(mu)), w, tv)
    pos = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy()
    do = _rand(rng, B, H, kc, w, dh)
    return (q, k, v, q_idx.int().numpy(), k_idx.int().numpy(), pos, kvalid,
            do)


ROUTING_CASES = [(True, True, True), (True, True, False),
                 (False, True, False), (False, True, True),
                 (True, False, False), (False, False, True)]
ROUTING_IDS = ["shared-causal-padded", "shared-causal", "separate-causal",
               "separate-causal-padded", "shared-noncausal",
               "separate-noncausal-padded"]


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("shared,causal,padded", ROUTING_CASES,
                         ids=ROUTING_IDS)
def test_routing_bwd_plain_matches_pallas_vjp(shared, causal, padded,
                                              paged):
    rng = np.random.default_rng(13)
    q, k, v, q_idx, k_idx, pos, kvalid, do = _routing_inputs(rng, shared,
                                                             padded)
    jkv = None if kvalid is None else jnp.asarray(kvalid)

    def jfn(*xs):
        jq, jk, jv = (xs[0], None, xs[1]) if shared else xs
        return jax_routing_kernel.routed_attention_fused(
            jq, jk, jv, jnp.asarray(q_idx), jnp.asarray(k_idx),
            jnp.asarray(pos), causal=causal, kvalid=jkv, interpret=True,
            paged=paged)

    prim = (q, v) if shared else (q, k, v)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, prim))
    j_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tk = None if k is None else _t(k)
    tkv = None if kvalid is None else _t(kvalid)
    args = (_t(q), tk, _t(v), _t(q_idx), _t(k_idx), _t(pos))
    out, lse = routing_k.routed_attention_fused(*args, causal, tkv)
    dqg, dkg, dvg = routing_k.routed_attention_fused_bwd_plain(
        *args, out, lse, _t(do), causal, tkv)
    N = q.shape[2]
    qi, ki = _t(q_idx).long(), _t(k_idx).long()
    dq = routing_ref.scatter_add_rows(dqg, qi, N)
    dk = routing_ref.scatter_add_rows(dkg, ki, N)
    dv = routing_ref.scatter_add_rows(dvg, ki, N)
    plain = [dq + dk, dv] if shared else [dq, dk, dv]

    leaves = [_t(x).requires_grad_(True) for x in prim]
    fq, fk, fv = ((leaves[0], None, leaves[1]) if shared else leaves)
    o, _ = routing_k.RoutedAttentionFused.apply(fq, fk, fv, *args[3:],
                                                causal, tkv)
    fn = torch.autograd.grad(o, leaves, _t(do))
    for p, f, j in zip(plain, fn, j_grads):
        np.testing.assert_allclose(p.numpy(), j, atol=VJP_TOL)
        np.testing.assert_allclose(f.numpy(), p.numpy(), atol=1e-6)


def test_shared_qk_gradient_keeps_the_key_side():
    """With shared-QK, q's rows are also the keys: the q gradient is the
    sum of the query-side and key-side scatters. Dropping the key side
    moves it by far more than the tolerance."""
    rng = np.random.default_rng(14)
    q, _, v, q_idx, _, pos, _, do = _routing_inputs(rng, True, False)
    args = (_t(q), None, _t(v), _t(q_idx), _t(q_idx), _t(pos))
    out, lse = routing_k.routed_attention_fused(*args)
    dqg, dkg, _ = routing_k.routed_attention_fused_bwd_plain(
        *args, out, lse, _t(do))
    key_side = routing_ref.scatter_add_rows(dkg, _t(q_idx).long(), q.shape[2])
    leaf = _t(q).requires_grad_(True)
    o, _ = routing_k.RoutedAttentionFused.apply(leaf, None, *args[2:],
                                                True, None)
    (g,) = torch.autograd.grad(o, [leaf], _t(do))
    query_side = routing_ref.scatter_add_rows(dqg, _t(q_idx).long(),
                                              q.shape[2])
    np.testing.assert_allclose(g.numpy(), (query_side + key_side).numpy(),
                               atol=1e-6)
    assert float(key_side.abs().max()) > 100 * VJP_TOL


# ---------------------------------------------------------------------------
# the Functions in float64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("N,padded", [(16, False), (13, True)])
def test_local_function_gradcheck(causal, N, padded):
    gen = torch.Generator().manual_seed(15)
    q = torch.randn(1, 2, N, 4, dtype=torch.float64, generator=gen)
    k, v = (torch.randn(1, 1, N, 4, dtype=torch.float64, generator=gen)
            for _ in range(2))
    pm = None
    if padded:
        pm = torch.rand(1, N, generator=gen) > 0.3
        pm[0, :3] = False
    inputs = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: local_k.LocalAttention.apply(a, b, c, 4, causal,
                                                     pm)[0], inputs)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_routing_function_gradcheck(shared, causal):
    gen = torch.Generator().manual_seed(16)
    B, H, N, dh, kc, w = 1, 2, 16, 4, 4, 4
    q, v = (torch.randn(B, H, N, dh, dtype=torch.float64, generator=gen)
            for _ in range(2))
    k = None if shared else torch.randn(B, H, N, dh, dtype=torch.float64,
                                        generator=gen)
    mu = torch.randn(H, kc, dh, dtype=torch.float64, generator=gen)

    def members(x):
        return routing_ref.balanced_topk(
            torch.einsum("bhnd,hkd->bhnk", x, mu), w).int().contiguous()
    q_idx = members(q)
    k_idx = q_idx if shared else members(k)
    pos = torch.arange(N, dtype=torch.int32)[None].expand(B, N).contiguous()
    kvalid = torch.ones(B, N, dtype=torch.bool)
    kvalid[0, -3:] = False
    inputs = (q, v) if shared else (q, k, v)
    inputs = tuple(t.requires_grad_(True) for t in inputs)

    def fn(*xs):
        a, b, c = (xs[0], None, xs[1]) if shared else xs
        return routing_k.RoutedAttentionFused.apply(
            a, b, c, q_idx, k_idx, pos, causal, kvalid)[0]
    assert torch.autograd.gradcheck(fn, inputs)


def test_cpu_backward_wrappers_take_plain_version_without_launching():
    common.reset_counters()
    rng = np.random.default_rng(17)
    q, _, v, q_idx, _, pos, _, do = _routing_inputs(rng, True, True)
    args = (_t(q), None, _t(v), _t(q_idx), _t(q_idx), _t(pos))
    out, lse = routing_k.routed_attention_fused(*args)
    routing_k.routed_attention_fused_bwd(*args, out, lse, _t(do))
    lq = _t(_rand(rng, 1, 2, 32, 16))
    out, lse = local_k.local_attention(lq, lq, lq, 16)
    local_k.local_attention_bwd(lq, lq, lq, out, lse, lq, 16)
    names = {"local_attention_bwd_dq", "local_attention_bwd_dkv",
             "routing_fused_bwd_dq", "routing_fused_bwd_dkv"}
    assert names <= set(common.counters())
    assert set(common.counters().values()) == {0}
