"""The plain PyTorch version of each ported kernel against its JAX kernel.

Each of the port's three CUDA kernels has a plain PyTorch version beside
its wrapper; on CPU tensors the wrapper runs that version (the CUDA kernel
itself is compared with it on the card by `chip_smoke.py`). Here each plain
version runs against the JAX package's Pallas kernel in interpret mode, on
the same numpy inputs:

* local window  vs ``kernels/local_attention.py`` `_fwd_call` (out + lse),
  and vs ``core/local.py`` for what the Pallas kernel does not take
  (ragged N, pad mask);
* fused routing vs ``kernels/routing_attention.py``
  `routed_attention_fused` in both memory plans and `_f_fwd_call` (lse):
  causal shared-QK with padded keys, separate k, non-causal;
* paged decode  vs ``kernels/routing_decode.py`` `paged_routing_decode`
  with a cap that is not a power of two and pages empty, partly filled
  and wrapped.

Tolerance: fp32 inputs, 2e-5 absolute on outputs and 1e-4 on lse (the
two frameworks sum the same fp32 products in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.core import kmeans as jax_kmeans
from repro.core import local as jax_local
from repro.core import routing as jax_routing
from repro.kernels import local_attention as jax_local_kernel
from repro.kernels import routing_attention as jax_routing_kernel
from repro.kernels import routing_decode as jax_decode_kernel
from repro_torch.configs.base import RoutingConfig
from repro_torch.core import kmeans, routing
from repro_torch.interop import params_from_jax, tree_to_numpy
from repro_torch.kernels import common
from repro_torch.kernels import local_attention as local_k
from repro_torch.kernels import routing_attention as routing_k
from repro_torch.kernels import routing_decode as decode_k

TOL = 2e-5
LSE_TOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# local window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_local_plain_matches_pallas_kernel(causal, H, Hkv):
    rng = np.random.default_rng(1)
    B, N, dh, w = 2, 64, 16, 16
    q, k, v = _rand(rng, B, H, N, dh), _rand(rng, B, Hkv, N, dh), \
        _rand(rng, B, Hkv, N, dh)
    j_out, j_lse = jax_local_kernel._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w, causal, True)
    p_out, p_lse = local_k.local_attention(_t(q), _t(k), _t(v), w, causal)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL)
    np.testing.assert_allclose(p_lse.numpy().reshape(B * H, N),
                               np.asarray(j_lse), atol=LSE_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("N,padded", [(50, False), (64, True), (37, True)])
def test_local_plain_ragged_and_padded(causal, N, padded):
    """Ragged last block and key pad masks (including rows with no valid
    key, which output 0) against the JAX reference."""
    rng = np.random.default_rng(2)
    B, H, Hkv, dh, w = 2, 4, 2, 16, 16
    q, k, v = _rand(rng, B, H, N, dh), _rand(rng, B, Hkv, N, dh), \
        _rand(rng, B, Hkv, N, dh)
    pm = None
    if padded:
        pm = rng.random((B, N)) > 0.3
        pm[1, :20] = False                     # rows that see no valid key
    j_out = jax_local.local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w, causal,
        None if pm is None else jnp.asarray(pm))
    p_out, p_lse = local_k.local_attention(
        _t(q), _t(k), _t(v), w, causal, None if pm is None else _t(pm))
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL)
    assert p_lse.shape == (B, H, N) and torch.isfinite(p_lse).all()


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
    pm = None if kvalid is None else jnp.asarray(kvalid)
    sq = jax_kmeans.cluster_scores(jnp.asarray(q), jnp.asarray(mu))
    q_idx = np.asarray(jax_routing.balanced_topk(sq, w, pm), np.int32)
    k_idx = q_idx if shared else np.asarray(jax_routing.balanced_topk(
        jax_kmeans.cluster_scores(jnp.asarray(k), jnp.asarray(mu)), w, pm),
        np.int32)
    pos = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy()
    return q, k, v, q_idx, k_idx, pos, kvalid


ROUTING_CASES = [(True, True, True), (True, True, False),
                 (False, True, False), (False, False, True)]
ROUTING_IDS = ["shared-causal-padded", "shared-causal", "separate-causal",
               "separate-noncausal-padded"]


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("shared,causal,padded", ROUTING_CASES,
                         ids=ROUTING_IDS)
def test_fused_routing_plain_matches_pallas_kernel(shared, causal, padded,
                                                   paged):
    rng = np.random.default_rng(3)
    q, k, v, q_idx, k_idx, pos, kvalid = _routing_inputs(rng, shared, padded)
    j_out = jax_routing_kernel.routed_attention_fused(
        jnp.asarray(q), None if k is None else jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(q_idx), jnp.asarray(k_idx),
        jnp.asarray(pos), causal=causal,
        kvalid=None if kvalid is None else jnp.asarray(kvalid),
        interpret=True, paged=paged)
    p_out, _ = routing_k.routed_attention_fused(
        _t(q), None if k is None else _t(k), _t(v), _t(q_idx), _t(k_idx),
        _t(pos), causal, None if kvalid is None else _t(kvalid))
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL)


@pytest.mark.parametrize("shared,causal,padded", ROUTING_CASES,
                         ids=ROUTING_IDS)
def test_fused_routing_plain_lse_matches_pallas_kernel(shared, causal,
                                                       padded):
    rng = np.random.default_rng(4)
    q, k, v, q_idx, k_idx, pos, kvalid = _routing_inputs(rng, shared, padded)
    B, H, N, dh = q.shape
    kc, w = q_idx.shape[2], q_idx.shape[3]
    qf = jnp.asarray(q).reshape(B * H, N, dh)
    kf = qf if k is None else jnp.asarray(k).reshape(B * H, N, dh)
    posk = pos if kvalid is None else np.where(
        kvalid, pos, jax_routing_kernel.SENTINEL).astype(np.int32)
    _, j_lse = jax_routing_kernel._f_fwd_call(
        qf, kf, jnp.asarray(v).reshape(B * H, N, dh),
        jnp.asarray(q_idx).reshape(B * H, kc, w),
        jnp.asarray(k_idx).reshape(B * H, kc, w), jnp.asarray(pos),
        jnp.asarray(posk), k is None, causal, w, w, H, True)
    _, p_lse = routing_k.routed_attention_fused(
        _t(q), None if k is None else _t(k), _t(v), _t(q_idx), _t(k_idx),
        _t(pos), causal, None if kvalid is None else _t(kvalid))
    np.testing.assert_allclose(p_lse.numpy().reshape(B * H, kc, w),
                               np.asarray(j_lse), atol=LSE_TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda_fused"])
@pytest.mark.parametrize("share_qk", [True, False])
def test_routed_attention_matches_jax(impl, share_qk):
    """The whole routing pipeline (normalize, scores, balanced top-k,
    attention, scatter-mean, EMA update) against the JAX reference."""
    rng = np.random.default_rng(5)
    B, H, N, dh, kc = 2, 2, 64, 16, 4
    q, k, v = (_rand(rng, B, H, N, dh) for _ in range(3))
    mu = _rand(rng, H, kc, dh)
    pm = np.ones((B, N), bool)
    pm[1, -7:] = False
    jcfg = JaxRoutingConfig(num_clusters=kc, share_qk=share_qk)
    j = jax_routing.routed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jax_kmeans.KMeansState(mu=jnp.asarray(mu)), jcfg,
        pad_mask=jnp.asarray(pm), update_state=True)
    p = routing.routed_attention(
        _t(q), _t(k), _t(v), kmeans.KMeansState(mu=_t(mu)),
        RoutingConfig(num_clusters=kc, share_qk=share_qk),
        pad_mask=_t(pm), update_state=True, impl=impl)
    np.testing.assert_allclose(p.out.numpy(), np.asarray(j.out), atol=TOL)
    np.testing.assert_allclose(p.state.mu.numpy(), np.asarray(j.state.mu),
                               atol=TOL)


def test_balanced_topk_tie_order_matches_jax():
    """Ties (here: every pad token at -1e9, and repeated scores) go to the
    lower token index first, as in jax.lax.top_k."""
    rng = np.random.default_rng(6)
    scores = rng.integers(0, 3, (2, 2, 40, 4)).astype(np.float32)
    valid = np.ones((2, 40), bool)
    valid[0, 10:30] = False
    valid[1, :] = False
    for w in (5, 13, 40):
        j = np.asarray(jax_routing.balanced_topk(
            jnp.asarray(scores), w, jnp.asarray(valid)))
        p = routing.balanced_topk(_t(scores), w, _t(valid)).numpy()
        np.testing.assert_array_equal(p, j)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", [13, 16])
def test_paged_decode_plain_matches_pallas_kernel(cap):
    rng = np.random.default_rng(7)
    B, Hr, kc, dh = 2, 3, 4, 16
    r, v_new = _rand(rng, B, Hr, dh), _rand(rng, B, Hr, dh)
    rk, rv = _rand(rng, B, Hr, kc, cap, dh), _rand(rng, B, Hr, kc, cap, dh)
    # empty, partly filled, exactly full and wrapped (rlen > cap) pages
    rlen = rng.choice([0, 1, cap // 2, cap, 3 * cap + 2],
                      (B, Hr, kc)).astype(np.int32)
    cluster = rng.integers(0, kc, (B, Hr)).astype(np.int32)
    cluster[0, 0] = 0
    rlen[0, 0, 0] = 0
    j = jax_decode_kernel.paged_routing_decode(
        *(jnp.asarray(a) for a in (r, v_new, rk, rv, rlen, cluster)),
        interpret=True)
    p = decode_k.paged_routing_decode(
        *(_t(a) for a in (r, v_new, rk, rv, rlen, cluster)))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=TOL)


def test_cpu_wrappers_take_plain_version_without_launching():
    """A CPU tensor goes to the plain version: no counter moves."""
    common.reset_counters()
    rng = np.random.default_rng(8)
    q = _t(_rand(rng, 1, 2, 32, 16))
    local_k.local_attention(q, q, q, 16)
    idx = torch.arange(32, dtype=torch.int32).reshape(1, 1, 2, 16).expand(
        1, 2, 2, 16).contiguous()
    pos = torch.arange(32, dtype=torch.int32)[None]
    routing_k.routed_attention_fused(q, None, q, idx, idx, pos)
    page = _t(_rand(rng, 1, 2, 2, 5, 16))
    tok = q[:, :, 0].contiguous()
    decode_k.paged_routing_decode(tok, tok, page, page,
                                  torch.ones((1, 2, 2), dtype=torch.int32),
                                  torch.zeros((1, 2), dtype=torch.int32))
    assert set(common.counters().values()) == {0}
    assert {"local_attention", "routing_fused",
            "routing_decode"} <= set(common.counters())


def test_interop_bfloat16_round_trip():
    """bf16 leaves cross through a 16-bit view, bit for bit."""
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 5), jnp.bfloat16)
    tree = {"a": [np.asarray(x)], "b": (np.arange(4, dtype=np.int32),)}
    t = params_from_jax(tree)
    assert t["a"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["a"][0].view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))
    back = tree_to_numpy(t)
    np.testing.assert_array_equal(back["a"][0],
                                  np.asarray(x, dtype=np.float32))
    np.testing.assert_array_equal(back["b"][0], np.arange(4))


@pytest.mark.parametrize("mode", ["mean", "last"])
def test_scatter_rows_matches_jax(mode):
    """Scatter back to sequence order; "last" only on membership without
    duplicates (with duplicates neither framework fixes the winner)."""
    rng = np.random.default_rng(9)
    B, H, kc, w, d, n = 2, 2, 4, 8, 16, 40
    og = _rand(rng, B, H, kc, w, d)
    if mode == "last":
        idx = np.stack([np.stack([rng.permutation(n)[:kc * w]
                                  for _ in range(H)]) for _ in range(B)])
    else:
        idx = rng.integers(0, n, (B, H, kc * w))
    idx = idx.reshape(B, H, kc, w)
    j = jax_routing._scatter_rows(jnp.asarray(og), jnp.asarray(idx), n, mode)
    p = routing._scatter_rows(_t(og), _t(idx).long(), n, mode)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=TOL)
