"""The gathered routing kernels of the port against the JAX package.

The CUDA kernels (``csrc/routing_gathered.cu``, ``routing_gathered_bwd.cu``)
run only on the card, where ``chip_smoke.py`` holds each against its plain
version. Here, on the same numpy inputs (fp32):

* the plain forward, dq and dk/dv (`kernels.routing_gathered`, which the
  wrappers run for CPU tensors) against the JAX package's
  ``routed_attention_blocks`` and its VJP, the Pallas kernels in interpret
  mode: causal shared-QK, causal separate-QK (rows with no attendable key
  included) and non-causal with padded keys (one cluster all padding), at
  w in {64, 200, 256} (200: ragged against the kernels' tiles);
* `RoutedAttentionBlocks` (the autograd Function) against the same VJP:
  with shared-QK the one block tensor comes in as q and k and its two
  gradients add;
* `core.routing.routed_attention(impl="cuda_gathered")` against the JAX
  package's ``impl="pallas"``: outputs, centroids and gradients;
* the registry: ``cuda_gathered`` is a forced impl that auto-selection
  never takes, and a forced ``cuda_gathered`` decode raises naming the
  backend auto-selection would use.

Tolerances: outputs and lse 1e-5 absolute (values of order 1; an online
softmax over key tiles against a one-shot softmax, both fp32); gradients
1e-5 relative to the largest reference entry (products of fp32 sums taken
in another order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.core import routing as jax_routing
from repro.core.kmeans import KMeansState as JaxKMeansState
from repro.kernels import ops as jax_ops
from repro_torch import attn
from repro_torch.attn import registry
from repro_torch.attn.spec import AttentionSpec
from repro_torch.configs.base import RoutingConfig
from repro_torch.core import routing
from repro_torch.core.kmeans import KMeansState
from repro_torch.kernels import routing_gathered as K

OUT_TOL = 1e-5
GRAD_TOL = 1e-5
MODES = ["shared-causal", "separate-causal", "padded-noncausal"]
B, H, KC, DH = 1, 2, 2, 16


def _blocks(mode, w, seed):
    """(q, k, v, pq, pk, valid, do) numpy blocks (B,H,k,w[,dh]); k is q
    for shared-QK, valid None unless padded."""
    rng = np.random.default_rng(seed)
    shape = (B, H, KC, w, DH)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    pq = np.sort(rng.choice(4 * w * KC, size=(B, H, KC, w)), -1)
    pq = pq.astype(np.int32)
    pk = (pq if mode == "shared-causal" else np.sort(
        rng.integers(0, 4 * w * KC, (B, H, KC, w)), -1).astype(np.int32))
    if mode == "separate-causal":
        pk[0, 0, 0] += 8 * w * KC            # a cluster of future keys only
    valid = None
    if mode == "padded-noncausal":
        valid = rng.random((B, H, KC, w)) < 0.85
        valid[0, 0, 0] = False                   # a cluster of padding only
    if mode == "shared-causal":
        k = q
    return q, k, v, pq, pk, valid, do


def _jax_blocks(mode, w, q, k, v, pq, pk, valid):
    bq = w if w % 128 else 128
    kw = dict(causal=mode != "padded-noncausal",
              valid_k=None if valid is None else jnp.asarray(valid),
              bq=bq, bk=bq, interpret=True)
    pq_, pk_ = jnp.asarray(pq), jnp.asarray(pk)
    if mode == "shared-causal":
        return (lambda q, v: jax_ops.routed_attention_blocks(
            q, q, v, pq_, pk_, **kw)), (q, v)
    return (lambda q, k, v: jax_ops.routed_attention_blocks(
        q, k, v, pq_, pk_, **kw)), (q, k, v)


def _flat(mode, q, k, v, pq, pk, valid):
    """The wrappers' (n, w, dh) blocks and int32 positions, padded keys at
    SENTINEL."""
    n, w = B * H * KC, q.shape[3]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).reshape(  # noqa
        n, w, -1)
    qf = t(q)
    kf = qf if mode == "shared-causal" else t(k)
    pkm = pk if valid is None else np.where(valid, pk, K.SENTINEL)
    return (qf, kf, t(v), torch.from_numpy(pq).reshape(n, w),
            torch.from_numpy(pkm.astype(np.int32)).reshape(n, w))


def _close(got, want, rel=None):
    want = np.asarray(want).reshape(got.shape)
    atol = OUT_TOL if rel is None else rel * np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=atol)


@pytest.mark.parametrize("w", [64, 200, 256])
@pytest.mark.parametrize("mode", MODES)
def test_plain_forward_matches_pallas_kernel(mode, w):
    q, k, v, pq, pk, valid, _ = _blocks(mode, w, seed=w)
    f, args = _jax_blocks(mode, w, q, k, v, pq, pk, valid)
    want = f(*map(jnp.asarray, args))
    qf, kf, vf, pqf, pkf = _flat(mode, q, k, v, pq, pk, valid)
    out, lse = K.routed_attention_blocks(qf, kf, vf, pqf, pkf,
                                         causal=mode != "padded-noncausal")
    _close(out, want)
    assert np.isfinite(lse.numpy()).all() and lse.shape == qf.shape[:2]
    # rows with no attendable key (all padding, or all keys in the future)
    # output 0 in both
    empty = (np.abs(np.asarray(want)).reshape(out.shape).max(-1) == 0)
    if mode != "shared-causal":
        assert empty.any()
        assert (out.reshape(-1, DH)[torch.from_numpy(empty.reshape(-1))]
                == 0).all()


@pytest.mark.parametrize("w", [64, 200, 256])
@pytest.mark.parametrize("mode", MODES)
def test_plain_backward_matches_pallas_vjp(mode, w):
    """dq, dk/dv of the plain versions (the wrappers on CPU tensors) and
    the gradients through `RoutedAttentionBlocks` against the Pallas
    VJP."""
    q, k, v, pq, pk, valid, do = _blocks(mode, w, seed=100 + w)
    f, args = _jax_blocks(mode, w, q, k, v, pq, pk, valid)
    _, vjp = jax.vjp(f, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(do))
    causal = mode != "padded-noncausal"
    qf, kf, vf, pqf, pkf = _flat(mode, q, k, v, pq, pk, valid)
    out, lse = K.routed_attention_blocks(qf, kf, vf, pqf, pkf, causal)
    dof = torch.from_numpy(do).reshape(out.shape)
    dq, dk, dv = K.routed_attention_blocks_bwd(qf, kf, vf, pqf, pkf, out, lse,
                                               dof, causal)
    got = (dq + dk, dv) if mode == "shared-causal" else (dq, dk, dv)
    for g, w_ in zip(got, want):
        _close(g, w_, GRAD_TOL)

    leaves = [t.clone().requires_grad_(True) for t in (qf, kf, vf)]
    if mode == "shared-causal":
        leaves[1] = leaves[0]
    o, _ = K.RoutedAttentionBlocks.apply(*leaves, pqf, pkf, causal)
    (o * dof).sum().backward()
    got = ((leaves[0].grad, leaves[2].grad) if mode == "shared-causal"
           else tuple(t.grad for t in leaves))
    for g, w_ in zip(got, want):
        _close(g, w_, GRAD_TOL)


def test_wrappers_check_their_inputs():
    q, k, v, pq, pk, valid, do = _blocks("separate-causal", 64, seed=7)
    qf, kf, vf, pqf, pkf = _flat("separate-causal", q, k, v, pq, pk, valid)
    with pytest.raises(ValueError, match="int32"):
        K.routed_attention_blocks(qf, kf, vf, pqf.long(), pkf)
    with pytest.raises(ValueError, match="one shape"):
        K.routed_attention_blocks(qf, kf[:, :32], vf, pqf, pkf)
    with pytest.raises(ValueError, match="contiguous"):
        K.routed_attention_blocks(qf.transpose(1, 2).contiguous()
                                  .transpose(1, 2), kf, vf, pqf, pkf)
    out, lse = K.routed_attention_blocks(qf, kf, vf, pqf, pkf)
    with pytest.raises(ValueError, match="accumulation"):
        K.routed_attention_blocks_bwd_dq(qf, kf, vf, pqf, pkf,
                                         torch.from_numpy(do).reshape(
                                             out.shape), lse.double(),
                                         lse, True)


# ---------------------------------------------------------------------------
# routed_attention(impl="cuda_gathered") against JAX impl="pallas"
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_routed_attention_gathered_matches_jax_pallas(mode):
    Bq, Hq, N, dh, kc = 2, 2, 128, 16, 4
    rng = np.random.default_rng(11)
    q, k, v, wt = (rng.standard_normal((Bq, Hq, N, dh)).astype(np.float32)
                   for _ in range(4))
    mu = rng.standard_normal((Hq, kc, dh)).astype(np.float32)
    causal = mode != "padded-noncausal"
    shared = mode == "shared-causal"
    pad = None
    if mode == "padded-noncausal":
        pad = np.ones((Bq, N), bool)
        pad[1, -40:] = False
    kw = dict(num_clusters=kc, window=32, share_qk=shared, causal=causal)
    jcfg, cfg = JaxRoutingConfig(**kw), RoutingConfig(**kw)

    def jf(q, k, v):
        ro = jax_routing.routed_attention(
            q, None if shared else k, v, JaxKMeansState(mu=jnp.asarray(mu)),
            jcfg, pad_mask=None if pad is None else jnp.asarray(pad),
            impl="pallas", interpret=True)
        return (ro.out * jnp.asarray(wt)).sum(), ro
    (_, jro), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                          has_aux=True)(
        *map(jnp.asarray, (q, k, v)))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ro = routing.routed_attention(
        leaves[0], None if shared else leaves[1], leaves[2],
        KMeansState(mu=torch.from_numpy(mu)), cfg,
        pad_mask=None if pad is None else torch.from_numpy(pad),
        impl="cuda_gathered")
    (ro.out * torch.from_numpy(wt)).sum().backward()
    _close(ro.out, jro.out)
    _close(ro.state.mu, jro.state.mu)
    for i in ((0, 2) if shared else (0, 1, 2)):
        _close(leaves[i].grad, jgrads[i], GRAD_TOL)
    # the gathered path computes what the plain path does
    ref = routing.routed_attention(
        torch.from_numpy(q), None if shared else torch.from_numpy(k),
        torch.from_numpy(v), KMeansState(mu=torch.from_numpy(mu)), cfg,
        pad_mask=None if pad is None else torch.from_numpy(pad))
    torch.testing.assert_close(ro.out.detach(), ref.out, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the registry: a forced impl, never auto-chosen
# ---------------------------------------------------------------------------
def _specs():
    rc = RoutingConfig(num_clusters=4, local_window=16)
    common = dict(num_heads=4, num_kv_heads=4, head_dim=16, rope_theta=1e4)
    return [AttentionSpec(variant="local", window=16, **common),
            AttentionSpec(variant="routing", routing=rc, **common),
            AttentionSpec(variant="local+routing", routing=rc, window=16,
                          routing_heads=2, **common)]


@pytest.mark.parametrize("spec", _specs(), ids=lambda s: s.variant)
def test_cuda_gathered_is_never_auto_chosen(spec):
    names = {b.impl: b for b in attn.backends_for(spec.variant)}
    assert {"torch", "cuda", "cuda_gathered"} <= set(names)
    g = names["cuda_gathered"]
    assert g.priority == 0 and g.caps.needs_cuda
    assert not g.caps.supports_decode and g.layout is None
    for call in ({}, {"needs_grad": True}, {"positioned": True},
                 {"padded": True}, {"decode": True}):
        assert attn.resolve(spec, platform="cuda", **call).impl == "cuda"
        assert attn.resolve(spec, platform="cpu", **call).impl == "torch"
    assert attn.resolve(spec, impl="cuda_gathered", needs_grad=True,
                        platform="cpu") is g


@pytest.mark.parametrize("spec", _specs(), ids=lambda s: s.variant)
def test_forced_cuda_gathered_decode_names_the_auto_choice(spec):
    with pytest.raises(registry.BackendResolutionError) as e:
        attn.resolve(spec, decode=True, impl="cuda_gathered",
                     platform="cuda")
    msg = str(e.value)
    assert "supports_decode=False" in msg
    assert f"would serve this call with {spec.variant}/cuda" in msg
    q = torch.randn(2, 4, 1, 16)
    cache = attn.init_decode_cache(spec, 2, 64, torch.float32, "cpu")
    with pytest.raises(registry.BackendResolutionError,
                       match=re.escape(f"{spec.variant}/torch")):
        attn.attend(spec, q, q, q, state=torch.randn(4, 4, 16), cache=cache,
                    pos=torch.zeros(2, dtype=torch.long),
                    impl="cuda_gathered")
