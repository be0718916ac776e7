"""Slice 3 parity: dense (full) attention and the flash kernels' glue.

On the CPU the flash kernel wrappers run their plain PyTorch versions
(``core/attention.py``); the CUDA kernels themselves are held to those on
the card by `chip_smoke.py`. Here, on the same numpy inputs:

* `flash_attention_plain` (out, lse) against the JAX package's Pallas
  flash kernel `_fwd_call` in interpret mode, and the plain backward and
  the `FlashAttention` Function against ``jax.vjp`` of the Pallas
  `flash_attention`: causal and not, GQA 1:1 and 4:1, M != N (the causal
  mask on row indices, as the TPU kernel has it); ragged N and M, which
  the Pallas kernel does not take, against autograd of the plain forward;
  the Function in float64 under ``gradcheck``;
* the ``full/torch`` backend against the JAX package's ``full/xla``:
  causal, explicit positions, pad mask, non-causal, and the KV-chunked
  online softmax against the one-shot path, forward and gradients;
* the registry's capabilities: ``full/cuda`` (row-index mask, no pad
  mask, no decode) is left out of positioned, padded and decode calls on
  the card, a forced ``impl="cuda"`` with positions raises and names
  ``full/torch``, a backend without a gradient is left out of a
  differentiated call, and the ``local+routing`` resolutions are as
  before; serving a full-attention model raises until its cache is
  ported;
* the reduced configs of the four full-attention models (equal to the
  JAX package's) and their forward logits against its `apply_model`, on the plain and the forced kernel
  backend, with the qkv biases set from the seed (the JAX init zeros them);
* chip_smoke's qwen2 fp32 gate statistics against its negative control.

Tolerance (fp32): 2e-5 absolute on outputs, 1e-4 on lse and gradients
(the frameworks sum the same fp32 products in other orders); 1e-5 between
two port paths with the same math in another order (chunked vs one-shot,
Function vs autograd); logits 2e-5 relative to the largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.attn import attend as jax_attend
from repro.attn.spec import AttentionSpec as JaxAttentionSpec
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import flash_attention as jax_flash
from repro.models.model import apply_model as jax_apply_model
from repro.models.model import init_model as jax_init_model
from repro_torch import attn
from repro_torch.attn import registry
from repro_torch.attn.backends import Prefix
from repro_torch.attn.spec import AttentionSpec, spec_for_layer
from repro_torch.configs import reduced_config
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.core.attention import full_attention
from repro_torch.interop import kstate_from_jax, params_from_jax
from repro_torch.kernels import common
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.models.model import apply_model, init_model
from repro_torch.serve import serving
from repro_torch.train import train_step

TOL = 2e-5
LSE_TOL = 1e-4
GRAD_TOL = 1e-4
SAME_MATH_TOL = 1e-5
FULL_ARCHS = ["qwen2-0.5b", "starcoder2-3b", "phi4-mini-3.8b", "granite-8b"]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def with_qkv_biases(tree, seed):
    """``tree`` (a JAX parameter tree of numpy leaves) with every qkv bias
    leaf drawn from ``seed`` instead of the zeros of the init."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if key in ("bq", "bk", "bv"):
            return (0.5 * rng.standard_normal(node.shape)).astype(node.dtype)
        return node
    return walk(tree)


# ---------------------------------------------------------------------------
# the flash kernels' plain versions and Function vs the Pallas kernel
# ---------------------------------------------------------------------------
# (causal, H, Hkv, N, M)
FLASH_CASES = [(True, 4, 4, 64, 64), (True, 4, 1, 64, 64),
               (False, 4, 4, 64, 64), (False, 4, 1, 64, 64),
               (False, 4, 2, 64, 32), (False, 4, 2, 32, 64),
               (True, 4, 2, 64, 32), (True, 4, 2, 32, 64)]
FLASH_IDS = [f"{'causal' if c else 'full'}-H{h}kv{g}-N{n}M{m}"
             for c, h, g, n, m in FLASH_CASES]


def _flash_inputs(rng, H, Hkv, N, M, B=2, dh=16):
    return (_rand(rng, B, H, N, dh), _rand(rng, B, Hkv, M, dh),
            _rand(rng, B, Hkv, M, dh), _rand(rng, B, H, N, dh))


@pytest.mark.parametrize("causal,H,Hkv,N,M", FLASH_CASES, ids=FLASH_IDS)
def test_flash_forward_matches_pallas_kernel(causal, H, Hkv, N, M):
    q, k, v, _ = _flash_inputs(np.random.default_rng(31), H, Hkv, N, M)
    j_out, j_lse = jax_flash._fwd_call(*map(jnp.asarray, (q, k, v)), causal,
                                       16, 16, True)
    j_lse = np.asarray(j_lse).reshape(q.shape[:3])
    for out, lse in (flash_k.flash_attention_plain(_t(q), _t(k), _t(v),
                                                   causal),
                     flash_k.flash_attention(_t(q), _t(k), _t(v), causal)):
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=TOL)
        np.testing.assert_allclose(lse.numpy(), j_lse, atol=LSE_TOL)
        assert lse.dtype == torch.float32


@pytest.mark.parametrize("causal,H,Hkv,N,M", FLASH_CASES, ids=FLASH_IDS)
def test_flash_backward_matches_pallas_vjp(causal, H, Hkv, N, M):
    """The plain backward (both kernels' plain versions and the group sum)
    and the Function's backward against jax.vjp of the Pallas kernel."""
    q, k, v, do = _flash_inputs(np.random.default_rng(32), H, Hkv, N, M)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal, bq=16, bk=16, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    j_grads = vjp(jnp.asarray(do))
    out, lse = flash_k.flash_attention(_t(q), _t(k), _t(v), causal)
    plain = flash_k.flash_attention_bwd_plain(_t(q), _t(k), _t(v), out, lse,
                                              _t(do), causal)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    fn_out = flash_k.FlashAttention.apply(*leaves, causal)
    np.testing.assert_allclose(fn_out.detach().numpy(), out.numpy(), atol=0)
    fn_grads = torch.autograd.grad(fn_out, leaves, _t(do))
    for grads in (plain, fn_grads):
        for p, j in zip(grads, j_grads):
            assert p.shape == j.shape
            np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                       atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("N,M", [(37, 37), (50, 23), (23, 50)])
def test_flash_ragged_matches_autograd_of_plain_forward(causal, N, M):
    """Sizes the Pallas kernel does not take (no multiple of its block):
    the Function (plain forward + plain backward kernels) against autograd
    of the one-shot plain forward."""
    rng = np.random.default_rng(33)
    q, k, v, do = _flash_inputs(rng, 4, 2, N, M)
    got, want = ([_t(x).requires_grad_(True) for x in (q, k, v)]
                 for _ in range(2))
    g_fn = torch.autograd.grad(flash_k.FlashAttention.apply(*got, causal),
                               got, _t(do))
    g_ref = torch.autograd.grad(full_attention(*want, causal), want, _t(do))
    for a, b in zip(g_fn, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SAME_MATH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradcheck(causal):
    gen = torch.Generator().manual_seed(34)
    q = torch.randn(1, 4, 9, 4, dtype=torch.float64, generator=gen)
    k, v = (torch.randn(1, 2, 7, 4, dtype=torch.float64, generator=gen)
            for _ in range(2))
    inputs = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_k.FlashAttention.apply(a, b, c, causal),
        inputs)


def test_flash_cpu_wrappers_check_and_take_plain_version():
    """On CPU tensors no launch is counted; the wrappers refuse what the
    kernels would refuse before they dispatch."""
    common.reset_counters()
    rng = np.random.default_rng(35)
    q, k, v, do = map(_t, _flash_inputs(rng, 4, 2, 32, 32))
    out, lse = flash_k.flash_attention(q, k, v)
    flash_k.flash_attention_bwd(q, k, v, out, lse, do)
    names = {"flash_attention", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"}
    assert names <= set(common.counters())
    assert {common.counters()[n] for n in names} == {0}
    with pytest.raises(ValueError, match="shapes"):
        flash_k.flash_attention(q, k[:, :, :, :8].contiguous(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_k.flash_attention(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="mixed dtypes"):
        flash_k.flash_attention(q, k.double(), v)


# ---------------------------------------------------------------------------
# full/torch vs the JAX package's full/xla
# ---------------------------------------------------------------------------
FULL_CASES = {
    "causal": dict(),
    "non_causal": dict(causal=False),
    "positions": dict(positions=True),
    "pad_mask": dict(padded=True),
    "chunked": dict(chunk=16),
    "chunked_positions_padded": dict(chunk=16, positions=True, padded=True),
}


def _full_call(rng, causal=True, positions=False, padded=False, chunk=0,
               B=2, H=4, Hkv=2, N=40, dh=16):
    q = _rand(rng, B, H, N, dh)
    k, v = _rand(rng, B, Hkv, N, dh), _rand(rng, B, Hkv, N, dh)
    kw = {}
    if positions:
        kw["positions"] = (np.arange(N)[None] + np.array([[0], [5]])
                           ).astype(np.int32)
    if padded:
        pm = rng.random((B, N)) > 0.3
        pm[:, 0] = True
        kw["pad_mask"] = pm
    spec = dict(variant="full", num_heads=H, num_kv_heads=Hkv, head_dim=dh,
                causal=causal, rope_theta=1e4, chunk=chunk)
    return (q, k, v), kw, spec


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_torch_matches_full_xla(case):
    """Forward, and gradients of a fixed projection of the output."""
    rng = np.random.default_rng(36)
    (q, k, v), kw, spec = _full_call(rng, **FULL_CASES[case])
    w = _rand(rng, *q.shape)

    def j_loss(a, b, c):
        out = jax_attend(JaxAttentionSpec(**spec), a, b, c, impl="xla",
                         **{n: jnp.asarray(x) for n, x in kw.items()}).out
        return (out * w).sum(), out
    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = attn.attend(AttentionSpec(**spec), *leaves, impl="torch",
                      **{n: _t(x) for n, x in kw.items()}).out
    grads = torch.autograd.grad((out * _t(w)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=TOL)
    for p, j in zip(grads, j_grads):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=GRAD_TOL)


@pytest.mark.parametrize("case", ["chunked", "chunked_positions_padded"])
def test_chunked_full_attention_equals_one_shot(case):
    """The chunked online softmax (each chunk under checkpoint) against the
    one-shot softmax, forward and gradients; the ragged last chunk (40 =
    2 x 16 + 8) included."""
    rng = np.random.default_rng(37)
    (q, k, v), kw, spec = _full_call(rng, **FULL_CASES[case])
    kw = {n: _t(x) for n, x in kw.items()}
    res = []
    for chunk in (spec["chunk"], 0):
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
        out = full_attention(*leaves, spec["causal"], chunk=chunk, **kw)
        res.append((out, torch.autograd.grad(out.square().sum(), leaves)))
    (a, ga), (b, gb) = res
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=SAME_MATH_TOL)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=SAME_MATH_TOL)


# ---------------------------------------------------------------------------
# the registry's capabilities
# ---------------------------------------------------------------------------
def _full_spec():
    return spec_for_layer(reduced_config("qwen2-0.5b"), "full")


def test_full_cuda_serves_the_plain_call_on_the_card():
    assert attn.resolve(_full_spec(), platform="cuda").name == "full/cuda"
    assert attn.resolve(_full_spec(), needs_grad=True,
                        platform="cuda").name == "full/cuda"
    assert attn.resolve(_full_spec(), platform="cpu").name == "full/torch"


@pytest.mark.parametrize("call", ["positioned", "padded"])
def test_full_cuda_left_out_of_calls_it_cannot_serve(call):
    """A call with positions (a prefill) or a pad mask goes to full/torch
    on the card; forced onto full/cuda it raises and names full/torch."""
    spec = _full_spec()
    assert attn.resolve(spec, platform="cuda", **{call: True}).name == \
        "full/torch"
    with pytest.raises(attn.BackendResolutionError,
                       match="would serve this call with full/torch"):
        attn.resolve(spec, platform="cuda", impl="cuda", **{call: True})


def test_full_attention_has_no_decode_path_yet():
    """No full backend declares decode: resolution refuses it, and a full
    model's serving cache raises instead of building a wrong one."""
    with pytest.raises(attn.BackendResolutionError,
                       match="full/cuda: call needs a decode path"):
        attn.resolve(_full_spec(), decode=True, platform="cuda")
    for impl in ("torch", "cuda"):
        with pytest.raises(attn.BackendResolutionError,
                           match="supports_decode=False"):
            attn.resolve(_full_spec(), decode=True, impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        serving.init_cache(reduced_config("qwen2-0.5b"), 1, 32, device="cpu")


def test_forced_cuda_with_positions_raises_through_attend():
    rng = np.random.default_rng(38)
    (q, k, v), kw, spec = _full_call(rng, positions=True)
    with pytest.raises(attn.BackendResolutionError, match="full/torch"):
        attn.attend(AttentionSpec(**spec), _t(q), _t(k), _t(v),
                    positions=_t(kw["positions"]), impl="cuda")


def test_a_backend_without_a_gradient_is_left_out_of_differentiated_calls():
    """attend announces a gradient when q, k or v requires one under
    autograd; a higher-priority backend without supports_grad then loses
    to one with it, and serves calls without a gradient."""
    used = []

    def apply(spec, q, k, v, **kw):
        used.append("nograd")
        return q, None, Prefix()
    registry.register(registry.Backend(
        variant="full", impl="nograd", apply=apply, priority=50,
        caps=registry.Capabilities()))
    try:
        spec = _full_spec()
        assert attn.resolve(spec).name == "full/nograd"
        assert attn.resolve(spec, needs_grad=True).name == "full/torch"
        with pytest.raises(attn.BackendResolutionError,
                           match="supports_grad=False"):
            attn.resolve(spec, needs_grad=True, impl="nograd")
        x = torch.randn(1, 4, 8, 16)
        kv = torch.randn(1, 1, 8, 16)
        with torch.no_grad():
            attn.attend(spec, x, kv, kv)
        assert used == ["nograd"]
        attn.attend(spec, x.requires_grad_(True), kv, kv)
        assert used == ["nograd"]
    finally:
        registry._REGISTRY.pop(("full", "nograd"))


@pytest.mark.parametrize("call", [{}, {"positioned": True}, {"padded": True},
                                  {"decode": True}, {"needs_grad": True}])
def test_local_routing_resolutions_unchanged(call):
    spec = spec_for_layer(reduced_config("rt-enwik8"), "local+routing")
    assert spec.variant == "local+routing"
    assert attn.resolve(spec, platform="cuda", **call).name == \
        "local+routing/cuda"
    assert attn.resolve(spec, platform="cpu", **call).name == \
        "local+routing/torch"


# ---------------------------------------------------------------------------
# the four full-attention models, reduced: forward logits vs JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", [None, "cuda"])
@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_reduced_forward_logits_match_jax(arch, impl):
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params, kstate = jax_init_model(jcfg, jax.random.PRNGKey(3))
    params = with_qkv_biases(jax.tree.map(np.asarray, params), 39)
    kstate = jax.tree.map(np.asarray, kstate)
    tokens = np.random.default_rng(40).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)
    j_logits = np.asarray(jax_apply_model(params, kstate,
                                          {"tokens": tokens}, jcfg)[0])
    logits, new_k = apply_model(params_from_jax(params),
                                kstate_from_jax(kstate),
                                {"tokens": _t(tokens)}, cfg, impl=impl)
    assert logits.shape == (2, 48, cfg.padded_vocab) == j_logits.shape
    V = cfg.vocab_size
    np.testing.assert_allclose(logits[..., :V].numpy(), j_logits[..., :V],
                               atol=TOL * np.abs(j_logits[..., :V]).max())
    assert (logits[..., V:] == -1e9).all()
    assert new_k == [{}]
    if cfg.qkv_bias:
        assert np.abs(params["stack"][0][0]["attn"]["bk"]).max() > 0.1


# ---------------------------------------------------------------------------
# chip_smoke's qwen2 fp32 gate against its negative control
# ---------------------------------------------------------------------------
def test_full_fp32_gate_separates_a_broken_backward(monkeypatch):
    """chip_smoke's gate statistics on reduced qwen2 (GQA 4:1): the kernel
    path (the Function's glue) against the plain path reads far below both
    limits; a backward that takes each kv head's dk/dv from the first
    query head of its group reads above them."""
    cfg = reduced_config("qwen2-0.5b")
    run = RunConfig(model=cfg, train=TrainConfig())
    params, kstate = init_model(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(41).integers(0, cfg.vocab_size, (2, 49))
    batch = {"tokens": _t(tokens)}

    def grads(impl):
        vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl))
        return vg(params, kstate, batch, None)[1]

    plain = grads("torch")
    sound = chip_smoke.grad_agreement(grads("cuda"), plain)
    monkeypatch.setattr(flash_k, "flash_attention_bwd",
                        chip_smoke.first_query_head_only)
    broken = chip_smoke.grad_agreement(grads("cuda"), plain)
    print(f"qwen2 fp32 gate statistic: sound {sound}, first head only "
          f"{broken}")
    assert sound["grad_rel_median"] < chip_smoke.MAX_GRAD_MEDIAN_FULL / 10
    assert sound["grad_rel_max"] < chip_smoke.MAX_BWD_GRAD_FULL / 10
    assert broken["grad_rel_median"] > chip_smoke.MAX_GRAD_MEDIAN_FULL
    assert broken["grad_rel_max"] > chip_smoke.MAX_BWD_GRAD_FULL
