"""Slice parity: the encoder family (hubert-xlarge: masked prediction over
codebook targets from frame features, non-causal dense layers, no
positions) in the port against the JAX package, on the CPU in fp32.

* The reduced config (2 layers, d 64, 4 heads of dh 16) and the full one
  equal the JAX package's; a bf16 JAX tree carried across
  (`repro_torch.interop`) has the port's own init's leaves and dtypes,
  ``mask_emb`` included.
* Reduced hubert-xlarge with the JAX weights: `apply_model` on
  ``features`` with ``mask_spans`` against the JAX `apply_model`, on the
  plain backend and on the forced kernel backend (the flash Function over
  its plain versions on the CPU, dh 16 padded to 64); one train step's
  loss and gradients (`value_and_grad` of the masked-prediction loss) and
  the parameters after one `make_train_step` step (Adam) against the JAX
  step; the loss unmoved by the targets of unmasked frames;
  `next_token_batch` and `lm_loss` with ``loss_mask`` as JAX's.
* The flash wrapper at dh 80 (padded to the dh-128 instance, the scale
  1/sqrt(80)), non-causal and causal, MHA and GQA 4:1: the forward and
  the `FlashAttention` gradients against the JAX Pallas
  `flash_attention` in interpret mode and ``jax.vjp`` of it, the plain
  versions reached at the padded width and no padded column returned; a
  dh over 128 runs the plain version unpadded on the CPU.
* Resolution and refusals: on the card a non-causal dh-80 full spec
  resolves to ``full/cuda`` and dh 192 raises `BackendResolutionError`
  naming it; the CPU resolves ``full/torch``; `init_cache` of an encoder
  raises `ValueError` (it has no decode) and a model axis on it
  `NotImplementedError` (ROADMAP item 12b).
* chip_smoke's encoder helpers on the CPU: HuBERT's span masks (about
  1 - 0.92^10 of the frames) and batches, and its fp32 train gate's
  statistics: the sound path far below the limits, the kernels at the
  padded width's scale (`padded_scale`) above them.

Tolerances as tests/test_torch_full.py: fp32 outputs 2e-5 absolute, lse
and gradients 1e-4 (the frameworks sum the same fp32 products in other
orders); logits 2e-5 of the largest; after one Adam step a parameter
whose gradient element is fp32 cancellation noise may differ by twice the
rate (tests/test_torch_ssm.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.base import with_overrides as jax_with_overrides
from repro.kernels import flash_attention as jax_flash
from repro.models.model import apply_model as jax_apply_model
from repro.models.model import init_model as jax_init_model
from repro.models.model import lm_loss as jax_lm_loss
from repro.models.model import next_token_batch as jax_next_token_batch
from repro.optim import schedule as jax_schedule
from repro.train import train_step as jax_train_step
from repro_torch import attn
from repro_torch.attn import BackendResolutionError
from repro_torch.attn.spec import spec_for_layer
from repro_torch.configs import get_config, reduced_config, with_overrides
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.core.attention import full_attention
from repro_torch.dist import sharding
from repro_torch.interop import (kstate_from_jax, params_from_jax,
                                 train_state_from_jax)
from repro_torch.kernels import common
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.models.model import (apply_model, init_model, lm_loss,
                                      next_token_batch)
from repro_torch.serve import serving
from repro_torch.train import train_step
from repro_torch.tree import tree_leaves
from test_torch_hybrid import assert_dtypes_equal, assert_tree_close

ARCH = "hubert-xlarge"
TOL = 2e-5
LSE_TOL = 1e-4
GRAD_TOL = 1e-4
B, S = 2, 40


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(cfg, rng, B=B, S=S, p=0.3):
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        features=rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
        mask_spans=rng.random((B, S)) < p)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    jparams, jkstate = jax_init_model(jcfg, jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, cfg=cfg, jparams=_np(jparams),
                jkstate=_np(jkstate),
                batch=_batch(cfg, np.random.default_rng(1)),
                params=params_from_jax(_np(jparams)),
                kstate=kstate_from_jax(_np(jkstate)))


def test_configs_equal_jax():
    cfg = reduced_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_reduced_config(ARCH))
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.head_dim_, cfg.is_causal, cfg.position) == (
        "encoder", 2, 64, 4, 16, False, "none")
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_get_config(ARCH))
    assert get_config(ARCH).head_dim_ == 80


def test_interop_keeps_the_dtypes():
    """A bf16 JAX hubert tree carried across has the leaves and dtypes of
    the port's own init, mask_emb included."""
    jcfg = jax_with_overrides(jax_reduced_config(ARCH), dtype="bfloat16")
    got = params_from_jax(_np(jax_init_model(jcfg,
                                             jax.random.PRNGKey(0))[0]))
    mine, _ = init_model(with_overrides(reduced_config(ARCH),
                                        dtype="bfloat16"), device="cpu")
    assert got["mask_emb"].dtype == torch.bfloat16
    assert got["mask_emb"].shape == (64,)
    assert_dtypes_equal(got, mine)


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_forward_matches_jax(model, impl):
    b = model["batch"]
    want = np.asarray(jax_apply_model(model["jparams"], model["jkstate"], b,
                                      model["jcfg"])[0])
    got, new_k = apply_model(model["params"], model["kstate"],
                             {k: _t(v) for k, v in b.items()}, model["cfg"],
                             impl=impl)
    V = model["cfg"].vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), want[..., :V],
                               atol=TOL * np.abs(want[..., :V]).max())
    assert (got[..., V:] == -1e9).all() and new_k == [{}]
    # the masked frames read mask_emb: other features there change nothing
    feats = b["features"].copy()
    feats[b["mask_spans"]] = 7.0
    again, _ = apply_model(model["params"], model["kstate"],
                           {"features": _t(feats),
                            "mask_spans": _t(b["mask_spans"])},
                           model["cfg"], impl=impl)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_train_step_matches_jax(model):
    kw = dict(global_batch=B, seq_len=S, warmup_steps=10)
    jrun = JaxRunConfig(model=model["jcfg"], train=JaxTrainConfig(**kw))
    run = RunConfig(model=model["cfg"], train=TrainConfig(**kw))
    b = model["batch"]
    tb = {k: _t(v) for k, v in b.items()}
    vg = jax.jit(jax.value_and_grad(jax_train_step.make_loss_fn(jrun),
                                    has_aux=True))
    (jloss, _), jgrads = vg(model["jparams"], model["jkstate"], b, None)
    port_vg = train_step.value_and_grad(train_step.make_loss_fn(run),
                                        model["cfg"])
    (loss, (_, metrics)), grads = port_vg(model["params"], model["kstate"],
                                          tb, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["tokens"]) == b["mask_spans"].sum()
    assert_tree_close(grads, _np(jgrads), GRAD_TOL)
    assert float(grads["embed"]["tok"].abs().max()) == 0.0
    # the targets of unmasked frames do not enter the loss
    other = dict(tb, tokens=torch.where(tb["mask_spans"], tb["tokens"],
                                        (tb["tokens"] + 1) % 128))
    (loss2, _), _ = port_vg(model["params"], model["kstate"], other, None)
    assert float(loss2) == float(loss)
    # the JAX train step's tail (clip, schedule, Adam) on those gradients
    opt_init, opt_update = jax_optim.make_optimizer(jrun.train)
    jts = jax_train_step.TrainState(model["jparams"], model["jkstate"],
                                    opt_init(model["jparams"]),
                                    jnp.asarray(0, jnp.int32), None)
    jts2, _ = jax_train_step._finish_step(
        jrun.train, jax_schedule.make_schedule(jrun.train,
                                               jrun.model.d_model),
        opt_update, jts, jgrads, model["jkstate"], {}, None)
    ts2, m = train_step.make_train_step(run)(train_state_from_jax(_np(jts)),
                                             tb)
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    # Adam's first step moves an element by about the rate whatever its
    # gradient's size, so where a gradient element is fp32 cancellation
    # noise its parameter may differ by twice the rate; such elements are
    # rare
    lr, noisy, total = float(m["lr"]), 0, 0
    for g, jg, p, jp in zip(tree_leaves(grads), jax.tree.leaves(jgrads),
                            tree_leaves(ts2.params),
                            jax.tree.leaves(jts2.params)):
        jg, jp = np.asarray(jg), np.asarray(jp)
        loose = np.abs(g.numpy() - jg) > 1e-3 * np.abs(jg)
        assert (np.abs(p.numpy() - jp) <= np.where(loose, 2 * lr,
                                                   TOL)).all()
        noisy, total = noisy + loose.sum(), total + loose.size
    assert noisy <= 1e-3 * total


def test_shift_and_masked_loss_match_jax():
    """`next_token_batch` shifts features and mask_spans with the tokens,
    and `lm_loss` with loss_mask (beside pad_mask) counts only the frames
    both keep, as the JAX functions do."""
    rng = np.random.default_rng(2)
    b = _batch(reduced_config(ARCH), rng)
    b["pad_mask"] = rng.random((B, S)) < 0.8
    j_in, j_tgt = jax_next_token_batch(b)
    inputs, tgt = next_token_batch({k: _t(v) for k, v in b.items()})
    assert set(inputs) == set(j_in)
    for k in j_in:
        np.testing.assert_array_equal(inputs[k].numpy(), np.asarray(j_in[k]))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(j_tgt))
    logits = rng.standard_normal((B, S, 128)).astype(np.float32)
    jl, jm = jax_lm_loss(logits, b["tokens"], b["pad_mask"], 1e-4,
                         b["mask_spans"])
    loss, m = lm_loss(_t(logits), _t(b["tokens"]), _t(b["pad_mask"]), 1e-4,
                      loss_mask=_t(b["mask_spans"]))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert float(m["tokens"]) == float(jm["tokens"]) == (
        b["pad_mask"] & b["mask_spans"]).sum()


# ---------------------------------------------------------------------------
# the flash wrapper at dh 80 against the Pallas kernel
# ---------------------------------------------------------------------------
# (causal, H, Hkv)
DH80_CASES = [(False, 4, 4), (True, 4, 4), (False, 4, 1), (True, 4, 1)]
DH80_IDS = [f"{'causal' if c else 'full'}-H{h}kv{g}" for c, h, g in
            DH80_CASES]


@pytest.mark.parametrize("causal,H,Hkv", DH80_CASES, ids=DH80_IDS)
def test_flash_at_dh80_matches_pallas(causal, H, Hkv, monkeypatch):
    """The wrapper at dh 80 runs its plain versions at the padded width 128
    with the scale 1/sqrt(80), returns dh-80 tensors, and matches the
    Pallas kernel (forward, lse) and jax.vjp of it (the Function's
    gradients)."""
    rng = np.random.default_rng(81)
    N = M = 32
    q, do = (rng.standard_normal((1, H, N, 80)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, Hkv, M, 80)).astype(np.float32)
            for _ in range(2))
    widths = []
    for name in ("flash_attention_plain", "flash_attention_bwd_dq_plain",
                 "flash_attention_bwd_dkv_plain"):
        def spy(*a, _f=getattr(flash_k, name), **kw):
            widths.append(a[0].shape[-1])
            return _f(*a, **kw)
        monkeypatch.setattr(flash_k, name, spy)
    j_out, j_lse = jax_flash._fwd_call(*map(jnp.asarray, (q, k, v)), causal,
                                       16, 16, True)
    out, lse = flash_k.flash_attention(_t(q), _t(k), _t(v), causal)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(j_lse).reshape(q.shape[:3]),
                               atol=LSE_TOL)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal, bq=16, bk=16, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(flash_k.FlashAttention.apply(*leaves, causal),
                                leaves, _t(do))
    for g, jg, x in zip(grads, vjp(jnp.asarray(do)), (q, k, v)):
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GRAD_TOL)
    assert widths == [128] * 4


def test_flash_over_128_runs_unpadded_on_the_cpu(monkeypatch):
    """A head dim the kernels do not take (192) runs the plain versions
    unpadded on the CPU, with the scale 1/sqrt(192); padding it raises."""
    widths = []
    for name in ("flash_attention_plain", "flash_attention_bwd_dq_plain"):
        def spy(*a, _f=getattr(flash_k, name), **kw):
            widths.append(a[0].shape[-1])
            return _f(*a, **kw)
        monkeypatch.setattr(flash_k, name, spy)
    gen = torch.Generator().manual_seed(82)
    q, k, v, do = (torch.randn(1, 2, 24, 192, generator=gen)
                   for _ in range(4))
    out, lse = flash_k.flash_attention(q, k, v, False)
    ref_out, ref_lse = full_attention(q, k, v, False, return_lse=True)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-6)
    dq = flash_k.flash_attention_bwd_dq(q, k, v, do, lse,
                                        (do * out).sum(-1), False)
    assert dq.shape == q.shape and widths == [192, 192]
    with pytest.raises(ValueError, match="wider than"):
        common.pad_heads("flash", 192, q, widths=flash_k.WIDTHS)


# ---------------------------------------------------------------------------
# resolution and the refusals
# ---------------------------------------------------------------------------
def test_resolution_of_the_encoder_spec():
    spec = spec_for_layer(get_config(ARCH), "full")
    assert (spec.variant, spec.causal, spec.head_dim, spec.rope_theta) == (
        "full", False, 80, None)
    assert attn.resolve(spec, platform="cuda").name == "full/cuda"
    assert attn.resolve(spec, needs_grad=True,
                        platform="cuda").name == "full/cuda"
    assert attn.resolve(spec, platform="cpu").name == "full/torch"
    wide = dataclasses.replace(spec, head_dim=192)
    with pytest.raises(BackendResolutionError, match="head_dim 192"):
        attn.resolve(wide, platform="cuda")
    with pytest.raises(BackendResolutionError, match="head_dim 192"):
        attn.resolve(wide, impl="cuda", platform="cuda")
    assert attn.resolve(wide, platform="cpu").name == "full/torch"


def test_what_the_slice_leaves_out_raises():
    cfg = reduced_config(ARCH)
    with pytest.raises(ValueError, match="no decode"):
        serving.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="12b"):
        sharding.head_groups(cfg, 2)
    with pytest.raises(NotImplementedError, match="12b"):
        sharding.head_groups(get_config(ARCH), 2)


# ---------------------------------------------------------------------------
# chip_smoke's encoder helpers on the CPU
# ---------------------------------------------------------------------------
def test_hubert_masks_and_batches(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    gen = torch.Generator().manual_seed(0)
    mask = chip_smoke.hubert_mask_spans(torch, 4, 4096, 0.08,
                                        chip_smoke.HUBERT_SPAN, gen)
    assert mask.dtype == torch.bool
    assert abs(float(mask.float().mean()) - (1 - 0.92 ** 10)) < 0.02
    cfg = with_overrides(reduced_config(ARCH), dtype="bfloat16")
    (b,) = chip_smoke.encoder_batches(torch, cfg, 2, 48, 1)
    assert b["tokens"].shape == (2, 48) and b["mask_spans"].shape == (2, 48)
    assert b["features"].shape == (2, 48, 64)
    assert b["features"].dtype == torch.bfloat16
    assert int(b["tokens"].max()) < cfg.vocab_size


def test_encoder_gate_refuses_the_padded_scale(monkeypatch):
    """chip_smoke's hubert fp32 gate statistics on reduced hubert (dh 16,
    run at 64 by the kernel backend's glue): the sound path reads far
    below the limits, the kernels at the padded width's scale above
    them."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    cfg = reduced_config(ARCH)
    run = RunConfig(model=cfg, train=TrainConfig())
    params, kstate = init_model(cfg, seed=0, device="cpu")
    (batch,) = chip_smoke.encoder_batches(torch, cfg, 2, 48, 1)

    def grads(impl):
        vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl),
                                       cfg)
        return vg(params, kstate, batch, None)[1]

    plain = grads("torch")
    sound = chip_smoke.grad_agreement(grads("cuda"), plain)
    with chip_smoke.padded_scale():
        assert common.head_scale(16) == common.head_scale(64)
        broken = chip_smoke.grad_agreement(grads("cuda"), plain)
    assert common.head_scale(16) == 0.25
    assert sound["grad_rel_median"] < chip_smoke.MAX_GRAD_MEDIAN_FULL / 10
    assert sound["grad_rel_max"] < chip_smoke.MAX_BWD_GRAD_FULL / 10
    assert broken["grad_rel_median"] > chip_smoke.MAX_GRAD_MEDIAN_FULL
    assert broken["grad_rel_max"] > chip_smoke.MAX_BWD_GRAD_FULL
