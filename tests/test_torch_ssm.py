"""Slice parity: the ssm family (mamba2-780m: the SSD mixer, no attention)
in the port against the JAX package, on the CPU in fp32.

* The SSD pieces (`models.ssm`): `ssd_chunked` (ragged last chunk
  included) and `ssd_naive` against the JAX functions, from a carried
  state too, and `apply_ssd` with its conv and SSD states carried across
  two calls (the chunked form, then the decode step) against JAX's same
  calls and against one call over the whole sequence; the fp32 leaves of
  a bf16 mixer.
* Reduced mamba2-780m (2 SSD layers, state 16, chunk 32, no FFN, tied
  embeddings, no positions) with the JAX weights (`repro_torch.interop`):
  `apply_model` logits over two chunks and a ragged third, one train
  step's loss and gradients (`value_and_grad` of the loss) and the
  parameters after one `make_train_step` step (Adam), remat "full" and
  "save_dots" giving the gradients of "none", and a prefill of a 40-token
  prompt then 4 decode tokens: the logits and every cache leaf (conv,
  state) against the JAX package's `prefill` / `make_serve_step`.
* The engine on the JAX package's hybrid engine test schedule, here on a
  2-layer ssm config, tokens equal and recorded logits within TOL of the
  JAX engine's; `specs_for_model` empty, as JAX's; a model axis refused
  (ROADMAP item 12b).

Tolerances: logits, gradients and float cache leaves TOL (2e-5) absolute
(two frameworks summing the same fp32 products in other orders); the SSD
outputs SSD_TOL (1e-5) of their largest value (the JAX package's own
chunked-vs-naive bound is 1e-3 absolute, tests/test_models.py); after one
Adam step, a parameter whose gradient element is fp32 cancellation noise
twice the rate (no more than 1e-3 of the elements).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import ssm as jax_ssm
from repro.models.model import apply_model as jax_apply_model
from repro.models.model import init_model as jax_init_model
from repro.optim import schedule as jax_schedule
from repro.serve import serving as jax_serving
from repro.serve.engine import InferenceEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.train import train_step as jax_train_step
from repro_torch.attn import specs_for_model
from repro_torch.configs import get_config, reduced_config, with_overrides
from repro_torch.configs import with_routing
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig
from repro_torch.dist import sharding
from repro_torch.interop import (kstate_from_jax, params_from_jax,
                                 train_state_from_jax)
from repro_torch.models import ssm
from repro_torch.models.model import apply_model, init_model
from repro_torch.models.transformer import build_segments
from repro_torch.serve import serving
from repro_torch.serve.engine import InferenceEngine, Request
from repro_torch.train import train_step
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_hybrid import _np, assert_tree_close

ARCH = "mamba2-780m"
TOL = 2e-5
SSD_TOL = 1e-5
B, N, STEPS = 2, 76, 4


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------
def _ssd_inputs(S, Bsz=2, H=3, P=8, Nst=16, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    xh = rng.randn(Bsz, S, H, P).astype(f)
    dt = np.log1p(np.exp(rng.randn(Bsz, S, H))).astype(f)
    A = -np.exp(rng.randn(H) * 0.5).astype(f)
    Bm, Cm = (rng.randn(Bsz, S, Nst).astype(f) * 0.5 for _ in range(2))
    s0 = rng.randn(Bsz, H, Nst, P).astype(f)
    return xh, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("S,chunk", [(64, 16), (100, 32), (48, 64)])
def test_ssd_chunked_and_naive_match_jax(S, chunk):
    args = _ssd_inputs(S)
    ja = [jnp.asarray(a) for a in args]
    ta = [torch.from_numpy(a) for a in args]
    for init in (False, True):
        jy, js = jax_ssm.ssd_chunked(*ja[:5], chunk,
                                     init_state=ja[5] if init else None)
        y, s = ssm.ssd_chunked(*ta[:5], chunk, ta[5] if init else None)
        ny, ns = ssm.ssd_naive(*ta[:5], ta[5] if init else None)
        jny, _ = jax_ssm.ssd_naive(*ja[:5], ja[5] if init else None)
        for got, want in ((y, jy), (s, js), (ny, jny), (ns, js), (ny, y)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=SSD_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def mixer():
    jcfg = jax_reduced_config(ARCH)
    p = _np(jax_ssm.init_ssd(jax.random.PRNGKey(3), jcfg))
    x = np.random.RandomState(4).randn(2, 45, jcfg.d_model).astype(
        np.float32)
    return dict(cfg=reduced_config(ARCH), jcfg=jcfg, p=p, x=x)


def test_apply_ssd_carries_its_states_as_jax(mixer):
    jp, p, x = mixer["p"], params_from_jax(mixer["p"]), mixer["x"]
    jcfg, cfg = mixer["jcfg"], mixer["cfg"]
    jy1, (jc, js) = jax_ssm.apply_ssd(jp, jnp.asarray(x[:, :40]), jcfg)
    jy2, (jc2, js2) = jax_ssm.apply_ssd(jp, jnp.asarray(x[:, 40:]), jcfg,
                                        conv_state=jc, ssm_state=js)
    ty1, (tc, ts) = ssm.apply_ssd(p, torch.from_numpy(x[:, :40]), cfg)
    ty2, (tc2, ts2) = ssm.apply_ssd(p, torch.from_numpy(x[:, 40:]), cfg,
                                    conv_state=tc, ssm_state=ts)
    for g, w in ((ty1, jy1), (ty2, jy2), (tc, jc), (ts, js), (tc2, jc2),
                 (ts2, js2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    whole, _ = ssm.apply_ssd(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(torch.cat([ty1, ty2], 1).numpy(),
                               whole.numpy(), atol=TOL)
    jd, (jdc, jds) = jax_ssm.apply_ssd(jp, jnp.asarray(x[:, 40:41]), jcfg,
                                       conv_state=jc, ssm_state=js,
                                       decode=True)
    td, (tdc, tds) = ssm.apply_ssd(p, torch.from_numpy(x[:, 40:41]), cfg,
                                   conv_state=tc, ssm_state=ts, decode=True)
    for g, w in ((td, jd), (tdc, jdc), (tds, jds)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    np.testing.assert_allclose(td.numpy(), ty2[:, :1].numpy(), atol=TOL)


def test_ssd_keeps_fp32_leaves():
    cfg = with_overrides(reduced_config(ARCH), dtype="bfloat16")
    p = ssm.init_ssd(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k for k, v in p.items() if not isinstance(v, dict)
            and v.dtype == torch.float32} == {"A_log", "D", "dt_bias"}


# ---------------------------------------------------------------------------
# reduced mamba2-780m against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    jparams, jkstate = jax_init_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, N + STEPS)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=_np(jparams),
                jkstate=_np(jkstate), tokens=tokens,
                params=params_from_jax(_np(jparams)),
                kstate=kstate_from_jax(_np(jkstate)))


def test_reduced_config_segments_and_specs():
    cfg = reduced_config(ARCH)
    assert (cfg.num_layers, cfg.d_ff, cfg.ssm_state, cfg.ssm_chunk) == (
        2, 0, 16, 32)
    assert [(tuple(s.kind for s in pat), g)
            for pat, g in build_segments(cfg)] == [(("ssd",), 2)]
    assert build_segments(get_config(ARCH))[0][1] == 48
    assert specs_for_model(cfg) == () == specs_for_model(get_config(ARCH))
    assert with_routing(get_config(ARCH)) == get_config(ARCH)


def test_logits_match_jax(model):
    toks = model["tokens"][:, :N]
    want, _, _ = jax_apply_model(model["jparams"], model["jkstate"],
                                 {"tokens": jnp.asarray(toks)}, model["jcfg"])
    got, _ = apply_model(model["params"], model["kstate"],
                         {"tokens": torch.from_numpy(toks)}, model["cfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_train_step_matches_jax(model):
    kw = dict(global_batch=B, seq_len=N - 1, warmup_steps=10)
    jrun = JaxRunConfig(model=model["jcfg"], train=JaxTrainConfig(**kw))
    run = RunConfig(model=model["cfg"], train=TrainConfig(**kw))
    batch = {"tokens": model["tokens"][:, :N]}
    vg = jax.jit(jax.value_and_grad(jax_train_step.make_loss_fn(jrun),
                                    has_aux=True))
    (jloss, _), jgrads = vg(model["jparams"], model["jkstate"], batch, None)
    (loss, _), grads = train_step.value_and_grad(
        train_step.make_loss_fn(run))(model["params"], model["kstate"],
                                      {"tokens": torch.from_numpy(
                                          batch["tokens"])}, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_tree_close(grads, _np(jgrads))
    # the JAX train step's tail (clip, schedule, Adam) on those gradients
    opt_init, opt_update = jax_optim.make_optimizer(jrun.train)
    jts = jax_train_step.TrainState(model["jparams"], model["jkstate"],
                                    opt_init(model["jparams"]),
                                    jnp.asarray(0, jnp.int32), None)
    jts2, _ = jax_train_step._finish_step(
        jrun.train, jax_schedule.make_schedule(jrun.train,
                                               jrun.model.d_model),
        opt_update, jts, jgrads, model["jkstate"], {}, None)
    ts2, m = train_step.make_train_step(run)(
        train_state_from_jax(_np(jts)), {"tokens": torch.from_numpy(
            batch["tokens"])})
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    # Adam's first step moves an element by about the rate whatever its
    # gradient's size, so where a gradient element is fp32 cancellation
    # noise (the two packages agree on it to less than 1e-3 of itself) its
    # parameter may differ by twice the rate; such elements are rare
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


def test_remat_policies_give_the_same_gradients():
    """remat "full" and "save_dots" (each group checkpointed, the chunks'
    own checkpoints nested inside) give the gradients of "none"."""
    cfg = reduced_config(ARCH)
    params, kstate = init_model(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 70)))
    grads = []
    for remat in ("none", "full", "save_dots"):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        lg, _ = apply_model(tree_unflatten(params, leaves), kstate,
                            {"tokens": toks}, cfg, remat=remat)
        grads.append(torch.autograd.grad(lg.square().mean(), leaves))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_prefill_and_decode_match_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    toks = model["tokens"]
    jcache = jax_serving.init_cache(jcfg, B, N + STEPS)
    jlog, jcache = jax_serving.prefill(
        model["jparams"], model["jkstate"], jcache,
        {"tokens": jnp.asarray(toks[:, :N])}, jcfg)
    cache = serving.init_cache(cfg, B, N + STEPS, device="cpu")
    log, cache = serving.prefill(model["params"], model["kstate"], cache,
                                 {"tokens": torch.from_numpy(toks[:, :N])},
                                 cfg)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=TOL)
    assert_tree_close(cache, _np(jcache))
    jstep = jax.jit(jax_serving.make_serve_step(jcfg))
    step = serving.make_serve_step(cfg)
    for t in range(STEPS):
        pos = np.full((B,), N + t, np.int32)
        jl, jcache = jstep(model["jparams"], model["jkstate"], jcache,
                           jnp.asarray(toks[:, N + t]), jnp.asarray(pos))
        lg, cache = step(model["params"], model["kstate"], cache,
                         torch.from_numpy(toks[:, N + t]),
                         torch.from_numpy(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL)
        assert_tree_close(cache, _np(jcache))
    assert serving.decode_cache_layouts(cfg, platform="cpu") == set()
    assert serving.decode_backends(cfg, platform="cpu") == {}


# ---------------------------------------------------------------------------
# the engine, on the JAX package's hybrid engine test schedule
# ---------------------------------------------------------------------------
ENG = dict(name="eng-s", family="ssm", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64, ssm_state=16,
           ssm_chunk=8, position="none", tie_embeddings=True,
           dtype="float32")


def _requests(cls):
    rng = np.random.RandomState(5)
    return [cls(uid=i, prompt=rng.randint(0, 64, size=6 + 2 * i).tolist(),
                max_new_tokens=4 + i) for i in range(3)]


def test_engine_ssm_family_matches_jax():
    jcfg, cfg = JaxModelConfig(**ENG), ModelConfig(**ENG)
    jparams, jkstate = jax_init_model(jcfg, jax.random.PRNGKey(1))
    jeng = JaxEngine(jcfg, jparams, jkstate, max_slots=2, max_len=32,
                     record_logits=True)
    jout = jeng.run(_requests(JaxRequest))
    jeng.close()
    eng = InferenceEngine(cfg, params_from_jax(_np(jparams)),
                          kstate_from_jax(_np(jkstate)), max_slots=2,
                          max_len=32, record_logits=True, device="cpu")
    out = eng.run(_requests(Request))
    assert out == jout
    for uid, rows in jeng.logits_trace.items():
        assert len(eng.logits_trace[uid]) == len(rows)
        for a, b in zip(eng.logits_trace[uid], rows):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    assert eng.attn_backends == {}
    assert all(s is None for s in eng.slots)
    for seg in eng.pool:
        for layer in seg.values():
            assert not any(leaf.any() for leaf in layer.values())


def test_the_launcher_trains_the_reduced_model_and_interop_keeps_dtypes(
        capsys):
    from repro.configs.base import with_overrides as jax_with_overrides
    from repro_torch.launch import train as launcher
    from test_torch_hybrid import assert_dtypes_equal
    out = launcher.main(["--arch", ARCH, "--reduced", "--steps", "2",
                         "--batch", "2", "--seq", "32", "--device", "cpu"])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert "arch=mamba2-780m" in capsys.readouterr().out
    jcfg = jax_with_overrides(jax_reduced_config(ARCH), dtype="bfloat16")
    got = params_from_jax(_np(jax_init_model(jcfg,
                                             jax.random.PRNGKey(0))[0]))
    mine, _ = init_model(with_overrides(reduced_config(ARCH),
                                        dtype="bfloat16"), device="cpu")
    assert got["stack"][0][0]["mixer"]["A_log"].dtype == torch.float32
    assert got["stack"][0][0]["mixer"]["in_proj"].dtype == torch.bfloat16
    assert_dtypes_equal(got, mine)


def test_a_model_axis_on_the_family_is_refused():
    with pytest.raises(NotImplementedError, match="12b"):
        sharding.head_groups(reduced_config(ARCH), 2)
    with pytest.raises(NotImplementedError, match="12b"):
        serving.init_cache(reduced_config(ARCH), 2, 16, device="cpu",
                           mesh=_ModelAxisOf2())


class _ModelAxisOf2:
    """A stand-in mesh with a model axis of 2 and a data axis of 1."""
    axis_names = ("data", "model")

    def size(self, axis):
        return 2 if axis == "model" else 1
