"""Slice parity: the hybrid family (recurrentgemma-9b: RG-LRU and local
attention, 2:1) in the port against the JAX package, on the CPU in fp32.

* The RG-LRU pieces (`models.rglru`): `rglru_scan`, `rglru_fused` and
  `rglru_naive` from a carried state ``h0``, across chunk boundaries, and
  `apply_rglru` with its conv and recurrent states carried across two
  calls, against the JAX functions. The port's chunk runs a Hillis-Steele
  scan where JAX runs ``lax.associative_scan``: the pairs combine in
  another order, so they agree to fp32 rounding (SCAN_TOL).
* Reduced recurrentgemma-9b (one (rglru, rglru, attn) group and a tail of
  one rglru layer, lru width 64, local window 32) with the JAX weights
  (`repro_torch.interop`): `apply_model` logits, one train step's loss
  and gradients (`value_and_grad` of the loss) and the parameters after
  one `make_train_step` step (Adafactor, as the card trains it), and a
  prefill of a 40-token prompt then 4 decode tokens: the logits and every
  cache leaf against the JAX package's `prefill` / `make_serve_step`.
* The segments of the full config: 12 pattern groups and a tail of two
  rglru layers (JAX ``tests/test_models.py::test_hybrid_tail``).
* The engine on the JAX package's own hybrid engine test config and
  schedule (``tests/test_engine.py::test_engine_hybrid_family``: 3
  layers, window 8, 2 slots of 32), tokens equal and recorded logits
  within TOL of the JAX engine's.
* The local kernel at dh 256, its plain version against the Pallas kernel
  in interpret mode (out within 2^-8 of its largest value, lse 1e-5, as
  tests/test_torch_local_fwd_tiles.py holds the narrower widths); the
  kernel widths (`common.padded_head_dim`): the local kernels take 256,
  the fused routing and decode kernels refuse it; a routing spec at dh
  256 (`with_routing(recurrentgemma-9b)`) is refused on the card when it
  resolves, before any launch, where its local spec resolves to the
  kernels; a model axis on the family is refused (ROADMAP item 12b).

Tolerances: logits, gradients and float cache leaves TOL (2e-5) absolute,
the serving tests' fp32 tolerance (two frameworks summing the same fp32
products in other orders); the scans SCAN_TOL (1e-5).
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
from repro.kernels import local_attention as jax_local_kernel
from repro.models import rglru as jax_rglru
from repro.models.model import apply_model as jax_apply_model
from repro.models.model import init_model as jax_init_model
from repro.serve import serving as jax_serving
from repro.optim import schedule as jax_schedule
from repro.serve.engine import InferenceEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.train import train_step as jax_train_step
from repro_torch import attn
from repro_torch.attn import BackendResolutionError
from repro_torch.configs import (get_config, reduced_config, with_routing)
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig
from repro_torch.dist import sharding
from repro_torch.interop import (kstate_from_jax, params_from_jax,
                                 train_state_from_jax)
from repro_torch.kernels import common
from repro_torch.kernels import local_attention as local_k
from repro_torch.models import rglru
from repro_torch.models.model import apply_model
from repro_torch.models.transformer import build_segments
from repro_torch.serve import serving
from repro_torch.serve.engine import InferenceEngine, Request
from repro_torch.train import train_step

ARCH = "recurrentgemma-9b"
TOL = 2e-5
SCAN_TOL = 1e-5
B, N, STEPS = 2, 40, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_close(got, want, tol=TOL, path="tree"):
    """Port tree ``got`` against JAX tree ``want`` key by key (dict order
    differs between the packages): float leaves within ``tol``, integer
    leaves equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, tol, f"{path}/{i}")
    else:
        w = np.asarray(want)
        g = got.detach().float().numpy() if w.dtype.kind == "f" else \
            got.numpy()
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# the RG-LRU pieces
# ---------------------------------------------------------------------------
def _ab(S, w=8, seed=0):
    rng = np.random.RandomState(seed)
    a = 1 / (1 + np.exp(-rng.randn(2, S, w))).astype(np.float32)
    return a.astype(np.float32), rng.randn(2, S, w).astype(np.float32), \
        rng.randn(2, w).astype(np.float32)


@pytest.mark.parametrize("S,chunk", [(16, 512), (100, 32), (64, 16)])
def test_rglru_scan_and_naive_match_jax(S, chunk):
    a, b, h0 = _ab(S)
    want = np.asarray(jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(h0), chunk=chunk))
    ta, tb, th = map(torch.from_numpy, (a, b, h0))
    np.testing.assert_allclose(
        rglru.rglru_scan(ta, tb, th, chunk=chunk).numpy(), want,
        atol=SCAN_TOL)
    np.testing.assert_allclose(rglru.rglru_naive(ta, tb, th).numpy(), want,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(rglru.rglru_scan(ta, tb, chunk=chunk).numpy(),
                               np.asarray(jax_rglru.rglru_naive(
                                   jnp.asarray(a), jnp.asarray(b))),
                               atol=SCAN_TOL)


@pytest.fixture(scope="module")
def mixer():
    jcfg = jax_reduced_config(ARCH)
    p = _np(jax_rglru.init_rglru(jax.random.PRNGKey(3), jcfg))
    x = np.random.RandomState(4).randn(2, 37, jcfg.d_model).astype(
        np.float32)
    return dict(cfg=reduced_config(ARCH), jcfg=jcfg, p=p, x=x)


def test_rglru_fused_matches_jax(mixer):
    jp, cfg = mixer["p"], mixer["cfg"]
    u = np.random.RandomState(5).randn(2, 70, cfg.lru_width).astype(
        np.float32)
    h0 = np.random.RandomState(6).randn(2, cfg.lru_width).astype(np.float32)
    want = np.asarray(jax_rglru.rglru_fused(jp, jnp.asarray(u),
                                            jnp.asarray(h0), chunk=32))
    got = rglru.rglru_fused(params_from_jax(jp), torch.from_numpy(u),
                            torch.from_numpy(h0), chunk=32)
    np.testing.assert_allclose(got.numpy(), want, atol=SCAN_TOL)


def test_apply_rglru_carries_its_states_as_jax(mixer):
    """Two calls (the second from the first's conv and h states) against
    JAX's same two calls, and against one call over the whole sequence;
    the decode path (step recurrence) too."""
    jp, p, x = mixer["p"], params_from_jax(mixer["p"]), mixer["x"]
    jcfg, cfg = mixer["jcfg"], mixer["cfg"]
    jy1, (jc, jh) = jax_rglru.apply_rglru(jp, jnp.asarray(x[:, :20]), jcfg)
    jy2, (jc2, jh2) = jax_rglru.apply_rglru(jp, jnp.asarray(x[:, 20:]), jcfg,
                                            conv_state=jc, h_state=jh)
    ty1, (tc, th) = rglru.apply_rglru(p, torch.from_numpy(x[:, :20]), cfg)
    ty2, (tc2, th2) = rglru.apply_rglru(p, torch.from_numpy(x[:, 20:]), cfg,
                                        conv_state=tc, h_state=th)
    for g, w in ((ty1, jy1), (ty2, jy2), (tc2, jc2), (th2, jh2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    whole, _ = rglru.apply_rglru(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(torch.cat([ty1, ty2], 1).numpy(),
                               whole.numpy(), atol=TOL)
    assert th2.dtype == torch.float32 and tc2.shape == (2, 3,
                                                         cfg.lru_width)
    jd, _ = jax_rglru.apply_rglru(jp, jnp.asarray(x[:, 20:21]), jcfg,
                                  conv_state=jc, h_state=jh, decode=True)
    td, _ = rglru.apply_rglru(p, torch.from_numpy(x[:, 20:21]), cfg,
                              conv_state=tc, h_state=th, decode=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL)


def test_rglru_gates_keep_fp32_leaves():
    from repro_torch.configs import with_overrides
    cfg = with_overrides(reduced_config(ARCH), dtype="bfloat16")
    p = rglru.init_rglru(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k for k, v in p.items() if v.dtype == torch.float32} == {
        "w_a", "w_x", "b_a", "b_x", "lam"}


# ---------------------------------------------------------------------------
# reduced recurrentgemma-9b against the JAX package
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


def test_reduced_config_and_segments():
    cfg = reduced_config(ARCH)
    assert (cfg.num_layers, cfg.lru_width, cfg.d_ff) == (4, 64, 128)
    assert [(tuple(s.kind for s in pat), g)
            for pat, g in build_segments(cfg)] == [
        (("rglru", "rglru", "attn"), 1), (("rglru",), 1)]
    # the full config: 12 groups and a tail of (rglru, rglru)
    segs = build_segments(get_config(ARCH))
    assert segs[0][1] == 12 and [s.kind for s in segs[1][0]] == [
        "rglru", "rglru"] and segs[1][1] == 1
    assert segs[0][0][2].attn == "local"


def test_logits_match_jax(model):
    toks = model["tokens"][:, :N]
    want, _, _ = jax_apply_model(model["jparams"], model["jkstate"],
                                 {"tokens": jnp.asarray(toks)}, model["jcfg"])
    got, _ = apply_model(model["params"], model["kstate"],
                         {"tokens": torch.from_numpy(toks)}, model["cfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _runs(model, optimizer="adafactor"):
    kw = dict(global_batch=B, seq_len=N - 1, warmup_steps=10,
              optimizer=optimizer)
    return (JaxRunConfig(model=model["jcfg"], train=JaxTrainConfig(**kw)),
            RunConfig(model=model["cfg"], train=TrainConfig(**kw)))


def test_train_step_matches_jax(model):
    jrun, run = _runs(model)
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
    # the JAX train step's tail (clip, schedule, optimizer) on those
    # gradients: its step, with the one compile above
    jts = jax_train_step.TrainState(
        model["jparams"], model["jkstate"],
        jax_optim.make_optimizer(jrun.train)[0](model["jparams"]),
        jnp.asarray(0, jnp.int32), None)
    jts2, _ = jax_train_step._finish_step(
        jrun.train, jax_schedule.make_schedule(jrun.train,
                                               jrun.model.d_model),
        jax_optim.make_optimizer(jrun.train)[1], jts, jgrads,
        model["jkstate"], {}, None)
    ts2, m = train_step.make_train_step(run)(
        train_state_from_jax(_np(jts)), {"tokens": torch.from_numpy(
            batch["tokens"])})
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert_tree_close(ts2.params, _np(jts2.params))


def test_prefill_and_decode_match_jax(model):
    """A 40-token prompt then 4 greedy-fed tokens (the same inputs on both
    sides): the prefill and step logits and, after each, every cache leaf
    (the ring's keys, values and positions, the RG-LRU's conv and h)."""
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


def test_inactive_lane_keeps_its_recurrent_state(model):
    cfg = model["cfg"]
    cache = serving.init_cache(cfg, B, N + STEPS, device="cpu")
    _, cache = serving.prefill(model["params"], model["kstate"], cache,
                               {"tokens": torch.from_numpy(
                                   model["tokens"][:, :N])}, cfg)
    step = serving.make_serve_step(cfg)
    _, new = step(model["params"], model["kstate"], cache,
                  torch.from_numpy(model["tokens"][:, N]),
                  torch.full((B,), N), active=torch.tensor([True, False]))
    for seg_new, seg_old in zip(new, cache):
        for i in seg_old:
            for leaf in seg_old[i]:
                assert torch.equal(new_l := seg_new[i][leaf][:, 1],
                                   seg_old[i][leaf][:, 1]), leaf
                assert new_l.dtype == seg_old[i][leaf].dtype


# ---------------------------------------------------------------------------
# the engine on the JAX package's hybrid engine test
# ---------------------------------------------------------------------------
ENG = dict(name="eng-h", family="hybrid", num_layers=3, d_model=64,
           num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=64,
           attention="local", attn_window=8,
           hybrid_pattern=("rglru", "rglru", "attn"), dtype="float32")


def _requests(cls):
    rng = np.random.RandomState(5)
    return [cls(uid=i, prompt=rng.randint(0, 64, size=6 + 2 * i).tolist(),
                max_new_tokens=4 + i) for i in range(3)]


def test_engine_hybrid_family_matches_jax():
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
    assert eng.attn_backends == {"local": "local/torch(ring)"}
    # a freed lane's recurrent leaves are back at zero
    assert all(s is None for s in eng.slots)
    for seg in eng.pool:
        for layer in seg.values():
            for name in ("conv", "h"):
                if name in layer:
                    assert not layer[name].any()


# ---------------------------------------------------------------------------
# the local kernel at dh 256, and what the card refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
def test_local_plain_at_dh256_matches_pallas(causal):
    rng = np.random.RandomState(7)
    q = rng.randn(1, 4, 64, 256).astype(np.float32)
    k, v = (rng.randn(1, 1, 64, 256).astype(np.float32) for _ in range(2))
    j_out, j_lse = jax_local_kernel._fwd_call(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), 32, causal,
                                              True)
    out, lse = local_k.local_attention(*map(torch.from_numpy, (q, k, v)),
                                       32, causal)
    j_out = np.asarray(j_out)
    assert np.abs(out.numpy() - j_out).max() <= 2 ** -8 * np.abs(
        j_out).max()
    np.testing.assert_allclose(lse.numpy().reshape(-1, 64),
                               np.asarray(j_lse).reshape(-1, 64), atol=1e-5)


def test_kernel_widths_by_family():
    assert [common.padded_head_dim("t", d, common.LOCAL_HEAD_DIMS)
            for d in (64, 129, 192, 193, 256)] == [64, 192, 192, 256, 256]
    with pytest.raises(ValueError, match="widest instance \\(256\\)"):
        common.padded_head_dim("t", 257, common.LOCAL_HEAD_DIMS)
    # the fused routing and decode kernels stop at 192
    with pytest.raises(ValueError, match="widest instance \\(192\\)"):
        common.padded_head_dim("t", 256)
    (p,) = common.pad_heads("t", 200, torch.ones(1, 200),
                            widths=common.LOCAL_HEAD_DIMS)
    assert p.shape == (1, 256) and not p[:, 200:].any()


def test_a_routing_spec_at_dh256_is_refused_on_the_card():
    cfg = get_config(ARCH)
    local = attn.spec_for_layer(cfg, "local")
    assert local.head_dim == 256
    assert attn.resolve(local, positioned=True, needs_grad=True,
                        platform="cuda").name == "local/cuda"
    assert attn.resolve(local, positioned=True,
                        platform="cpu").name == "local/torch"
    rcfg = with_routing(cfg)
    for variant in ("local+routing", "routing"):
        spec = attn.spec_for_layer(rcfg, variant)
        with pytest.raises(BackendResolutionError,
                           match="head_dim 256.*widest instance is 192"):
            attn.resolve(spec, positioned=True, platform="cuda")
        with pytest.raises(BackendResolutionError, match="head_dim 256"):
            attn.resolve(spec, positioned=True, impl="cuda",
                         platform="cuda")
        with pytest.raises(BackendResolutionError, match="head_dim 256"):
            attn.init_decode_cache(spec, 1, 64, torch.bfloat16, "cuda")
        # the plain path on the CPU serves it
        assert attn.resolve(spec, platform="cpu").impl == "torch"


def test_a_model_axis_on_the_family_is_refused():
    with pytest.raises(NotImplementedError, match="12b"):
        sharding.head_groups(reduced_config(ARCH), 2)


def test_interop_keeps_the_mixers_dtypes():
    """A bf16 JAX model carried across keeps every leaf's dtype, the
    RG-LRU's fp32 gate leaves included, and the port's own init agrees
    leaf by leaf."""
    from repro.configs.base import with_overrides as jax_with_overrides
    from repro_torch.configs import with_overrides
    from repro_torch.models.model import init_model
    jcfg = jax_with_overrides(jax_reduced_config(ARCH), dtype="bfloat16")
    jparams, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    got = params_from_jax(_np(jparams))
    mine, _ = init_model(with_overrides(reduced_config(ARCH),
                                        dtype="bfloat16"), device="cpu")
    mixer = got["stack"][0][0]["mixer"]
    assert mixer["w_a"].dtype == mixer["lam"].dtype == torch.float32
    assert mixer["w_in"].dtype == torch.bfloat16
    assert_dtypes_equal(got, mine)


def assert_dtypes_equal(a, b, path="tree"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_dtypes_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert_dtypes_equal(x, y, f"{path}/{i}")
    else:
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path


def test_the_launcher_trains_the_reduced_model(capsys):
    from repro_torch.launch import train as launcher
    out = launcher.main(["--arch", ARCH, "--reduced", "--steps", "2",
                         "--batch", "2", "--seq", "32", "--device", "cpu"])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert "arch=recurrentgemma-9b" in capsys.readouterr().out
