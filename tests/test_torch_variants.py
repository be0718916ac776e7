"""The ``local`` and ``routing`` variants: reduced rt-cifar10 in the port
against the JAX package.

Two stacks of the JAX registry's rt-cifar10 (`configs/paper.py`), cut by
``reduced_config`` and given the same overrides on both sides:

* ``mixed``: ``routing_layers=(L-1,)``, so a ``local`` layer and a
  ``local+routing`` layer meet in one stack (the full config has layers
  0-7 ``local`` and 8-11 ``local+routing``);
* ``routing``: every head routing on every layer (the paper's all-routing
  row, ``cifar10(routing_heads=8, routing_layers=12)``), which collapses
  to the ``routing`` variant.

The routing window is cut to 16 tokens (4 clusters of a 64-token
sequence), so that membership matters. Checked on the CPU, fp32:

* the variant collapse of `spec_for_layer` against the JAX package's, on
  the full configs of the ablation grid;
* `interop` carries the JAX parameters and per-layer centroids across
  (``local`` layers hold none, in both);
* one forward and one train step (`make_train_step`, Adam, remat "full")
  against the JAX package, with ``impl=None`` on both sides and with the
  JAX package's forced ``impl="pallas"`` (its Pallas kernels in interpret
  mode) against the port's forced ``impl="cuda_gathered"`` (the kernel
  glue with the plain versions under it);
* prefill and 12 greedy decode steps against JAX `serving`, token for
  token, the port on its plain path and forced onto its kernel path;
* the prefill fills its cache from the keys, routing vectors and centroid
  scores its attention computed: the same cache as from those recomputed,
  and the same logits as a forward without a cache;
* the routing scatter adds a token's cluster copies in a fixed order, and
  ``chip_smoke.py``'s routing gate refuses a backward that changes from
  run to run (its ``repeat`` reading).

Tolerances: logits, losses, parameters and float cache leaves 2e-5
absolute, gradients 1e-5 relative to each leaf's largest entry (two
frameworks summing the same fp32 products in other orders), except a
parameter whose gradient is fp32 noise, which Adam's first step may move
by the rate either way (see `test_train_step_matches_jax`); integer cache
leaves and greedy tokens exactly equal.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.attn import spec as jax_spec
from repro.configs import paper as jax_paper
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.base import with_overrides as jax_with_overrides
from repro.data import synthetic as jax_synthetic
from repro.models import model as jax_model
from repro.serve import serving as jax_serving
from repro.train import train_step as jax_train_step
from repro_torch import attn
from repro_torch.attn import spec as port_spec
from repro_torch.attn.backends import Prefix
from repro_torch.configs import paper, reduced_config, with_overrides
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.core.kmeans import cluster_scores, normalize_routing
from repro_torch.interop import (kstate_from_jax, params_from_jax,
                                 train_state_from_jax, tree_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models.model import apply_model
from repro_torch.serve import serving
from repro_torch.train import train_step
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_train import _leaf_close

ARCH = "rt-cifar10"
B, S, STEPS = 2, 64, 12
TOL = 2e-5
GRAD_TOL = 1e-5
INT_LEAVES = ("rlen", "lpos")
STACKS = ["mixed", "routing"]
# (JAX impl, port impl): auto-selection, and the forced gathered kernels
IMPLS = [(None, None), ("pallas", "cuda_gathered")]


def _overrides(stack):
    """The routing overrides of a stack, the same on both sides."""
    L = reduced_config(ARCH).num_layers
    if stack == "mixed":
        return dict(routing_layers=(L - 1,), window=16)
    return dict(routing_layers=(), routing_heads=4, window=16)


def _cfgs(stack):
    jc, pc = jax_reduced_config(ARCH), reduced_config(ARCH)
    ov = _overrides(stack)
    return (jax_with_overrides(jc, routing=jax_with_overrides(jc.routing,
                                                              **ov)),
            with_overrides(pc, routing=with_overrides(pc.routing, **ov)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, n=B, s=S):
    return np.random.default_rng(seed).integers(0, 128, (n, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    for g, w in zip(tree_leaves(tree_to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=0,
                                   atol=tol)


@pytest.fixture(scope="module", params=STACKS)
def jax_init(request):
    jcfg, cfg = _cfgs(request.param)
    params, kstate = jax.jit(lambda k: jax_model.init_model(jcfg, k))(
        jax.random.PRNGKey(3))
    return dict(stack=request.param, jcfg=jcfg, cfg=cfg, params=_np(params),
                kstate=_np(kstate))


# ---------------------------------------------------------------------------
# configs, specs, interop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,variants", [
    ({}, ["local"] * 8 + ["local+routing"] * 4),
    ({"routing_heads": 0}, ["local"] * 12),
    ({"routing_heads": 8, "routing_layers": 12}, ["routing"] * 12),
    ({"routing_heads": 2, "routing_layers": 2},
     ["local"] * 10 + ["local+routing"] * 2)],
    ids=["default", "no-routing", "all-routing", "r2x2"])
def test_variant_collapse_matches_jax(kw, variants):
    """0 routing heads -> local, all heads routing -> routing, layers
    outside routing_layers -> local, as in the JAX package (full configs
    of the Table 1 grid)."""
    jcfg, cfg = jax_paper.cifar10(**kw), paper.cifar10(**kw)
    got = []
    for i in range(cfg.num_layers):
        jv = jax_spec.variant_for_layer(jcfg, i)
        assert port_spec.variant_for_layer(cfg, i) == jv
        js = jax_spec.spec_for_layer(jcfg, jv)
        ps = port_spec.spec_for_layer(cfg, jv)
        assert (ps.variant, ps.num_heads, ps.window, ps.routing_heads) == \
            (js.variant, js.num_heads, js.window, js.routing_heads)
        got.append(ps.variant)
    assert got == variants


def test_a_stack_with_local_layers_runs_a_forward():
    """Reduced rt-cifar10 with a ``local`` layer below a routing layer:
    before the ``local`` variant was registered, its forward raised
    BackendResolutionError."""
    _, cfg = _cfgs("mixed")
    assert [port_spec.variant_for_layer(cfg, i)
            for i in range(cfg.num_layers)] == ["local", "local+routing"]
    from repro_torch.models.model import init_model
    params, kstate = init_model(cfg, seed=0, device="cpu")
    assert kstate[0] == {} and kstate[1]["0"].shape[1:] == (2, 4, 16)
    for impl in (None, "cuda", "cuda_gathered"):
        logits, new_k = apply_model(params, kstate, {
            "tokens": torch.from_numpy(_tokens(0))}, cfg, impl=impl)
        assert logits.shape == (B, S, cfg.padded_vocab)
        assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
        assert new_k[0] == {}


def test_interop_carries_params_and_centroids(jax_init):
    params = params_from_jax(jax_init["params"])
    kstate = kstate_from_jax(jax_init["kstate"])
    _close(params, jax_init["params"], 0.0)
    _close(kstate, jax_init["kstate"], 0.0)
    jleaves = jax.tree_util.tree_flatten_with_path(jax_init["kstate"])[0]
    assert [tuple(w.shape) for _, w in jleaves] == \
        [tuple(t.shape) for t in tree_leaves(kstate)]
    if jax_init["stack"] == "mixed":
        assert kstate[0] == {} == jax_init["kstate"][0]
        assert sorted(kstate[1]) == ["0"]
    else:
        assert kstate[0]["0"].shape[1] == jax_init["cfg"].num_heads


# ---------------------------------------------------------------------------
# forward and one train step against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jimpl,impl", IMPLS, ids=["auto", "gathered"])
def test_forward_matches_jax(jax_init, jimpl, impl):
    toks = _tokens(1)
    jl, jk, _ = jax_model.apply_model(
        jax_init["params"], jax_init["kstate"], {"tokens": toks},
        jax_init["jcfg"], impl=jimpl)
    pl, pk = apply_model(params_from_jax(jax_init["params"]),
                         kstate_from_jax(jax_init["kstate"]),
                         {"tokens": torch.from_numpy(toks)}, jax_init["cfg"],
                         impl=impl)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _close(pk, _np(jk))


@pytest.mark.parametrize("jimpl,impl", IMPLS, ids=["auto", "gathered"])
def test_train_step_matches_jax(jax_init, jimpl, impl):
    """One fp32 step of `make_train_step` (Adam, the vaswani schedule,
    clipping, remat "full") from the same state, and its gradients."""
    kw = dict(global_batch=B, seq_len=S, warmup_steps=10)
    jrun = JaxRunConfig(model=jax_init["jcfg"], train=JaxTrainConfig(**kw))
    run = RunConfig(model=jax_init["cfg"], train=TrainConfig(**kw))
    batch = next(jax_synthetic.SyntheticLoader("markov", 128, B, S, seed=4))
    jts = _np(jax_train_step.init_train_state(jrun, jax.random.PRNGKey(5)))

    vg = jax.value_and_grad(jax_train_step.make_loss_fn(jrun, impl=jimpl),
                            has_aux=True)
    (jloss, _), jgrads = vg(jts.params, jts.kstate, batch, None)
    pvg = train_step.value_and_grad(train_step.make_loss_fn(run, impl),
                                   run.model)
    pts = train_state_from_jax(jts)
    pbatch = {"tokens": torch.from_numpy(batch["tokens"])}
    (ploss, _), pgrads = pvg(pts.params, pts.kstate, pbatch, None)
    assert float(ploss) == pytest.approx(float(jloss), abs=TOL)
    _leaf_close(pgrads, _np(jgrads), GRAD_TOL)

    jts1, jm = jax.jit(jax_train_step.make_train_step(jrun, impl=jimpl))(
        jts, batch)
    pts1, pm = train_step.make_train_step(run, impl)(pts, pbatch)
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=TOL)
    assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    # Adam's first step moves each element by about the rate whatever its
    # gradient's size, so where the gradient is fp32 noise (the two sides
    # disagree on it by more than 1e-3 of it; under 0.1% of elements) the
    # two steps may part by twice the rate
    noisy = [np.abs(g - w) > 1e-3 * np.abs(w) for g, w in zip(
        tree_leaves(tree_to_numpy(pgrads)), jax.tree.leaves(_np(jgrads)))]
    assert sum(n.sum() for n in noisy) <= 1e-3 * sum(n.size for n in noisy)
    lr = float(pm["lr"])
    for n, g, w in zip(noisy, tree_leaves(tree_to_numpy(pts1.params)),
                       jax.tree.leaves(_np(jts1.params))):
        assert (np.abs(g - w) <= np.where(n, 2 * lr, TOL)).all()
    _close(pts1.kstate, _np(jts1.kstate))


def test_only_the_unread_key_projection_gets_a_zero_gradient(jax_init):
    """`unread_leaves` flags the key projection of the all-routing stack
    (shared-QK: its keys are its queries) and nothing of the mixed one; a
    leaf the loss does not use and the config does not flag raises."""
    run = RunConfig(model=jax_init["cfg"],
                    train=TrainConfig(global_batch=B, seq_len=S))
    pts = train_state_from_jax(_np(jax_train_step.init_train_state(
        JaxRunConfig(model=jax_init["jcfg"],
                     train=JaxTrainConfig(global_batch=B, seq_len=S)),
        jax.random.PRNGKey(5))))
    flags = tree_unflatten(pts.params,
                           train_step.unread_leaves(pts.params, run.model))
    flagged = [(i, name) for i, seg in enumerate(flags["stack"])
               for layer in seg for name, f in layer["attn"].items() if f]
    want = ([(i, "wk") for i in range(len(flags["stack"]))]
            if jax_init["stack"] == "routing" else [])
    assert flagged == want
    assert sum(tree_leaves(flags)) == len(want)

    loss_fn = train_step.make_loss_fn(run)
    # a second embedding the loss never reads, which no config flags
    params = dict(pts.params, spare=torch.zeros(3))
    batch = {"tokens": torch.from_numpy(_tokens(6, s=S + 1))}
    with pytest.raises(RuntimeError, match="not used by the loss"):
        train_step.value_and_grad(
            lambda p, *a: loss_fn({k: v for k, v in p.items()
                                   if k != "spare"}, *a),
            run.model)(params, pts.kstate, batch, None)


# ---------------------------------------------------------------------------
# serving against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_serve(jax_init):
    cfg = jax_init["jcfg"]
    prompt = _tokens(2)
    cache = jax_serving.init_cache(cfg, B, S + STEPS)
    logits, cache = jax.jit(lambda p, k, c, b: jax_serving.prefill(
        p, k, c, b, cfg))(jax_init["params"], jax_init["kstate"], cache,
                          {"tokens": prompt})
    out = dict(prompt=prompt, prefill_logits=np.asarray(logits),
               prefill_cache=_np(cache))
    step = jax.jit(jax_serving.make_serve_step(cfg))
    tok = np.asarray(logits[:, -1].argmax(-1))
    toks, step_logits = [], []
    for t in range(STEPS):
        lg, cache = step(jax_init["params"], jax_init["kstate"], cache, tok,
                         np.full((B,), S + t, np.int32))
        step_logits.append(np.asarray(lg))
        tok = np.asarray(lg.argmax(-1))
        toks.append(tok)
    out.update(tokens=np.stack(toks, 1), step_logits=np.stack(step_logits, 1),
               final_cache=_np(cache))
    return out


def _assert_cache_match(jc, pc):
    assert len(jc) == len(pc)
    for js, ps in zip(jc, pc):
        assert sorted(js) == sorted(ps)
        for layer in js:
            assert sorted(js[layer]) == sorted(ps[layer])
            for leaf, jv in js[layer].items():
                pv = ps[layer][leaf]
                assert pv.shape == jv.shape, (leaf, pv.shape, jv.shape)
                if leaf in INT_LEAVES:
                    np.testing.assert_array_equal(pv, jv, err_msg=leaf)
                else:
                    np.testing.assert_allclose(pv, jv, atol=TOL, rtol=0,
                                               err_msg=leaf)


@pytest.mark.parametrize("impl", [None, "cuda"], ids=["auto-torch",
                                                      "forced-cuda"])
def test_prefill_and_greedy_decode_match_jax(jax_init, jax_serve, impl):
    cfg = jax_init["cfg"]
    params = params_from_jax(jax_init["params"])
    kstate = kstate_from_jax(jax_init["kstate"])
    cache = serving.init_cache(cfg, B, S + STEPS, device="cpu")
    logits, cache = serving.prefill(
        params, kstate, cache, {"tokens": torch.from_numpy(
            jax_serve["prompt"])}, cfg, impl=impl)
    np.testing.assert_allclose(logits.numpy(), jax_serve["prefill_logits"],
                               atol=TOL, rtol=0)
    _assert_cache_match(jax_serve["prefill_cache"], tree_to_numpy(cache))
    step = serving.make_serve_step(cfg, impl=impl)
    tok = logits[:, -1].argmax(-1)
    toks, step_logits = [], []
    for t in range(STEPS):
        lg, cache = step(params, kstate, cache, tok, torch.full((B,), S + t))
        step_logits.append(lg.numpy())
        tok = lg.argmax(-1)
        toks.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(toks, 1), jax_serve["tokens"])
    np.testing.assert_allclose(np.stack(step_logits, 1),
                               jax_serve["step_logits"], atol=TOL, rtol=0)
    _assert_cache_match(jax_serve["final_cache"], tree_to_numpy(cache))


def test_prefill_fills_from_what_its_attention_computed(jax_init,
                                                        monkeypatch):
    """Each layer's prefill fills its cache from the roped keys, routing
    vectors and centroid scores its attention computed: the cache equals
    the one filled from those recomputed from the layer's q/k/v (bitwise),
    and the prefill logits equal the forward's without a cache (bitwise)."""
    cfg = jax_init["cfg"]
    params = params_from_jax(jax_init["params"])
    kstate = kstate_from_jax(jax_init["kstate"])
    toks = torch.from_numpy(_tokens(6))
    calls = []
    attend = attn.attend

    def spy(spec, q, k, v, **kw):
        out = attend(spec, q, k, v, **kw)
        if kw.get("fill") is not None:
            calls.append((spec, q, k, v, kw, out.cache))
        return out
    monkeypatch.setattr(attn, "attend", spy)
    cache = serving.init_cache(cfg, B, S, device="cpu")
    logits, _ = serving.prefill(params, kstate, cache, {"tokens": toks}, cfg)
    monkeypatch.undo()
    ref, _ = apply_model(params, kstate, {"tokens": toks}, cfg)
    assert torch.equal(logits, ref)
    assert len(calls) == cfg.num_layers
    for spec, q, k, v, kw, filled in calls:
        pos = kw["positions"]
        ring = pages = None
        if "local" in spec.variant:
            Hl = spec.num_heads - spec.routing_heads if spec.routing_heads \
                else spec.num_heads
            kl = k[:, :Hl]
            ring = (L.apply_rope(kl, pos, spec.rope_theta), v[:, :Hl])
        if "routing" in spec.variant:
            Hr = spec.routing_heads or spec.num_heads
            r = normalize_routing(q[:, -Hr:])
            pages = (r, cluster_scores(r, kw["state"]), v[:, -Hr:])
        layout = attn.resolve(spec, decode=True, platform="cpu").layout
        want = layout.fill(kw["fill"], Prefix(ring=ring, pages=pages),
                           positions=pos)
        assert sorted(want) == sorted(filled)
        for leaf in want:
            assert torch.equal(want[leaf], filled[leaf]), leaf


# ---------------------------------------------------------------------------
# the routing scatter and chip_smoke's repeat gate
# ---------------------------------------------------------------------------
def test_scatter_add_rows_adds_copies_in_cluster_order():
    """`scatter_add_rows` adds a token's per-cluster copies in cluster
    order, the same in every run (a stable sort by row and a segmented
    sum, where index_add_ on the card adds them by atomics in an order
    that changes from run to run): bitwise the sum built one cluster at a
    time, and the transpose of the gather."""
    from repro_torch.core import routing
    rng = np.random.default_rng(8)
    Bq, Hq, N, kc, w, d = 2, 3, 40, 5, 16, 8
    idx = torch.from_numpy(np.sort(np.stack([
        rng.choice(N, w, replace=False) for _ in range(Bq * Hq * kc)]),
        -1).reshape(Bq, Hq, kc, w))
    og = torch.from_numpy(rng.standard_normal(
        (Bq, Hq, kc, w, d)).astype(np.float32))
    got = routing.scatter_add_rows(og, idx, N)
    want = torch.zeros(Bq, Hq, N, d)
    for c in range(kc):         # one cluster's rows are distinct
        want.scatter_add_(2, idx[:, :, c, :, None].expand(-1, -1, -1, d),
                          og[:, :, c])
    assert torch.equal(got, want)
    x = torch.randn(Bq, Hq, N, d, requires_grad=True)
    (routing._gather_rows(x, idx) * og).sum().backward()
    torch.testing.assert_close(x.grad, got, rtol=1e-6, atol=1e-6)


def test_repeat_gate_refuses_a_run_dependent_backward(monkeypatch):
    """chip_smoke's routing gate reads the kernel path against itself run
    again (``repeat``) and fails when it moves by more than its limit: on
    reduced rt-enwik8 (the kernel glue on the CPU) a sound backward reads
    0.0 and passes; one whose scatter adds a run-dependent relative error
    of 1e-3, as atomics summing in another order would at a larger
    scale, is refused for its repeat reading."""
    from repro_torch.core import routing
    from repro_torch.models.model import init_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cfg = reduced_config("rt-enwik8")
    params, kstate = init_model(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(next(jax_synthetic.SyntheticLoader(
        "markov", 128, B, S, seed=3))["tokens"])}
    limits = chip_smoke.ENWIK8_LIMITS
    out = chip_smoke.routing_gate(torch, cfg, params, kstate, batch, limits,
                                  impl="cuda")
    assert out["repeat"]["grad_rel_median"] == 0.0
    assert chip_smoke.gate_failures(out, limits) == []
    noisy = dict(out, repeat=dict(out["repeat"], grad_rel_median=2e-4))
    assert chip_smoke.gate_failures(noisy, limits) == [
        f"repeat.grad_rel_median 0.0002 > {limits['repeat']}"]

    scatter = routing.scatter_add_rows
    gen = torch.Generator().manual_seed(0)

    def run_dependent(og, idx, n):
        out = scatter(og, idx, n)
        return out * (1 + 1e-3 * torch.randn(out.shape, generator=gen))
    monkeypatch.setattr(routing, "scatter_add_rows", run_dependent)
    with pytest.raises(AssertionError, match="repeat.grad_rel_median"):
        chip_smoke.routing_gate(torch, cfg, params, kstate, batch, limits,
                                impl="cuda")
