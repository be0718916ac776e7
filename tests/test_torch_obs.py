"""Slice parity: the port's observability layer (`repro_torch.obs`) against
the JAX package's ``repro.obs``.

The same inputs (numpy, from seeds; JAX parameters carried across with
`repro_torch.interop`) go through both packages on the CPU:

* `compute_routing_stats` on identical intermediates (causal and not,
  shared and separate QK, with and without a pad mask), and
  `routed_attention(stats=True)` (update_state on and off, the plain impl
  and the fused kernels' glue): each field within 1e-5 relative in fp32,
  occupancy, dead and mismatch exactly; the outputs equal stats off bit
  for bit;
* the JAX package's invariants and its collapse control;
* `summarize` and `flatten` (keys and values), `pages_health` on the
  port's and the JAX package's prefilled caches of reduced rt-enwik8
  (exactly) and the prefill's own stats;
* one train step with stats on (the JAX package's ``_tiny_run`` config of
  ``tests/test_obs.py``): the JAX step's metric keys, ``routing/*`` and
  ``rt/*`` within 1e-4; in the port, stats on equal stats off bit for bit
  in loss, parameters and centroids (remat "none" and "full", grad
  accumulation), and the stats-off metric dict unchanged;
* the trainer's and the launcher's JSONL lines through both packages'
  validators, the launcher's Chrome trace, the schema CLI, the kernel
  spans, `profile()` and the metrics core.

The engine's records are held in `test_torch_obs_engine.py`.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.base import with_overrides as jax_with_overrides
from repro.core import routing as jax_routing
from repro.core.kmeans import KMeansState as JaxKMeansState
from repro.core.routing import balanced_topk as jax_balanced_topk
from repro.models.model import init_model as jax_init_model
from repro.obs import routing_stats as jax_rt
from repro.obs import schema as jax_schema
from repro.serve import serving as jax_serving
from repro.train import train_step as jax_train_step
from repro_torch import obs
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.configs.base import (ModelConfig, RoutingConfig, RunConfig,
                                      TrainConfig)
from repro_torch.core import routing
from repro_torch.core.kmeans import KMeansState, normalize_routing
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.interop import kstate_from_jax, params_from_jax
from repro_torch.kernels import local_attention as local_k
from repro_torch.launch import train as launcher
from repro_torch.obs import routing_stats as rt
from repro_torch.obs import schema
from repro_torch.serve import serving
from repro_torch.train import train_step
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves

STATS_TOL = 1e-5            # fp32 relative, each field
# drift is the difference of two centroid sets, each rounded by its own
# framework's EMA update: one fp32 ulp (~1.2e-7 at |mu| ~ 1) per coordinate,
# over dh 32 coordinates, bounds its absolute error near 7e-7
DRIFT_ATOL = 1e-6
STEP_TOL = 1e-4             # the train step's routing/* and rt/* metrics
EXACT = ("occupancy", "dead", "mismatch")
TINY = dict(name="obs-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            attention="local+routing", dtype="float32")


def _tiny_runs(stats: bool, **train):
    """The JAX package's ``_tiny_run`` (tests/test_obs.py) in both
    packages."""
    kw = dict(global_batch=2, seq_len=64, steps=5, lr=1e-3, **train)
    return (JaxRunConfig(model=JaxModelConfig(routing=JaxRoutingConfig(
                num_clusters=4, local_window=16, stats=stats), **TINY),
                train=JaxTrainConfig(**kw)),
            RunConfig(model=ModelConfig(routing=RoutingConfig(
                num_clusters=4, local_window=16, stats=stats), **TINY),
                train=TrainConfig(**kw)))


def _close(got, want, rel=STATS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _stats_close(got, want, rel=STATS_TOL, drift_atol=0.0):
    """Field by field; ``drift_atol`` where the two packages computed
    their own centroid updates."""
    for f in rt.RoutingStats._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if f in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f)
        elif f == "drift" and drift_atol:
            np.testing.assert_allclose(g, w, rtol=rel, atol=drift_atol)
        else:
            _close(g, w, rel)


# ---------------------------------------------------------------------------
# compute_routing_stats and routed_attention(stats=True)
# ---------------------------------------------------------------------------
def _intermediates(causal, shared, padded, B=2, H=2, N=96, dh=16, kc=4,
                   seed=0):
    """Numpy intermediates of one routing layer; the memberships come from
    the JAX package's balanced top-k on the scores."""
    rng = np.random.RandomState(seed)
    f = np.float32
    r_q = np.asarray(normalize_routing(torch.tensor(
        rng.randn(B, H, N, dh).astype(f))))
    k_attn = r_q if shared else np.asarray(normalize_routing(torch.tensor(
        rng.randn(B, H, N, dh).astype(f))))
    mu = rng.randn(H, kc, dh).astype(f)
    mu_new = (mu + 0.01 * rng.randn(H, kc, dh)).astype(f)
    scores_q = np.einsum("bhnd,hkd->bhnk", r_q, mu).astype(f)
    scores_k = np.einsum("bhnd,hkd->bhnk", k_attn, mu).astype(f)
    positions = np.broadcast_to(np.arange(N), (B, N)).astype(np.int32)
    pad = None
    if padded:
        pad = np.arange(N)[None, :] < np.array([[N], [N - 23]])
    w = N // kc
    jpad = None if pad is None else jnp.asarray(pad)
    q_idx = np.asarray(jax_balanced_topk(jnp.asarray(scores_q), w, jpad))
    k_idx = q_idx if shared else np.asarray(
        jax_balanced_topk(jnp.asarray(scores_k), w, jpad))
    return dict(r_q=r_q, k_attn=k_attn, mu_prev=mu, mu_new=mu_new,
                scores_q=scores_q, q_idx=q_idx, k_idx=k_idx,
                positions=positions, pad_mask=pad, causal=causal)


@pytest.mark.parametrize("causal,shared", [(True, True), (True, False),
                                           (False, False)],
                         ids=["causal-shared", "causal-separate",
                              "noncausal-separate"])
@pytest.mark.parametrize("padded", [False, True], ids=["nopad", "pad"])
def test_compute_routing_stats_matches_jax(causal, shared, padded):
    x = _intermediates(causal, shared, padded)
    # op by op, as the JAX package's tests run it: under jit XLA may fold
    # mismatch's division into a reciprocal product, one ulp away
    want = jax_rt.compute_routing_stats(
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in x.items()}, probes=8)
    args = {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v) for k, v in x.items()}
    if shared:
        args["k_idx"] = args["q_idx"]
    got = rt.compute_routing_stats(**args, probes=8)
    _stats_close(got, want)
    assert all(t.dtype == torch.float32 and not t.requires_grad
               for t in got)


def _routing_inputs(B=2, H=2, N=128, dh=32, kc=4, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, N, dh).astype(np.float32)
    v = rng.randn(B, H, N, dh).astype(np.float32)
    mu = rng.randn(H, kc, dh).astype(np.float32)
    mu = mu / np.linalg.norm(mu, axis=-1, keepdims=True) * np.sqrt(dh)
    return q, v, mu


@pytest.fixture(scope="module")
def jax_routed():
    q, v, mu = _routing_inputs()
    cfg = JaxRoutingConfig(num_clusters=4, stats=True)
    return {upd: jax.jit(lambda q, v, mu, upd=upd: jax_routing.routed_attention(
        q, None, v, JaxKMeansState(mu), cfg, update_state=upd))(q, v, mu)
        for upd in (True, False)}


def _port_routed(stats, update_state, impl, **inputs):
    q, v, mu = _routing_inputs(**inputs)
    return routing.routed_attention(
        torch.tensor(q, requires_grad=True), None,
        torch.tensor(v, requires_grad=True), KMeansState(torch.tensor(mu)),
        RoutingConfig(num_clusters=4, stats=stats),
        update_state=update_state, impl=impl)


@pytest.mark.parametrize("impl", ["torch", "cuda_fused"])
@pytest.mark.parametrize("update_state", [True, False],
                         ids=["update", "frozen"])
def test_routed_attention_stats_match_jax(jax_routed, impl, update_state):
    on = _port_routed(True, update_state, impl)
    off = _port_routed(False, update_state, impl)
    assert off.stats is None and isinstance(on.stats, rt.RoutingStats)
    assert torch.equal(on.out, off.out)
    assert torch.equal(on.state.mu, off.state.mu)
    assert torch.equal(on.r_q, off.r_q) and torch.equal(on.scores, off.scores)
    _stats_close(on.stats, jax_routed[update_state].stats,
                 drift_atol=DRIFT_ATOL)
    if update_state:
        assert (on.stats.drift > 0).all()
    else:
        assert (on.stats.drift == 0).all()
    assert not any(t.requires_grad for t in on.stats)


def test_stats_do_not_change_gradients():
    """On the plain impl (the fused glue's CPU backward is not bit-exact
    from run to run, so its own control would differ)."""
    grads = []
    for stats in (True, False):
        q, v, mu = _routing_inputs()
        qt = torch.tensor(q, requires_grad=True)
        vt = torch.tensor(v, requires_grad=True)
        ro = routing.routed_attention(
            qt, None, vt, KMeansState(torch.tensor(mu)),
            RoutingConfig(num_clusters=4, stats=stats))
        grads.append(torch.autograd.grad(ro.out.square().sum(), [qt, vt]))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_routing_stats_invariants():
    B, H, N, kc = 2, 2, 128, 4
    s = _port_routed(True, True, "torch").stats
    assert s.occupancy.shape == (H, kc)
    np.testing.assert_allclose(s.occupancy.sum(-1), N, rtol=1e-5)
    np.testing.assert_allclose(s.dead, (s.occupancy <= 0).sum(-1), atol=1e-5)
    assert (s.entropy >= -1e-5).all()
    assert (s.entropy <= math.log(kc) + 1e-5).all()
    assert ((s.mismatch >= -1e-5) & (s.mismatch <= 1 + 1e-5)).all()
    assert ((s.recall >= -1e-5) & (s.recall <= 1 + 1e-5)).all()
    assert (s.drift > 0).all()
    # padding is excluded from the occupancy
    q, v, mu = _routing_inputs()
    pad = (torch.arange(N)[None, :] < N // 2).expand(B, N)
    sp = routing.routed_attention(
        torch.tensor(q), None, torch.tensor(v), KMeansState(torch.tensor(mu)),
        RoutingConfig(num_clusters=kc, stats=True), pad_mask=pad,
        update_state=False).stats
    np.testing.assert_allclose(sp.occupancy.sum(-1), N // 2, rtol=1e-5)


def test_routing_stats_detect_collapse():
    """All tokens routed to one centroid -> entropy ~0, dead = k-1 (the
    JAX package's collapse control)."""
    B, H, N, dh, kc = 1, 1, 64, 32, 4
    vec = torch.linspace(-1.0, 1.0, dh)
    q = vec.expand(B, H, N, dh).contiguous()
    v = torch.from_numpy(np.random.RandomState(1).randn(B, H, N, dh)
                         .astype(np.float32))
    r = normalize_routing(vec[None])[0]
    mu = torch.stack([r] + [-r] * (kc - 1))[None]
    s = routing.routed_attention(q, None, v, KMeansState(mu),
                                 RoutingConfig(num_clusters=kc, stats=True),
                                 update_state=False).stats
    assert float(s.entropy[0]) == pytest.approx(0.0, abs=1e-5)
    assert float(s.dead[0]) == kc - 1
    assert float(s.occupancy[0, 0]) == N


def test_segments_still_raise_naming_item_11():
    """The segment fold is ported: ``segments=2`` with the stats on routes
    each half of the sequence on its own and reads the stats of the folded
    batch, as the JAX package's `routed_attention` does (its fold holds in
    `test_torch_sharding.py` too)."""
    q, v, mu = _routing_inputs()
    got = routing.routed_attention(
        torch.tensor(q), None, torch.tensor(v),
        KMeansState(torch.tensor(mu)),
        RoutingConfig(num_clusters=4, segments=2, stats=True))
    want = jax_routing.routed_attention(
        q, None, v, JaxKMeansState(mu),
        JaxRoutingConfig(num_clusters=4, segments=2, stats=True))
    _close(got.out.numpy(), want.out)
    _close(got.state.mu.numpy(), want.state.mu)
    _stats_close(got.stats, want.stats, drift_atol=DRIFT_ATOL)


def test_summarize_and_flatten_match_jax(jax_routed):
    j_tree = [{"0": jax_routed[True].stats, "1": jax_routed[False].stats},
              {}]
    p_tree = [{"0": _port_routed(True, True, "torch").stats,
               "1": _port_routed(True, False, "torch").stats}, {}]
    js, ps = jax_rt.summarize(j_tree), rt.summarize(p_tree)
    assert list(ps) == list(js) == [f"routing/{f}"
                                    for f in rt.SCALAR_FIELDS]
    for k in js:
        assert ps[k].shape == ()
        np.testing.assert_allclose(ps[k].item(), float(js[k]),
                                   rtol=STATS_TOL, atol=DRIFT_ATOL
                                   if k == "routing/drift" else 0)
    jf, pf = jax_rt.flatten(j_tree), rt.flatten(p_tree)
    assert list(pf) == list(jf)
    for k in jf:
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(jf[k]),
                                   rtol=STATS_TOL, atol=DRIFT_ATOL
                                   if k.endswith("/drift") else 0)
    assert rt.summarize([{}, {}]) == {} and rt.stats_leaves(None) == []


# ---------------------------------------------------------------------------
# pages_health and the prefill's stats, on reduced rt-enwik8
# ---------------------------------------------------------------------------
PB, PN = 2, 64


@pytest.fixture(scope="module")
def prefilled():
    jcfg = jax_reduced_config("rt-enwik8")
    jcfg = jax_with_overrides(jcfg, routing=jax_with_overrides(
        jcfg.routing, stats=True))
    params, kstate = jax.jit(lambda k: jax_init_model(jcfg, k))(
        jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (PB, PN)).astype(np.int32)
    _, jcache, jstats = jax.jit(lambda p, k, c, b: jax_serving.prefill(
        p, k, c, b, jcfg, return_stats=True))(
        params, kstate, jax_serving.init_cache(jcfg, PB, PN + 4),
        {"tokens": jnp.asarray(prompt)})
    cfg = reduced_config("rt-enwik8")
    cfg = with_overrides(cfg, routing=with_overrides(cfg.routing,
                                                     stats=True))
    p_params = params_from_jax(jax.tree.map(np.asarray, params))
    p_kstate = kstate_from_jax(jax.tree.map(np.asarray, kstate))
    _, cache, stats = serving.prefill(
        p_params, p_kstate, serving.init_cache(cfg, PB, PN + 4, device="cpu"),
        {"tokens": torch.from_numpy(prompt)}, cfg, return_stats=True)
    off = serving.prefill(
        p_params, p_kstate, serving.init_cache(
            reduced_config("rt-enwik8"), PB, PN + 4, device="cpu"),
        {"tokens": torch.from_numpy(prompt)}, reduced_config("rt-enwik8"))
    return dict(jcache=jax.tree.map(np.asarray, jcache), jstats=jstats,
                cache=cache, stats=stats, off=off)


@pytest.mark.parametrize("active", [None, [True, False]],
                         ids=["all", "first-lane"])
def test_pages_health_matches_jax(prefilled, active):
    act = None if active is None else np.array(active)
    want = jax_rt.pages_health(prefilled["jcache"], active=act)
    got = rt.pages_health(prefilled["cache"], active=act)
    assert want is not None and got == want


def test_prefill_stats_match_jax_and_leave_outputs(prefilled):
    js, ps = prefilled["jstats"], prefilled["stats"]
    assert len(ps) == len(js) and all(set(a) == set(b)
                                      for a, b in zip(ps, js))
    for jseg, pseg in zip(js, ps):
        for li in jseg:
            _stats_close(pseg[li], jseg[li])
    summ_j, summ_p = jax_rt.summarize(js), rt.summarize(ps)
    for k in summ_j:
        _close(summ_p[k].item(), float(summ_j[k]))
    # stats on leave the cache as stats off fill it
    for a, b in zip(tree_leaves(prefilled["cache"]),
                    tree_leaves(prefilled["off"][1])):
        assert torch.equal(a, b)


def test_pages_health_reads_rlen():
    rlen = np.zeros((1, 2, 1, 4), np.int32)
    rlen[0, 0, 0] = [10, 10, 10, 10]
    rlen[0, 1, 0] = [40, 0, 0, 0]
    h = rt.pages_health([{"rlen": torch.from_numpy(rlen)}])
    assert h == jax_rt.pages_health([{"rlen": rlen}])
    assert h["routing/entropy"] == pytest.approx(math.log(4) / 2, abs=1e-6)
    assert h["routing/dead"] == pytest.approx(1.5)
    h0 = rt.pages_health([{"rlen": rlen}], active=np.array([True, False]))
    assert h0["routing/dead"] == 0.0
    assert rt.pages_health([{"k": np.zeros((1, 2, 1, 4))}]) is None
    assert rt.pages_health([{"rlen": rlen}],
                           active=np.array([False, False])) is None


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def _batch(seed=0, B=2, S=65):
    return {"tokens": np.random.RandomState(seed).randint(
        0, 256, size=(B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_step():
    jrun, _ = _tiny_runs(True)
    state = jax.jit(lambda k: jax_train_step.init_train_state(jrun, k))(
        jax.random.PRNGKey(0))
    _, metrics = jax.jit(jax_train_step.make_train_step(jrun))(
        state, _batch())
    return dict(metrics=jax.device_get(metrics),
                params=jax.tree.map(np.asarray, state.params),
                kstate=jax.tree.map(np.asarray, state.kstate))


def _port_state(run, jx):
    from repro_torch.optim import make_optimizer
    params = params_from_jax(jx["params"])
    return train_step.TrainState(params, kstate_from_jax(jx["kstate"]),
                                 make_optimizer(run.train)[0](params), 0)


def test_train_step_stats_match_jax(jax_step):
    _, run = _tiny_runs(True)
    batch = {"tokens": torch.from_numpy(_batch()["tokens"])}
    _, m = train_step.make_train_step(run)(_port_state(run, jax_step), batch)
    jm = jax_step["metrics"]
    # the JAX package's MoE aux terms (zero for the dense family) are not
    # in the port's metrics
    assert set(m) == {k for k in jm if not k.startswith("moe_")}
    keys = [k for k in jm if k.startswith(("routing/", "rt/"))]
    assert "rt/0/0/entropy" in keys and len(keys) == 5 + 5 * 1
    for k in keys:
        assert tuple(m[k].shape) == np.shape(jm[k]), k
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=STEP_TOL,
                                   atol=DRIFT_ATOL if "drift" in k else 0)
    _close(m["loss"].item(), float(jm["loss"]), STEP_TOL)


@pytest.mark.parametrize("train", [dict(), dict(remat="full"),
                                   dict(grad_accum=2)],
                         ids=["plain", "remat-full", "grad-accum-2"])
def test_train_step_stats_leave_the_step(jax_step, train):
    """Stats on equal stats off bit for bit in loss, parameters and
    centroids; stats off keep the metric dict as it was."""
    batch = {"tokens": torch.from_numpy(_batch()["tokens"])}
    out = {}
    for stats in (True, False):
        _, run = _tiny_runs(stats, **train)
        out[stats] = train_step.make_train_step(run)(
            _port_state(run, jax_step), batch)
    (ts_on, m_on), (ts_off, m_off) = out[True], out[False]
    assert set(m_off) == {"nll", "tokens", "loss", "grad_norm", "lr"}
    assert set(m_on) - set(m_off) == {
        k for k in m_on if k.startswith(("routing/", "rt/"))}
    for k in m_off:
        assert torch.equal(torch.as_tensor(m_on[k]),
                           torch.as_tensor(m_off[k])), k
    for a, b in zip(tree_leaves((ts_on.params, ts_on.kstate,
                                 ts_on.opt_state)),
                    tree_leaves((ts_off.params, ts_off.kstate,
                                 ts_off.opt_state))):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    # (G, Hr): the stack's one segment runs 2 groups of 2 routing heads
    assert m_on["rt/0/0/entropy"].shape == (2, 2)


# ---------------------------------------------------------------------------
# The trainer, the launcher, the schema
# ---------------------------------------------------------------------------
def test_trainer_obs_jsonl(tmp_path):
    path = str(tmp_path / "train.jsonl")
    _, run = _tiny_runs(True)
    tr = Trainer(run, SyntheticLoader("markov", 256, 2, 64), device="cpu",
                 obs_jsonl=path)
    out = tr.fit(3)
    tr.close()
    assert out["steps"] == 3 and len(tr.metrics_history) == 3
    assert schema.validate_jsonl(path) == 3
    assert jax_schema.validate_jsonl(path) == 3
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["step"] for r in recs] == [1, 2, 3]
    rec = recs[0]
    assert rec["kind"] == "train_step" and rec["source"] == "trainer"
    assert 0.0 <= rec["metrics"]["routing/entropy"] <= math.log(4) + 1e-5
    assert np.shape(rec["metrics"]["rt/0/0/recall"]) == (2, 2)
    assert rec["metrics"]["step_time_s"] > 0
    assert tr.metrics_history[0] == rec["metrics"]
    assert tr.obs.histogram("train/step_time_s").count == 3
    # with a checkpoint directory: the resumed run records its own steps
    ckpt, path2 = str(tmp_path / "ckpt"), str(tmp_path / "resumed.jsonl")
    Trainer(run, SyntheticLoader("markov", 256, 2, 64), device="cpu",
            ckpt_dir=ckpt).fit(2)
    tr2 = Trainer(run, SyntheticLoader("markov", 256, 2, 64), device="cpu",
                  ckpt_dir=ckpt, obs_jsonl=path2)
    assert tr2.fit(3)["steps"] == 3
    tr2.close()
    assert [json.loads(ln)["step"] for ln in open(path2)] == [3]
    assert schema.validate_jsonl(path2) == 1


def test_launcher_obs_flags(tmp_path):
    path, prof = str(tmp_path / "l.jsonl"), str(tmp_path / "prof")
    out = launcher.main(["--arch", "rt-enwik8", "--reduced", "--steps", "2",
                         "--batch", "2", "--seq", "64", "--device", "cpu",
                         "--obs-jsonl", path, "--routing-stats",
                         "--profile-dir", prof])
    assert out["steps"] == 2
    assert schema.validate_jsonl(path) == jax_schema.validate_jsonl(path) == 2
    rec = json.loads(open(path).readline())
    assert "routing/recall" in rec["metrics"]
    trace = open(os.path.join(prof, obs.trace.TRACE_FILE)).read()
    # (the CPU runs the plain backend, which calls no kernel wrapper)
    for name in ("train/grad", "train/optimizer"):
        assert name in trace, name


def test_schema_cli_and_tampered_lines(tmp_path, capsys):
    path = str(tmp_path / "ok.jsonl")
    with obs.JsonlSink(path, source="cli") as sink:
        sink.emit("x", metrics={"a": torch.tensor(1.5),
                                "v": torch.arange(3.0),
                                "nan": torch.tensor(float("nan"))})
    assert schema.main([path]) == 0
    assert "1 records ok" in capsys.readouterr().out
    rec = json.loads(open(path).readline())
    assert rec["metrics"] == {"a": 1.5, "v": [0.0, 1.0, 2.0], "nan": None}
    bad = str(tmp_path / "bad.jsonl")
    open(bad, "w").write("{}\n")
    assert schema.main([bad]) == 1
    assert schema.main([]) == 2
    good = {"v": obs.SCHEMA_VERSION, "kind": "x", "t": 0.0}
    schema.validate_record(good)
    for tampered in ({**good, "v": 99}, {**good, "kind": ""},
                     {**good, "t": float("nan")}, {**good, "step": -1},
                     {**good, "metrics": {"a": float("inf")}},
                     {**good, "extra": {1: 2}}):
        with pytest.raises(obs.SchemaError):
            schema.validate_record(tampered)
        with pytest.raises(jax_schema.SchemaError):
            jax_schema.validate_record(tampered)
    whole = tmp_path / "r.json"
    whole.write_text('{"x": NaN}')
    assert schema.main([str(whole)]) == 1
    whole.write_text('{"x": 1.0, "y": [null, "s"]}')
    assert schema.main([str(whole)]) == 0


def test_schema_module_runs_as_a_script(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.obs.schema FILE`` (run in-process)."""
    import runpy
    import sys
    path = str(tmp_path / "ok.jsonl")
    with obs.JsonlSink(path) as sink:
        sink.emit("x", step=0)
    monkeypatch.setattr(sys, "argv", ["schema", path])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("repro_torch.obs.schema", run_name="__main__")
    assert done.value.code == 0
    assert "1 records ok (schema v1)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Spans, profile(), the metrics core
# ---------------------------------------------------------------------------
def test_kernel_span_in_a_capture_adds_no_launch(tmp_path):
    from repro_torch.kernels import common
    q = torch.randn(1, 2, 32, 16)
    common.reset_counters()
    d = str(tmp_path / "prof")
    with obs.profile(d):
        local_k.local_attention(q, q, q, 8)
    assert common.counters()["local_attention"] == 0      # the CPU path
    trace = open(os.path.join(d, obs.trace.TRACE_FILE)).read()
    assert "kernels/local_attention" in trace
    with obs.profile(None):
        pass
    with obs.profile(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(str(tmp_path / "off"))


def test_metrics_core_and_step_series(tmp_path):
    reg = obs.Registry()
    reg.counter("steps").inc(3)
    reg.histogram("lat").record(2.0)
    assert reg.summary()["steps"] == 3.0
    assert obs.default_registry() is obs.default_registry()
    path = str(tmp_path / "s.jsonl")
    series = obs.StepSeries(sink=obs.JsonlSink(path, source="t"))
    series.record(0, {"loss": torch.tensor(2.0), "arr": torch.ones(2, 1)})
    series.record(1, {"loss": torch.tensor(1.0)})
    series.sink.close()
    assert [r["loss"] for r in series.history] == [2.0, 1.0]
    assert series.history[0]["arr"] == [[1.0], [1.0]]
    assert jax_schema.validate_jsonl(path) == 2
