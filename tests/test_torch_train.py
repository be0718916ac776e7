"""Slice parity: the port trains reduced rt-enwik8 and qwen2-0.5b as the
JAX package does.

The same inputs (numpy, from seeds; JAX parameters and train states carried
across with `repro_torch.interop`) go through the JAX package and the port
on the CPU:

* pieces: synthetic batches (bit-equal), the LR schedules, Adam, global-norm
  clipping;
* the model, for each arch (rt-enwik8's local+routing heads, qwen2-0.5b's
  full attention with its qkv biases set from the seed, since the JAX init
  zeros them): `apply_model` + `lm_loss` loss, gradients and new centroids
  against ``jax.value_and_grad`` of `make_loss_fn`, the JAX side on its
  Pallas kernels in interpret mode (REPRO_ATTN_PLATFORM=tpu +
  REPRO_FORCE_INTERPRET=1), the port on its plain backend and forced onto
  its kernel backend (impl="cuda": the autograd Functions, whose wrappers
  take their plain versions for CPU tensors);
* training, for each arch: a 20-step loss trajectory and the final
  parameters against JAX `make_train_step` (grad_accum 1 and 2); and a port
  run continuing a JAX rt-enwik8 run mid-trajectory;
* what has no JAX counterpart to match: dropout by its statistics, remat
  "full" against "none" with dropout on (each arch), the trainer loop, and
  the fp32 gradient gate of ``chip_smoke.py`` against a broken backward.

Tolerances (fp32): loss 1e-5 and gradients 1e-5 relative to each leaf's
largest entry for one step (two frameworks summing the same fp32 products
in other orders); over 20 Adam steps losses and parameters 1e-5
absolute (the order differences feed back through the updates).
"""
import os
import signal

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import synthetic as jax_synthetic
from repro.optim.adam import adam as jax_adam
from repro.optim import make_schedule as jax_make_schedule
from repro.train import train_step as jax_train_step
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.data import synthetic
from repro_torch.interop import (kstate_from_jax, params_from_jax,
                                 train_state_from_jax, tree_to_numpy)
from repro_torch.kernels import routing_attention as routing_k
from repro_torch.models import transformer as T
from repro_torch.optim import make_schedule
from repro_torch.optim.adam import adam
from repro_torch.train import train_step
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves
from test_torch_full import with_qkv_biases

ARCH = "rt-enwik8"
ARCHS = ["rt-enwik8", "qwen2-0.5b"]
B, S = 2, 64
STEP_TOL = 1e-5
TRAJ_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _runs(grad_accum=1, warmup=100, batch=B, arch=ARCH):
    kw = dict(global_batch=batch, seq_len=S, warmup_steps=warmup,
              grad_accum=grad_accum)
    return (JaxRunConfig(model=jax_reduced_config(arch),
                         train=JaxTrainConfig(**kw)),
            RunConfig(model=reduced_config(arch), train=TrainConfig(**kw)))


def _batches(n, batch=B, start=0):
    loader = jax_synthetic.SyntheticLoader("markov", 128, batch, S, seed=3,
                                           start_step=start)
    return [next(loader) for _ in range(n)]


def _leaf_close(got, want, rel):
    for g, w in zip(tree_leaves(tree_to_numpy(got)), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, atol=rel * max(np.abs(w).max(),
                                                        1e-30))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("task", ["markov", "copy", "uniform"])
def test_synthetic_batches_equal_jax(task):
    j = jax_synthetic.SyntheticLoader(task, 64, 3, 33, seed=5, start_step=2)
    p = synthetic.SyntheticLoader(task, 64, 3, 33, seed=5, start_step=2)
    for _ in range(3):
        a, b = next(j), next(p)
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert b["tokens"].dtype == np.int32
    assert p.state() == j.state()


@pytest.mark.parametrize("schedule", ["vaswani", "linear_warmup_rsqrt",
                                      "const"])
def test_schedules_match_jax(schedule):
    tc = TrainConfig(schedule=schedule, warmup_steps=100, lr=3e-3)
    jtc = JaxTrainConfig(schedule=schedule, warmup_steps=100, lr=3e-3)
    p, j = make_schedule(tc, 1024), jax_make_schedule(jtc, 1024)
    for step in (0, 1, 7, 99, 100, 101, 5000):
        np.testing.assert_allclose(p(step), float(j(np.int32(step))),
                                   rtol=1e-6)


def test_adam_matches_jax():
    """fp32 moments, the update in fp32, cast back to each leaf's dtype
    (bf16 leaves agree within one bf16 ulp of rounding)."""
    rng = np.random.default_rng(21)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": [rng.standard_normal((7,)).astype(jax.numpy.bfloat16)]}
    j_init, j_upd = jax_adam(0.9, 0.98, 1e-9, 1e-2)
    p_init, p_upd = adam(0.9, 0.98, 1e-9, 1e-2)
    jp = jax.tree.map(jax.numpy.asarray, params)
    js = j_init(jp)
    pp = params_from_jax(params)
    ps = p_init(pp)
    for i in range(3):
        g = {"a": rng.standard_normal((4, 5)).astype(np.float32),
             "b": [rng.standard_normal((7,)).astype(jax.numpy.bfloat16)]}
        jp, js = j_upd(jax.tree.map(jax.numpy.asarray, g), js, jp, 1e-2)
        pp, ps = p_upd(params_from_jax(g), ps, pp, 1e-2)
    assert ps["count"] == int(js["count"]) == 3
    np.testing.assert_allclose(pp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pp["b"][0].float().numpy(),
                               np.asarray(jp["b"][0], np.float32),
                               rtol=2 ** -7)
    assert pp["b"][0].dtype == torch.bfloat16
    for key in ("m", "v"):
        _leaf_close(ps[key], js[key], 1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(22)
    grads = {"a": rng.standard_normal((6, 3)).astype(np.float32),
             "b": (rng.standard_normal((9,)).astype(np.float32),)}
    jg, jn = jax_train_step.clip_by_global_norm(
        jax.tree.map(jax.numpy.asarray, grads), max_norm)
    pg, pn = train_step.clip_by_global_norm(params_from_jax(grads), max_norm)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    _leaf_close(pg, jg, 1e-6)


# ---------------------------------------------------------------------------
# the model: one step's loss, gradients and centroids
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def jax_step(request):
    """Loss, grads and new kstate of one fp32 step of each arch, JAX on
    its Pallas kernels in interpret mode."""
    jrun, _ = _runs(arch=request.param)
    params, kstate = jax.jit(lambda k: __import__(
        "repro.models.model", fromlist=["init_model"]).init_model(
        jrun.model, k))(jax.random.PRNGKey(0))
    params = with_qkv_biases(_np(params), 4)
    batch = _batches(1)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_ATTN_PLATFORM", "tpu")
        mp.setenv("REPRO_FORCE_INTERPRET", "1")
        vg = jax.jit(jax.value_and_grad(jax_train_step.make_loss_fn(jrun),
                                        has_aux=True))
        (loss, (new_k, _)), grads = vg(params, kstate, batch, None)
    return dict(arch=request.param, params=params, kstate=_np(kstate),
                batch=batch, loss=float(loss), grads=_np(grads),
                new_k=_np(new_k))


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_model_loss_grads_and_centroids_match_jax(jax_step, impl):
    _, run = _runs(arch=jax_step["arch"])
    vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl=impl))
    batch = {"tokens": torch.from_numpy(jax_step["batch"]["tokens"])}
    (loss, (new_k, metrics)), grads = vg(
        params_from_jax(jax_step["params"]),
        kstate_from_jax(jax_step["kstate"]), batch, None)
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=STEP_TOL)
    assert float(metrics["tokens"]) == B * S
    _leaf_close(grads, jax_step["grads"], STEP_TOL)
    _leaf_close(new_k, jax_step["new_k"], STEP_TOL)


# ---------------------------------------------------------------------------
# training trajectories
# ---------------------------------------------------------------------------
def _jax_trajectory(jrun, ts, batches):
    step = jax.jit(jax_train_step.make_train_step(jrun))
    losses = []
    for b in batches:
        ts, m = step(ts, b)
        losses.append(float(m["loss"]))
    return ts, losses


def _port_trajectory(run, ts, batches, impl=None):
    step = train_step.make_train_step(run, impl=impl)
    losses = []
    for b in batches:
        ts, m = step(ts, {"tokens": torch.from_numpy(b["tokens"])})
        losses.append(float(m["loss"]))
    return ts, losses


def _determined_tolerance(jrun, run, ts, batch):
    """Per parameter leaf, the elementwise tolerance of a 20-step Adam
    trajectory: TRAJ_TOL where the first step's gradient is determined in
    fp32 (JAX and the port agree on it to 1e-3 of its value), else twice
    the summed learning rate. Where a gradient is fp32 cancellation noise
    (qwen2's key bias in the rope's slow dimensions, which at theta 1e6
    barely turn over 64 positions, so the bias shifts all of a query's
    scores alike; a few FFN weights with gradients ~1e-8 of their leaf's
    largest) Adam (eps 1e-9) scales the noise to steps of up to the rate.
    Such elements must stay under 0.1% of all."""
    vg = jax.jit(jax.value_and_grad(jax_train_step.make_loss_fn(jrun),
                                    has_aux=True))
    jg = _np(vg(ts.params, ts.kstate, batch, None)[1])
    pg = train_step.value_and_grad(train_step.make_loss_fn(run))(
        params_from_jax(ts.params), kstate_from_jax(ts.kstate),
        {"tokens": torch.from_numpy(batch["tokens"])}, None)[1]
    schedule = make_schedule(run.train, run.model.d_model)
    adam_bound = 2 * sum(schedule(s) for s in range(1, 21))
    noisy = [np.abs(p - j) > 1e-3 * np.abs(j)
             for p, j in zip(tree_leaves(tree_to_numpy(pg)),
                             jax.tree.leaves(jg))]
    assert sum(n.sum() for n in noisy) <= 1e-3 * sum(n.size for n in noisy)
    return [np.where(n, adam_bound, TRAJ_TOL) for n in noisy]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grad_accum,impl", [(1, None), (1, "cuda"),
                                             (2, None)])
def test_train_trajectory_matches_jax(grad_accum, impl, arch):
    """20 fp32 steps from the same JAX initial state (Adam, vaswani
    schedule with a 100-step warm-up, clipping, remat "full"). Parameters
    agree elementwise to TRAJ_TOL; for qwen2, to TRAJ_TOL wherever the
    gradient is determined in fp32 (`_determined_tolerance`)."""
    batch = 2 * grad_accum
    jrun, run = _runs(grad_accum, batch=batch, arch=arch)
    jts = _np(jax_train_step.init_train_state(jrun, jax.random.PRNGKey(1)))
    jts = jts._replace(params=with_qkv_biases(jts.params, 5))
    pts = train_state_from_jax(jts)
    batches = _batches(20, batch=batch)
    init = jts
    jts, jl = _jax_trajectory(jrun, jts, batches)
    pts, pl = _port_trajectory(run, pts, batches, impl)
    np.testing.assert_allclose(pl, jl, atol=TRAJ_TOL)
    assert pl[-1] < pl[0]
    assert pts.step == int(jts.step) == 20
    assert pts.opt_state["count"] == 20
    tols = (_determined_tolerance(jrun, run, init, batches[0])
            if arch != ARCH else None)
    for i, (g, w) in enumerate(zip(tree_leaves(tree_to_numpy(pts.params)),
                                   jax.tree.leaves(_np(jts.params)))):
        if tols is None:
            np.testing.assert_allclose(g, w, atol=TRAJ_TOL)
        else:
            assert (np.abs(g - w) <= tols[i]).all(), \
                f"leaf {i}: largest difference {np.abs(g - w).max()}"
    _leaf_close(pts.kstate, _np(jts.kstate), TRAJ_TOL)


def test_port_continues_a_jax_run_mid_trajectory():
    """JAX trains 5 steps; the port takes its state (params, centroids,
    Adam moments and count, step) and trains 5 more; JAX's own 10-step
    run agrees."""
    jrun, run = _runs()
    batches = _batches(10)
    jts = jax_train_step.init_train_state(jrun, jax.random.PRNGKey(2))
    jts5, jl5 = _jax_trajectory(jrun, jts, batches[:5])
    jts10, jl10 = _jax_trajectory(jrun, jts5, batches[5:])
    pts, pl = _port_trajectory(run, train_state_from_jax(_np(jts5)),
                               batches[5:])
    np.testing.assert_allclose(pl, jl10, atol=TRAJ_TOL)
    assert pts.step == 10
    for g, w in zip(tree_leaves(tree_to_numpy(pts.params)),
                    jax.tree.leaves(_np(jts10.params))):
        np.testing.assert_allclose(g, w, atol=TRAJ_TOL)


# ---------------------------------------------------------------------------
# what has no JAX counterpart to match
# ---------------------------------------------------------------------------
def test_dropout_statistics_and_determinism():
    x = torch.ones(200_000)
    y = T._dropout(x, 0.4, 123)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.6) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.6, rtol=1e-6)
    assert torch.equal(T._dropout(x, 0.4, 123), y)
    assert not torch.equal(T._dropout(x, 0.4, 124), y)
    assert T._dropout(x, 0.4, None) is x and T._dropout(x, 0.0, 1) is x
    assert T.fold_seed(0, 1) != T.fold_seed(0, 2) != T.fold_seed(1, 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", [None, "cuda"])
def test_remat_full_equals_none_with_dropout(impl, arch):
    """Rematerialized groups redraw the same dropout masks: loss and
    gradients with remat "full" equal those without (1e-6: the same ops
    in the same order; only the recomputation differs)."""
    cfg = with_overrides(reduced_config(arch), dropout=0.4)
    from repro_torch.models.model import init_model
    params, kstate = init_model(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(_batches(1)[0]["tokens"])}
    out = {}
    for remat in ("none", "full"):
        run = RunConfig(model=cfg, train=TrainConfig(remat=remat))
        vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl))
        out[remat] = vg(params, kstate, batch, 7)
    (l0, (k0, _)), g0 = out["none"]
    (l1, (k1, _)), g1 = out["full"]
    assert float(l0) == pytest.approx(float(l1), abs=1e-6)
    for a, b in zip(tree_leaves(g0) + tree_leaves(k0),
                    tree_leaves(g1) + tree_leaves(k1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    (l2, _), _ = train_step.value_and_grad(train_step.make_loss_fn(
        RunConfig(model=cfg), impl))(params, kstate, batch, 8)
    assert abs(float(l2) - float(l0)) > 1e-4      # other seed, other masks


def test_trainer_fits_watches_stragglers_and_stops_on_preemption(tmp_path):
    _, run = _runs()
    calls = []

    def step_fn(state, batch):
        calls.append(state.step)
        if len(calls) == 7:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return inner(state, batch)

    inner = train_step.make_train_step(run)
    loader = synthetic.SyntheticLoader("markov", 128, B, S, seed=3)
    before = signal.getsignal(signal.SIGTERM)
    slow = []
    tr = Trainer(run, loader, step_fn=step_fn, device="cpu",
                 straggler_factor=1e-9,
                 on_straggler=lambda step, ratio: slow.append(step))
    out = tr.fit(20)
    assert out["preempted"] and out["steps"] == 7
    assert len(tr.metrics_history) == 7
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_history)
    assert {"loss", "nll", "grad_norm", "lr", "step_time_s"} <= set(
        tr.metrics_history[0])
    assert out["stragglers"] == len(slow) >= 1     # every step past the 5th
    assert signal.getsignal(signal.SIGTERM) is before
    assert loader.step == 7
    # with a checkpoint directory: the preempted run is saved at its step
    # and a fresh Trainer resumes it, loader cursor included
    ckpt = os.fspath(tmp_path / "ckpt")
    calls.clear()
    tr = Trainer(run, synthetic.SyntheticLoader("markov", 128, B, S, seed=3),
                 step_fn=step_fn, device="cpu", ckpt_dir=ckpt)
    assert tr.fit(20)["steps"] == 7
    tr2 = Trainer(run, synthetic.SyntheticLoader("markov", 128, B, S, seed=3),
                  device="cpu", ckpt_dir=ckpt)
    assert tr2.init_or_restore().step == 7 and tr2.loader.step == 7
    for a, b in zip(tree_leaves(tr.state.params),
                    tree_leaves(tr2.state.params)):
        assert torch.equal(a, b)


def test_fp32_gate_separates_a_broken_backward(monkeypatch):
    """chip_smoke's fp32 gate statistics (over parameter leaves, the median
    and the largest relative gradient difference, kernel path vs plain
    path) on reduced rt-enwik8, where both paths route alike: a sound
    backward reads far below both limits, a backward that drops the key
    side of shared-QK above them."""
    _, run = _runs()
    from repro_torch.models.model import init_model
    params, kstate = init_model(run.model, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(_batches(1)[0]["tokens"])}

    def grads(impl):
        vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl))
        return vg(params, kstate, batch, None)[1]

    plain = grads("torch")
    sound = chip_smoke.grad_agreement(grads("cuda"), plain)
    monkeypatch.setattr(routing_k, "routed_attention_fused_bwd",
                        chip_smoke.key_side_dropped(
                            routing_k.routed_attention_fused_bwd))
    broken = chip_smoke.grad_agreement(grads("cuda"), plain)
    print(f"fp32 gate statistic: sound {sound}, key side dropped {broken}")
    assert sound["grad_rel_median"] < 1e-5
    assert sound["grad_rel_max"] < chip_smoke.MAX_BWD_GRAD_FP32
    assert broken["grad_rel_median"] > chip_smoke.MAX_GRAD_MEDIAN_FP32
    assert broken["grad_rel_max"] > chip_smoke.MAX_BWD_GRAD_FP32


def test_fp32_gate_replays_the_kernel_paths_membership():
    """chip_smoke's gate feeds the plain path the kernel path's cluster
    membership. Under remat "full" both paths route twice per layer
    (forward and recompute) in the same order; a faithful replay leaves the
    plain path's gradients as they were (both paths route alike here),
    and a replay of another batch's memberships moves them."""
    _, run = _runs()
    assert run.train.remat == "full"
    from repro_torch.models.model import init_model
    params, kstate = init_model(run.model, seed=0, device="cpu")
    batch, other = ({"tokens": torch.from_numpy(b["tokens"])}
                    for b in _batches(2))

    def grads(impl, membership, batch=batch):
        vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl))
        with membership:
            return vg(params, kstate, batch, None)[1]

    calls, other_calls, flips = [], [], []
    grads("cuda", chip_smoke.membership_recorded(calls))
    assert len(calls) == 2 * run.model.num_layers
    plain = grads("torch", chip_smoke.membership_replayed(calls, flips))
    assert flips == [False] * len(calls)
    own = grads("torch", chip_smoke.contextlib.nullcontext())
    assert chip_smoke.grad_agreement(plain, own)["grad_rel_max"] < 1e-6
    grads("cuda", chip_smoke.membership_recorded(other_calls), other)
    flips = []
    wrong = grads("torch", chip_smoke.membership_replayed(other_calls, flips))
    assert any(flips)
    assert chip_smoke.grad_agreement(wrong, own)["grad_rel_median"] > \
        chip_smoke.MAX_GRAD_MEDIAN_FP32
