"""The port's data-parallel pieces against the JAX package's
(``repro.dist.compression``, ``repro.train.train_step``'s compressed step,
``repro.launch.{distributed,mesh}``), on the CPU.

Several ranks are spawned processes over gloo (a ``file://`` rendezvous in
the test's directory, and for the launcher a ``tcp://`` one on a free
port; every process group and join has a timeout). One spawn of 2 ranks
and one of 4 run every multi-process case of this file; the JAX
references run in this process, the collectives under ``jax.vmap(...,
axis_name="i")``.

* ``_quantize``'s codes and scales equal JAX's bit for bit (round half to
  even included);
* ``int8_psum_mean`` and ``int8_ef_psum_mean`` at 2 and 4 ranks against
  JAX's: equal bit for bit at 2 ranks; at 4, within one hop-2 quantization
  step of the leaf (the two sum 4 rows in other orders, which can move a
  re-quantized code by one);
* the error-feedback property: over 64 rounds the time-averaged error is
  below 0.3 x the stateless one, the residual below 0.3;
* at D = 1 (no group) both are the identity and the compressed step is
  the uncompressed step, bit for bit;
* the D = 2 compressed step against JAX's, composed from ``make_grad_fn``
  on each shard, ``int8_ef_psum_mean`` under ``vmap`` and ``_finish_step``:
  grads within 1e-5 of each leaf's largest, the applied mean and the
  residuals within one quantization step per element (a grad that differs
  in the last bits may flip a code), the loss within 1e-5, the parameters
  within 2 x lr (Adam's first step moves an element by lr times the sign
  of its mean); both ranks equal bit for bit;
* the D = 2 uncompressed step against one process's step on the whole
  batch (dropout 0): parameters within 1e-6; the centroids equal the mean
  of the two shards' updates, as in the JAX package's data-parallel step;
* a compressed restart at D = 2 bit for bit, and a restore of its
  checkpoint at D = 1 that re-zeros the residuals;
* the launcher over 2 processes (``--coordinator``, ``--num-processes``,
  ``--process-id``, ``int8_ef``, ``--ckpt-dir``);
* ``detect`` / ``LaunchSpec`` / ``feasible_mesh_shape``, copied from
  ``tests/test_distributed.py`` and ``tests/test_mesh.py``, and the port's
  mesh, which clamps as JAX's (its model axis is held in
  `test_torch_tp.py`).
"""
import concurrent.futures
import datetime
import multiprocessing as mp
import shutil
import socket
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (ModelConfig, RoutingConfig, RunConfig,
                                      TrainConfig)
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.dist import compression as comp
from repro_torch.interop import train_state_from_jax, tree_to_numpy
from repro_torch.launch import distributed as dist
from repro_torch.launch import mesh as port_mesh
from repro_torch.train import train_step
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map

_MODEL = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
              d_ff=64, vocab_size=64, attention="local+routing",
              dtype="float32")
_ROUTING = dict(num_clusters=2, local_window=8)
_TRAIN = dict(global_batch=4, seq_len=32, lr=1e-3, schedule="const",
              warmup_steps=1)
M = 4096 + 200          # not a multiple of n * 128: the padded path
EF_ROUNDS = 64
JOIN_S = 240
PG_TIMEOUT = datetime.timedelta(seconds=120)


def _run(compression="none"):
    return RunConfig(model=ModelConfig(**_MODEL,
                                       routing=RoutingConfig(**_ROUTING)),
                     train=TrainConfig(**_TRAIN,
                                       grad_compression=compression))


def _loader():
    return SyntheticLoader("markov", 64, 4, 32)


def _wire_inputs(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n, M) * np.exp(rng.randn(n, 1))).astype(np.float32)
    e = (rng.randn(n, M) * 1e-3).astype(np.float32)
    return x, e


def _batch():
    return {"tokens": torch.from_numpy(next(_loader())["tokens"])}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, not at the top, so the
    spawned ranks, which import this file, do not load JAX)."""
    import jax
    from repro.configs.base import ModelConfig as JM
    from repro.configs.base import RoutingConfig as JR
    from repro.configs.base import RunConfig as JRun
    from repro.configs.base import TrainConfig as JT
    from repro.dist import compression as jcomp
    from repro.optim import make_optimizer, make_schedule
    from repro.train import train_step as jts

    def jrun(compression="none"):
        return JRun(model=JM(**_MODEL, routing=JR(**_ROUTING)),
                    train=JT(**_TRAIN, grad_compression=compression))
    state = jax.jit(lambda k: jts.init_train_state(jrun(), k))(
        jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        jax=jax, comp=jcomp, ts=jts, jrun=jrun,
        make_optimizer=make_optimizer, make_schedule=make_schedule,
        state=jax.tree.map(np.asarray, state))


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------
def _jax_wire(jx, n):
    """Op by op, as JAX dispatches outside jit: XLA's fusion under jit
    rounds the dequantization differently in the last bit."""
    x, e = _wire_inputs(n)
    jax = jx.jax
    mean = jax.vmap(lambda a: jx.comp.int8_psum_mean(a, "i"),
                    axis_name="i")(x)
    ef_mean, ef_err = jax.vmap(
        lambda a, b: jx.comp.int8_ef_psum_mean(a, b, "i"),
        axis_name="i")(x, e)
    return x, np.asarray(mean), np.asarray(ef_mean), np.asarray(ef_err)


def _jax_compressed_step(jx):
    """JAX's D = 2 compressed step, composed: grads of each shard, the
    exchange under vmap, the kstate and metric means, `_finish_step`."""
    jax, jnp = jx.jax, jx.jax.numpy
    jrun = jx.jrun("int8_ef")
    jts = jx.ts.TrainState(*jx.state[:4])
    grad_fn = jax.jit(jx.ts.make_grad_fn(jrun, jx.ts.make_loss_fn(jrun)))
    toks = jnp.asarray(_batch()["tokens"].numpy())
    shards = [grad_fn(jts.params, jts.kstate, {"tokens": toks[r * 2:r * 2 + 2]},
                      None) for r in range(2)]
    gstack = jax.tree.map(lambda *a: jnp.stack(a), *[s[0] for s in shards])
    estack = jax.tree.map(lambda g: jnp.zeros_like(g), gstack)

    def exchange(g_tree, e_tree):
        gl, tdef = jax.tree_util.tree_flatten(g_tree)
        el = jax.tree.leaves(e_tree)
        pairs = [jx.comp.int8_ef_psum_mean(g, e, "i") if g.size >= 256
                 else (jax.lax.pmean(g, "i"), e) for g, e in zip(gl, el)]
        return (jax.tree_util.tree_unflatten(tdef, [p[0] for p in pairs]),
                jax.tree_util.tree_unflatten(tdef, [p[1] for p in pairs]))
    mean_s, ef_s = jax.jit(jax.vmap(exchange, axis_name="i"))(gstack,
                                                                estack)
    mean = jax.tree.map(lambda a: a[0], mean_s)
    new_k = jax.tree.map(lambda a, b: (a + b) / 2, shards[0][1],
                         shards[1][1])
    metrics = {k: (shards[0][2][k] + shards[1][2][k]) / 2
               for k in shards[0][2]}
    _, opt_update = jx.make_optimizer(jrun.train)
    schedule = jx.make_schedule(jrun.train, jrun.model.d_model)
    new_ts, m = jax.jit(lambda *a: jx.ts._finish_step(
        jrun.train, schedule, opt_update, *a))(jts, mean, new_k, metrics,
                                               ef_s)
    return dict(grads=[jax.tree.map(np.asarray, s[0]) for s in shards],
                mean=jax.tree.map(np.asarray, mean),
                ef=jax.tree.map(np.asarray, ef_s),
                ts=jax.tree.map(np.asarray, new_ts), loss=float(m["loss"]))


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _np_state(ts):
    return dict(params=tree_to_numpy(ts.params),
                kstate=tree_to_numpy(ts.kstate),
                m=tree_to_numpy(ts.opt_state["m"]),
                v=tree_to_numpy(ts.opt_state["v"]),
                ef=None if ts.ef_state is None else tree_to_numpy(
                    ts.ef_state), step=ts.step)


def _wire(rank, world):
    x, e = _wire_inputs(world)
    xt, et = torch.from_numpy(x[rank]), torch.from_numpy(e[rank])
    comp.reset_wire_bytes()
    mean = comp.int8_psum_mean(xt)
    wire = comp.wire_bytes()
    ef_mean, ef_err = comp.int8_ef_psum_mean(xt, et)
    err, acc = torch.zeros_like(xt), torch.zeros_like(xt)
    for _ in range(EF_ROUNDS):
        m, err = comp.int8_ef_psum_mean(xt, err)
        acc += m
    return dict(mean=mean.numpy(), ef_mean=ef_mean.numpy(),
                ef_err=ef_err.numpy(), avg=(acc / EF_ROUNDS).numpy(),
                residual=float(err.abs().max()), wire=wire)


def _steps(rank, world, jstate, tmp):
    """The compressed and uncompressed D = 2 steps, the exchange of the
    first, and a compressed restart through the Trainer."""
    out = {}
    batch = _batch()
    for c in ("int8_ef", "none"):
        run = _run(c)
        ts = train_state_from_jax(jstate)
        if c == "int8_ef":
            ts = ts._replace(ef_state=train_step.init_ef_state(ts.params))
            rows = slice(rank * 2, rank * 2 + 2)
            grad_fn = train_step.make_grad_fn(
                run, train_step.make_loss_fn(run))
            grads, _, _ = grad_fn(ts.params, ts.kstate,
                                  {"tokens": batch["tokens"][rows]}, None)
            mean, new_ef = train_step.exchange_grads(grads, ts.ef_state)
            out["grads"] = tree_to_numpy(grads)
            out["mean"] = tree_to_numpy(mean)
            out["new_ef"] = tree_to_numpy(new_ef)
        step = train_step.make_train_step(run)
        ts1, m1 = step(ts, batch)
        out[c] = dict(_np_state(ts1), loss=float(m1["loss"]),
                      tokens=float(m1["tokens"]))
    run = _run("int8_ef")
    fn = train_step.make_train_step(run, "torch")
    full = Trainer(run, _loader(), ckpt_dir=f"{tmp}/a", ckpt_every=2,
                   device="cpu", step_fn=fn)
    full.fit(4)
    Trainer(run, _loader(), ckpt_dir=f"{tmp}/b", ckpt_every=2,
            device="cpu", step_fn=fn).fit(2)
    res = Trainer(run, _loader(), ckpt_dir=f"{tmp}/b", ckpt_every=2,
                  device="cpu", step_fn=fn)
    res.fit(4)
    out["restart"] = dict(full=_np_state(full.state),
                          resumed=_np_state(res.state),
                          losses=[m["loss"] for m in full.metrics_history],
                          resumed_losses=[m["loss"]
                                          for m in res.metrics_history])
    return out


def _launch(rank, world, coordinator, tmp):
    from repro_torch.launch import train as launcher
    argv = ["--arch", "rt-enwik8", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "64", "--device", "cpu", "--grad-compression",
            "int8_ef", "--ckpt-dir", f"{tmp}/launch", "--coordinator",
            coordinator, "--num-processes", str(world), "--process-id",
            str(rank)]
    out = launcher.main(argv)
    return dict(out, initialized=torch.distributed.is_initialized())


def _worker(rank, world, tmp, coordinator, jstate):
    """One rank: the launcher (its own tcp:// process group, destroyed on
    return), then, in a file:// group, the wire and the steps. One thread
    each: the ranks share the host's cores with each other and the other
    test processes."""
    torch.set_num_threads(1)
    res = {}
    if coordinator:
        res["launch"] = _launch(rank, world, coordinator, tmp)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank,
        world_size=world, timeout=PG_TIMEOUT)
    res["wire"] = _wire(rank, world)
    if jstate is not None:
        res["steps"] = _steps(rank, world, jstate, tmp)
    torch.distributed.destroy_process_group()
    torch.save(res, f"{tmp}/rank{rank}.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, tmp, launch=False, jstate=None):
    ctx = mp.get_context("spawn")
    coordinator = f"127.0.0.1:{_free_port()}" if launch else None
    procs = [ctx.Process(target=_worker,
                         args=(r, world, str(tmp), coordinator, jstate))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _results(procs, tmp):
    for p in procs:
        p.join(JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"ranks exited with {codes}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def ranks2_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks2")


@pytest.fixture(scope="module")
def ranks(ranks2_dir, tmp_path_factory, jx):
    """Both spawns at once: 2 ranks (the launcher, the wire, the steps)
    and 4 (the wire)."""
    # the state as plain containers: unpickling JAX's TrainState would
    # import JAX in every rank
    st = jx.state
    jstate = types.SimpleNamespace(params=st.params, kstate=st.kstate,
                                   opt_state=st.opt_state, step=st.step)
    dir4 = tmp_path_factory.mktemp("ranks4")
    p2 = _start(2, ranks2_dir, launch=True, jstate=jstate)
    p4 = _start(4, dir4)
    # the JAX references, while the ranks run; the step's compilation in
    # a thread beside the wire's op-by-op dispatch
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        step = pool.submit(_jax_compressed_step, jx)
        refs = {"wire": {n: _jax_wire(jx, n) for n in (2, 4)},
                "step": step.result()}
    return {2: _results(p2, ranks2_dir), 4: _results(p4, dir4), **refs}


@pytest.fixture(scope="module")
def ranks2(ranks):
    return ranks[2]


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------
def test_quantize_codes_equal_jax(jx):
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 512) * np.exp(rng.randn(6, 1) * 3)).astype(np.float32)
    x[1] = 0.0                                  # a group of zeros
    x[2, :128] = np.arange(128) - 63.5          # ties: scale 64/127
    x[3, :128] = 0.0
    x[3, :4] = [127.0, 2.5, -3.5, 0.5]          # scale 1: half to even
    q, s = comp._quantize(torch.from_numpy(x))
    jq, js = jx.comp._quantize(jx.jax.numpy.asarray(x), 128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[3, :4].tolist() == [127, 2, -4, 0]
    d = comp._dequantize(q, s).numpy()
    np.testing.assert_array_equal(d, np.asarray(
        jx.comp._dequantize(jq, js, 128)))


@pytest.mark.parametrize("n", [2, 4])
def test_wire_means_match_jax(n, ranks):
    x, mean, ef_mean, ef_err = ranks["wire"][n]
    step = np.abs(x.mean(0)).max() / 127      # one hop-2 step of the leaf
    for r, res in enumerate(ranks[n]):
        w = res["wire"]
        for got, want in ((w["mean"], mean[r]), (w["ef_mean"], ef_mean[r])):
            if n == 2:
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= step
        tol = 0 if n == 2 else n * step
        assert np.abs(w["ef_err"] - ef_err[r]).max() <= tol
        # every rank applies the same mean; int8 codes carry the payload
        np.testing.assert_array_equal(w["mean"], ranks[n][0]["wire"]["mean"])
        chunk = -(-M // (n * 128)) * 128
        assert w["wire"]["int8"] == 2 * (n - 1) * chunk
        assert w["wire"]["fp32"] == 2 * (n - 1) * (chunk // 128) * 4


@pytest.mark.parametrize("n", [2, 4])
def test_error_feedback_is_unbiased(n, ranks):
    x, _ = _wire_inputs(n)
    true = x.mean(0)
    for res in ranks[n]:
        w = res["wire"]
        ef_err = np.linalg.norm(w["avg"] - true)
        noef_err = np.linalg.norm(w["mean"] - true)
        assert ef_err < 0.3 * noef_err, (ef_err, noef_err)
        assert w["residual"] < 0.3


def test_identity_without_a_group():
    x, e = torch.randn(300), torch.randn(300)
    assert comp.world_size() == 1 and comp.rank() == 0
    assert comp.int8_psum_mean(x) is x
    m, ne = comp.int8_ef_psum_mean(x, e)
    assert m is x and ne is e
    assert comp.all_mean(x) is x and comp.all_sum(x) is x


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_d1_compressed_step_equals_uncompressed(jx):
    batch = _batch()
    out = {}
    for c in ("none", "int8_ef"):
        run = _run(c)
        ts = train_state_from_jax(jx.state)
        if c == "int8_ef":
            ts = ts._replace(ef_state=train_step.init_ef_state(ts.params))
        step = train_step.make_train_step(run)
        for b in (batch, batch):
            ts, m = step(ts, b)
        out[c] = (ts, float(m["loss"]))
    (a, la), (b, lb) = out["none"], out["int8_ef"]
    assert la == lb
    for x, y in zip(tree_leaves((a.params, a.kstate, a.opt_state["m"])),
                    tree_leaves((b.params, b.kstate, b.opt_state["m"]))):
        assert torch.equal(x, y)
    assert all(float(e.abs().max()) == 0.0 for e in tree_leaves(b.ef_state))


def test_ef_state_rows_are_checked(jx):
    """A JAX residual comes across with all its rows at world size 1; the
    step takes one row per rank and refuses two."""
    jts = jx.state._replace(ef_state=jx.ts.init_ef_state(jx.state.params, 1))
    ts = train_state_from_jax(jts)
    assert {e.shape[0] for e in tree_leaves(ts.ef_state)} == {1}
    two = ts._replace(ef_state=tree_map(lambda e: e.expand(
        2, *e.shape[1:]), ts.ef_state))
    step = train_step.make_train_step(_run("int8_ef"))
    with pytest.raises(ValueError, match="ef_state rows"):
        step(two, _batch())
    with pytest.raises(ValueError, match="ef_state rows"):
        step(ts._replace(ef_state=None), _batch())
    assert step(ts, _batch())[0].step == 1


def _flat(tree):
    from repro_torch.ckpt.checkpoint import _flatten
    return dict(_flatten(tree))


def test_compressed_step_d2_follows_jax(ranks):
    want, ranks2 = ranks["step"], ranks[2]
    lr = _TRAIN["lr"]
    wmean, wef = _flat(want["mean"]), _flat(want["ef"])
    for r, res in enumerate(ranks2):
        s = res["steps"]
        for k, g in _flat(s["grads"]).items():
            w = _flat(want["grads"][r])[k]
            np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max())
        for k, m in _flat(s["mean"]).items():
            # one hop-2 step in the mean; in the residual one hop-1 step
            # of this rank's grads plus n hop-2 steps
            step = np.abs(wmean[k]).max() / 127
            step1 = np.abs(_flat(s["grads"])[k]).max() / 127
            assert np.abs(m - wmean[k]).max() <= step + 1e-6, k
            e, we = _flat(s["new_ef"])[k][0], wef[k][r]
            assert np.abs(e - we).max() <= step1 + 2 * step + 1e-6, k
        st = s["int8_ef"]
        assert abs(st["loss"] - want["loss"]) < 1e-5
        for k, p in _flat(st["params"]).items():
            assert np.abs(p - _flat(want["ts"].params)[k]).max() <= 2 * lr
        for k, e in _flat(st["ef"]).items():
            np.testing.assert_array_equal(e, _flat(s["new_ef"])[k])
    a, b = (res["steps"]["int8_ef"] for res in ranks2)
    for part in ("params", "kstate", "m", "v"):
        for k, x in _flat(a[part]).items():
            np.testing.assert_array_equal(x, _flat(b[part])[k])


def test_uncompressed_step_d2_matches_one_process(jx, ranks2):
    run = _run()
    batch = _batch()
    ts = train_state_from_jax(jx.state)
    one, m = train_step.make_train_step(run)(ts, batch)
    grad_fn = train_step.make_grad_fn(run, train_step.make_loss_fn(run))
    ks = [grad_fn(ts.params, ts.kstate,
                  {"tokens": batch["tokens"][r * 2:r * 2 + 2]}, None)[1]
          for r in range(2)]
    for res in ranks2:
        st = res["steps"]["none"]
        assert abs(st["loss"] - float(m["loss"])) < 1e-6
        assert st["tokens"] == float(m["tokens"]) == 4 * 32
        assert st["ef"] is None and st["step"] == 1
        for k, p in _flat(tree_to_numpy(one.params)).items():
            np.testing.assert_allclose(_flat(st["params"])[k], p, atol=1e-6)
        for k, a in _flat(tree_to_numpy(ks[0])).items():
            b = _flat(tree_to_numpy(ks[1]))[k]
            np.testing.assert_allclose(_flat(st["kstate"])[k], (a + b) / 2,
                                       atol=1e-6)


def test_compressed_restart_d2_and_restore_at_d1(ranks2, ranks2_dir,
                                                 tmp_path):
    for res in ranks2:
        rs = res["steps"]["restart"]
        for part in ("params", "kstate", "m", "v", "ef"):
            for k, x in _flat(rs["full"][part]).items():
                np.testing.assert_array_equal(x, _flat(rs["resumed"][part])[k])
        assert rs["resumed_losses"] == rs["losses"][2:]
        assert rs["resumed"]["step"] == 4
    # the two ranks' residuals differ; their checkpoint holds both rows
    e0, e1 = (_flat(res["steps"]["restart"]["full"]["ef"]) for res in ranks2)
    assert any(np.abs(e0[k] - e1[k]).max() > 0 for k in e0)
    ckpt = shutil.copytree(ranks2_dir / "b", tmp_path / "b")
    tr = Trainer(_run("int8_ef"), _loader(), ckpt_dir=str(ckpt),
                 device="cpu")
    got = tr.init_or_restore()
    assert got.step == 4 and tr.loader.step == 4
    for k, p in _flat(tree_to_numpy(got.params)).items():
        np.testing.assert_array_equal(
            p, _flat(ranks2[0]["steps"]["restart"]["full"]["params"])[k])
    assert all(float(e.abs().max()) == 0.0 for e in tree_leaves(got.ef_state))


def test_launcher_over_two_processes(ranks2):
    outs = [res["launch"] for res in ranks2]
    assert all(o["steps"] == 2 and not o["initialized"] for o in outs)
    assert outs[0]["final_loss"] == outs[1]["final_loss"]


# ---------------------------------------------------------------------------
# launch spec and mesh (copies of the JAX package's cases)
# ---------------------------------------------------------------------------
def test_detect_nothing_configured_is_single_process():
    assert dist.detect(env={}) is None


def test_detect_from_env():
    spec = dist.detect(env={dist.ENV_COORDINATOR: "host0:9876",
                            dist.ENV_NUM_PROCESSES: "4",
                            dist.ENV_PROCESS_ID: "2"})
    assert spec == dist.LaunchSpec("host0:9876", 4, 2)


def test_flags_override_env():
    spec = dist.detect(env={dist.ENV_COORDINATOR: "stale:1",
                            dist.ENV_NUM_PROCESSES: "2",
                            dist.ENV_PROCESS_ID: "1"},
                       coordinator="fresh:2", num_processes=8,
                       process_id=7)
    assert spec == dist.LaunchSpec("fresh:2", 8, 7)


def test_missing_rank_raises():
    with pytest.raises(ValueError, match="explicit rank"):
        dist.detect(env={dist.ENV_COORDINATOR: "host0:9876",
                         dist.ENV_NUM_PROCESSES: "2"})
    with pytest.raises(ValueError, match="explicit rank"):
        dist.detect(env={dist.ENV_COORDINATOR: "host0:9876",
                         dist.ENV_NUM_PROCESSES: "2",
                         dist.ENV_PROCESS_ID: ""})


def test_half_configured_launch_raises():
    with pytest.raises(ValueError, match="coordinator"):
        dist.detect(env={dist.ENV_NUM_PROCESSES: "4"})
    with pytest.raises(ValueError):
        dist.detect(env={dist.ENV_COORDINATOR: "host0:9876"})


def test_spec_validation():
    with pytest.raises(ValueError, match="process_id"):
        dist.LaunchSpec("host0:9876", 4, 4)
    with pytest.raises(ValueError, match="host:port"):
        dist.LaunchSpec("no-port", 4, 0)
    assert dist.LaunchSpec("", 1, 0).num_processes == 1


def test_initialize_single_process_fallback():
    assert dist.initialize(env={}) is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl")])
def test_initialize_picks_the_backend(monkeypatch, device, backend):
    calls = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: calls.update(backend=b, **kw))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.update(card=i))
    env = {dist.ENV_COORDINATOR: "host0:9876", dist.ENV_NUM_PROCESSES: "8",
           dist.ENV_PROCESS_ID: "5"}
    assert dist.initialize(env=env, device=device) is True
    assert calls["backend"] == backend
    assert calls["init_method"] == "tcp://host0:9876"
    assert (calls["world_size"], calls["rank"]) == (8, 5)
    assert calls["timeout"].total_seconds() == dist.TIMEOUT_S
    assert calls.get("card") == (1 if device == "cuda" else None)
    dist.initialize(env=env, device=device, backend="gloo")
    assert calls["backend"] == "gloo"


def test_process_info_single_process():
    info = dist.process_info()
    assert info["process_index"] == 0
    assert info["process_count"] == 1
    assert info["global_devices"] >= 1


@pytest.mark.parametrize("n,data,model,want", [
    (8, 2, 4, (2, 4)), (8, 1, 1, (1, 1)), (16, 16, 1, (16, 1)),
    (8, 4, 4, (2, 4)), (8, 2, 16, (1, 8)), (8, 16, 2, (4, 2)),
    (8, 3, 5, (2, 4)), (6, 4, 3, (2, 3)), (6, 4, 4, (2, 3)),
    (1, 2, 4, (1, 1)), (1, 1, 1, (1, 1))])
def test_feasible_mesh_shape(n, data, model, want):
    from repro.launch.mesh import feasible_mesh_shape
    assert port_mesh.feasible_mesh_shape(n, data, model) == want == \
        feasible_mesh_shape(n, data, model)


def test_host_mesh_clamps_to_the_data_axis(monkeypatch):
    """The clamped grid, its coordinates, and the production meshes'
    shapes (the JAX package's); a model axis above 1 builds process
    groups, held in `test_torch_tp.py`."""
    m = dist.make_process_mesh(64, 64)
    assert m.shape == {"data": 1, "model": 1}
    assert m.coords == {"data": 0, "model": 0} and m.groups == {}
    assert port_mesh.make_host_mesh(2, 4).shape == {"data": 1, "model": 1}
    monkeypatch.setattr(comp, "world_size", lambda group=None: 8)
    monkeypatch.setattr(comp, "rank", lambda group=None: 5)
    m = port_mesh.make_host_mesh(8, 1)
    assert m.shape == {"data": 8, "model": 1}
    assert m.coords == {"data": 5, "model": 0}
    assert m.groups == {"data": None}        # the default group
    with pytest.raises(ValueError, match="processes out"):
        port_mesh.make_host_mesh(4, 1)
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        pm = port_mesh.make_production_mesh(multi_pod=multi_pod)
        assert pm.shape == shape and pm.axis_names == tuple(shape)
        assert pm.coords is None and pm.groups == {}
