"""The port's model axis (tensor and sequence parallelism over a (data,
model) mesh of gloo ranks) against the port's one-process step and the JAX
package's single-device step, on the CPU.

One spawn of 2 ranks and one of 4 run every multi-process case of this
file (a ``file://`` rendezvous in the test's directory, and for the
launcher a ``tcp://`` one on a free port; every process group and join
has a timeout); the references run in this process while they run, and
the ranks read the JAX state from a file once this process has made it. The
model is reduced rt-enwik8 (4 heads: each of 2 model ranks runs one local
and one routing head, rank 1's vocabulary block is all padding), its
state carried across from the JAX package's init (`interop` with a mesh).
Dropout 0 and a clip of 0.5 (active: the first step's norm is above 2)
unless said otherwise.

* ``1x2`` and ``2x2``: one step against the port's one-process step on the
  whole batch (parameters within 1e-6; at ``2x2`` the centroids are the
  mean of the data shards' updates, as the data-parallel step's) and
  against JAX's single-device step (loss within 1e-5, gathered gradients
  within 1e-5 of each leaf's largest, parameters within 1e-5: the
  tolerances of `test_torch_train.py`'s one-step parity); every replicated
  leaf equal to the bit on the ranks;
* ``1x2`` sequence-parallel (``RoutingConfig.segments`` 2) against ``1x2``
  without it at dropout 0.4 (two steps; the mask is the unsharded
  stream's): parameters within 1e-6;
* the routing-health stats at ``1x2``: ``routing/*`` and ``rt/*`` equal
  one process's (the ranks' heads gathered), within 1e-5;
* reduced rt-pg19 with Adafactor at ``1x2`` against one process, two
  steps at lr 1e-2: parameters and statistics within 1e-5 of each leaf's
  largest (Adafactor scales its step by the parameter's RMS, ~1 here, so
  a rounding difference in the statistics moves a parameter by ~lr times
  it), the statistics equal on the ranks to the bit;
* a checkpoint written at ``1x2`` (the gathered state, by rank 0) restored
  at ``1x2``, at ``2x1`` and at ``1x1`` byte for byte;
* the launcher at ``--mesh 1x2`` and ``--mesh 1x2 --seq-parallel`` (rt-enwik8
  with 2 segments), equal losses; with 1 segment ``--seq-parallel`` raises
  the JAX package's `ValueError`.
"""
import concurrent.futures
import datetime
import multiprocessing as mp
import os
import socket
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import to_host
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.dist import sharding as shd
from repro_torch.interop import train_state_from_jax, tree_to_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import train_step
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ARCH = "rt-enwik8"
_TRAIN = dict(global_batch=4, seq_len=32, lr=1e-3, schedule="const",
              warmup_steps=1, grad_clip=0.5)
JOIN_S = 240
PG_TIMEOUT = datetime.timedelta(seconds=120)


def _cfg(segments=1, dropout=0.0):
    cfg = with_overrides(reduced_config(ARCH), dropout=dropout)
    return with_overrides(cfg, routing=with_overrides(cfg.routing,
                                                      segments=segments))


def _run(cfg=None, **train):
    return RunConfig(model=cfg or _cfg(), train=TrainConfig(**{**_TRAIN,
                                                               **train}))


def _pg19_run():
    return RunConfig(model=reduced_config("rt-pg19"), train=TrainConfig(
        **{**_TRAIN, "optimizer": "adafactor", "lr": 1e-2}))


def _stats_run():
    cfg = _cfg()
    return _run(with_overrides(cfg, routing=with_overrides(cfg.routing,
                                                           stats=True)))


def _stats_metrics(m):
    return {k: v.numpy() for k, v in m.items()
            if k.startswith(("routing/", "rt/"))}


def _batch(vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": torch.from_numpy(
        rng.randint(0, vocab, (4, 33)).astype(np.int64))}


def _np(ts):
    return dict(params=tree_to_numpy(ts.params),
                kstate=tree_to_numpy(ts.kstate),
                opt=tree_to_numpy({k: v for k, v in ts.opt_state.items()
                                   if k != "count"}))


def _bytes(ts):
    """The bytes of every leaf of a TrainState, in tree order."""
    return [to_host(x).tobytes() for x in tree_leaves(ts._asdict())
            if x is not None]


def _repl_bytes(ts, mesh):
    """The bytes of every replicated tensor leaf, in tree order."""
    pl = shd.state_placements(mesh, ts)._asdict()
    return [to_host(leaf).tobytes()
            for path, leaf in tree_paths(ts._asdict())
            if isinstance(leaf, torch.Tensor)
            and "model" not in shd.placement_at(pl, path)]


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _step(run, ts, mesh, sp=False, steps=1, batch=None):
    from repro_torch.attn.spec import specs_for_model
    cf = shd.make_constrain_fn(mesh, sp,
                               attn_specs=specs_for_model(run.model))
    grads, _, _ = train_step.make_tp_grad_fn(run, None, cf, mesh)(
        ts.params, ts.kstate, batch or _batch(), None)
    full_g = shd.gather_tree(grads, shd.grads_placements(mesh, grads), mesh,
                             shd.head_groups(run.model, mesh.size("model")))
    step = train_step.make_train_step(run, None, cf, mesh)
    losses = []
    for i in range(steps):
        ts, m = step(ts, batch or _batch(seed=i))
        losses.append(float(m["loss"]))
    return dict(losses=losses, grads=tree_to_numpy(full_g),
                repl=_repl_bytes(ts, mesh),
                state=_np(shd.gather_state(ts, run.model, mesh)))


def _ranks2(rank, tmp, jstate):
    mesh = make_host_mesh(1, 2)
    assert mesh.coords == {"data": 0, "model": rank}
    out = {}
    run = _run()
    ts = train_state_from_jax(jstate, "cpu", mesh, run.model)
    out["1x2"] = _step(run, ts, mesh)
    for sp in (False, True):
        run = _run(_cfg(segments=2, dropout=0.4))
        ts = train_state_from_jax(jstate, "cpu", mesh, run.model)
        out[f"drop_sp{int(sp)}"] = _step(run, ts, mesh, sp, steps=2)
    run = _stats_run()
    ts = train_state_from_jax(jstate, "cpu", mesh, run.model)
    _, _, m = train_step.make_tp_grad_fn(
        run, None, shd.make_constrain_fn(mesh), mesh)(
        ts.params, ts.kstate, _batch(), None)
    out["stats"] = _stats_metrics(m)
    run = _pg19_run()
    ts = train_step.init_train_state(run, seed=0, device="cpu", mesh=mesh)
    out["pg19"] = _step(run, ts, mesh, steps=2,
                        batch=_batch(run.model.vocab_size))
    # a checkpoint at 1 x 2, restored at 1 x 2 and at 2 x 1
    from repro_torch.data.synthetic import SyntheticLoader
    run = _run()

    def trainer(m):
        return Trainer(run, SyntheticLoader("markov", 128, 4, 32),
                       ckpt_dir=f"{tmp}/ckpt", ckpt_every=2, device="cpu",
                       mesh=m, constrain_fn=shd.make_constrain_fn(m))
    tr = trainer(mesh)
    tr.fit(2)
    full = shd.gather_state(tr.state, run.model, mesh)
    again = trainer(mesh).init_or_restore()
    out["ckpt"] = dict(
        full=_bytes(full),
        shards_equal=_bytes(tr.state) == _bytes(again))
    torch.distributed.barrier()
    dp = make_host_mesh(2, 1)
    assert dp.coords == {"data": rank, "model": 0}
    st = trainer(dp).init_or_restore()
    out["ckpt"]["at_2x1"] = _bytes(st)
    return out


def _ranks4(rank, jstate):
    mesh = make_host_mesh(2, 2)
    assert mesh.coords == {"data": rank // 2, "model": rank % 2}
    run = _run()
    ts = train_state_from_jax(jstate, "cpu", mesh, run.model)
    return {"2x2": _step(run, ts, mesh)}


def _launch(rank, coordinator, extra, segments):
    from repro_torch.launch import train as launcher
    launcher.reduced_config = lambda arch: _cfg(segments)
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--mesh", "1x2",
            "--coordinator", coordinator, "--num-processes", "2",
            "--process-id", str(rank), *extra]
    try:
        return launcher.main(argv)
    except ValueError as e:
        return {"error": str(e)}


def _jstate(tmp):
    """The JAX state the test process writes once its JAX init is done
    (the ranks start before it, and run the launcher meanwhile)."""
    path = f"{tmp}/jstate.pt"
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > JOIN_S:
            raise TimeoutError(path)
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _worker(rank, world, tmp, ports):
    torch.set_num_threads(1)
    res = {}
    if ports:
        for name, extra, segments in (("mesh", [], 1),
                                      ("sp", ["--seq-parallel"], 2),
                                      ("sp_global", ["--seq-parallel"], 1)):
            res[name] = _launch(rank, ports.pop(0), extra, segments)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank,
        world_size=world, timeout=PG_TIMEOUT)
    jstate = _jstate(tmp)
    res.update(_ranks2(rank, tmp, jstate) if world == 2
               else _ranks4(rank, jstate))
    torch.distributed.destroy_process_group()
    torch.save(res, f"{tmp}/rank{rank}.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _start(world, tmp, launch=False):
    ctx = mp.get_context("spawn")
    ports = [_free_port() for _ in range(3)] if launch else []
    procs = [ctx.Process(target=_worker,
                         args=(r, world, str(tmp), list(ports)))
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


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------
def _one_process(run, ts, steps=1, batch=None, halves=False):
    """The port's one-process step(s); with ``halves`` the centroids are
    the mean of the two half batches' updates (the data-parallel rule)."""
    grads, new_k, _ = train_step.make_grad_fn(
        run, train_step.make_loss_fn(run))(ts.params, ts.kstate,
                                           batch or _batch(), None)
    if halves:
        b = batch or _batch()
        ks = [train_step.make_grad_fn(run, train_step.make_loss_fn(run))(
            ts.params, ts.kstate, {"tokens": b["tokens"][i * 2:i * 2 + 2]},
            None)[1] for i in range(2)]
        new_k = tree_map(lambda a, c: (a + c) / 2, *ks)
    step = train_step.make_train_step(run)
    losses = []
    for i in range(steps):
        ts, m = step(ts, batch or _batch(seed=i))
        losses.append(float(m["loss"]))
    if halves:
        ts = ts._replace(kstate=new_k)
    return dict(losses=losses, grads=tree_to_numpy(grads), state=_np(ts))


def _jax_step(jstate):
    """The JAX package's single-device step on the whole batch."""
    import jax
    from repro.configs import reduced_config as jax_reduced
    from repro.configs.base import RunConfig as JRun
    from repro.configs.base import TrainConfig as JT
    from repro.train import train_step as jts
    jrun = JRun(model=jax_reduced(ARCH), train=JT(**_TRAIN))
    state = jts.TrainState(*jax.tree.map(jax.numpy.asarray,
                                         (jstate.params, jstate.kstate,
                                          jstate.opt_state, jstate.step)))
    batch = {"tokens": jax.numpy.asarray(_batch()["tokens"].numpy())}
    grads, _, _ = jax.jit(jts.make_grad_fn(jrun, jts.make_loss_fn(jrun)))(
        state.params, state.kstate, batch, None)
    new, m = jax.jit(jts.make_train_step(jrun))(state, batch)
    return dict(loss=float(m["loss"]), grads=jax.tree.map(np.asarray, grads),
                params=jax.tree.map(np.asarray, new.params))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    dir2, dir4 = (tmp_path_factory.mktemp(n) for n in ("tp2", "tp4"))
    p2 = _start(2, dir2, launch=True)
    p4 = _start(4, dir4)
    import jax
    from repro.configs import reduced_config as jax_reduced
    from repro.configs.base import RunConfig as JRun
    from repro.configs.base import TrainConfig as JT
    from repro.train import train_step as jts
    jrun = JRun(model=jax_reduced(ARCH), train=JT(**_TRAIN))
    st = jax.tree.map(np.asarray, jax.jit(
        lambda k: jts.init_train_state(jrun, k))(jax.random.PRNGKey(0)))
    jstate = types.SimpleNamespace(params=st.params, kstate=st.kstate,
                                   opt_state=st.opt_state, step=st.step)
    for d in (dir2, dir4):
        torch.save(jstate, d / "jstate.tmp")
        os.replace(d / "jstate.tmp", d / "jstate.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jref = pool.submit(_jax_step, jstate)
        refs = {}
        run = _run()
        refs["one"] = _one_process(run, train_state_from_jax(jstate))
        refs["halves"] = _one_process(run, train_state_from_jax(jstate),
                                      halves=True)
        srun = _stats_run()
        refs["stats"] = _stats_metrics(train_step.make_grad_fn(
            srun, train_step.make_loss_fn(srun))(
            *train_state_from_jax(jstate)[:2], _batch(), None)[2])
        prun = _pg19_run()
        refs["pg19"] = _one_process(
            prun, train_step.init_train_state(prun, seed=0, device="cpu"),
            steps=2, batch=_batch(prun.model.vocab_size))
        refs["jax"] = jref.result()
    r2, r4 = _results(p2, dir2), _results(p4, dir4)
    return dict(r2=r2, r4=r4, refs=refs, dir2=dir2)


def _close(got, want, tol, rel_to_max=False):
    """Leaf by leaf, matched by path (the JAX package's trees order dict
    keys their own way)."""
    want = dict(tree_paths(want))
    got = dict(tree_paths(got))
    assert got.keys() == want.keys()
    for p in want:
        a = np.asarray(got[p], np.float64)
        b = np.asarray(want[p], np.float64)
        scale = max(np.abs(b).max(), 1e-30) if rel_to_max else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _repl_equal(rows):
    assert all(r == rows[0] for r in rows)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_step_matches_one_process(ranks, mesh):
    rows = [r[mesh] for r in (ranks["r2"] if mesh == "1x2" else ranks["r4"])]
    ref = ranks["refs"]["one" if mesh == "1x2" else "halves"]
    got = rows[0]
    assert got["losses"] == pytest.approx(ref["losses"], rel=1e-6)
    _close(got["state"]["params"], ref["state"]["params"], 1e-6)
    _close(got["state"]["kstate"], ref["state"]["kstate"], 1e-6)
    _close(got["state"]["opt"], ref["state"]["opt"], 1e-6)
    _repl_equal([r["repl"] for r in rows])
    for r in rows[1:]:
        assert r["losses"] == got["losses"]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_step_matches_jax(ranks, mesh):
    got = (ranks["r2"] if mesh == "1x2" else ranks["r4"])[0][mesh]
    ref = ranks["refs"]["jax"]
    assert got["losses"][0] == pytest.approx(ref["loss"], rel=1e-5)
    _close(got["grads"], ref["grads"], 1e-5, rel_to_max=True)
    _close(got["state"]["params"], ref["params"], 1e-5)


def test_seq_parallel_equals_tp_under_dropout(ranks):
    rows = ranks["r2"]
    a, b = rows[0]["drop_sp0"], rows[0]["drop_sp1"]
    assert a["losses"] == pytest.approx(b["losses"], rel=1e-6)
    _close(b["grads"], a["grads"], 1e-6, rel_to_max=True)
    _close(b["state"], a["state"], 1e-6)
    _repl_equal([r["drop_sp1"]["repl"] for r in rows])
    # dropout is on: the step differs from the dropout-free one
    assert a["losses"][0] != rows[0]["1x2"]["losses"][0]


def test_routing_stats_at_1x2_are_the_whole_models(ranks):
    """Each rank computes its routing heads' stats; the step gathers them,
    so ``routing/*`` and ``rt/*`` equal one process's."""
    ref = ranks["refs"]["stats"]
    assert any(k.startswith("rt/") for k in ref)
    for r in ranks["r2"]:
        got = r["stats"]
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_adafactor_at_1x2_matches_one_process(ranks):
    got, ref = ranks["r2"][0]["pg19"], ranks["refs"]["pg19"]
    assert got["losses"] == pytest.approx(ref["losses"], rel=1e-6)
    _close(got["state"]["params"], ref["state"]["params"], 1e-5,
           rel_to_max=True)
    _close(got["state"]["opt"], ref["state"]["opt"], 1e-5, rel_to_max=True)
    _repl_equal([r["pg19"]["repl"] for r in ranks["r2"]])


def test_checkpoint_restores_across_meshes_byte_for_byte(ranks):
    rows = [r["ckpt"] for r in ranks["r2"]]
    full = rows[0]["full"]
    assert all(r["shards_equal"] for r in rows)
    assert all(r["full"] == full and r["at_2x1"] == full for r in rows)
    from repro_torch.data.synthetic import SyntheticLoader
    st = Trainer(_run(), SyntheticLoader("markov", 128, 4, 32),
                 ckpt_dir=str(ranks["dir2"] / "ckpt"),
                 device="cpu").init_or_restore()
    assert _bytes(st) == full
    assert st.step == 2


def test_launcher_runs_the_model_axis(ranks):
    rows = ranks["r2"]
    for r in rows:
        assert r["mesh"]["steps"] == r["sp"]["steps"] == 2
        assert "route globally" in r["sp_global"]["error"]
    assert rows[0]["mesh"]["final_loss"] == rows[1]["mesh"]["final_loss"]
    assert rows[0]["sp"]["final_loss"] == rows[1]["sp"]["final_loss"]
    assert np.isfinite(rows[0]["sp"]["final_loss"])
