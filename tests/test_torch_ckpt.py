"""The port's checkpoints against the JAX package's (``repro.ckpt``,
``repro.train.trainer``), on the CPU at the reduced config of
``tests/test_ckpt.py`` (fp32, 2 layers, d_model 32, local+routing).

* the JAX package's cases, mirrored: round trip, a torn ``.tmp`` ignored,
  the keep limit, a shape mismatch (and a missing leaf) raising, residuals
  (``ef_state``) round trip and warm start from an uncompressed checkpoint,
  the legacy bare-tuple layout, a restart bit for bit (with and without
  int8_ef), preemption. Restart and preemption run on the plain impl
  (``impl="torch"``): the fused kernels' glue is not run-to-run exact in
  its backward on the CPU. Tolerance: 0, every leaf equal.
* format parity, both ways: a checkpoint of the JAX `Trainer` restores in
  the port equal to `train_state_from_jax` of the same JAX state (bit for
  bit); the port writes the same keys and the same bytes for every array
  as the JAX package does for that state, and the JAX `CheckpointManager`
  restores the port's file with fp32 leaves equal to the port's (bit for
  bit); a bf16 leaf JAX wrote (``|V2`` words) reads back in the port as the
  same bits, and the port writes the same bytes for it (numpy writes
  ``ml_dtypes.bfloat16`` under the descr ``'<V2'``).
* a JAX run continued by the port from the JAX Trainer's checkpoint tracks
  JAX's own continuation: losses and parameters within 1e-5 (the
  tolerance of ``test_torch_train.py``'s 20-step trajectories).
"""
import os
import shutil
import signal
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxManager
from repro.ckpt.checkpoint import _flatten as jax_flatten
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.synthetic import SyntheticLoader as JaxLoader
from repro.train.train_step import init_ef_state as jax_init_ef_state
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.ckpt.checkpoint import (CheckpointManager, _flatten,
                                         to_host)
from repro_torch.configs.base import (ModelConfig, RoutingConfig, RunConfig,
                                      TrainConfig)
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.interop import train_state_from_jax, tree_to_numpy
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map

_MODEL = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
              d_ff=64, vocab_size=64, attention="local+routing",
              dtype="float32")
_ROUTING = dict(num_clusters=2, local_window=8)
_TRAIN = dict(global_batch=4, seq_len=32, steps=9, lr=1e-3,
              schedule="const", warmup_steps=1)
CFG = ModelConfig(**_MODEL, routing=RoutingConfig(**_ROUTING))
JCFG = JaxModelConfig(**_MODEL, routing=JaxRoutingConfig(**_ROUTING))
TRAJ_TOL = 1e-5


def _run(compression="none"):
    return RunConfig(model=CFG, train=TrainConfig(
        **_TRAIN, grad_compression=compression))


def _jrun(compression="none"):
    return JaxRunConfig(model=JCFG, train=JaxTrainConfig(
        **_TRAIN, grad_compression=compression))


def _loader():
    return SyntheticLoader("markov", 64, 4, 32)


def _trainer(run, path, **kw):
    return Trainer(run, _loader(), ckpt_dir=str(path), device="cpu",
                   step_fn=make_train_step(run, "torch"), **kw)


def _equal(a, b) -> bool:
    """Two port trees (or TrainStates) equal leaf for leaf by their
    checkpoint keys (dicts in any key order), bits and dtypes, ints too."""
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    return fa.keys() == fb.keys() and all(
        (torch.equal(x, fb[k]) and x.dtype == fb[k].dtype)
        if isinstance(x, torch.Tensor) else x == fb[k]
        for k, x in fa.items())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _members(path):
    """name -> bytes of every array of a checkpoint's npz, in file order."""
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return [(n, z.read(n)) for n in z.namelist()]


@pytest.fixture(scope="module")
def jax_states():
    """JAX's fresh TrainState (seed 0) without and with residuals."""
    jts = jax.jit(lambda k: jax_init_train_state(_jrun(), k))(
        jax.random.PRNGKey(0))
    return {"none": jts, "int8_ef": jts._replace(
        ef_state=jax_init_ef_state(jts.params, 1))}


# ---------------------------------------------------------------------------
# the JAX package's cases
# ---------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.int32),
                   "h": torch.randn(3, 5).to(torch.bfloat16)},
             "n": 7, "z": None}
    mgr.save(3, state, extra={"loader": {"step": 7, "seed": 0}})
    restored, extra = mgr.restore(state)
    assert _equal(state, restored) and restored["z"] is None
    assert isinstance(restored["n"], int)
    assert extra["loader"]["step"] == 7
    assert mgr.keys() == ["a", "b/c", "b/h", "n"]


def test_torn_save_ignored(tmp_path):
    """A .tmp directory (a crash mid-save) is invisible, and cleaned up."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.ones(2)}
    mgr.save(1, state)
    torn = tmp_path / "step_00000002.tmp"
    os.makedirs(torn)
    (torn / "arrays.npz").write_text("garbage")
    assert mgr.latest_step() == 1
    assert _equal(mgr.restore(state)[0], state)
    mgr.save(3, state)      # commits, then removes the .tmp
    assert not os.path.exists(torn)


def test_keep_limit_and_duplicate_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4]
    mgr.save(4, {"w": torch.zeros(2)})      # already committed: kept
    assert _equal(mgr.restore({"w": torch.ones(2)})[0],
                  {"w": torch.full((2,), 4.0)})
    mgr.save_async(5, {"w": torch.full((2,), 5.0)})
    mgr.wait()
    assert mgr.all_steps() == [4, 5] and mgr._thread is None


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf v"):
        mgr.restore({"w": torch.ones(2), "v": torch.ones(2)})
    empty = CheckpointManager(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        empty.restore({"w": torch.ones(2)})


def test_restore_takes_the_templates_dtype(tmp_path):
    """Each leaf comes back in its template's dtype: bf16 words into an
    fp32 template, fp32 into a bf16 one."""
    x = torch.arange(4, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": x.to(torch.bfloat16), "b": x})
    got, _ = mgr.restore({"a": x, "b": x.to(torch.bfloat16)})
    assert got["a"].dtype == torch.float32 and torch.equal(got["a"], x)
    assert got["b"].dtype == torch.bfloat16


def test_ef_state_roundtrip_and_warm_start(tmp_path):
    """The residual survives a round trip bit for bit; a checkpoint without
    one (or with another data-parallel size) restores into a compressed
    state with zero residuals."""
    ts = init_train_state(_run("int8_ef"), device="cpu")
    assert all(e.shape[0] == 1 for e in tree_leaves(ts.ef_state))
    ts = ts._replace(ef_state=tree_map(lambda e: e + 0.25, ts.ef_state))
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, ts._asdict())
    assert _equal(TrainState(**mgr.restore(ts._asdict())[0]), ts)

    plain = init_train_state(_run(), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "p"))
    mgr.save(1, plain._asdict())
    wide = ts._replace(ef_state=tree_map(lambda e: e.expand(
        2, *e.shape[1:]), ts.ef_state))
    mgr.save(2, wide._asdict())
    for step in (1, 2):
        got = TrainState(**mgr.restore(ts._asdict(), step=step)[0])
        assert _equal(got.params, ts.params)
        assert all(float(e.abs().max()) == 0.0
                   for e in tree_leaves(got.ef_state))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_legacy_tuple_checkpoint_restores(tmp_path, writer, jax_states):
    """A checkpoint of the bare TrainState tuple (the layout before the
    field-named one; JAX keys its leaves ".params/...") resumes through
    the Trainer, with fresh zero residuals when compression is on."""
    if writer == "port":
        ts = init_train_state(_run(), device="cpu")
        CheckpointManager(str(tmp_path)).save(
            4, ts, extra={"loader": {"step": 4, "seed": 0}})
    else:
        jts = jax_states["none"]
        JaxManager(str(tmp_path)).save(
            4, jts, extra={"loader": {"step": 4, "seed": 0}})
        ts = train_state_from_jax(_np(jts))
    assert CheckpointManager(str(tmp_path)).keys()[0] == ".kstate/0/0"
    for comp in ("none", "int8_ef"):
        tr = Trainer(_run(comp), _loader(), ckpt_dir=str(tmp_path),
                     device="cpu")
        got = tr.init_or_restore()
        assert _equal(got.params, ts.params) and got.step == ts.step == 0
        assert _equal(got.opt_state, ts.opt_state)
        assert tr.loader.step == 4
        if comp == "int8_ef":
            assert all(float(e.abs().max()) == 0.0
                       for e in tree_leaves(got.ef_state))


@pytest.mark.parametrize("comp", ["none", "int8_ef"])
def test_restart_bit_exact(tmp_path, comp):
    """Stopped at step 5 and resumed by a fresh Trainer == uninterrupted 9
    steps: every leaf of params, centroids, optimizer state and residual,
    the step, the loader cursor and the losses of steps 6-9."""
    run = _run(comp)
    full = _trainer(run, tmp_path / "a", ckpt_every=3)
    full.fit(9)
    _trainer(run, tmp_path / "b", ckpt_every=3).fit(5)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [3, 5]
    res = _trainer(run, tmp_path / "b", ckpt_every=3)
    res.fit(9)
    assert _equal(full.state, res.state) and res.state.step == 9
    assert full.loader.step == res.loader.step == 9
    assert [m["loss"] for m in res.metrics_history] == \
        [m["loss"] for m in full.metrics_history[5:]]
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [5, 6, 9]


def test_preemption_checkpoints_and_stops(tmp_path):
    """A SIGTERM during step 2 ends the fit after it with a synchronous
    checkpoint at step 2; a fresh Trainer resumes it and finishes equal to
    an uninterrupted run."""
    run = _run()
    tr = _trainer(run, tmp_path / "p", ckpt_every=100)
    inner, calls = tr.step_fn, []

    def step_and_preempt(state, batch):
        out = inner(state, batch)
        calls.append(1)
        if len(calls) == 2:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return out

    tr.step_fn = step_and_preempt
    before = signal.getsignal(signal.SIGTERM)
    out = tr.fit(9)
    assert out["preempted"] and out["steps"] == 2
    assert signal.getsignal(signal.SIGTERM) is before
    assert tr.mgr.all_steps() == [2]
    tr2 = _trainer(run, tmp_path / "p", ckpt_every=100)
    out2 = tr2.fit(4)
    assert out2["steps"] == 4 and not out2["preempted"]
    full = _trainer(run, tmp_path / "f", ckpt_every=100)
    full.fit(4)
    assert _equal(full.state, tr2.state)


def test_trainer_without_a_directory_writes_nothing(tmp_path):
    tr = Trainer(_run(), _loader(), device="cpu",
                 step_fn=make_train_step(_run(), "torch"))
    assert tr.fit(1)["steps"] == 1 and tr.mgr is None


# ---------------------------------------------------------------------------
# format parity with the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's Trainer: 5 steps checkpointed at step 5 (the directory is
    copied), then on to 10; its state at 5 from the checkpoint."""
    root = tmp_path_factory.mktemp("jax_run")
    jtr = JaxTrainer(_jrun(), JaxLoader("markov", 64, 4, 32),
                     ckpt_dir=str(root / "j"), ckpt_every=5)
    jtr.fit(5)
    shutil.copytree(root / "j", root / "at5")
    jts5 = _np(jtr.state)            # the next fit donates the state
    jtr.fit(10)
    return dict(dir5=str(root / "at5"), jts5=jts5,
                losses=[float(m["loss"]) for m in jtr.metrics_history],
                jts10=_np(jtr.state))


def test_jax_trainer_checkpoint_restores_in_the_port(jax_run):
    tr = Trainer(_run(), _loader(), ckpt_dir=jax_run["dir5"], device="cpu")
    got = tr.init_or_restore()
    assert _equal(got, train_state_from_jax(jax_run["jts5"]))
    assert got.step == 5 and tr.loader.step == 5


@pytest.mark.parametrize("comp", ["none", "int8_ef"])
def test_port_writes_the_jax_format(tmp_path, comp, jax_states):
    """The same state (JAX's init, carried across) saved by both packages:
    the same sorted keys in the manifest, the same arrays byte for byte in
    the same order; the JAX manager restores the port's file equal to the
    port's leaves."""
    jts = jax_states[comp]
    JaxManager(str(tmp_path / "j")).save(3, jts._asdict(),
                                         extra={"loader": {"step": 3}})
    pts = train_state_from_jax(_np(jts))
    CheckpointManager(str(tmp_path / "p")).save(
        3, pts._asdict(), extra={"loader": {"step": 3}})
    jkeys = JaxManager(str(tmp_path / "j")).keys()
    assert CheckpointManager(str(tmp_path / "p")).keys() == jkeys
    assert any(k.startswith("ef_state/") for k in jkeys) == (
        comp == "int8_ef")
    assert _members(tmp_path / "p" / "step_00000003") == \
        _members(tmp_path / "j" / "step_00000003")
    back, extra = JaxManager(str(tmp_path / "p")).restore(jts._asdict())
    assert extra == {"loader": {"step": 3}}
    jflat = jax_flatten(back)[0]
    pflat = {k: to_host(v) for k, v in _flatten(pts._asdict())}
    assert list(jflat) == list(pflat)
    for k, v in pflat.items():
        np.testing.assert_array_equal(np.asarray(jflat[k]), v)
        assert np.asarray(jflat[k]).dtype == v.dtype


def test_bf16_leaves_read_back_as_the_same_bits(tmp_path):
    """JAX writes an ml_dtypes bfloat16 array as 2-byte words under the
    descr '<V2' (which np.load gives back as void words that its own
    restore cannot cast); the port reads them through a 16-bit view, and
    writes the same bytes itself."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7).astype(np.float32).astype(ml_dtypes.bfloat16)
    JaxManager(str(tmp_path / "j")).save(1, {"w": jnp.asarray(x)})
    like = {"w": torch.zeros(3, 7, dtype=torch.bfloat16)}
    got, _ = CheckpointManager(str(tmp_path / "j")).restore(like)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  x.view(np.int16))
    CheckpointManager(str(tmp_path / "p")).save(1, got)
    assert _members(tmp_path / "p" / "step_00000001") == \
        _members(tmp_path / "j" / "step_00000001")
    assert b"'<V2'" in _members(tmp_path / "p" / "step_00000001")[0][1]


def test_port_continues_a_jax_checkpoint(jax_run, tmp_path):
    """The port's Trainer resumes the JAX Trainer's step-5 checkpoint and
    trains to step 10 on the same batches; JAX's own continuation agrees
    within TRAJ_TOL."""
    ckpt = shutil.copytree(jax_run["dir5"], tmp_path / "c")
    tr = Trainer(_run(), _loader(), ckpt_dir=str(ckpt), device="cpu")
    out = tr.fit(10)
    assert out["steps"] == 10 and tr.loader.step == 10
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_history],
                               jax_run["losses"][5:], atol=TRAJ_TOL)
    want = jax_flatten(jax_run["jts10"].params)[0]
    for k, g in _flatten(tree_to_numpy(tr.state.params)):
        np.testing.assert_allclose(g, want[k], atol=TRAJ_TOL)
    assert CheckpointManager(str(ckpt)).latest_step() == 10
