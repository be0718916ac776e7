"""The serve engine on a (data, model) mesh of gloo ranks, on the CPU,
against the port's and the JAX package's one-device engines.

One spawn of 2 ranks (a 1 x 2 mesh) and one of 4 (2 x 2), a ``file://``
rendezvous in the test's directory, a timeout on every process group and
join; the references run in this process while the ranks run, and the
ranks read the JAX weights from a file once this process has made them.
The models: reduced rt-enwik8 (each model rank runs one local and one
routing head on its ring and its cluster pages) and reduced qwen2-0.5b
with two KV heads (the append cache on each rank's GQA head shard; the
reduced config's one KV head cannot split), fp32, the JAX package's
initial weights with drawn qkv biases (`interop`).

* The JAX package's ``test_engine_on_mesh_matches_single_device``
  workload (8 staggered greedy requests, 4 slots of 48): at 1 x 2 and 2 x
  2 the token streams equal the port's 1 x 1 engine's and the JAX
  package's 1 x 1 engine's, every recorded logits row within 1e-5 of the
  port's 1 x 1 row (the two sum the model axis's partial products in
  another order), and the ranks' streams and rows equal to the bit.
* After a prefill written to slot 3, each rank's pool equals the JAX
  package's pool cut by `dist.sharding.cache_sharding`
  (`interop.cache_from_jax` with the rank's mesh; pages in the JAX
  package's columns, the port's pad columns zero), values within 1e-5.
* At 1 x 2 and 2 x 2, chunked prefill, a prefix hit and time-slice parks
  and resumes (2 slots) give the 1 x 1 engine's tokens under the same
  knobs.
* A session exported at 1 x 2 (the gathered lane, the JAX package's blob)
  and imported at 1 x 1, and one exported at 1 x 1 and imported at 1 x 2,
  finish the one-device engine's tokens; an export that rank 0's
  transport refuses raises on both ranks and leaves the session parked.
* The JSONL records with ``routing_stats`` at 1 x 2 (monolithic and
  chunked prefill): written by rank 0 alone, the whole model's routing
  stats and page health, the 1 x 1 engine's within 1e-5.
* At 2 x 1 (the 2-rank spawn's second mesh) a sampled request decodes
  alone while the other data rank's lane idles, then a greedy and a
  sampled request join: the streams and recorded logits are the 1 x 1
  engine's, the ranks equal to the bit (every data rank gathers its
  tokens in one dtype, whichever path sampled them).
* One tensor-parallel train step at 1 x 2 under remat "save_dots"
  (reduced rt-enwik8, dropout 0.4) against the 1 x 1 "save_dots" step:
  parameters within 1e-6.
"""
import datetime
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config, with_overrides
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.dist import sharding as shd
from repro_torch.interop import (cache_from_jax, kstate_from_jax,
                                 params_from_jax, tree_to_numpy)
from repro_torch.kernels.routing_decode import page_width
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.serve.engine import (InferenceEngine, Request,
                                      SamplingParams, init_pool)
from repro_torch.serve.engine import write_slot
from repro_torch.serve.kvstore import PrefixCache
from repro_torch.serve.kvstore.remote import (FileTransport,
                                              LoopbackTransport,
                                              TransportError)
from repro_torch.serve.serving import init_cache, prefill
from repro_torch.train import train_step
from repro_torch.tree import tree_paths

ARCHS = ("rt-enwik8", "qwen2-0.5b")
SLOTS, MAX_LEN = 4, 48
TOL = 1e-5
JOIN_S = 240
PG_TIMEOUT = datetime.timedelta(seconds=120)
PROMPT = np.arange(3, 22, dtype=np.int64)[None] % 128
FEATURES = dict(max_slots=2, chunked_prefill=1, time_slice=2)
_TRAIN = dict(global_batch=2, seq_len=32, lr=1e-3, schedule="const",
              warmup_steps=1, remat="save_dots")


def _cfg(arch):
    cfg = reduced_config(arch)
    return (with_overrides(cfg, num_kv_heads=2) if arch == "qwen2-0.5b"
            else cfg)


def _workload(cls, repeat=False):
    """The JAX package's mesh-test workload; ``repeat`` adds a late
    request repeating request 0's prompt (an exact prefix hit)."""
    rng = np.random.RandomState(3)
    reqs = [cls(uid=i, prompt=rng.randint(0, 128, size=5 + 3 * i).tolist(),
                max_new_tokens=4 + (i % 5), arrival_step=i // 2)
            for i in range(8)]
    if repeat:
        reqs.append(cls(uid=8, prompt=list(reqs[0].prompt),
                        max_new_tokens=5, arrival_step=9))
    return reqs


def _sampled():
    """Request 0 samples alone for three steps (at 2 x 1 its slot is data
    rank 0's, so rank 1 has no active lane), then a greedy request and a
    second sampled one arrive."""
    rng = np.random.RandomState(5)
    hot = [SamplingParams(temperature=0.8, top_k=20, seed=11),
           SamplingParams(),
           SamplingParams(temperature=1.0, top_p=0.9, seed=12)]
    return [Request(uid=i, prompt=rng.randint(0, 128, size=7 + 2 * i).tolist(),
                    max_new_tokens=6 - i, arrival_step=(0, 3, 4)[i],
                    sampling=hot[i])
            for i in range(3)]


def _run(eng, reqs):
    out = eng.run(reqs)
    trace = {u: np.stack(rows) for u, rows in eng.logits_trace.items()}
    row = dict(out=out, trace=trace,
               drained=all(s is None for s in eng.slots),
               summary=eng.metrics.summary())
    if eng.prefix_cache is not None:
        row["prefix"] = eng.prefix_cache.stats()
    eng.close()
    return row


def _weights(state, arch):
    params, kstate = state[arch]
    return params_from_jax(params), kstate_from_jax(kstate)


def _wait(path):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > JOIN_S:
            raise TimeoutError(path)
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
class _Refusing(LoopbackTransport):
    """A transport whose every put fails."""

    def _put(self, name, data):
        raise TransportError(f"refused {name!r}")


def _export_all(eng, reqs, root):
    """Prefill every request in a ``prefill_only`` engine and export each
    session to the shared directory ``root``, the first after an export
    to a transport that refuses it. Returns that export's error's type
    name and the session's state after it."""
    eng.run(reqs)
    try:
        eng.export_session(reqs[0].uid, transport=_Refusing())
        refused = None
    except (TransportError, RuntimeError) as e:
        refused = type(e).__name__
    left = reqs[0].state
    transport = FileTransport(root)
    for r in reqs:
        eng.export_session(r.uid, name=f"s{r.uid}", transport=transport)
    eng.close()
    return refused, left


def _ranks(rank, world, tmp, state):
    mesh = make_host_mesh(1, 2) if world == 2 else make_host_mesh(2, 2)
    res = {"coords": mesh.coords}
    for arch in ARCHS:
        cfg = _cfg(arch)
        params, kstate = _weights(state, arch)
        row = _run(InferenceEngine(cfg, params, kstate, max_slots=SLOTS,
                                   max_len=MAX_LEN, record_logits=True,
                                   device="cpu", mesh=mesh),
                   _workload(Request))
        pool = init_pool(cfg, SLOTS, MAX_LEN, device="cpu", mesh=mesh)
        _, lane = prefill(shd.shard_params(params, cfg, mesh), kstate,
                          init_cache(cfg, 1, MAX_LEN, "cpu", mesh),
                          {"tokens": torch.from_numpy(PROMPT)}, cfg,
                          mesh=mesh)
        row["pool"] = tree_to_numpy(write_slot(pool, 3, lane, mesh))
        res[arch] = row
    cfg = _cfg("rt-enwik8")
    params, kstate = _weights(state, "rt-enwik8")

    def engine(**kw):
        kw.setdefault("mesh", mesh)
        return InferenceEngine(cfg, params, kstate, max_len=MAX_LEN,
                               device="cpu", **kw)
    res["features"] = _run(engine(prefix_cache=PrefixCache(),
                                  record_logits=True, **FEATURES),
                           _workload(Request, repeat=True))
    if world == 4:
        return res
    res["sampled"] = _run(engine(max_slots=2, record_logits=True,
                                 mesh=make_host_mesh(2, 1)), _sampled())
    for chunked in (None, 1):
        _run(engine(max_slots=SLOTS, routing_stats=True,
                    chunked_prefill=chunked,
                    obs_jsonl=f"{tmp}/obs{chunked}_1x2.jsonl"),
             _workload(Request))
    res["refused"] = _export_all(engine(max_slots=SLOTS, prefill_only=True),
                                 _workload(Request), f"{tmp}/from1x2")
    _wait(f"{tmp}/from1x1.ready")
    eng = engine(max_slots=SLOTS)
    transport = FileTransport(f"{tmp}/from1x1")
    hs = [eng.import_session(f"s{r.uid}", transport=transport)
          for r in _workload(Request)]
    while eng.has_work():
        eng.step()
    res["imported"] = {h.uid: h.output for h in hs}
    eng.close()
    run = RunConfig(model=with_overrides(cfg, dropout=0.4),
                    train=TrainConfig(**_TRAIN))
    ts = train_step.init_train_state(run, seed=0, device="cpu", mesh=mesh)
    step = train_step.make_train_step(run, None, shd.make_constrain_fn(mesh),
                                      mesh)
    ts, m = step(ts, _batch())
    res["save_dots"] = dict(loss=float(m["loss"]), params=tree_to_numpy(
        shd.gather_state(ts, run.model, mesh).params))
    return res


def _batch():
    rng = np.random.RandomState(0)
    return {"tokens": torch.from_numpy(
        rng.randint(0, 128, (2, 33)).astype(np.int64))}


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank,
        world_size=world, timeout=PG_TIMEOUT)
    _wait(f"{tmp}/jstate.pt")
    state = torch.load(f"{tmp}/jstate.pt", weights_only=False)
    res = _ranks(rank, world, tmp, state)
    torch.distributed.destroy_process_group()
    torch.save(res, f"{tmp}/rank{rank}.pt")


def _start(world, tmp):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(tmp)))
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
def _jax_references(state):
    """The JAX package's 1 x 1 engine on the workload, and its pool after
    the prefill of PROMPT written to slot 3, per arch."""
    import jax
    from repro.configs import reduced_config as jax_reduced
    from repro.configs.base import with_overrides as jax_with
    from repro.serve.engine import InferenceEngine as JaxEngine
    from repro.serve.engine import Request as JaxRequest
    from repro.serve.engine.pool import init_pool as jax_init_pool
    from repro.serve.engine.pool import write_slot as jax_write_slot
    from repro.serve.serving import init_cache as jax_init_cache
    from repro.serve.serving import prefill as jax_prefill
    out = {}
    for arch in ARCHS:
        cfg = jax_reduced(arch)
        if arch == "qwen2-0.5b":
            cfg = jax_with(cfg, num_kv_heads=2)
        params, kstate = jax.tree.map(jax.numpy.asarray, state[arch])
        eng = JaxEngine(cfg, params, kstate, max_slots=SLOTS,
                        max_len=MAX_LEN)
        toks = eng.run(_workload(JaxRequest))
        _, lane = jax_prefill(params, kstate,
                              jax_init_cache(cfg, 1, MAX_LEN),
                              {"tokens": jax.numpy.asarray(PROMPT)}, cfg)
        pool = jax_write_slot(jax_init_pool(cfg, SLOTS, MAX_LEN), 3, lane)
        out[arch] = dict(out=toks, pool=jax.tree.map(np.asarray, pool))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    from repro.configs import reduced_config as jax_reduced
    from repro.configs.base import with_overrides as jax_with
    from repro.models.model import init_model as jax_init_model
    from test_torch_full import with_qkv_biases
    dir2, dir4 = (tmp_path_factory.mktemp(n) for n in ("eng2", "eng4"))
    p2, p4 = _start(2, dir2), _start(4, dir4)
    state = {}
    for arch in ARCHS:
        cfg = jax_reduced(arch)
        if arch == "qwen2-0.5b":
            cfg = jax_with(cfg, num_kv_heads=2)
        params, kstate = jax.tree.map(np.asarray, jax_init_model(
            cfg, jax.random.PRNGKey(0)))
        state[arch] = (with_qkv_biases(params, 4), kstate)
    for d in (dir2, dir4):
        torch.save(state, d / "jstate.tmp")
        os.replace(d / "jstate.tmp", d / "jstate.pt")
    # the references' tiny products on one thread, as the ranks run: a
    # pool of threads beside six busy ranks waits more than it works
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = _port_references(state, dir2)
        refs["jax"] = _jax_references(state)
        r2, r4 = _results(p2, dir2), _results(p4, dir4)
        cfg = _cfg("rt-enwik8")
        params, kstate = _weights(state, "rt-enwik8")
        eng = InferenceEngine(cfg, params, kstate, max_slots=SLOTS,
                              max_len=MAX_LEN, device="cpu")
        transport = FileTransport(str(dir2 / "from1x2"))
        hs = [eng.import_session(f"s{r.uid}", transport=transport)
              for r in _workload(Request)]
        while eng.has_work():
            eng.step()
        refs["imported"] = {h.uid: h.output for h in hs}
        eng.close()
    finally:
        torch.set_num_threads(threads)
    return {"1x2": r2, "2x2": r4, "refs": refs, "dir2": dir2}


def _port_references(state, dir2):
    """The port's 1 x 1 engines on every workload the ranks run (the
    rt-enwik8 sessions exported for the ranks to import, the JSONL
    records), and its 1 x 1 "save_dots" train step."""
    refs = {}
    for arch in ARCHS:
        params, kstate = _weights(state, arch)
        refs[arch] = _run(InferenceEngine(
            _cfg(arch), params, kstate, max_slots=SLOTS, max_len=MAX_LEN,
            record_logits=True, device="cpu"), _workload(Request))
    cfg = _cfg("rt-enwik8")
    params, kstate = _weights(state, "rt-enwik8")

    def engine(**kw):
        return InferenceEngine(cfg, params, kstate, max_len=MAX_LEN,
                               device="cpu", **kw)
    refs["features"] = _run(engine(prefix_cache=PrefixCache(),
                                   record_logits=True, **FEATURES),
                            _workload(Request, repeat=True))
    refs["sampled"] = _run(engine(max_slots=2, record_logits=True),
                           _sampled())
    _export_all(engine(max_slots=SLOTS, prefill_only=True),
                _workload(Request), str(dir2 / "from1x1"))
    (dir2 / "from1x1.ready").touch()
    for chunked in (None, 1):
        _run(engine(max_slots=SLOTS, routing_stats=True,
                    chunked_prefill=chunked,
                    obs_jsonl=str(dir2 / f"obs{chunked}_1x1.jsonl")),
             _workload(Request))
    run = RunConfig(model=with_overrides(cfg, dropout=0.4),
                    train=TrainConfig(**_TRAIN))
    ts, m = train_step.make_train_step(run)(
        train_step.init_train_state(run, seed=0, device="cpu"), _batch())
    refs["save_dots"] = dict(loss=float(m["loss"]),
                             params=tree_to_numpy(ts.params))
    return refs


def _rows_equal(rows, key):
    first = rows[0][key]
    for r in rows[1:]:
        assert r[key]["out"] == first["out"]
        assert first["trace"].keys() == r[key]["trace"].keys()
        for u, a in first["trace"].items():
            assert a.tobytes() == r[key]["trace"][u].tobytes(), u


def _near(got, ref):
    assert got["out"] == ref["out"]
    assert got["trace"].keys() == ref["trace"].keys()
    for u, a in ref["trace"].items():
        np.testing.assert_allclose(got["trace"][u], a, atol=TOL, rtol=0,
                                   err_msg=str(u))


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_mesh_matches_one_device(ranks, arch, mesh):
    rows = ranks[mesh]
    got, ref = rows[0][arch], ranks["refs"][arch]
    assert got["drained"]
    _near(got, ref)
    assert got["out"] == ranks["refs"]["jax"][arch]["out"]
    _rows_equal(rows, arch)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pool_shard_after_prefill_matches_jax(ranks, arch, mesh):
    """Each rank's pool against the JAX pool cut for its coordinates."""
    jpool = ranks["refs"]["jax"][arch]["pool"]
    shape = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    for r in ranks[mesh]:
        want = tree_to_numpy(cache_from_jax(
            jpool, mesh=Mesh(shape, r["coords"]), batch=SLOTS))
        got = dict(tree_paths(r[arch]["pool"]))
        want = dict(tree_paths(want))
        # the JAX package orders its dict keys its own way
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            if path[-1] in ("rk", "rv"):
                dh = w.shape[-1]
                assert g.shape[-1] == page_width(dh)
                assert not g[..., dh:].any()
                g = g[..., :dh]
            assert g.shape == w.shape, (path, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w, err_msg=str(path))
            else:
                np.testing.assert_allclose(g, w, atol=TOL, rtol=0,
                                           err_msg=str(path))
            assert g.any() or not w.any()


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_chunked_prefill_prefix_hit_and_parks(ranks, mesh):
    """At 2 x 2 each data rank holds one of the 2 lanes: a park hands the
    owner's lane to the other data rank (`pool.read_slot`)."""
    rows = ranks[mesh]
    got, ref = rows[0]["features"], ranks["refs"]["features"]
    _near(got, ref)
    assert got["prefix"]["kvstore/prefix_hits"] == 1.0
    assert got["summary"]["parks"] >= 1 and got["summary"]["resumes"] >= 1
    assert got["out"][8][:4] == got["out"][0]
    _rows_equal(rows, "features")


def test_sampled_stream_with_an_idle_data_rank(ranks):
    rows = ranks["1x2"]
    got, ref = rows[0]["sampled"], ranks["refs"]["sampled"]
    assert got["drained"]
    _near(got, ref)
    assert len(got["out"][0]) == 6 and len(got["out"][2]) == 4
    _rows_equal(rows, "sampled")


@pytest.mark.parametrize("direction", ["1x2 to 1x1", "1x1 to 1x2"])
def test_session_moves_between_meshes(ranks, direction):
    want = ranks["refs"]["rt-enwik8"]["out"]
    if direction == "1x2 to 1x1":
        assert ranks["refs"]["imported"] == want
    else:
        for r in ranks["1x2"]:
            assert r["imported"] == want


def test_refused_export_raises_on_every_rank(ranks):
    """At 1 x 2 rank 0 writes the blob: where its transport refuses it,
    rank 0 raises the transport's error and rank 1 a `RuntimeError`
    together, and the session stays parked on both, so the next export
    moves it (`test_session_moves_between_meshes`)."""
    got = [r["refused"] for r in ranks["1x2"]]
    assert got == [("TransportError", "PARKED"), ("RuntimeError", "PARKED")]


def _records(path):
    import json
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("chunked", [None, 1], ids=["monolithic", "chunked"])
def test_obs_records_at_1x2_are_the_whole_models(ranks, chunked):
    """With ``routing_stats`` and ``obs_jsonl`` on both ranks, rank 0
    alone writes the records (valid schema-v1 lines, the 1 x 1 engine's
    kinds in its order), whose routing stats (the ranks' heads gathered)
    and page health (gathered over heads and slots) are the 1 x 1
    engine's within 1e-5."""
    from repro_torch.obs.schema import validate_jsonl
    two = ranks["dir2"] / f"obs{chunked}_1x2.jsonl"
    validate_jsonl(str(two))
    got = _records(two)
    want = _records(ranks["dir2"] / f"obs{chunked}_1x1.jsonl")
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    assert {"engine_prefill", "engine_tick"} <= {r["kind"] for r in got}
    for g, w in zip(got, want):
        wm = {k: v for k, v in w.get("metrics", {}).items()
              if k.startswith("routing/")}
        gm = {k: v for k, v in g.get("metrics", {}).items()
              if k.startswith("routing/")}
        assert gm.keys() == wm.keys()
        for k in wm:
            assert gm[k] == pytest.approx(wm[k], abs=1e-5), k


def test_tp_save_dots_step_matches_one_process(ranks):
    ref = ranks["refs"]["save_dots"]
    for r in ranks["1x2"]:
        got = r["save_dots"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        want = dict(tree_paths(ref["params"]))
        for path, g in tree_paths(got["params"]):
            np.testing.assert_allclose(g, want[path], atol=1e-6, rtol=0,
                                       err_msg=str(path))
