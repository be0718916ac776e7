"""Slice parity: the serve engine's observability (`InferenceEngine(
obs_jsonl=, routing_stats=True)`) against the JAX package's engine.

The JAX package's ``_tiny_run`` model (tests/test_obs.py: 2 layers, d 64,
local+routing, k 4; the port's random weights from seed 0, the same
numbers handed to the JAX package as arrays) serves the same prompts in
both packages on the CPU:

* the ``engine_prefill`` records (the prefill's ``routing/*`` means) of
  the port's monolithic and chunked prefill against the JAX engine's,
  within 1e-5 relative (drift exactly 0: serving freezes the centroids);
* the port's lines pass both packages' validators: one ``engine_prefill``
  per prefill, ``engine_tick`` records carrying the cluster pages' health
  with drift 0.0 and the last prefill's recall, ``kvstore_park`` /
  ``kvstore_resume`` (time slices force them), ``session_export`` /
  ``session_import`` on the disaggregation rail, and ``engine_summary``
  last;
* greedy tokens and recorded logits rows equal the stats-off engine's bit
  for bit, and with no sink and stats off no stats or pages health is
  computed at all.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.obs import schema as jax_schema
from repro.serve.engine import InferenceEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import ModelConfig, RoutingConfig
from repro_torch.interop import tree_to_numpy
from repro_torch.models.model import init_model
from repro_torch.obs import routing_stats as rt
from repro_torch.obs import schema
from repro_torch.serve.engine import InferenceEngine, Request
from repro_torch.serve.engine import engine as engine_mod
from repro_torch.serve.kvstore import KVStore, StoreConfig
from repro_torch.serve.kvstore.remote import LoopbackTransport

TOL = 1e-5
TINY = dict(name="obs-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            attention="local+routing", dtype="float32")
JCFG = JaxModelConfig(routing=JaxRoutingConfig(num_clusters=4,
                                               local_window=16), **TINY)
CFG = ModelConfig(routing=RoutingConfig(num_clusters=4, local_window=16),
                  **TINY)
PROMPTS = ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10, 11], list(range(20, 31)))
MAX_LEN = 32
MODES = {"monolithic": {}, "chunked": dict(chunked_prefill=1, time_slice=2)}


def _requests(cls, new_tokens):
    return [cls(uid=i, prompt=list(p), max_new_tokens=new_tokens,
                arrival_step=i) for i, p in enumerate(PROMPTS)]


def _records(path):
    return [json.loads(ln) for ln in open(path)]


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX engine's ``engine_prefill`` metrics per uid of the first two
    prompts (one new token each: no decode step is compiled)."""
    params, kstate = init_model(CFG, seed=0, device="cpu")
    path = str(tmp_path_factory.mktemp("jax") / "engine.jsonl")
    eng = JaxEngine(JCFG, jax.tree.map(jnp.asarray, tree_to_numpy(params)),
                    jax.tree.map(jnp.asarray, tree_to_numpy(kstate)),
                    max_slots=2, max_len=MAX_LEN, obs_jsonl=path,
                    routing_stats=True)
    eng.run(_requests(JaxRequest, 1)[:2])
    eng.close()
    return dict(prefill={r["uid"]: r["metrics"] for r in _records(path)
                         if r["kind"] == "engine_prefill"},
                params=params, kstate=kstate)


def _engine(jx, **kw):
    return InferenceEngine(CFG, jx["params"], jx["kstate"], max_slots=2,
                           max_len=MAX_LEN, record_logits=True, device="cpu",
                           **kw)


@pytest.fixture(scope="module", params=list(MODES))
def port_run(request, jax_engine, tmp_path_factory):
    mode = MODES[request.param]
    path = str(tmp_path_factory.mktemp("port") / "engine.jsonl")
    eng = _engine(jax_engine, obs_jsonl=path, routing_stats=True, **mode)
    out = eng.run(_requests(Request, 6))
    eng.close()
    ref = _engine(jax_engine, **mode)
    ref_out = ref.run(_requests(Request, 6))
    ref.close()
    return dict(path=path, out=out, trace=eng.logits_trace, ref_out=ref_out,
                ref_trace=ref.logits_trace, records=_records(path),
                mode=request.param)


def test_engine_prefill_records_match_jax(port_run, jax_engine):
    recs = [r for r in port_run["records"] if r["kind"] == "engine_prefill"]
    assert sorted(r["uid"] for r in recs) == list(range(len(PROMPTS)))
    assert len(jax_engine["prefill"]) == 2
    for r in recs:
        assert r["prompt_len"] == len(PROMPTS[r["uid"]])
        if r["uid"] not in jax_engine["prefill"]:
            continue
        want = jax_engine["prefill"][r["uid"]]
        assert set(r["metrics"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=TOL)
        assert r["metrics"]["routing/drift"] == 0.0


def test_engine_records_valid_and_complete(port_run):
    path, recs = port_run["path"], port_run["records"]
    assert schema.validate_jsonl(path) == jax_schema.validate_jsonl(path) \
        == len(recs)
    kinds = [r["kind"] for r in recs]
    assert all(r["source"] == "engine" for r in recs)
    assert kinds.count("engine_prefill") == len(PROMPTS)
    assert kinds[-1] == "engine_summary" and kinds.count("engine_summary") == 1
    ticks = [r for r in recs if r["kind"] == "engine_tick"]
    assert [t["step"] for t in ticks] == list(range(1, len(ticks) + 1))
    health = [t["metrics"] for t in ticks if "routing/entropy" in t["metrics"]]
    assert health
    for m in health:
        assert 0.0 <= m["routing/entropy"] <= math.log(4) + 1e-9
        assert 0.0 <= m["routing/dead"] <= 4.0
        assert m["routing/drift"] == 0.0
        assert 0.0 <= m["routing/recall"] <= 1.0
    assert "kvstore/parks" in ticks[-1]["metrics"]
    # the recall a tick carries is the latest prefill's
    last = None
    for r in recs:
        if r["kind"] == "engine_prefill":
            last = r["metrics"]["routing/recall"]
        elif r["kind"] == "engine_tick" and "routing/recall" in r["metrics"]:
            assert r["metrics"]["routing/recall"] == last
    if port_run["mode"] == "chunked":
        parks = [r for r in recs if r["kind"] == "kvstore_park"]
        resumes = [r for r in recs if r["kind"] == "kvstore_resume"]
        assert parks and resumes
        assert {"park_s", "bytes", "tokens"} == set(parks[0]["metrics"])
        assert {"resume_s", "slot", "tokens"} == set(resumes[0]["metrics"])


def test_engine_stats_leave_tokens_and_logits(port_run):
    assert port_run["out"] == port_run["ref_out"]
    for uid, rows in port_run["ref_trace"].items():
        got = port_run["trace"][uid]
        assert len(got) == len(rows)
        for a, b in zip(got, rows):
            assert np.array_equal(a, b), uid


def test_tick_pages_health_reads_the_pool(jax_engine, tmp_path):
    """An ``engine_tick``'s health is `pages_health` of the pool's ``rlen``
    leaves over the active slots at that step."""
    path = str(tmp_path / "e.jsonl")
    eng = _engine(jax_engine, obs_jsonl=path)
    for r in _requests(Request, 4)[:2]:
        eng.submit(dataclasses.replace(r, arrival_step=0))
    eng.step()
    active = np.array([s is not None for s in eng.slots])
    want = rt.pages_health(eng.pool, active=active)
    eng.close()
    tick = [r for r in _records(path) if r["kind"] == "engine_tick"][0]
    assert active.sum() == 2 and tick["metrics"]["active_slots"] == 2.0
    for k, v in want.items():
        assert tick["metrics"][k] == v
    assert tick["metrics"]["routing/drift"] == 0.0
    assert "routing/recall" not in tick["metrics"]     # stats off


def test_export_and_import_records(jax_engine, tmp_path):
    t = LoopbackTransport()
    pa, pb = str(tmp_path / "pre.jsonl"), str(tmp_path / "dec.jsonl")
    pre = _engine(jax_engine, prefill_only=True, obs_jsonl=pa,
                  kvstore=KVStore(StoreConfig(remote=t)))
    pre.submit(Request(uid=7, prompt=[3, 1, 4, 1, 5], max_new_tokens=4))
    while pre.has_work():
        pre.step()
    name = pre.export_session(7)
    pre.close()
    dec = _engine(jax_engine, obs_jsonl=pb,
                  kvstore=KVStore(StoreConfig(remote=t)))
    h = dec.import_session(name)
    while dec.has_work():
        dec.step()
    dec.close()
    assert len(h.output) == 4
    kinds_a = [r["kind"] for r in _records(pa)]
    exp = [r for r in _records(pa) if r["kind"] == "session_export"]
    imp = [r for r in _records(pb) if r["kind"] == "session_import"]
    assert "kvstore_park" in kinds_a and kinds_a[-1] == "engine_summary"
    assert exp[0]["uid"] == imp[0]["uid"] == 7
    assert exp[0]["name"] == imp[0]["name"] == name
    assert exp[0]["metrics"] == imp[0]["metrics"] == {"tokens": 5.0}
    assert "kvstore_resume" in [r["kind"] for r in _records(pb)]
    for p in (pa, pb):
        assert jax_schema.validate_jsonl(p) == schema.validate_jsonl(p)


def test_no_sink_and_stats_off_compute_nothing(jax_engine, monkeypatch):
    """With no sink and stats off a step neither folds stats nor reads the
    pages' occupancy back."""
    def refuse(*a, **k):
        raise AssertionError("computed with no sink and stats off")
    monkeypatch.setattr(engine_mod, "pages_health", refuse)
    monkeypatch.setattr(engine_mod.obs_rt, "summarize", refuse)
    for mode in MODES.values():
        eng = _engine(jax_engine, **mode)
        eng.run(_requests(Request, 3))
        eng.close()
        assert eng._sink is None and not eng.cfg.routing.stats
