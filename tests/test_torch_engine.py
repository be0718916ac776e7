"""The port's continuous-batching engine on the CPU.

* Against the JAX package's engine, on its own engine test config (2
  layers, d_model 64, local+routing, k 4, local window 8) with the same
  weights (`repro_torch.interop`) and the same staggered greedy workload:
  tokens equal per request, every recorded logits row within 2e-5
  absolute (the fp32 tolerance of the serving tests: two layers of fp32
  matmuls summed in another order by each framework). The JAX engine runs
  its CPU backends (routing/xla decode), as its own engine tests do; the
  port runs its auto-resolved plain backend and, forced, its kernel
  backend (whose wrappers take their plain versions on the CPU).
* Inside the port, at one pool size, bit for bit (reduced rt-enwik8): a
  request's tokens and recorded logits do not depend on its slot, its
  co-tenants (sampled streams included), chunked prefill, priority
  preemption or time-slice park/resume, an explicit park into another
  slot, or an exact prefix hit. A B=1 decode is not bitwise a pool
  decode's row (torch's matrix products take another path at one row):
  held within 2e-5 instead, which is why the parity above is at a fixed
  pool size.
* The reduced qwen2-0.5b (append cache) through the engine: its tokens
  equal a B=1 prefill + decode's, logits within 2e-5; chunked equals
  unchunked bit for bit.
* EOS, the token budget, submit validation, the SessionHandle lifecycle,
  the default device and the ValueError of a mesh that does not divide
  the heads
  (export and import are tested in `test_torch_disagg.py`, the
  observability knobs in `test_torch_obs_engine.py`).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.models.model import init_model as jax_init_model
from repro.serve.engine import InferenceEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.configs.base import ModelConfig, RoutingConfig
from repro_torch.interop import kstate_from_jax, params_from_jax
from repro_torch.models.model import init_model
from repro_torch.serve import serving
from repro_torch.serve.engine import (PRIORITY_BATCH, PRIORITY_INTERACTIVE,
                                      FCFSScheduler, InferenceEngine,
                                      Request, SamplingParams, read_slot,
                                      write_slot)
from repro_torch.serve.kvstore import PrefixCache
from repro_torch.tree import tree_leaves

TOL = 2e-5
ENG = dict(name="eng", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
           attention="local+routing", dtype="float32")
JCFG = JaxModelConfig(routing=JaxRoutingConfig(num_clusters=4,
                                               local_window=8), **ENG)
TCFG = ModelConfig(routing=RoutingConfig(num_clusters=4, local_window=8),
                   **ENG)
CFG = with_overrides(reduced_config("rt-enwik8"), max_seq_len=96)
MAX_LEN = 48
SAMPLED = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=5)


def _workload(n=8, prompt_lens=(5, 9, 14, 20), gen_lens=(3, 5, 7, 9, 4),
              arrival_every_other=True, seed=3, vocab=128, cls=Request,
              sampled=False):
    rng = np.random.RandomState(seed)
    reqs = []
    for uid in range(n):
        p = prompt_lens[uid % len(prompt_lens)]
        g = gen_lens[(2 * uid + 1) % len(gen_lens)]
        kw = dict(sampling=SAMPLED) if sampled and uid % 2 else {}
        reqs.append(cls(uid=uid, prompt=rng.randint(0, vocab, size=p).tolist(),
                        max_new_tokens=g,
                        arrival_step=(uid // 2 if arrival_every_other else 0),
                        **kw))
    return reqs


def _clone(reqs):
    return [dataclasses.replace(r, output=[]) for r in reqs]


@pytest.fixture(scope="module")
def model():
    return init_model(CFG, seed=0, device="cpu")


def _engine(model, cfg=CFG, **kw):
    params, kstate = model
    kw.setdefault("max_len", MAX_LEN)
    return InferenceEngine(cfg, params, kstate, device="cpu", **kw)


def _assert_bitwise(trace_a, trace_b, uids):
    for uid in uids:
        la, lb = trace_a[uid], trace_b[uid]
        assert len(la) == len(lb), uid
        for a, b in zip(la, lb):
            assert np.array_equal(a, b), uid           # BIT-identical


# ---------------------------------------------------------------------------
# The port's engine against the JAX package's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_engine_run():
    params, kstate = jax_init_model(JCFG, jax.random.PRNGKey(0))
    eng = JaxEngine(JCFG, params, kstate, max_slots=3, max_len=MAX_LEN,
                    record_logits=True)
    out = eng.run(_workload(cls=JaxRequest))
    eng.close()
    return dict(out=out, trace=eng.logits_trace,
                params=jax.tree.map(np.asarray, params),
                kstate=jax.tree.map(np.asarray, kstate),
                slots={u: r.slot for u, r in eng.metrics.requests.items()})


@pytest.mark.parametrize("impl", [None, "cuda"], ids=["auto-torch",
                                                      "forced-cuda"])
def test_engine_matches_jax_engine(jax_engine_run, impl):
    jr = jax_engine_run
    eng = InferenceEngine(TCFG, params_from_jax(jr["params"]),
                          kstate_from_jax(jr["kstate"]), max_slots=3,
                          max_len=MAX_LEN, record_logits=True, impl=impl,
                          device="cpu")
    out = eng.run(_workload())
    assert out == jr["out"]
    assert {u: r.slot for u, r in eng.metrics.requests.items()} == jr["slots"]
    for uid, rows in jr["trace"].items():
        assert len(eng.logits_trace[uid]) == len(rows)
        for a, b in zip(eng.logits_trace[uid], rows):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    assert all(s is None for s in eng.slots)
    assert eng.attn_backends == {
        "local+routing": ("local+routing/torch(ring+pages)" if impl is None
                          else "local+routing/cuda(ring+pages)")}
    assert serving.decode_cache_layouts(TCFG, impl=impl,
                                        platform="cpu") == {"ring+pages"}


# ---------------------------------------------------------------------------
# Parity inside the port at one pool size
# ---------------------------------------------------------------------------
def test_slot_parity_bitwise(model):
    """A request decoded in slot 3 of a busy pool gives bit-identical
    logits to the same request alone in slot 0 of a same-size pool."""
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, CFG.vocab_size, size=13).tolist()
    target = lambda: Request(uid=99, prompt=list(prompt), max_new_tokens=7)
    tenants = [Request(uid=i, prompt=rng.randint(
        0, CFG.vocab_size, size=6 + i).tolist(), max_new_tokens=9)
        for i in range(3)]
    eng_a = _engine(model, max_slots=4, record_logits=True)
    out_a = eng_a.run(tenants + [target()])
    eng_b = _engine(model, max_slots=4, record_logits=True)
    out_b = eng_b.run([target()])
    assert eng_a.metrics.requests[99].slot == 3
    assert eng_b.metrics.requests[99].slot == 0
    assert out_a[99] == out_b[99]
    _assert_bitwise(eng_a.logits_trace, eng_b.logits_trace, [99])


def test_sampled_outputs_independent_of_co_tenants(model):
    """Counter-based PRNG streams: a sampled request's tokens and logits
    do not change when its pool neighbours change."""
    prompt = np.random.RandomState(4).randint(0, CFG.vocab_size,
                                              size=8).tolist()
    runs = []
    for tenant_seed in (1, 2):
        tenants = [Request(uid=i, prompt=np.random.RandomState(
            tenant_seed + i).randint(0, CFG.vocab_size, size=5 + i).tolist(),
            max_new_tokens=8, sampling=SamplingParams(temperature=1.1,
                                                      seed=tenant_seed))
            for i in range(2)]
        eng = _engine(model, max_slots=3, record_logits=True)
        out = eng.run(tenants + [Request(uid=50, prompt=list(prompt),
                                         max_new_tokens=6, sampling=SAMPLED)])
        runs.append((out, eng))
    assert runs[0][0][50] == runs[1][0][50]
    _assert_bitwise(runs[0][1].logits_trace, runs[1][1].logits_trace, [50])


def test_chunked_prefill_matches_unchunked(model):
    """Depth-chunked prefill gives the same tokens and bit-identical
    logits as monolithic prefill for any stage budget."""
    base = _workload(sampled=True)
    ref = _engine(model, max_slots=3, record_logits=True)
    out_ref = ref.run(_clone(base))
    for budget in (1, 3):
        eng = _engine(model, max_slots=3, chunked_prefill=budget,
                      record_logits=True)
        assert out_ref == eng.run(_clone(base)), budget
        assert all(s is None for s in eng.slots)
        assert not eng._prefill_jobs
        _assert_bitwise(ref.logits_trace, eng.logits_trace, out_ref)


def test_chunked_prefill_interleaves_decode(model):
    """A long prompt admitted mid-flight does not block: the decoding
    session gains a token every step while the newcomer's prefill advances
    one depth stage at a time."""
    rng = np.random.RandomState(13)
    eng = _engine(model, max_slots=2, chunked_prefill=1)
    a = eng.submit(Request(uid=0, prompt=rng.randint(
        0, CFG.vocab_size, size=6).tolist(), max_new_tokens=12))
    while not a.output:
        eng.step()
    b = eng.submit(Request(uid=1, prompt=rng.randint(
        0, CFG.vocab_size, size=20).tolist(), max_new_tokens=3))
    interleaved = 0
    while b.state in ("queued", "active") and not b.output:
        n = len(a.output)
        eng.step()
        if eng._prefill_jobs:
            interleaved += 1
            assert len(a.output) == n + 1
    assert interleaved >= 1
    while eng.has_work():
        eng.step()
    ref = _engine(model, max_slots=2)
    assert ref.run([dataclasses.replace(a._request, output=[])])[0] == \
        a.output
    ref = _engine(model, max_slots=2)
    assert ref.run([dataclasses.replace(b._request, output=[])])[1] == \
        b.output


def _alone(model, req, max_slots):
    eng = _engine(model, max_slots=max_slots, record_logits=True)
    eng.run([dataclasses.replace(req, output=[], arrival_step=0)])
    return eng.logits_trace[req.uid]


def test_priority_preemption_parks_lowest_bitwise(model):
    """max_slots=1: an interactive arrival preempts the running session,
    which parks, resumes and finishes bit-identical to never parked."""
    rng = np.random.RandomState(7)
    low = Request(uid=0, prompt=rng.randint(
        0, CFG.vocab_size, size=8).tolist(), max_new_tokens=12,
        sampling=SAMPLED)
    high = Request(uid=1, prompt=rng.randint(
        0, CFG.vocab_size, size=6).tolist(), max_new_tokens=4,
        priority=PRIORITY_INTERACTIVE)
    eng = _engine(model, max_slots=1, record_logits=True)
    eng.submit(low)
    eng.step()
    eng.step()
    assert low.state == "DECODE"
    eng.submit(high)
    eng.step()
    assert low.state == "PARKED" and high.state == "DECODE"
    while eng.has_work():
        eng.step()
    assert low.state == high.state == "FINISHED"
    summ = eng.metrics.summary()
    assert summ["parks"] == summ["resumes"] == 1
    for r in (low, high):
        _assert_bitwise(eng.logits_trace, {r.uid: _alone(model, r, 1)},
                        [r.uid])


def test_priority_preempts_mid_prefill_job(model):
    """max_slots=1, chunked_prefill=1: an interactive arrival preempts a
    batch-class request still in its prefill stages; the victim's partial
    work is dropped, it requeues, re-prefills, and both finish bit-exact."""
    rng = np.random.RandomState(17)
    low = Request(uid=0, prompt=rng.randint(
        0, CFG.vocab_size, size=14).tolist(), max_new_tokens=5,
        priority=PRIORITY_BATCH)
    high = Request(uid=1, prompt=rng.randint(
        0, CFG.vocab_size, size=6).tolist(), max_new_tokens=4,
        priority=PRIORITY_INTERACTIVE)
    eng = _engine(model, max_slots=1, chunked_prefill=1, record_logits=True)
    eng.submit(low)
    eng.step()
    assert [j.request.uid for j in eng._prefill_jobs.values()] == [0]
    eng.submit(high)
    eng.step()
    assert low.output == [] and low.state in ("PARKED", "WAITING")
    while eng.has_work():
        eng.step()
    assert low.state == high.state == "FINISHED"
    assert 0 not in eng.kvstore and eng.metrics.summary()["parks"] >= 1
    for r in (low, high):
        _assert_bitwise(eng.logits_trace, {r.uid: _alone(model, r, 1)},
                        [r.uid])


def test_time_slice_rotation_bitwise(model):
    """8 sessions over 2 slots rotating every 2 tokens through the KV
    store give the tokens and bit-identical logits of the same pool run
    to completion (no park)."""
    base = _workload(arrival_every_other=False, sampled=True)
    ref = _engine(model, max_slots=2, record_logits=True)
    out_ref = ref.run(_clone(base))
    assert ref.metrics.summary()["parks"] == 0
    eng = _engine(model, max_slots=2, time_slice=2, record_logits=True)
    assert eng.run(_clone(base)) == out_ref
    summ = eng.metrics.summary()
    assert summ["parks"] > 0 and summ["resumes"] == summ["parks"]
    assert len(eng.kvstore) == 0 and all(s is None for s in eng.slots)
    _assert_bitwise(ref.logits_trace, eng.logits_trace, out_ref)


def test_park_resume_into_another_slot_bitwise(model):
    """A session parked mid-decode by its handle and resumed into a
    different slot decodes bit-identical to an uninterrupted run."""
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, CFG.vocab_size, size=13).tolist()
    mk = lambda: Request(uid=99, prompt=list(prompt), max_new_tokens=7,
                         sampling=SAMPLED)
    ref = _engine(model, max_slots=2, record_logits=True)
    out_ref = ref.run([mk()])
    eng = _engine(model, max_slots=2, record_logits=True)
    h = eng.submit(mk())
    eng.step()
    eng.step()
    assert h.state == "active" and eng.metrics.requests[99].slot == 0
    assert 0 < len(h.output) < 7
    lane = read_slot(eng.pool, 0)
    h.park()
    assert h.state == "parked" and 99 in eng.kvstore
    eng.submit(Request(uid=1, prompt=rng.randint(
        0, CFG.vocab_size, size=6).tolist(), max_new_tokens=9))
    eng.step()
    assert eng.slots[0].request.uid == 1
    h.resume()
    eng._admit_and_prefill()                # the lane streams back
    assert eng.metrics.requests[99].slot == 1
    back = read_slot(eng.pool, 1)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(lane),
                                                 tree_leaves(back)))
    while eng.has_work():
        eng.step()
    assert h.state == "finished" and 99 not in eng.kvstore
    assert h.output == out_ref[99]
    _assert_bitwise(eng.logits_trace, ref.logits_trace, [99])


def test_park_mid_prefill_requeues(model):
    rng = np.random.RandomState(19)
    eng = _engine(model, max_slots=1, chunked_prefill=1)
    h = eng.submit(Request(uid=5, prompt=rng.randint(
        0, CFG.vocab_size, size=10).tolist(), max_new_tokens=4))
    eng.step()
    assert eng._prefill_jobs and not h.output
    h.park()
    assert h.state == "parked"
    assert not eng._prefill_jobs and 5 not in eng.kvstore
    eng.step()
    assert not h.output
    h.resume()
    while eng.has_work():
        eng.step()
    assert h.state == "finished"
    ref = _engine(model, max_slots=1)
    assert ref.run([dataclasses.replace(h._request, output=[])])[5] == \
        h.output


def test_prefix_cache_exact_hit_matches_miss(model):
    """Two sessions sharing a prompt: the second is an exact hit (lane
    written from the cache, no model call) with the identical tokens and
    bit-identical logits; a hit never aliases the pool."""
    prompt = np.random.RandomState(21).randint(0, CFG.vocab_size,
                                               size=14).tolist()
    pc = PrefixCache()
    eng = _engine(model, max_slots=2, prefix_cache=pc, record_logits=True)
    calls = []
    real = eng._prefill
    eng._prefill = lambda *a, **k: calls.append(1) or real(*a, **k)
    out = eng.run([Request(uid=0, prompt=list(prompt), max_new_tokens=6),
                   Request(uid=1, prompt=list(prompt), max_new_tokens=6,
                           arrival_step=5)])
    assert len(calls) == 1
    assert pc.stats()["kvstore/prefix_hits"] == 1.0
    assert pc.stats()["kvstore/prefix_misses"] == 1.0
    assert out[0] == out[1]
    _assert_bitwise({1: eng.logits_trace[0]}, eng.logits_trace, [1])
    ref = _engine(model, max_slots=2, record_logits=True)
    ref.run([Request(uid=0, prompt=list(prompt), max_new_tokens=6)])
    _assert_bitwise(ref.logits_trace, eng.logits_trace, [0])


def test_b1_decode_is_not_bitwise_a_pool_decode(model):
    """Why the parity above holds at a fixed pool size: the same lane
    decoded alone (B=1) and in slot 2 of a pool of 4 gives logits equal
    within 2e-5 but not bit for bit."""
    params, kstate = model
    prompt = torch.from_numpy(np.random.RandomState(5).randint(
        0, CFG.vocab_size, size=(1, 12)))
    lane = serving.init_cache(CFG, 1, MAX_LEN, device="cpu")
    _, lane = serving.prefill(params, kstate, lane, {"tokens": prompt}, CFG)
    eng = _engine(model, max_slots=4)
    write_slot(eng.pool, 2, lane)
    step = serving.make_serve_step(CFG)
    tok, pos = torch.tensor([3]), torch.tensor([12])
    solo, _ = step(params, kstate, lane, tok, pos)
    act = torch.tensor([False, False, True, False])
    pooled, _ = step(params, kstate, eng.pool, tok.expand(4).clone(),
                     pos.expand(4).clone(), act)
    np.testing.assert_allclose(pooled[2].numpy(), solo[0].numpy(), atol=TOL,
                               rtol=0)
    assert not torch.equal(pooled[2], solo[0])


def test_qwen2_through_the_engine():
    """The reduced qwen2-0.5b (full attention, append cache): greedy
    tokens equal a B=1 prefill + decode's (logits within 2e-5), chunked
    prefill bit-identical to monolithic."""
    cfg = with_overrides(reduced_config("qwen2-0.5b"), num_heads=14,
                         num_kv_heads=2)
    params, kstate = init_model(cfg, seed=1, device="cpu")
    reqs = _workload(n=5, vocab=cfg.vocab_size)
    engines = [InferenceEngine(cfg, params, kstate, max_slots=2,
                               max_len=MAX_LEN, record_logits=True,
                               chunked_prefill=c, device="cpu")
               for c in (None, 1)]
    outs = [e.run(_clone(reqs)) for e in engines]
    assert outs[0] == outs[1]
    _assert_bitwise(engines[0].logits_trace, engines[1].logits_trace,
                    outs[0])
    assert engines[0].attn_backends == {"full": "full/torch(append)"}
    assert serving.decode_cache_layouts(cfg, platform="cpu") == {"append"}
    step = serving.make_serve_step(cfg)
    for r in reqs:
        cache = serving.init_cache(cfg, 1, MAX_LEN, device="cpu")
        lg, cache = serving.prefill(params, kstate, cache, {
            "tokens": torch.tensor([r.prompt])}, cfg)
        rows, toks = [lg[0, -1]], [int(lg[0, -1].argmax())]
        pos = r.prompt_len
        while len(toks) < r.max_new_tokens:
            lg1, cache = step(params, kstate, cache, torch.tensor(toks[-1:]),
                              torch.tensor([pos]))
            rows.append(lg1[0])
            toks.append(int(lg1[0].argmax()))
            pos += 1
        assert outs[0][r.uid] == toks, r.uid
        for a, b in zip(engines[0].logits_trace[r.uid], rows):
            np.testing.assert_allclose(a, b.numpy(), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# Admission, termination, validation, lifecycle
# ---------------------------------------------------------------------------
def test_engine_token_budget_backpressure(model):
    """A budget that fits one request at a time: occupancy never exceeds
    1 even with free slots, and the tokens are the unbudgeted run's."""
    reqs = _workload(n=3, arrival_every_other=False)
    budget = max(FCFSScheduler.reserved_tokens(r) for r in reqs)
    eng = _engine(model, max_slots=2, token_budget=budget)
    out = eng.run(_clone(reqs))
    assert eng.metrics.mean_occupancy <= 1.0
    for r in reqs:
        assert out[r.uid] == _engine(model, max_slots=2).run(
            [dataclasses.replace(r, output=[])])[r.uid]


def test_eos_termination(model):
    req = _workload(n=1, prompt_lens=(10,), gen_lens=(9,),
                    arrival_every_other=False)[0]
    full = _engine(model, max_slots=2).run([_clone([req])[0]])[0]
    eos = full[2]
    stop_at = full.index(eos) + 1
    out = _engine(model, max_slots=2).run(
        [dataclasses.replace(req, eos_id=eos, output=[])])
    assert out[req.uid] == full[:stop_at]


def test_submit_validation(model):
    eng = _engine(model, max_slots=1, max_len=16, token_budget=14)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=0, prompt=[1] * 12, max_new_tokens=8))
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(Request(uid=1, prompt=[], max_new_tokens=4))
    with pytest.raises(ValueError, match="budget"):
        eng.submit(Request(uid=2, prompt=[1] * 10, max_new_tokens=5))
    with pytest.raises(ValueError, match="already has output"):
        eng.submit(Request(uid=3, prompt=[1], max_new_tokens=2, output=[4]))
    eng.submit(Request(uid=4, prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(ValueError, match="already queued"):
        eng.submit(Request(uid=4, prompt=[1, 2], max_new_tokens=2))


def test_session_handle_lifecycle_and_interop(model):
    """submit() returns a SessionHandle: queued -> active -> finished,
    int(handle) interop, cancel of a queued, an active and a parked
    session."""
    eng = _engine(model, max_slots=1)
    h1 = eng.submit(Request(uid=7, prompt=[3, 4, 5], max_new_tokens=3))
    h2 = eng.submit(Request(uid=8, prompt=[5, 6, 7], max_new_tokens=3))
    assert int(h1) == 7 and h1.uid == 7 and "queued" in repr(h1)
    assert h1.state == h2.state == "queued"
    eng.step()
    assert h1.state == "active" and h2.state == "queued"
    h2.cancel()
    assert h2.state == "cancelled"
    while eng.has_work():
        eng.step()
    assert h1.state == "finished" and len(h1.output) == 3
    assert h2.output == []
    assert eng.metrics.requests[int(h1)].uid == 7
    h3 = eng.submit(Request(uid=9, prompt=[1, 2, 3], max_new_tokens=5))
    eng.step()
    h3.park()
    assert h3.state == "parked" and 9 in eng.kvstore
    h3.cancel()
    assert h3.state == "cancelled" and 9 not in eng.kvstore
    h4 = eng.submit(Request(uid=10, prompt=[1, 2], max_new_tokens=5))
    eng.step()
    h4.cancel()
    assert h4.state == "cancelled" and all(s is None for s in eng.slots)
    with pytest.raises(ValueError, match="not queued"):
        eng.cancel_session(10)
    with pytest.raises(ValueError, match="not parked"):
        eng.resume_session(10)
    summ = eng.metrics.summary()
    assert {"requests", "finished", "decode_steps", "decode_tokens",
            "decode_tokens_per_s", "tokens_per_step", "mean_occupancy",
            "mean_ttft_s", "prefill_tokens", "parks", "resumes",
            "ttft_p50_s", "decode_step_p90_s"} <= set(summ)
    eng.close()


def test_prefill_only_parks_after_the_first_token(model):
    """prefill_only: a session parks, held, right after its first token
    (no decode step runs), its lane in the KV store."""
    eng = _engine(model, max_slots=2, prefill_only=True)
    hs = [eng.submit(Request(uid=i, prompt=[1 + i, 2, 3], max_new_tokens=4))
          for i in range(2)]
    eng.step()
    assert all(h.state == "parked" and len(h.output) == 1 for h in hs)
    assert len(eng.kvstore) == 2 and eng.metrics.decode_steps == 0
    assert not eng.has_work()


@pytest.mark.parametrize("knob", ["mesh"])
def test_unported_engine_knobs_raise(model, knob):
    """What stays refused of ``mesh``: a model axis that does not divide
    the layers' local and routing head counts (reduced rt-enwik8: 2 + 2
    heads over 3 ranks) raises `attn.head_shard`'s `ValueError` before
    anything is built (the mesh itself is ported:
    `test_torch_engine_mesh.py`)."""
    from repro_torch.launch.mesh import Mesh
    value = {"mesh": Mesh({"data": 1, "model": 3},
                          {"data": 0, "model": 0})}[knob]
    with pytest.raises(ValueError, match="do not divide over a 3-way model"):
        _engine(model, max_slots=1, **{knob: value})


def test_engine_defaults_to_the_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, kstate = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(CFG, params, kstate, max_slots=1, max_len=MAX_LEN)
