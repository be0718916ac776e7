"""Disaggregated prefill and decode pools of the port, on the CPU (reduced
models: 2 layers, d_model 64, fp32, ``max_len`` 48), mirroring the JAX
package's ``test_disagg.py``.

* A prefill pool (``prefill_only=True``) exports every session through a
  transport blob, a second engine imports and decodes them: every token
  and every recorded logits row equal the port's monolithic engine's bit
  for bit, at the same pool size, over a loopback transport (local+routing
  model, greedy and sampled requests), a shared directory (local model)
  and a TCP peer; and through a decode pool whose store holds the
  sessions on all three tiers, with async parks under time slices (the
  CPU rehearsal of chip_smoke's ``serve_disagg`` gates).
* ``prefill_only`` parks after the first token; exporting a session that
  is not parked with a prefilled lane is refused; exporting one a time
  slice queued to resume takes it out of the queue; an import whose uid
  is live here is refused.
* The engine's own store runs async transfers, and the engine drains the
  store's tier events on every step.
* A JAX prefill pool to a port decode pool: the JAX engine's
  ``export_session`` writes to a ``FileTransport`` directory and the
  port's ``import_session`` reads it (the JAX package's sorted dict order
  and its head-dim-wide pages fitted to the port's pool); the tokens equal
  the JAX monolithic engine's and every decode row is within 2e-5, the
  tolerance of ``test_torch_engine.py``'s ``test_engine_matches_jax_engine``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.models.model import init_model as jax_init_model
from repro.serve.engine import InferenceEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.kvstore import KVStore as JaxKVStore
from repro.serve.kvstore import StoreConfig as JaxStoreConfig
from repro.serve.kvstore.remote import FileTransport as JaxFileTransport
from repro_torch.configs.base import ModelConfig, RoutingConfig
from repro_torch.interop import kstate_from_jax, params_from_jax
from repro_torch.models.model import init_model
from repro_torch.serve.engine import InferenceEngine, Request, SamplingParams
from repro_torch.serve.kvstore import KVStore, StoreConfig
from repro_torch.serve.kvstore.remote import (FaultInjectionTransport,
                                              FileTransport,
                                              LoopbackTransport, RetryPolicy,
                                              TCPStoreServer, TCPTransport)

TOL = 2e-5
COMMON = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")
ROUTED = ModelConfig(name="dsg", attention="local+routing",
                     routing=RoutingConfig(num_clusters=4, local_window=8),
                     **COMMON)
LOCAL = ModelConfig(name="dsl", attention="local",
                    routing=RoutingConfig(local_window=8), **COMMON)
JROUTED = JaxModelConfig(name="dsg", attention="local+routing",
                         routing=JaxRoutingConfig(num_clusters=4,
                                                  local_window=8), **COMMON)
MAX_LEN = 48
SLOTS = 2
FAST = RetryPolicy(attempts=3, base_delay_s=0.001, max_delay_s=0.002)
WAIT = 30.0                             # seconds: every wait's timeout
SAMPLED = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=5)


@pytest.fixture(scope="module")
def routed_model():
    return init_model(ROUTED, seed=0, device="cpu")


@pytest.fixture(scope="module")
def local_model():
    return init_model(LOCAL, seed=0, device="cpu")


def _mk_requests(n=6, seed=3, cls=Request, sampled=True):
    rng = np.random.RandomState(seed)
    return [cls(uid=u, prompt=rng.randint(0, 128, size=5 + 2 * u).tolist(),
                max_new_tokens=4 + (u % 3),
                **(dict(sampling=SAMPLED) if sampled and u % 2 else {}))
            for u in range(n)]


def _engine(cfg, model, **kw):
    params, kstate = model
    return InferenceEngine(cfg, params, kstate, max_slots=SLOTS,
                           max_len=MAX_LEN, record_logits=True,
                           device="cpu", **kw)


def _monolithic(cfg, model, reqs):
    eng = _engine(cfg, model)
    out = eng.run(reqs)
    eng.close()
    return out, eng.logits_trace


def _disaggregate(cfg, model, reqs, prefill_transport, decode_store,
                  **decode_kw):
    """Prefill pool -> transport blobs -> decode pool. Returns the decode
    pool's outputs, the two pools' logits rows per uid and the decode
    pool (closed)."""
    pre = _engine(cfg, model, prefill_only=True,
                  kvstore=KVStore(StoreConfig(remote=prefill_transport)))
    for r in reqs:
        pre.submit(r)
    while pre.has_work():
        pre.step()
    names = [pre.export_session(r.uid) for r in reqs]
    assert all(r.state == "EXPORTED" for r in reqs)
    assert len(pre.kvstore) == 0
    pre.close()
    dec = _engine(cfg, model, kvstore=decode_store, **decode_kw)
    handles = [dec.import_session(n) for n in names]
    assert all(h.state == "parked" for h in handles)   # queued to resume
    while dec.has_work():
        dec.step()
    dec.close()
    trace = {u: pre.logits_trace[u] + dec.logits_trace.get(u, [])
             for u in pre.logits_trace}
    return {h.uid: h.output for h in handles}, trace, dec


def _assert_bitwise(out, trace, ref_out, ref_trace):
    assert out == ref_out
    assert trace.keys() == ref_trace.keys()
    for uid, rows in ref_trace.items():
        assert len(trace[uid]) == len(rows), uid
        for a, b in zip(trace[uid], rows):
            assert np.array_equal(a, b), uid           # BIT-identical


# ---------------------------------------------------------------------------
# Disaggregation parity against the port's monolithic engine
# ---------------------------------------------------------------------------
def test_disagg_parity_loopback_routed(routed_model):
    """Routing model, greedy and sampled requests, one loopback transport
    shared by the two pools."""
    ref = _monolithic(ROUTED, routed_model, _mk_requests())
    t = LoopbackTransport()
    out, trace, dec = _disaggregate(
        ROUTED, routed_model, _mk_requests(), t,
        KVStore(StoreConfig(remote=t, async_transfers=True)))
    _assert_bitwise(out, trace, *ref)
    assert t.list_blobs() == []         # every blob consumed
    assert dec.kvstore.stats()["kvstore/imports"] == 6.0


def test_disagg_parity_file_transport(local_model, tmp_path):
    """Two pools meeting in a shared directory (object-store semantics)."""
    ref = _monolithic(LOCAL, local_model, _mk_requests(n=4))
    root = str(tmp_path / "blobs")
    out, trace, _ = _disaggregate(
        LOCAL, local_model, _mk_requests(n=4), FileTransport(root),
        KVStore(StoreConfig(remote=FileTransport(root),
                            async_transfers=True)))
    _assert_bitwise(out, trace, *ref)


def test_disagg_parity_tcp(routed_model):
    """Both pools talk to one TCP blob peer, each with its own client."""
    ref = _monolithic(ROUTED, routed_model, _mk_requests(n=4))
    with TCPStoreServer() as server:
        def tcp():
            return TCPTransport(server.host, server.port, retry=FAST,
                                connect_timeout_s=2.0, io_timeout_s=WAIT)
        out, trace, _ = _disaggregate(
            ROUTED, routed_model, _mk_requests(n=4), tcp(),
            KVStore(StoreConfig(remote=tcp(), async_transfers=True)))
        assert len(server) == 0
    _assert_bitwise(out, trace, *ref)


def test_disagg_through_every_tier(routed_model, tmp_path):
    """The decode pool's store holds the imported sessions on the host,
    on disk and on the TCP peer, and time slices park sessions
    asynchronously while others wait: parity holds bit for bit and every
    tier and transfer ran (chip_smoke's serve_disagg gates, reduced)."""
    reqs = _mk_requests(n=6)
    ref = _monolithic(ROUTED, routed_model, _mk_requests(n=6))
    with TCPStoreServer() as server:
        def tcp():
            return TCPTransport(server.host, server.port, retry=FAST,
                                connect_timeout_s=2.0, io_timeout_s=WAIT)
        probe = _engine(ROUTED, routed_model, prefill_only=True)
        probe.run([dataclasses.replace(reqs[0], output=[])])
        probe.kvstore.flush(WAIT)
        lane_bytes = probe.kvstore.host_bytes
        probe.close()
        store = KVStore(StoreConfig(
            remote=tcp(), async_transfers=True,
            spill_dir=str(tmp_path / "spill"),
            host_bytes_limit=2 * lane_bytes,
            disk_bytes_limit=2 * lane_bytes))
        out, trace, dec = _disaggregate(ROUTED, routed_model, reqs, tcp(),
                                        store, time_slice=2)
    _assert_bitwise(out, trace, *ref)
    st = dec.kvstore.stats()
    # (a disk session is warmed back to the host by the engine's prefetch
    # before its resume, so no resume need find it on disk)
    for key in ("imports", "spills", "remote_parks", "remote_resumes",
                "parks", "prefetches", "resume_host_p50_s",
                "resume_remote_p50_s", "park_transfer_p50_s"):
        assert st[f"kvstore/{key}"] > 0, key
    assert st["kvstore/sessions"] == 0.0
    assert not list((tmp_path / "spill").iterdir())


# ---------------------------------------------------------------------------
# The engine's side of the rail
# ---------------------------------------------------------------------------
def test_prefill_only_engine_parks_and_exports(routed_model):
    t = LoopbackTransport()
    eng = _engine(ROUTED, routed_model, prefill_only=True,
                  kvstore=KVStore(StoreConfig(remote=t)))
    h = eng.submit(Request(uid=1, prompt=[3, 1, 4, 1, 5], max_new_tokens=8))
    while eng.has_work():
        eng.step()
    # exactly the first (prefill-sampled) token, then parked, held
    assert h.state == "parked" and len(h.output) == 1
    assert eng.metrics.decode_steps == 0
    assert eng.export_session(1, name="pool-a/1") == "pool-a/1"
    assert h.state == "exported" and t.list_blobs() == ["pool-a/1"]
    eng.close()


def test_export_requires_prefilled_parked_session(routed_model):
    t = LoopbackTransport()
    eng = _engine(ROUTED, routed_model, kvstore=KVStore(StoreConfig(remote=t)))
    h = eng.submit(Request(uid=1, prompt=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(ValueError, match="not parked"):
        eng.export_session(1)           # queued, never prefilled
    h.park()                            # held before its prefill
    with pytest.raises(ValueError, match="not parked"):
        eng.export_session(1)
    h.resume()
    eng.step()
    h.park()
    assert eng.export_session(1)
    assert h.state == "exported" and not eng.has_work()
    with pytest.raises(ValueError, match="not parked"):
        eng.export_session(1)           # already gone
    eng.close()


def test_export_of_a_session_queued_to_resume(routed_model):
    """A session a time slice parked is queued to resume; exporting it
    takes it out of the queue too, so it is not prefilled here again."""
    t = LoopbackTransport()
    eng = InferenceEngine(ROUTED, *routed_model, max_slots=1,
                          max_len=MAX_LEN, time_slice=1, device="cpu",
                          kvstore=KVStore(StoreConfig(remote=t)))
    h0 = eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=6))
    h1 = eng.submit(Request(uid=1, prompt=[4, 5], max_new_tokens=3))
    eng.step()                          # uid 0 rotates out for uid 1
    assert h0.state == "parked" and eng.scheduler.has_uid(0)
    eng.export_session(0)
    assert h0.state == "exported" and not eng.scheduler.has_uid(0)
    while eng.has_work():
        eng.step()
    assert h1.state == "finished" and h0.state == "exported"
    assert eng.metrics.requests[0].slot == eng.metrics.requests[1].slot
    eng.close()


def test_import_collision_rejected(routed_model):
    t = LoopbackTransport()
    eng = _engine(ROUTED, routed_model, kvstore=KVStore(StoreConfig(remote=t)))
    h = eng.submit(Request(uid=1, prompt=[1, 2, 3], max_new_tokens=4))
    eng.step()
    h.park()
    name = eng.export_session(1)
    eng.submit(Request(uid=1, prompt=[9, 9], max_new_tokens=2))
    with pytest.raises(ValueError, match="collides"):
        eng.import_session(name)
    assert 1 not in eng.kvstore         # the imported lane was dropped
    eng.close()


def test_default_store_is_async_and_events_drain(routed_model):
    eng = _engine(ROUTED, routed_model)
    assert eng.kvstore.config == StoreConfig(async_transfers=True)
    eng.close()
    ft = FaultInjectionTransport(LoopbackTransport(), fail_puts=99)
    eng = _engine(ROUTED, routed_model, kvstore=KVStore(StoreConfig(
        host_bytes_limit=1, remote=ft, async_transfers=True)))
    h = eng.submit(Request(uid=4, prompt=[5, 6, 7], max_new_tokens=3))
    eng.step()
    h.park()
    eng.kvstore.flush(WAIT)
    eng.step()                          # drains the degradation event
    assert eng.kvstore_events == {"kvstore_remote_degraded": 1}
    assert eng.kvstore.drain_events() == []
    h.resume()
    while eng.has_work():
        eng.step()
    assert h.state == "finished" and len(h.output) == 3
    eng.close()


# ---------------------------------------------------------------------------
# A JAX prefill pool to a port decode pool
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_pools(tmp_path_factory):
    """The JAX package's prefill pool exports four sessions to a shared
    directory; its monolithic engine serves the same requests."""
    root = str(tmp_path_factory.mktemp("jax_blobs"))
    params, kstate = jax_init_model(JROUTED, jax.random.PRNGKey(0))
    reqs = [JaxRequest(uid=u, prompt=[(7 * u + 3 * i) % 128
                                      for i in range(5 + 4 * (u % 2))],
                       max_new_tokens=4 + u % 3) for u in range(4)]
    pre = JaxEngine(JROUTED, params, kstate, max_slots=SLOTS,
                    max_len=MAX_LEN, prefill_only=True,
                    kvstore=JaxKVStore(JaxStoreConfig(
                        remote=JaxFileTransport(root))))
    for r in reqs:
        pre.submit(dataclasses.replace(r, output=[]))
    while pre.has_work():
        pre.step()
    names = [pre.export_session(r.uid) for r in reqs]
    pre.close()
    mono = JaxEngine(JROUTED, params, kstate, max_slots=SLOTS,
                     max_len=MAX_LEN, record_logits=True)
    out = mono.run([dataclasses.replace(r, output=[]) for r in reqs])
    mono.close()
    return dict(root=root, names=names, out=out, trace=mono.logits_trace,
                params=jax.tree.map(np.asarray, params),
                kstate=jax.tree.map(np.asarray, kstate))


def test_jax_prefill_pool_to_port_decode_pool(jax_pools):
    jp = jax_pools
    eng = InferenceEngine(ROUTED, params_from_jax(jp["params"]),
                          kstate_from_jax(jp["kstate"]), max_slots=SLOTS,
                          max_len=MAX_LEN, record_logits=True, device="cpu",
                          kvstore=KVStore(StoreConfig(
                              remote=FileTransport(jp["root"]),
                              async_transfers=True)))
    handles = [eng.import_session(n) for n in jp["names"]]
    while eng.has_work():
        eng.step()
    eng.close()
    assert {h.uid: h.output for h in handles} == jp["out"]
    for uid, rows in jp["trace"].items():
        got = eng.logits_trace[uid]     # the decode rows (the prefill's
        assert len(got) == len(rows) - 1  # first row is the JAX pool's)
        for a, b in zip(got, rows[1:]):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
