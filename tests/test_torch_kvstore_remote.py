"""The port's tiered KV store beyond the host tier, on the CPU (reduced
local+routing model: 2 layers, d_model 64, k 4, local window 8, fp32,
``max_len`` 48), mirroring the JAX package's ``test_remote_kvstore.py`` and
its disk-tier tests:

* the session blob: round trip, corruption and truncation detected;
* the transports (Loopback, File, TCP) behave alike, the TCP framing holds
  a blob larger than a socket buffer, an unreachable peer is retried and
  then refused, ``with_retries`` retries transient faults only;
* the disk tier, the remote tier and the disk-then-remote chain resume
  bit for bit; a failed remote push degrades to the host or the disk tier
  with a recorded event; corrupted, truncated or dropped remote blobs
  raise and the session survives;
* async parks: an in-flight handle, an immediate resume, a duplicate park,
  ``flush``; a background failure raises at ``flush`` (and, where the lane
  was lost, at that uid's ``resume``); a dead worker refuses new parks;
  three caller threads on one store with every tier, bit for bit;
* ``prefetch`` of a spilled and of a remote session;
* export and import (loopback and TCP) and a failed export that keeps
  the session;
* across the two packages: a blob the JAX package's ``encode_session``
  wrote from a JAX engine's parked lane decodes in the port, each leaf
  equal bit for bit to that lane carried across by ``interop``, fp32 and
  bf16; a port-written blob decodes with the JAX package's
  ``decode_session``; the JAX ``TCPTransport`` puts to the port's
  ``TCPStoreServer`` and the port's client reads the same bytes; the
  port's ``stats()`` holds every key of the JAX store's.

Every socket has a timeout, every wait a ``timeout=``, servers close in a
context manager and retry delays are in milliseconds. Everything here is
exact: no tolerance.
"""
import struct
import sys
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.models.model import init_model as jax_init_model
from repro.serve.engine import InferenceEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.kvstore import KVStore as JaxKVStore
from repro.serve.kvstore import StoreConfig as JaxStoreConfig
from repro.serve.kvstore.remote import LoopbackTransport as JaxLoopback
from repro.serve.kvstore.remote import TCPTransport as JaxTCPTransport
from repro.serve.kvstore.remote import decode_session as jax_decode_session
from repro.serve.kvstore.remote import encode_session as jax_encode_session
from repro_torch.configs.base import ModelConfig, RoutingConfig
from repro_torch.interop import params_from_jax
from repro_torch.models.model import init_model
from repro_torch.serve.kvstore import InflightPark, KVStore, StoreConfig
from repro_torch.serve.kvstore import store as store_mod
from repro_torch.serve.kvstore.remote import (BlobChecksumError, BlobError,
                                              BlobNotFound,
                                              FaultInjectionTransport,
                                              FileTransport,
                                              LoopbackTransport, RetryPolicy,
                                              TCPStoreServer, TCPTransport,
                                              TransportError, decode_session,
                                              encode_session, with_retries)
from repro_torch.serve.kvstore.remote.blob import keystr
from repro_torch.serve.serving import init_cache, prefill
from repro_torch.tree import tree_map, tree_paths

ENG = dict(name="rkv", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
           attention="local+routing", dtype="float32")
JCFG = JaxModelConfig(routing=JaxRoutingConfig(num_clusters=4,
                                               local_window=8), **ENG)
CFG = ModelConfig(routing=RoutingConfig(num_clusters=4, local_window=8),
                  **ENG)
MAX_LEN = 48
FAST = RetryPolicy(attempts=3, base_delay_s=0.001, max_delay_s=0.002)
WAIT = 30.0                             # seconds: every wait's timeout


@pytest.fixture(scope="module")
def model():
    return init_model(CFG, seed=0, device="cpu")


@pytest.fixture(scope="module")
def lane(model):
    params, kstate = model
    toks = (torch.arange(11) * 7 % CFG.vocab_size)[None]
    _, out = prefill(params, kstate, init_cache(CFG, 1, MAX_LEN,
                                                device="cpu"),
                     {"tokens": toks}, CFG)
    return out


def _assert_tree_equal(a, b):
    pa, pb = dict(tree_paths(a)), dict(tree_paths(b))
    assert pa.keys() == pb.keys()
    for path, x in pa.items():
        assert x.dtype == pb[path].dtype, path
        assert torch.equal(x, pb[path]), path


def _tiers(store):
    return {uid: s.tier for uid, s in store._sessions.items()}


# ---------------------------------------------------------------------------
# Blob codec
# ---------------------------------------------------------------------------
def test_blob_roundtrip_bitexact(lane):
    sess = KVStore().park(5, lane)
    blob = encode_session(sess, meta={"pos": 11, "note": "x"})
    back, meta = decode_session(blob)
    assert meta == {"pos": 11, "note": "x"}
    assert back.uid == 5 and sorted(back.order) == sorted(sess.order)
    assert back.nbytes == sess.nbytes
    for k in sess.order:
        a, b = sess.leaves[k], back.leaves[k]
        assert a.shape == b.shape and a.page_len_key == b.page_len_key
        assert a.data.dtype == b.data.dtype
        assert torch.equal(a.data, b.data), k


def test_blob_detects_corruption_and_truncation(lane):
    blob = encode_session(KVStore().park(1, lane))
    for i in (10, len(blob) // 2, len(blob) - 1):
        bad = blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1:]
        with pytest.raises(BlobChecksumError):
            decode_session(bad)
    with pytest.raises(BlobError):
        decode_session(blob[:len(blob) // 2])
    with pytest.raises(BlobError):
        decode_session(b"")
    with pytest.raises(BlobError, match="magic"):
        body = b"XXXX" + blob[4:-4]     # a valid CRC over a wrong magic
        decode_session(body + struct.pack(">I", zlib.crc32(body)))


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------
@pytest.fixture(params=["loopback", "file", "tcp"])
def transport(request, tmp_path):
    if request.param == "loopback":
        yield LoopbackTransport()
    elif request.param == "file":
        yield FileTransport(str(tmp_path / "blobs"))
    else:
        with TCPStoreServer() as server:
            yield TCPTransport(server.host, server.port, retry=FAST,
                               connect_timeout_s=2.0, io_timeout_s=WAIT)


def test_transport_semantics(transport):
    """put/get/delete/exists/list behave alike on every transport (the
    store's remote tier is transport-agnostic by this contract)."""
    assert not transport.exists("a")
    with pytest.raises(BlobNotFound):
        transport.get("a")
    transport.put("a", b"one")
    transport.put("b/1", b"two")
    transport.put("b/2", b"three" * 1000)
    assert transport.exists("a") and transport.get("a") == b"one"
    transport.put("a", b"overwritten")
    assert transport.get("a") == b"overwritten"
    assert transport.list_blobs() == ["a", "b/1", "b/2"]
    assert transport.list_blobs("b/") == ["b/1", "b/2"]
    transport.delete("a")
    assert not transport.exists("a")
    with pytest.raises(BlobNotFound):
        transport.delete("a")
    stats = transport.stats()
    assert stats["transport/puts"] == 4.0
    assert stats["transport/bytes_in"] > 0


def test_tcp_large_blob_roundtrip():
    """The framing holds across many recv() chunks (8 MiB does not fit one
    socket buffer)."""
    big = np.random.RandomState(0).bytes(8 << 20)
    with TCPStoreServer() as server:
        t = TCPTransport(server.host, server.port, retry=FAST,
                         connect_timeout_s=2.0, io_timeout_s=WAIT)
        t.put("big", big)
        assert t.get("big") == big


def test_tcp_unreachable_peer_retries_then_fails():
    with TCPStoreServer() as probe:
        port = probe.port               # free once the probe has closed
    t = TCPTransport("127.0.0.1", port, retry=FAST, connect_timeout_s=1.0,
                     io_timeout_s=1.0)
    with pytest.raises(TransportError, match="gave up after 3"):
        t.put("x", b"1")
    assert t.stats()["transport/retries"] == 2.0
    assert t.stats()["transport/failures"] == 1.0


def test_with_retries_policy():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransportError("transient")
        return "ok"

    assert with_retries(flaky, FAST) == "ok"
    assert len(calls) == 3
    with pytest.raises(BlobNotFound):
        # a deterministic answer is never retried
        with_retries(lambda: (_ for _ in ()).throw(BlobNotFound("gone")),
                     FAST)
    assert list(RetryPolicy(attempts=4, base_delay_s=0.001, factor=2.0,
                            max_delay_s=0.003).delays()) == [0.001, 0.002,
                                                             0.003]


# ---------------------------------------------------------------------------
# Disk and remote tiers
# ---------------------------------------------------------------------------
def test_disk_spill_roundtrip_bitexact(lane, tmp_path):
    """host_bytes_limit=1 sends every park straight to disk; the resumed
    lane is byte-identical and the spill file is reclaimed."""
    store = KVStore(StoreConfig(spill_dir=str(tmp_path), host_bytes_limit=1))
    store.park(3, lane)
    assert len(list(tmp_path.glob("kv_session_*.blob"))) == 1
    assert store.stats()["kvstore/spills"] == 1.0
    _assert_tree_equal(lane, store.resume(3))
    assert list(tmp_path.glob("kv_session_*.blob")) == []
    assert store.stats()["kvstore/resume_disk_p50_s"] > 0


def test_spill_is_lru_and_respects_limit(lane, tmp_path):
    nbytes = KVStore().park(0, lane).nbytes
    store = KVStore(StoreConfig(spill_dir=str(tmp_path),
                                host_bytes_limit=2 * nbytes))
    for uid in (1, 2):
        store.park(uid, lane)
    assert store.stats()["kvstore/spills"] == 0.0
    store.park(3, lane)                     # overflows: uid 1 spills
    assert _tiers(store) == {1: "disk", 2: "host", 3: "host"}
    assert store.host_bytes <= 2 * nbytes
    for uid in (1, 2, 3):
        _assert_tree_equal(lane, store.resume(uid))


@pytest.mark.parametrize("over", ["loopback", "tcp"])
def test_remote_tier_roundtrip_bitexact(lane, over):
    """With no disk tier, host_bytes_limit=1 pushes every park through the
    transport; the resumed lane is byte-identical, the blob reclaimed."""
    with TCPStoreServer() as server:
        t = (LoopbackTransport() if over == "loopback" else
             TCPTransport(server.host, server.port, retry=FAST,
                          connect_timeout_s=2.0, io_timeout_s=WAIT))
        store = KVStore(StoreConfig(host_bytes_limit=1, remote=t))
        store.park(3, lane)
        assert t.list_blobs() == ["spill/3"]
        assert _tiers(store) == {3: "remote"}
        _assert_tree_equal(lane, store.resume(3))
        assert t.list_blobs() == []
        st = store.stats()
        assert st["kvstore/remote_parks"] == st["kvstore/remote_resumes"] == 1
        assert st["kvstore/resume_remote_p50_s"] > 0


def test_disk_then_remote_tier_chain(lane, tmp_path):
    """disk_bytes_limit pushes the oldest spilled sessions on to the remote
    tier; every tier still resumes bit for bit."""
    nbytes = KVStore().park(0, lane).nbytes
    t = LoopbackTransport()
    store = KVStore(StoreConfig(spill_dir=str(tmp_path),
                                host_bytes_limit=2 * nbytes,
                                disk_bytes_limit=nbytes, remote=t))
    for uid in (1, 2, 3, 4):
        store.park(uid, lane)
    assert _tiers(store) == {1: "remote", 2: "disk", 3: "host", 4: "host"}
    for uid in (1, 2, 3, 4):
        _assert_tree_equal(lane, store.resume(uid))
    st = store.stats()
    assert st["kvstore/bytes_spilled"] == 2 * nbytes   # 1 and 2 spilled
    assert st["kvstore/bytes_to_remote"] > nbytes      # 1's blob
    assert len(list(tmp_path.glob("*.blob"))) == 0 and not t.list_blobs()


def test_disk_limit_without_remote_rejected(tmp_path):
    with pytest.raises(ValueError, match="remote"):
        KVStore(StoreConfig(spill_dir=str(tmp_path), disk_bytes_limit=1))


def test_over_limit_without_a_lower_tier_raises(lane):
    store = KVStore(StoreConfig(host_bytes_limit=1))
    with pytest.raises(RuntimeError, match="spill_dir"):
        store.park(1, lane)


@pytest.mark.parametrize("kept", ["host", "disk"])
def test_remote_put_failure_degrades(lane, tmp_path, kept):
    """A dead transport keeps the session on the nearer tier, counts and
    records the degradation, and the resume is bit for bit."""
    ft = FaultInjectionTransport(LoopbackTransport(), fail_puts=99)
    disk = (dict(spill_dir=str(tmp_path), disk_bytes_limit=1)
            if kept == "disk" else {})
    store = KVStore(StoreConfig(host_bytes_limit=1, remote=ft, **disk))
    store.park(4, lane)
    assert _tiers(store) == {4: kept}
    events = store.drain_events()
    assert [e["kind"] for e in events] == ["kvstore_remote_degraded"]
    assert events[0]["uid"] == 4 and events[0]["kept_tier"] == kept
    assert store.drain_events() == []
    assert store.stats()["kvstore/remote_degraded"] == 1.0
    _assert_tree_equal(lane, store.resume(4))


@pytest.mark.parametrize("fault", ["corrupt_gets", "truncate_gets"])
def test_damaged_remote_blob_raises_and_the_session_survives(lane, fault):
    ft = FaultInjectionTransport(LoopbackTransport(), **{fault: 1})
    store = KVStore(StoreConfig(host_bytes_limit=1, remote=ft))
    store.park(7, lane)
    with pytest.raises(BlobChecksumError):
        store.resume(7)
    assert 7 in store and _tiers(store) == {7: "remote"}
    _assert_tree_equal(lane, store.resume(7))   # the fault is used up


def test_dropped_put_is_a_loud_miss(lane):
    ft = FaultInjectionTransport(LoopbackTransport(), drop_puts=1)
    store = KVStore(StoreConfig(host_bytes_limit=1, remote=ft))
    store.park(8, lane)
    with pytest.raises(BlobNotFound):
        store.resume(8)
    assert 8 in store


def test_corrupted_spill_file_raises(lane, tmp_path):
    store = KVStore(StoreConfig(spill_dir=str(tmp_path), host_bytes_limit=1))
    store.park(2, lane)
    (path,) = tmp_path.glob("kv_session_2.blob")
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(BlobChecksumError):
        store.resume(2)
    assert 2 in store


# ---------------------------------------------------------------------------
# Async transfers
# ---------------------------------------------------------------------------
def test_async_park_returns_inflight_handle(lane):
    store = KVStore(StoreConfig(async_transfers=True))
    h = store.park(1, lane)
    assert isinstance(h, InflightPark) and h.uid == 1 and 1 in store
    sess = h.wait(WAIT)
    assert sess.nbytes > 0 and h.nbytes == sess.nbytes
    _assert_tree_equal(lane, store.resume(1, device="cpu"))
    st = store.stats()
    assert st["kvstore/park_transfer_p50_s"] > 0
    store.close()


def test_async_park_resume_immediately_and_duplicate(lane):
    """resume() right after an async park waits for the in-flight
    transfer; a second park of a parked uid is refused."""
    store = KVStore(StoreConfig(async_transfers=True))
    for uid in range(4):
        store.park(uid, lane)
        with pytest.raises(ValueError, match="already parked"):
            store.park(uid, lane)
        _assert_tree_equal(lane, store.resume(uid))
    assert len(store) == 0
    store.close()


def test_async_with_remote_tier_and_flush(lane, tmp_path):
    t = LoopbackTransport()
    nbytes = KVStore().park(0, lane).nbytes
    store = KVStore(StoreConfig(spill_dir=str(tmp_path),
                                host_bytes_limit=nbytes,
                                disk_bytes_limit=nbytes, remote=t,
                                async_transfers=True))
    for uid in range(4):
        store.park(uid, lane)
    store.flush(WAIT)
    assert _tiers(store) == {0: "remote", 1: "remote", 2: "disk", 3: "host"}
    assert t.list_blobs() == ["spill/0", "spill/1"]
    for uid in range(4):
        _assert_tree_equal(lane, store.resume(uid))
    assert store.stats()["kvstore/inflight_parks"] == 0.0
    store.close()


def test_async_failures_surface(lane, monkeypatch):
    """No background failure is swallowed: an eviction that fails after
    the session landed raises at flush (the session stays resumable); a
    park that lost its lane raises at flush and at its resume; a dead
    worker refuses the next park."""
    store = KVStore(StoreConfig(host_bytes_limit=1, async_transfers=True))
    store.park(1, lane)                 # nowhere to evict to
    with pytest.raises(RuntimeError, match="background park"):
        store.flush(WAIT)
    store.flush(WAIT)                   # raised once
    _assert_tree_equal(lane, store.resume(1))

    store = KVStore(StoreConfig(async_transfers=True))

    def lost(*_):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(store_mod.attn_api, "pageable_cache_leaves", lost)
    store.park(2, lane)
    with pytest.raises(RuntimeError, match="background park of session 2"):
        store.resume(2)
    with pytest.raises(RuntimeError, match="copy failed"):
        store.flush(WAIT)
    assert 2 not in store
    monkeypatch.undo()
    store.drop(2)                       # clears the failure
    store.park(2, lane)
    _assert_tree_equal(lane, store.resume(2))

    store._get_worker().close()
    with pytest.raises(RuntimeError, match="not running"):
        store.park(3, lane)
    assert 3 not in store and len(store) == 0


def test_async_store_under_concurrent_callers(lane, tmp_path):
    """Three caller threads park, prefetch, resume and drop their own uids
    on one async store with every tier while its worker evicts, with a
    short switch interval: every resume is bit for bit, nothing is lost
    and every tier copy is reclaimed."""
    nbytes = KVStore().park(0, lane).nbytes
    t = LoopbackTransport()
    store = KVStore(StoreConfig(spill_dir=str(tmp_path), remote=t,
                                host_bytes_limit=2 * nbytes,
                                disk_bytes_limit=2 * nbytes,
                                async_transfers=True))
    errors = []

    def caller(base):
        try:
            for i in range(16):
                uid = base + i
                store.park(uid, lane)
                if i % 3 == 1:
                    store.prefetch(uid)
                if i % 4 == 3:
                    store.drop(uid)
                    continue
                _assert_tree_equal(lane, store.resume(uid))
        except BaseException as e:      # reported below, in the test
            errors.append(e)

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(100 * k,))
                   for k in range(1, 4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
    finally:
        sys.setswitchinterval(old_interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    store.flush(WAIT)
    assert len(store) == 0 and store.host_bytes == 0
    assert t.list_blobs() == [] and list(tmp_path.iterdir()) == []
    store.close()


@pytest.mark.parametrize("tier", ["disk", "remote"])
def test_prefetch_warms_a_session(lane, tmp_path, tier):
    lower = (dict(spill_dir=str(tmp_path)) if tier == "disk"
             else dict(remote=LoopbackTransport()))
    store = KVStore(StoreConfig(host_bytes_limit=1, **lower))
    store.park(1, lane)
    assert _tiers(store) == {1: tier}
    h = store.prefetch(1)
    h.wait(WAIT)
    assert _tiers(store) == {1: "host"}
    assert store.prefetch(1) is None    # already resident: no-op
    assert store.prefetch(99) is None   # unknown: no-op
    _assert_tree_equal(lane, store.resume(1))
    assert store.stats()["kvstore/prefetches"] == 1.0
    store.close()


# ---------------------------------------------------------------------------
# Export / import (the disaggregation rail)
# ---------------------------------------------------------------------------
def test_export_import_moves_ownership(lane):
    t = LoopbackTransport()
    a = KVStore(StoreConfig(remote=t))
    b = KVStore(StoreConfig(remote=t))
    a.park(11, lane)
    name = a.export(11, meta={"pos": 11, "last_token": 3})
    assert 11 not in a and name == "session/11"
    uid, meta = b.import_remote(name)
    assert (uid, meta) == (11, {"pos": 11, "last_token": 3})
    assert not t.exists(name)           # consumed
    t.put(name, encode_session(KVStore().park(11, lane)))
    with pytest.raises(ValueError, match="already parked"):
        b.import_remote(name)
    _assert_tree_equal(lane, b.resume(11))
    assert a.stats()["kvstore/exports"] == b.stats()["kvstore/imports"] == 1


def test_export_import_over_tcp(lane, tmp_path):
    """A spilled session exports over TCP; the importer spills it too."""
    with TCPStoreServer() as server:
        def tcp():
            return TCPTransport(server.host, server.port, retry=FAST,
                                connect_timeout_s=2.0, io_timeout_s=WAIT)
        a = KVStore(StoreConfig(spill_dir=str(tmp_path / "a"),
                                host_bytes_limit=1, remote=tcp()))
        a.park(12, lane)
        assert _tiers(a) == {12: "disk"}
        name = a.export(12, meta={"k": 1})
        assert len(server) == 1
        b = KVStore(StoreConfig(spill_dir=str(tmp_path / "b"),
                                host_bytes_limit=1, remote=tcp()))
        assert b.import_remote(name) == (12, {"k": 1})
        assert len(server) == 0 and _tiers(b) == {12: "disk"}
        _assert_tree_equal(lane, b.resume(12))


def test_export_failure_keeps_session(lane):
    ft = FaultInjectionTransport(LoopbackTransport(), fail_puts=99)
    store = KVStore(StoreConfig(remote=ft))
    store.park(13, lane)
    with pytest.raises(TransportError):
        store.export(13)
    assert 13 in store
    _assert_tree_equal(lane, store.resume(13))
    with pytest.raises(KeyError):
        store.resume(99)
    with pytest.raises(ValueError, match="transport"):
        KVStore().export(1)


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_parked():
    """A JAX engine's lane, parked by its prefill-only pool: the JAX
    package's blob of it (fp32, and with its float leaves cast to bf16)
    and the lane itself as numpy leaves."""
    params, kstate = jax_init_model(JCFG, jax.random.PRNGKey(0))
    eng = JaxEngine(JCFG, params, kstate, max_slots=2, max_len=MAX_LEN,
                    prefill_only=True)
    eng.submit(JaxRequest(uid=7, prompt=list(range(3, 14)),
                          max_new_tokens=4))
    while eng.has_work():
        eng.step()
    eng.kvstore.flush(WAIT)
    blob = jax_encode_session(eng.kvstore._sessions[7], meta={"pos": 11})
    lane = jax.tree.map(np.asarray, eng.kvstore.resume(7))
    eng.close()
    lane16 = jax.tree.map(lambda x: (np.asarray(jnp.asarray(x, jnp.bfloat16))
                                     if x.dtype == np.float32 else x), lane)
    blob16 = jax_encode_session(JaxKVStore().park(8, lane16))
    return dict(float32=(blob, lane), bfloat16=(blob16, lane16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_blob_decodes_in_the_port(jax_parked, dtype):
    blob, lane = jax_parked[dtype]
    sess, meta = decode_session(blob)
    assert meta == ({"pos": 11} if dtype == "float32" else {})
    store = KVStore()
    with store._lock:
        store._sessions[sess.uid] = sess
    back = store.resume(sess.uid)
    ref = params_from_jax(lane)
    _assert_tree_equal(back, ref)
    assert {x.dtype for _, x in tree_paths(back)} >= {getattr(torch, dtype)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_blob_decodes_in_the_jax_package(lane, dtype):
    port_lane = tree_map(lambda t: t.to(getattr(torch, dtype))
                         if t.is_floating_point() else t, lane)
    blob = encode_session(KVStore().park(21, port_lane), meta={"m": [1, 2]})
    jsess, meta = jax_decode_session(blob)
    assert jsess.uid == 21 and meta == {"m": [1, 2]}
    jstore = JaxKVStore()
    jstore._sessions[21] = jsess
    back = jstore.resume(21)
    ref = dict(tree_paths(port_lane))
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert sorted(keystr(p) for p in ref) == [jax.tree_util.keystr(p)
                                              for p, _ in flat]
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    for path, t in ref.items():
        a = got[keystr(path)]
        assert a.dtype.name == dtype or not t.is_floating_point()
        want = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                else t.numpy())
        have = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(have, want), path


def test_jax_tcp_client_to_port_server(jax_parked):
    blob, _ = jax_parked["float32"]
    with TCPStoreServer() as server:
        jt = JaxTCPTransport(server.host, server.port, retry=FAST,
                             connect_timeout_s=2.0, io_timeout_s=WAIT)
        jt.put("session/7", blob)
        pt = TCPTransport(server.host, server.port, retry=FAST,
                          connect_timeout_s=2.0, io_timeout_s=WAIT)
        assert pt.get("session/7") == blob
        assert pt.list_blobs() == jt.list_blobs() == ["session/7"]
        pt.put("x", b"port")
        assert jt.get("x") == b"port"
        assert KVStore(StoreConfig(remote=pt)).import_remote(
            "session/7") == (7, {"pos": 11})
        assert not jt.exists("session/7")


def test_stats_hold_the_jax_store_keys(lane, jax_parked):
    """After the same park, remote push and resume, the port's stats()
    holds every key of the JAX store's (plus the per-tier resume
    latencies)."""
    _, jlane = jax_parked["float32"]
    jstore = JaxKVStore(JaxStoreConfig(host_bytes_limit=1,
                                       remote=JaxLoopback()))
    jstore.park(1, jlane)
    jstore.resume(1)
    store = KVStore(StoreConfig(host_bytes_limit=1,
                                remote=LoopbackTransport()))
    store.park(1, lane)
    store.resume(1)
    jkeys, keys = set(jstore.stats()), set(store.stats())
    assert jkeys <= keys
    assert keys - jkeys == {"kvstore/resume_remote_p50_s",
                            "kvstore/resume_remote_p99_s"}
