"""The port's slot pool, the KV store's host tier and the prefix cache (reduced
rt-enwik8, fp32, on the CPU).

* `reset_slot` returns a lane to `init_cache`'s leaves (ring positions
  -1), `read_slot` / `write_slot` round-trip a lane exactly, and each of
  `write_slot`'s checks raises the JAX package's ValueError;
* the host-tier store's park -> resume round trip is byte-identical, and
  the compacted cluster pages take fewer bytes than the whole lane;
* `PrefixCache` exact and partial lookups, LRU order and read-only
  entries.
The store's other tiers, its background transfers and the session blob
are tested in `test_torch_kvstore_remote.py`. Everything here is exact: no
tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch import attn
from repro_torch.configs import reduced_config
from repro_torch.models.model import init_model
from repro_torch.serve.engine import (init_pool, read_slot, reset_slot,
                                      write_slot)
from repro_torch.serve.kvstore import KVStore, PrefixCache, StoreConfig
from repro_torch.serve.serving import init_cache, prefill
from repro_torch.tree import tree_leaves, tree_map, tree_paths

CFG = reduced_config("rt-enwik8")
MAX_LEN = 48


@pytest.fixture(scope="module")
def model():
    return init_model(CFG, seed=0, device="cpu")


def _lane(model, n=11, max_len=MAX_LEN):
    params, kstate = model
    toks = (torch.arange(n) * 7 % CFG.vocab_size)[None]
    _, lane = prefill(params, kstate, init_cache(CFG, 1, max_len,
                                                 device="cpu"),
                      {"tokens": toks}, CFG)
    return lane


def _assert_tree_equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype, path
        assert torch.equal(x.cpu(), y.cpu()), path


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_layouts_declare_reset_values_and_pages():
    assert attn.cache_reset_values() == {"lpos": -1}
    assert attn.pageable_cache_leaves() == {"rk": "rlen", "rv": "rlen"}


def test_reset_slot_restores_init_state(model):
    """A freed lane equals a freshly allocated lane, leaf for leaf:
    cluster pages emptied, local ring positions back to -1."""
    fresh = init_pool(CFG, 3, MAX_LEN, device="cpu")
    pool = init_pool(CFG, 3, MAX_LEN, device="cpu")
    write_slot(pool, 1, _lane(model))
    dirty = sum(int((a != b).sum()) for a, b in
                zip(tree_leaves(pool), tree_leaves(fresh)))
    assert dirty > 0
    reset_slot(pool, 1)
    _assert_tree_equal(pool, fresh)
    assert all(bool((seg["0"]["lpos"] == -1).all()) for seg in pool)


def test_read_slot_roundtrip_and_copy(model):
    pool = init_pool(CFG, 2, MAX_LEN, device="cpu")
    lane = _lane(model, n=9)
    write_slot(pool, 1, lane)
    back = read_slot(pool, 1)
    _assert_tree_equal(back, lane)
    reset_slot(pool, 1)                     # read_slot handed out a copy
    _assert_tree_equal(back, lane)
    _assert_tree_equal(read_slot(pool, 0),
                       init_cache(CFG, 1, MAX_LEN, device="cpu"))


def _with_leaf(lane, name, fn):
    return [{g: {k: (fn(v) if k == name else v) for k, v in leaves.items()}
             for g, leaves in seg.items()} for seg in lane]


@pytest.mark.parametrize("fault,match", [
    ("max_len", "trailing"),
    ("dtype", "dtype"),
    ("batch", "B=1"),
    ("structure", "structure"),
    ("rank", "rank"),
    ("groups", "scan-group"),
])
def test_write_slot_rejects_bad_lanes(model, fault, match):
    pool = init_pool(CFG, 2, MAX_LEN, device="cpu")
    before = read_slot(pool, 0)
    lane = _lane(model)
    bad = {
        "max_len": lambda: _lane(model, n=5, max_len=MAX_LEN // 2),
        "dtype": lambda: tree_map(
            lambda t: t.double() if t.is_floating_point() else t, lane),
        "batch": lambda: tree_map(lambda t: torch.cat([t, t], 1), lane),
        "structure": lambda: [{g: {k: v for k, v in leaves.items()
                                   if k != "rlen"}
                               for g, leaves in seg.items()} for seg in lane],
        "rank": lambda: _with_leaf(lane, "rk", lambda t: t[..., 0]),
        "groups": lambda: tree_map(lambda t: t[:1], lane),
    }[fault]()
    with pytest.raises(ValueError, match=match):
        write_slot(pool, 0, bad)
    _assert_tree_equal(read_slot(pool, 0), before)   # nothing written


def test_slot_index_bounds_checked(model):
    pool = init_pool(CFG, 2, MAX_LEN, device="cpu")
    lane = _lane(model)
    with pytest.raises(ValueError, match="out of range"):
        write_slot(pool, 2, lane)
    with pytest.raises(ValueError, match="out of range"):
        read_slot(pool, -1)
    with pytest.raises(ValueError, match="out of range"):
        reset_slot(pool, 5)


def test_init_pool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_pool(CFG, 2, MAX_LEN)


# ---------------------------------------------------------------------------
# Host-tier KV store
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [3, 11, 40])
def test_park_resume_roundtrip_bitexact(model, n):
    """Park -> resume reproduces every leaf byte-identically, compacted
    cluster pages re-expanded against their rlen tables, and the lane
    written back into another slot reads back as parked."""
    pool = init_pool(CFG, 3, MAX_LEN, device="cpu")
    write_slot(pool, 0, _lane(model, n=n))
    lane = read_slot(pool, 0)
    store = KVStore()
    sess = store.park(7, lane)
    assert 7 in store and len(store) == 1
    assert sess.nbytes == store.host_bytes < _nbytes(lane)
    back = store.resume(7)
    assert 7 not in store and store.host_bytes == 0
    _assert_tree_equal(back, lane)
    write_slot(pool, 2, back)
    _assert_tree_equal(read_slot(pool, 2), lane)
    st = store.stats()
    assert st["kvstore/parks"] == st["kvstore/resumes"] == 1.0
    assert st["kvstore/bytes_to_host"] == float(sess.nbytes)


def test_page_compaction_tracks_occupancy(model):
    """Compacted bytes grow with the pages' occupancy, stay below the
    whole lane, and compaction off keeps every byte."""
    short, long = _lane(model, n=4), _lane(model, n=40)
    store = KVStore()
    b_short = store.park(1, short).nbytes
    b_long = store.park(2, long).nbytes
    full = KVStore(StoreConfig(compact_pages=False)).park(3, long).nbytes
    assert b_short < b_long < full == _nbytes(long)
    _assert_tree_equal(store.resume(1), short)


def test_park_duplicate_and_resume_missing_raise(model):
    store = KVStore()
    lane = _lane(model)
    store.park(1, lane)
    with pytest.raises(ValueError, match="already parked"):
        store.park(1, lane)
    with pytest.raises(KeyError):
        store.resume(2)
    store.drop(1)
    assert len(store) == 0 and store.prefetch(1) is None


# ---------------------------------------------------------------------------
# Prefix cache
# ---------------------------------------------------------------------------
def test_prefix_cache_exact_partial_and_lru(model):
    lane = _lane(model)
    row = torch.arange(CFG.vocab_size, dtype=torch.float32)[None]
    pc = PrefixCache(capacity=2)
    assert pc.get([1, 2, 3]) is None                # miss counted
    pc.put([1, 2, 3], lane, row)
    hit = pc.get([1, 2, 3])
    assert hit.matched == 3
    _assert_tree_equal(hit.lane_as(lane), lane)
    assert np.array_equal(hit.last_logits, row.numpy())
    assert pc.get([1, 2]) is None                   # prefix != exact key
    part = pc.get([1, 2, 3, 4, 5], partial=True)    # longest prefix
    assert part is not None and part.matched == 3
    assert pc.get([9, 1, 2, 3], partial=True) is None
    pc.put([4], lane, row)
    pc.get([1, 2, 3])                               # refresh LRU order
    pc.put([5], lane, row)                          # evicts [4]
    assert pc.get([4]) is None and pc.get([5]) is not None
    st = pc.stats()
    assert st["kvstore/prefix_hits"] == 3.0
    assert st["kvstore/prefix_partial_hits"] == 1.0
    assert st["kvstore/prefix_misses"] == 4.0
    assert 0.0 < pc.hit_rate < 1.0
    # entries are read-only host copies: a consumer cannot corrupt the
    # shared lane, and the pool never aliases it
    leaf = tree_leaves(hit.lane)[0]
    with pytest.raises(ValueError):
        leaf[...] = 0
    pool = init_pool(CFG, 1, MAX_LEN, device="cpu")
    write_slot(pool, 0, hit.lane_as(lane))
    reset_slot(pool, 0)
    _assert_tree_equal(pc.get([1, 2, 3]).lane_as(lane), lane)
