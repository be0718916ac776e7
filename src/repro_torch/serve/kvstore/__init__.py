"""repro_torch.serve.kvstore — the KV store behind the engine's slot pool
(port of the host tier of the JAX package's ``repro.serve.kvstore``).

  host    parked sessions live as host tensors, cluster pages stored
          compacted: only the occupied prefix of each page, per the
          layouts' ``pageable_leaves`` / ``page_len_leaf``

The disk and remote tiers, background transfers and the session blobs of
``export``/``import_remote`` are ROADMAP.md item 8.

Public surface:
  KVStore, StoreConfig, ParkedSession — park(uid, lane) / resume(uid)
  PrefixCache, PrefixHit              — shared prompt lanes
"""
from repro_torch.serve.kvstore.prefix import PrefixCache, PrefixHit
from repro_torch.serve.kvstore.store import (KVStore, ParkedSession,
                                             StoreConfig)

__all__ = ["KVStore", "StoreConfig", "ParkedSession", "PrefixCache",
           "PrefixHit"]
