"""repro_torch.serve.kvstore — the tiered KV store behind the engine's slot
pool (port of the JAX package's ``repro.serve.kvstore``).

Three tiers below the device pool:

  host    parked sessions live as host tensors, cluster pages stored
          compacted: only the occupied prefix of each page, per the
          layouts' ``pageable_leaves`` / ``page_len_leaf``
  disk    optional spill once the host tier exceeds its byte limit —
          one checksummed blob file per session (versioned header +
          CRC32, verified on load)
  remote  optional ``Transport`` to a peer blob store beyond the disk
          tier; also the rail sessions move over between disaggregated
          prefill/decode pools (``export`` / ``import_remote``)

Public surface:
  KVStore, StoreConfig, ParkedSession — park(uid, lane) / resume(uid)
  InflightPark                        — async park completion handle
  PrefixCache, PrefixHit              — shared prompt lanes
  repro_torch.serve.kvstore.remote    — blob codec + transports + worker
"""
from repro_torch.serve.kvstore.prefix import PrefixCache, PrefixHit
from repro_torch.serve.kvstore.store import (InflightPark, KVStore,
                                             ParkedSession, StoreConfig)

__all__ = ["KVStore", "StoreConfig", "ParkedSession", "InflightPark",
           "PrefixCache", "PrefixHit"]
