"""KV store of the port, host tier: park a slot's cache lane off the card
and resume it bit for bit into any free slot (port of the host tier of
the JAX package's ``serve/kvstore/store.py``).

``park(uid, lane)`` takes the B=1 tree ``read_slot`` extracts and copies
it to host memory; ``resume(uid)`` hands back a tree ``write_slot``
accepts, every leaf byte-identical to what was parked. Cluster-paged
leaves (the layouts' ``pageable_leaves``) are kept compacted: only the
occupied ``min(page_len, cap)`` prefix of each page. The unoccupied slots
are zeros by construction (fresh lanes are zeroed, a prefill writes only
kept slots, decode appends one slot, ``reset_slot`` re-zeroes), so
dropping them and re-zeroing them on resume is exact.

The JAX package's other tiers are not ported: the disk spill
(``spill_dir``, ``host_bytes_limit``), the remote tier (``remote``,
``disk_bytes_limit``), background transfers (``async_transfers``) and the
session blobs that ``export``/``import_remote`` move between engines
(ROADMAP.md item 8). Asking for any of them raises NotImplementedError.

Metrics (park/resume latency histograms, bytes moved, counts) live in a
`repro_torch.obs.Registry` owned by the store; ``stats()`` flattens them
with the JAX store's keys.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import attn as attn_api
from repro_torch.obs import Registry
from repro_torch.tree import tree_paths, tree_unflatten

_UNPORTED = "is not ported yet (ROADMAP.md item 8: the KV store's disk " \
            "and remote tiers and background transfers)"


@dataclass(frozen=True)
class StoreConfig:
    """Knobs of the store. Only the host tier is ported: ``spill_dir``,
    ``host_bytes_limit``, ``disk_bytes_limit``, ``remote`` and
    ``async_transfers=True`` raise NotImplementedError.

    ``compact_pages``   per-page compaction of cluster-paged leaves
                        (disable only for debugging round trips)
    """

    spill_dir: Optional[str] = None
    host_bytes_limit: Optional[int] = None
    disk_bytes_limit: Optional[int] = None
    remote: Any = None
    compact_pages: bool = True
    async_transfers: bool = False

    def __post_init__(self):
        for knob in ("spill_dir", "host_bytes_limit", "disk_bytes_limit",
                     "remote"):
            if getattr(self, knob) is not None:
                raise NotImplementedError(f"StoreConfig.{knob} {_UNPORTED}")
        if self.async_transfers:
            raise NotImplementedError(
                f"StoreConfig.async_transfers=True {_UNPORTED}")


@dataclass
class _LeafRec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    data: Optional[torch.Tensor]        # host copy (compacted if paged)
    page_len_key: Optional[Tuple] = None  # set => data is the occupied
    #                                       prefix of each page


@dataclass
class ParkedSession:
    uid: int
    template: Any                       # the lane's structure (no data)
    order: List[Tuple]                  # leaf paths in flatten order
    leaves: Dict[Tuple, _LeafRec] = field(default_factory=dict)
    nbytes: int = 0                     # host bytes (compacted)


def _occupied(rlen: torch.Tensor, cap: int) -> torch.Tensor:
    """(..., cap) bool mask of the occupied ring slots of each page."""
    return (torch.arange(cap, device=rlen.device) <
            torch.clamp(rlen.long(), max=cap)[..., None])


class KVStore:
    """Host-tier session store."""

    def __init__(self, config: StoreConfig = StoreConfig()):
        self.config = config
        self._sessions: Dict[int, ParkedSession] = {}
        self.obs = Registry()
        self._park_s = self.obs.histogram("kvstore/park_s")
        self._resume_s = self.obs.histogram("kvstore/resume_s")
        self._parks = self.obs.counter("kvstore/parks")
        self._resumes = self.obs.counter("kvstore/resumes")
        self._to_host = self.obs.counter("kvstore/bytes_to_host")
        self._to_dev = self.obs.counter("kvstore/bytes_to_device")

    # -- inventory ---------------------------------------------------------
    def __contains__(self, uid: int) -> bool:
        return uid in self._sessions

    def __len__(self) -> int:
        return len(self._sessions)

    @property
    def host_bytes(self) -> int:
        return sum(s.nbytes for s in self._sessions.values())

    def drop(self, uid: int) -> None:
        self._sessions.pop(uid, None)
        self._update_gauges()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Every transfer of the host tier completes inside its call:
        nothing is in flight."""

    def close(self) -> None:
        self.flush()

    def drain_events(self) -> List[dict]:
        """Pop accumulated tier events: the host tier records none (the
        JAX store's events come from its remote tier)."""
        return []

    # -- park --------------------------------------------------------------
    @torch.no_grad()
    def park(self, uid: int, lane) -> ParkedSession:
        """Copy the B=1 cache ``lane`` to host memory under ``uid``."""
        if uid in self._sessions:
            raise ValueError(f"session {uid} is already parked")
        t0 = time.perf_counter()
        flat = tree_paths(lane)
        leaves = dict(flat)
        pageable = (attn_api.pageable_cache_leaves()
                    if self.config.compact_pages else {})
        sess = ParkedSession(
            uid=uid, template=tree_unflatten(lane, [None] * len(flat)),
            order=[p for p, _ in flat])
        for path, v in flat:
            v = v.detach()
            rec = _LeafRec(tuple(v.shape), v.dtype, None)
            rlen_key = path[:-1] + (pageable.get(path[-1], ""),)
            if path[-1] in pageable and rlen_key in leaves:
                # compacted where the lane lives, so only the occupied
                # rows cross to the host (a boolean gather copies)
                occ = _occupied(leaves[rlen_key], v.shape[-2])
                rec.data = v[occ].to("cpu")
                rec.page_len_key = rlen_key
            else:
                rec.data = v.to("cpu", copy=True)
            sess.leaves[path] = rec
        sess.nbytes = sum(r.data.numel() * r.data.element_size()
                          for r in sess.leaves.values())
        self._sessions[uid] = sess
        self._to_host.inc(sess.nbytes)
        self._park_s.record(time.perf_counter() - t0)
        self._parks.inc()
        self._update_gauges()
        return sess

    def _update_gauges(self) -> None:
        self.obs.gauge("kvstore/host_bytes").set(self.host_bytes)
        self.obs.gauge("kvstore/sessions").set(len(self))

    # -- resume ------------------------------------------------------------
    @torch.no_grad()
    def resume(self, uid: int):
        """Rebuild ``uid``'s lane bit for bit and remove it from the store.
        Returns host tensors in the structure and dtypes ``write_slot``
        checks against the pool; its copy streams them back to the card."""
        sess = self._sessions.pop(uid, None)
        if sess is None:
            raise KeyError(f"no parked session {uid}")
        t0 = time.perf_counter()
        full: Dict[Tuple, torch.Tensor] = {
            k: r.data for k, r in sess.leaves.items()
            if r.page_len_key is None}
        for key, rec in sess.leaves.items():
            if rec.page_len_key is None:
                continue
            out = torch.zeros(rec.shape, dtype=rec.dtype)
            out[_occupied(full[rec.page_len_key], rec.shape[-2])] = rec.data
            full[key] = out
        lane = tree_unflatten(sess.template, [full[k] for k in sess.order])
        self._resume_s.record(time.perf_counter() - t0)
        self._resumes.inc()
        self._to_dev.inc(sess.nbytes)
        self._update_gauges()
        return lane

    def prefetch(self, uid: int) -> None:
        """Scheduler hint that ``uid`` resumes soon: a no-op on the host
        tier, where every session is resident."""
        return None

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Flat float map of the store's counters and latencies."""
        out = {
            "kvstore/sessions": float(len(self)),
            "kvstore/host_bytes": float(self.host_bytes),
            "kvstore/parks": self._parks.value,
            "kvstore/resumes": self._resumes.value,
            "kvstore/bytes_to_host": self._to_host.value,
            "kvstore/bytes_to_device": self._to_dev.value,
        }
        for name, h in (("park", self._park_s), ("resume", self._resume_s)):
            if h.count:
                out[f"kvstore/{name}_p50_s"] = h.percentile(50)
                out[f"kvstore/{name}_p99_s"] = h.percentile(99)
        return out
