"""Tiered KV store of the port: park a slot's cache lane off the card,
resume it bit for bit into any free slot (port of the JAX package's
``serve/kvstore/store.py``).

``park(uid, lane)`` takes the B=1 tree ``read_slot`` extracts and moves
it off the card; ``resume(uid)`` hands back a tree ``write_slot``
accepts, every leaf byte-identical to what was parked. Four tiers:

  device   the engine's slot pool (not this module's problem)
  host     parked sessions as host tensors, cluster-paged leaves (the
           layouts' ``pageable_leaves``) kept compacted: only the
           occupied ``min(page_len, cap)`` prefix of each page. The
           unoccupied slots are zeros by construction (fresh lanes are
           zeroed, a prefill writes only kept slots, decode appends one
           slot, ``reset_slot`` re-zeroes), so dropping them and
           re-zeroing them on resume is exact
  disk     beyond ``host_bytes_limit`` the least recently parked
           sessions spill to ``spill_dir`` in the checksummed blob
           format (remote/blob.py: versioned header + CRC32, verified
           on load; a corrupted spill file raises instead of resuming
           silent garbage)
  remote   beyond the disk tier (``disk_bytes_limit``, or directly when
           no ``spill_dir`` is set): the same blob pushed through a
           ``Transport`` to a peer host or object store. A remote push
           that fails after the transport's retries degrades: the
           session stays on the nearer tier and a
           ``kvstore_remote_degraded`` event is recorded; a parked
           session is never lost

A park copies whole lanes off the card and compacts the pages on the
host. On the card the copies run on a side stream of the store's that
waits for the caller's current stream, non-blocking into pinned buffers,
and a CUDA event marks their end; the lane's tensors stay referenced
until that event has completed. Compacting where the lane lives would
cross only the occupied rows (about 2.4x fewer bytes for a long
rt-enwik8 lane), but a boolean gather's output size depends on data on
the card, so the calling thread would wait for the card on every park.
A resume goes the other way at the caller's side: only the occupied rows
cross to the device asked for (the engine's card), where the pages are
re-expanded.

``async_transfers=True`` moves the rest of a park (waiting on the event,
compaction, tier eviction) and every prefetch onto one background worker
thread: ``park()`` returns an ``InflightPark`` without waiting for the
card, so the engine's admission path overlaps the transfer with its next
decode step. ``resume()``, ``export()``, ``drop()`` and ``prefetch()``
settle the uid's in-flight transfer first. A background failure is never
swallowed: a park that lost its lane raises at that uid's ``resume`` or
``export``, and every failed background park raises at the next
``flush()``. Without ``async_transfers`` the same steps run inside
``park()``. ``export``/``import_remote`` move whole sessions (plus caller
metadata) between engines through a transport: the rail of the
disaggregated prefill and decode pools.

Metrics (park/resume latency histograms, resume latency per tier the
session came from, background transfer latency, bytes per tier,
spill/remote/degraded counts) live in a `repro_torch.obs.Registry` owned
by the store; ``stats()`` flattens them with the JAX store's keys.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import attn as attn_api
from repro_torch.obs import Registry
from repro_torch.serve.kvstore.remote.blob import (decode_session,
                                                   encode_session)
from repro_torch.serve.kvstore.remote.transport import (Transport,
                                                        TransportError)
from repro_torch.serve.kvstore.remote.worker import (TransferHandle,
                                                     TransferWorker)
from repro_torch.tree import tree_paths, tree_unflatten

SPILL_SUFFIX = ".blob"
TIERS = ("host", "disk", "remote")


@dataclass(frozen=True)
class StoreConfig:
    """Knobs for the tiered store.

    ``spill_dir``         directory for the disk tier (None = no disk
                          tier; with a host byte limit but neither disk
                          nor remote, over-limit parks raise instead of
                          silently growing)
    ``host_bytes_limit``  soft cap on resident parked bytes — exceeding
                          it moves least-recently-parked sessions down a
                          tier (disk first, else remote)
    ``disk_bytes_limit``  soft cap on spilled bytes — exceeding it
                          pushes the oldest disk sessions to the remote
                          tier (requires ``remote``)
    ``remote``            a ``Transport`` to a peer blob store: the tier
                          beyond disk, and the rail ``export`` /
                          ``import_remote`` move sessions over for
                          disaggregated prefill/decode pools
    ``compact_pages``     per-page compaction of cluster-paged leaves
                          (disable only for debugging round trips)
    ``async_transfers``   run the host side of a park, tier eviction and
                          prefetch on a background worker so ``park()``
                          returns without waiting for the card
    """

    spill_dir: Optional[str] = None
    host_bytes_limit: Optional[int] = None
    disk_bytes_limit: Optional[int] = None
    remote: Optional[Transport] = None
    compact_pages: bool = True
    async_transfers: bool = False


@dataclass
class _LeafRec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    data: Optional[torch.Tensor]        # host copy; None while spilled or
    #                                     remote
    page_len_key: Optional[Tuple] = None  # set => data is the occupied
    #                                       prefix of each page


@dataclass
class ParkedSession:
    uid: int
    template: Any                       # the lane's structure (no data)
    order: List[Tuple]                  # leaf paths in the template's order
    leaves: Dict[Tuple, _LeafRec] = field(default_factory=dict)
    nbytes: int = 0                     # host bytes (compacted)
    parked_at: float = 0.0
    spill_path: Optional[str] = None    # set while on the disk tier
    remote_name: Optional[str] = None   # set while on the remote tier

    @property
    def resident(self) -> bool:
        return self.spill_path is None and self.remote_name is None

    @property
    def tier(self) -> str:
        return ("remote" if self.remote_name is not None
                else "disk" if self.spill_path is not None else "host")


class InflightPark:
    """What ``park()`` returns under ``async_transfers``: the session's
    uid plus a completion handle. ``nbytes`` reads 0 until the host copy
    lands (that is the latency being hidden)."""

    def __init__(self, uid: int, handle: TransferHandle):
        self.uid = uid
        self._handle = handle

    @property
    def done(self) -> bool:
        return self._handle.done

    @property
    def nbytes(self) -> int:
        if not self._handle.done or self._handle._error is not None:
            return 0
        return self._handle._result.nbytes

    def wait(self, timeout: Optional[float] = None) -> ParkedSession:
        return self._handle.wait(timeout)

    def __repr__(self) -> str:
        state = "done" if self.done else "in-flight"
        return f"InflightPark(uid={self.uid}, {state})"


def _occupied(rlen: torch.Tensor, cap: int) -> torch.Tensor:
    """(..., cap) bool mask of the occupied ring slots of each page."""
    return (torch.arange(cap, device=rlen.device) <
            torch.clamp(rlen.long(), max=cap)[..., None])


class KVStore:
    """Tiered (host + optional disk + optional remote) session store."""

    def __init__(self, config: StoreConfig = StoreConfig()):
        if config.disk_bytes_limit is not None and config.remote is None:
            raise ValueError("disk_bytes_limit needs a remote transport "
                             "(the tier beyond disk) to evict into")
        self.config = config
        self._sessions: Dict[int, ParkedSession] = {}
        self._inflight: Dict[int, InflightPark] = {}
        self._prefetching: Dict[int, TransferHandle] = {}
        # background parks that lost their lane (raised at that uid's
        # resume/export) and every background park error not yet raised
        # by flush()
        self._failed: Dict[int, BaseException] = {}
        self._errors: List[Tuple[int, BaseException]] = []
        self._events: "deque[dict]" = deque(maxlen=512)
        self._lock = threading.RLock()
        self._evict_lock = threading.Lock()     # one tier eviction at a time
        self._worker: Optional[TransferWorker] = None
        self._streams: Dict[int, Any] = {}      # side stream per card
        self.obs = Registry()
        self._park_s = self.obs.histogram("kvstore/park_s")
        self._resume_s = self.obs.histogram("kvstore/resume_s")
        self._resume_tier_s = {t: self.obs.histogram(f"kvstore/resume_{t}_s")
                               for t in TIERS}
        self._transfer_s = self.obs.histogram("kvstore/park_transfer_s")
        self._parks = self.obs.counter("kvstore/parks")
        self._resumes = self.obs.counter("kvstore/resumes")
        self._to_host = self.obs.counter("kvstore/bytes_to_host")
        self._to_dev = self.obs.counter("kvstore/bytes_to_device")
        self._spilled_b = self.obs.counter("kvstore/bytes_spilled")
        self._spills = self.obs.counter("kvstore/spills")
        self._to_remote = self.obs.counter("kvstore/bytes_to_remote")
        self._from_remote = self.obs.counter("kvstore/bytes_from_remote")
        self._remote_parks = self.obs.counter("kvstore/remote_parks")
        self._remote_resumes = self.obs.counter("kvstore/remote_resumes")
        self._exports = self.obs.counter("kvstore/exports")
        self._imports = self.obs.counter("kvstore/imports")
        self._degraded = self.obs.counter("kvstore/remote_degraded")
        self._prefetches = self.obs.counter("kvstore/prefetches")
        if config.spill_dir:
            os.makedirs(config.spill_dir, exist_ok=True)

    def _get_worker(self) -> TransferWorker:
        with self._lock:
            if self._worker is None:
                self._worker = TransferWorker()
            return self._worker

    # -- inventory ---------------------------------------------------------
    def __contains__(self, uid: int) -> bool:
        with self._lock:
            return uid in self._sessions or uid in self._inflight

    def __len__(self) -> int:
        with self._lock:
            # union: an async park is briefly in both maps while the
            # worker commits the materialized session
            return len(self._sessions.keys() | self._inflight.keys())

    @property
    def host_bytes(self) -> int:
        with self._lock:
            return sum(s.nbytes for s in self._sessions.values()
                       if s.resident)

    def drop(self, uid: int) -> None:
        self._settle(uid)
        with self._lock:
            self._failed.pop(uid, None)
            s = self._sessions.pop(uid, None)
        if s is None:
            return
        if s.spill_path and os.path.exists(s.spill_path):
            os.remove(s.spill_path)
        if s.remote_name and self.config.remote is not None:
            try:
                self.config.remote.delete(s.remote_name)
            except (TransportError, KeyError):
                pass                    # best-effort remote GC
        self._update_gauges()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait until every in-flight park and prefetch has settled, then
        raise if a background park failed since the last flush (a failed
        prefetch leaves its session on its tier: the dependent resume
        loads it again and raises there)."""
        with self._lock:
            handles = ([p._handle for p in self._inflight.values()]
                       + list(self._prefetching.values()))
        for h in handles:
            if not h._event.wait(timeout):
                raise TimeoutError(f"transfer {h.label} did not complete "
                                   f"within {timeout}s")
        if self._worker is not None:
            self._worker.flush(timeout)
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            uid, err = errors[0]
            raise RuntimeError(
                f"{len(errors)} background park(s) failed (first: session "
                f"{uid}: {err!r})") from err

    def close(self) -> None:
        try:
            self.flush()
        finally:
            if self._worker is not None:
                self._worker.close()
                self._worker = None

    def drain_events(self) -> List[dict]:
        """Pop accumulated tier events (e.g. ``kvstore_remote_degraded``);
        the engine drains them on every step."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    def _settle(self, uid: int) -> None:
        """Wait for any in-flight park or prefetch of ``uid``."""
        with self._lock:
            park = self._inflight.get(uid)
            pre = self._prefetching.get(uid)
        if park is not None:
            park._handle._event.wait()
        if pre is not None:
            pre._event.wait()

    def _wait_uid(self, uid: int) -> None:
        """Settle ``uid``'s transfers; raise if its background park lost
        the lane (the failure surfaces at the caller that depends on it)."""
        self._settle(uid)
        with self._lock:
            err = self._failed.get(uid)
        if err is not None:
            raise RuntimeError(f"the background park of session {uid} "
                               f"failed: {err!r}") from err

    # -- park --------------------------------------------------------------
    def _side_stream(self, device: torch.device):
        with self._lock:
            s = self._streams.get(device.index)
            if s is None:
                s = self._streams[device.index] = torch.cuda.Stream(device)
            return s

    def _stage(self, flat):
        """Start the lane's copy to host memory. Returns the host tensors,
        the CUDA event that marks the copies' end (None on the CPU) and
        the lane's tensors, which must stay referenced until then. On the
        card the copies queue on the store's side stream behind the
        caller's current stream, into pinned buffers, so the calling
        thread does not wait for the card; CPU leaves are cloned."""
        devices = {v.device for _, v in flat}
        if len(devices) != 1:
            raise ValueError(f"a lane's leaves must live on one device, "
                             f"got {sorted(map(str, devices))}")
        (dev,) = devices
        if dev.type != "cuda":
            return [v.detach().clone() for _, v in flat], None, None
        side = self._side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        host = []
        with torch.cuda.stream(side):
            for _, v in flat:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v.detach(), non_blocking=True)
                host.append(buf)
        done = torch.cuda.Event(blocking=True)  # its waiter sleeps
        done.record(side)
        return host, done, [v for _, v in flat]

    @torch.no_grad()
    def park(self, uid: int, lane):
        """Move the B=1 cache ``lane`` off the card under ``uid``.

        Returns the ``ParkedSession`` (sync) or an ``InflightPark``
        handle (``async_transfers``: the host side of the copy and any
        tier eviction continue on the worker thread while the caller
        keeps decoding).
        """
        with self._lock:
            if uid in self._sessions or uid in self._inflight:
                raise ValueError(f"session {uid} is already parked")
            self._failed.pop(uid, None)
        t0 = time.perf_counter()
        flat = tree_paths(lane)
        template = tree_unflatten(lane, [None] * len(flat))
        paths = [p for p, _ in flat]
        host, done, keep = self._stage(flat)
        del flat

        def job() -> ParkedSession:
            return self._materialize(uid, template, paths, host, done,
                                     keep, t0)

        if not self.config.async_transfers:
            sess = job()
            self._park_s.record(time.perf_counter() - t0)
            self._parks.inc()
            return sess
        handle = TransferHandle(f"park:{uid}")
        inflight = InflightPark(uid, handle)
        with self._lock:
            self._inflight[uid] = inflight
        try:
            self._get_worker().submit(lambda: self._bg_park(uid, job),
                                      handle)
        except BaseException:
            with self._lock:
                self._inflight.pop(uid, None)
            raise
        self._park_s.record(time.perf_counter() - t0)
        self._parks.inc()
        return inflight

    def _bg_park(self, uid: int, job) -> ParkedSession:
        try:
            return job()
        except BaseException as e:
            with self._lock:
                if uid not in self._sessions:
                    self._failed[uid] = e
                self._errors.append((uid, e))
            raise
        finally:
            with self._lock:
                self._inflight.pop(uid, None)

    @torch.no_grad()
    def _materialize(self, uid: int, template, paths, host, done, keep,
                     t0: float) -> ParkedSession:
        """Wait for the copies, compact the pages on the host, insert the
        session and enforce the limits: the body of a park, on whichever
        thread runs it. A failed copy raises at ``done.synchronize()``."""
        if done is not None:
            done.synchronize()
        del keep                        # the copies have read the lane
        staged = dict(zip(paths, host))
        pageable = (attn_api.pageable_cache_leaves()
                    if self.config.compact_pages else {})
        sess = ParkedSession(uid=uid, template=template, order=list(paths),
                             parked_at=t0)
        for path in paths:
            v = staged[path]
            rec = _LeafRec(tuple(v.shape), v.dtype, None)
            rlen_key = path[:-1] + (pageable.get(path[-1], ""),)
            if path[-1] in pageable and rlen_key in staged:
                rec.data = v[_occupied(staged[rlen_key], v.shape[-2])]
                rec.page_len_key = rlen_key
            else:
                # a pinned staging buffer goes back to the allocator's
                # cache: the session keeps a copy in pageable memory
                rec.data = v.clone() if v.is_pinned() else v
            sess.leaves[path] = rec
        sess.nbytes = sum(r.data.numel() * r.data.element_size()
                          for r in sess.leaves.values())
        with self._lock:
            self._sessions[uid] = sess
        self._to_host.inc(sess.nbytes)
        self._enforce_limit()
        self._transfer_s.record(time.perf_counter() - t0)
        self._update_gauges()
        return sess

    def _update_gauges(self) -> None:
        self.obs.gauge("kvstore/host_bytes").set(self.host_bytes)
        self.obs.gauge("kvstore/sessions").set(len(self))

    # -- resume ------------------------------------------------------------
    def _load(self, sess: ParkedSession) -> None:
        """Bring a session taken out of ``_sessions`` back to host memory
        from whichever tier holds it."""
        if sess.remote_name is not None:
            self._fetch_remote(sess)
        if sess.spill_path is not None:
            self._load_spill(sess)

    def _take(self, uid: int) -> Tuple[ParkedSession, str]:
        """Settle ``uid``, take its session out of the store (so no tier
        eviction touches it) and load it to host memory; on a failed load
        the session goes back, with whatever tier copy survives. Returns
        the session and the tier it was taken from."""
        self._wait_uid(uid)
        with self._lock:
            sess = self._sessions.pop(uid, None)
        if sess is None:
            raise KeyError(f"no parked session {uid}")
        tier = sess.tier
        try:
            self._load(sess)
        except BaseException:
            with self._lock:
                self._sessions[uid] = sess
            raise
        return sess, tier

    @torch.no_grad()
    def resume(self, uid: int, device=None):
        """Rebuild ``uid``'s lane bit for bit and remove it from the store.

        Returns tensors in the structure and dtypes ``write_slot`` checks
        against the pool, on the host, or on ``device`` (the engine passes
        its pool's): only the occupied rows of the pages cross to it, and
        the pages are re-expanded there. Waits for an in-flight park or
        prefetch of the same uid first, so async mode never races its own
        transfers.
        """
        dev = torch.device("cpu" if device is None else device)
        t0 = time.perf_counter()
        sess, tier = self._take(uid)
        full: Dict[Tuple, torch.Tensor] = {
            k: r.data.to(dev) for k, r in sess.leaves.items()
            if r.page_len_key is None}
        for key, rec in sess.leaves.items():
            if rec.page_len_key is None:
                continue
            out = torch.zeros(rec.shape, dtype=rec.dtype, device=dev)
            out[_occupied(full[rec.page_len_key], rec.shape[-2])] = \
                rec.data.to(dev)
            full[key] = out
        lane = tree_unflatten(sess.template, [full[k] for k in sess.order])
        dt = time.perf_counter() - t0
        self._resume_s.record(dt)
        self._resume_tier_s[tier].record(dt)
        self._resumes.inc()
        self._to_dev.inc(sess.nbytes)
        self._update_gauges()
        return lane

    def prefetch(self, uid: int) -> Optional[TransferHandle]:
        """Scheduler hint: warm a disk/remote session back to host in the
        background so the upcoming ``resume`` finds it resident. No-op
        for resident/in-flight/unknown uids."""
        with self._lock:
            if uid in self._inflight or uid in self._prefetching:
                return self._prefetching.get(uid)
            sess = self._sessions.get(uid)
            if sess is None or sess.resident:
                return None
            handle = TransferHandle(f"prefetch:{uid}")
            self._prefetching[uid] = handle
        try:
            self._get_worker().submit(lambda: self._bg_prefetch(uid),
                                      handle)
        except BaseException:
            with self._lock:
                self._prefetching.pop(uid, None)
            raise
        self._prefetches.inc()
        return handle

    def _bg_prefetch(self, uid: int) -> None:
        try:
            # no eviction reads the session's spill file or blob meanwhile
            with self._evict_lock:
                with self._lock:
                    sess = self._sessions.get(uid)
                if sess is not None and not sess.resident:
                    self._load(sess)
        finally:
            with self._lock:
                self._prefetching.pop(uid, None)

    # -- disk tier ---------------------------------------------------------
    def _enforce_limit(self) -> None:
        limit = self.config.host_bytes_limit
        if limit is None:
            return
        with self._evict_lock:
            with self._lock:
                resident = sorted(
                    (s for s in self._sessions.values() if s.resident),
                    key=lambda s: s.parked_at)
                total = sum(s.nbytes for s in resident)
            while total > limit and resident:
                victim = resident.pop(0)
                if not self._evict(victim):
                    break               # degraded: tolerate over-limit
                total -= victim.nbytes
            self._enforce_disk_limit()

    def _evict(self, sess: ParkedSession) -> bool:
        """Move one resident session down a tier. True iff it left the
        host tier; False means every lower tier refused (the session
        stays resident, never lost, and a degradation was recorded), or
        an error is raised when no tier exists at all."""
        if self.config.spill_dir is not None:
            self._spill(sess)
            return True
        if self.config.remote is not None:
            return self._push_remote(sess)
        raise RuntimeError(
            f"host tier over host_bytes_limit and no spill_dir or remote "
            f"transport configured (session {sess.uid} has nowhere to go)")

    def _enforce_disk_limit(self) -> None:
        limit = self.config.disk_bytes_limit
        if limit is None:
            return
        with self._lock:
            spilled = sorted(
                (s for s in self._sessions.values()
                 if s.spill_path is not None),
                key=lambda s: s.parked_at)
            total = sum(s.nbytes for s in spilled)
        while total > limit and spilled:
            victim = spilled.pop(0)
            if not self._push_remote(victim):
                break                   # degraded: stays on disk
            total -= victim.nbytes

    def _current(self, sess: ParkedSession) -> bool:
        """(under the lock) whether ``sess`` is still the store's record
        of its uid: a resume, export or drop takes it out first."""
        return self._sessions.get(sess.uid) is sess

    def _spill(self, sess: ParkedSession) -> None:
        """Disk tier: one checksummed blob file per session (the codec of
        the remote tier, remote/blob.py)."""
        path = os.path.join(self.config.spill_dir,
                            f"kv_session_{sess.uid}{SPILL_SUFFIX}")
        blob = encode_session(sess)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        with self._lock:
            current = self._current(sess) and sess.resident
            if current:
                for k in sess.order:
                    sess.leaves[k].data = None
                sess.spill_path = path
        if not current:                 # taken out meanwhile
            os.remove(path)
            return
        self._spills.inc()
        self._spilled_b.inc(sess.nbytes)

    def _load_spill(self, sess: ParkedSession) -> None:
        path = sess.spill_path
        with open(path, "rb") as f:
            data = f.read()
        decoded, _ = decode_session(data)   # CRC verified here
        if set(decoded.leaves) != set(sess.leaves):
            raise ValueError(f"spill file {path} does not match session "
                             f"{sess.uid}'s leaves")
        with self._lock:
            for k in sess.order:
                sess.leaves[k].data = decoded.leaves[k].data
            sess.spill_path = None
        os.remove(path)

    # -- remote tier -------------------------------------------------------
    def _degrade(self, sess: ParkedSession, err: Exception) -> None:
        self._degraded.inc()
        with self._lock:
            self._events.append({
                "kind": "kvstore_remote_degraded", "uid": sess.uid,
                "error": str(err)[:200],
                "kept_tier": "disk" if sess.spill_path else "host"})

    def _push_remote(self, sess: ParkedSession) -> bool:
        """Push one session to the remote tier. On failure (after the
        transport's own retries) the session keeps its current tier copy
        — the disk file is only deleted after a successful put, so a
        degraded push leaves the session exactly where it was, never
        lost. True iff pushed."""
        transport = self.config.remote
        if sess.spill_path is not None:
            # the spill file IS the blob format: forward its bytes as-is
            # (the CRC written at spill time travels to the peer intact)
            with open(sess.spill_path, "rb") as f:
                blob = f.read()
        else:
            blob = encode_session(sess)
        name = f"spill/{sess.uid}"
        try:
            transport.put(name, blob)
        except (TransportError, OSError) as e:
            self._degrade(sess, e)
            return False
        spill_path = None
        with self._lock:
            current = self._current(sess) and sess.remote_name is None
            if current:
                for k in sess.order:
                    sess.leaves[k].data = None
                sess.remote_name = name
                spill_path, sess.spill_path = sess.spill_path, None
        if not current:                 # taken out meanwhile
            try:
                transport.delete(name)
            except (TransportError, KeyError):
                pass
            return True
        if spill_path and os.path.exists(spill_path):
            os.remove(spill_path)
        self._remote_parks.inc()
        self._to_remote.inc(len(blob))
        return True

    def _fetch_remote(self, sess: ParkedSession) -> None:
        name = sess.remote_name
        blob = self.config.remote.get(name)
        decoded, _ = decode_session(blob)   # CRC verified here
        if set(decoded.leaves) != set(sess.leaves):
            raise ValueError(f"remote blob {name!r} does not match "
                             f"session {sess.uid}'s leaves")
        with self._lock:
            for k in sess.order:
                sess.leaves[k].data = decoded.leaves[k].data
            sess.remote_name = None
        try:
            self.config.remote.delete(name)
        except (TransportError, KeyError):
            pass                        # best-effort remote GC
        self._remote_resumes.inc()
        self._from_remote.inc(len(blob))

    # -- cross-process session movement (disaggregation rail) --------------
    def export(self, uid: int, *, name: Optional[str] = None,
               meta: Optional[dict] = None,
               transport: Optional[Transport] = None) -> str:
        """Serialize parked session ``uid`` (+ caller ``meta``) into one
        blob and put it on the transport; the local copy is removed —
        ownership moves to whoever imports the name. Returns the name.
        A failed put keeps the session here (resident)."""
        transport = transport if transport is not None else self.config.remote
        if transport is None:
            raise ValueError("export needs a transport "
                             "(StoreConfig.remote or transport=...)")
        sess, _ = self._take(uid)
        name = name if name is not None else f"session/{uid}"
        try:
            blob = encode_session(sess, meta=meta)
            transport.put(name, blob)
        except BaseException:
            with self._lock:
                self._sessions[uid] = sess
            raise
        self._exports.inc()
        self._to_remote.inc(len(blob))
        self._update_gauges()
        return name

    def import_remote(self, name: str, *,
                      transport: Optional[Transport] = None,
                      consume: bool = True) -> Tuple[int, dict]:
        """Fetch blob ``name``, verify it, and adopt the session into
        the host tier. Returns ``(uid, meta)``; ``consume`` deletes the
        blob after a successful import (ownership transferred)."""
        transport = transport if transport is not None else self.config.remote
        if transport is None:
            raise ValueError("import_remote needs a transport "
                             "(StoreConfig.remote or transport=...)")
        blob = transport.get(name)
        sess, meta = decode_session(blob)   # CRC verified here
        self._settle(sess.uid)
        with self._lock:
            if sess.uid in self._sessions or sess.uid in self._inflight:
                raise ValueError(
                    f"session {sess.uid} (blob {name!r}) is already "
                    f"parked here")
            self._failed.pop(sess.uid, None)
            sess.parked_at = time.perf_counter()
            self._sessions[sess.uid] = sess
        if consume:
            try:
                transport.delete(name)
            except (TransportError, KeyError):
                pass
        self._imports.inc()
        self._from_remote.inc(len(blob))
        self._enforce_limit()
        self._update_gauges()
        return sess.uid, meta

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Flat float map: the JAX store's keys, plus the resume latency
        per tier the session came from (``kvstore/resume_<tier>_p50_s``)."""
        with self._lock:
            inflight = float(len(self._inflight))
        out = {
            "kvstore/sessions": float(len(self)),
            "kvstore/inflight_parks": inflight,
            "kvstore/host_bytes": float(self.host_bytes),
            "kvstore/parks": self._parks.value,
            "kvstore/resumes": self._resumes.value,
            "kvstore/bytes_to_host": self._to_host.value,
            "kvstore/bytes_to_device": self._to_dev.value,
            "kvstore/spills": self._spills.value,
            "kvstore/bytes_spilled": self._spilled_b.value,
            "kvstore/bytes_to_remote": self._to_remote.value,
            "kvstore/bytes_from_remote": self._from_remote.value,
            "kvstore/remote_parks": self._remote_parks.value,
            "kvstore/remote_resumes": self._remote_resumes.value,
            "kvstore/exports": self._exports.value,
            "kvstore/imports": self._imports.value,
            "kvstore/remote_degraded": self._degraded.value,
            "kvstore/prefetches": self._prefetches.value,
        }
        hists = [("park", self._park_s), ("resume", self._resume_s),
                 ("park_transfer", self._transfer_s)]
        hists += [(f"resume_{t}", h) for t, h in self._resume_tier_s.items()]
        for name, h in hists:
            if h.count:
                out[f"kvstore/{name}_p50_s"] = h.percentile(50)
                out[f"kvstore/{name}_p99_s"] = h.percentile(99)
        remote = self.config.remote
        if remote is not None and hasattr(remote, "stats"):
            out.update(remote.stats())
        return out
