"""Continuous-batching inference engine over the slot-pooled cache (port of
the JAX package's ``serve/engine/engine.py``).

Request lifecycle::

    WAITING --admit (free slot + token budget)--> PREFILL
    PREFILL --first token sampled, lane written--> DECODE
    PREFILL --preempted mid-stages (chunked)----> PARKED (partial dropped,
                                                  request requeued)
    DECODE  --eos_id / max_new_tokens----------->  FINISHED (lane reset,
                                                   slot returned to pool)
    DECODE  --park (preempted / time-sliced / handle.park())--> PARKED
    PARKED  --readmitted, lane streamed back----> DECODE (any free slot)
    PARKED  --export_session (disaggregation)---> EXPORTED (lane + request
                                                  state shipped through a
                                                  transport blob; a peer
                                                  engine's import_session
                                                  continues the decode
                                                  bit for bit)

Each engine ``step()``:

  1. admit: pop admittable requests (priority-then-FCFS, see the PRIORITY_*
     classes in scheduler.py) and place each into a free lane: fresh
     requests prefill (one B=1 prefill per request at its exact prompt
     length), parked requests stream their saved lane back from the KV
     store. When slots are full, admission parks the lowest-priority
     active session (preferring a mid-prefill job, which has produced
     nothing yet and just requeues), or time-slices the oldest one, to the
     KV store instead of blocking. The first output token of a fresh
     request is sampled from the prefill logits; with a PrefixCache
     attached, an exact prompt match skips the model call entirely.
  2. chunked prefill (``chunked_prefill=N``): admission only runs the
     embed stage and enqueues a _PrefillJob; each step then advances at
     most N depth stages (serving.make_prefill_stages, one layer group per
     stage) across the outstanding jobs, oldest first, so a long prompt's
     prefill interleaves with step 3. With ``chunked_prefill=None`` the
     prefill completes at admission.
  3. decode: ONE ``serve_step`` over ALL pool slots with a per-slot active
     mask (free lanes are exact no-ops), then per-slot sampling.
  4. retire: finished requests free their lane (``reset_slot``) so the next
     admission reuses it without reallocation.

On the card, every prefill (or its chunked stages) runs the local-window
and the fused routing kernels and every decode step the paged decode
kernel; ``impl="torch"`` runs the plain PyTorch path instead.

Parity. Every lane is computed independently and sampling keys are
counter-based per request, so at a fixed pool size a request's outputs are
bit-identical whichever slot it occupies, whoever its co-tenants are, how
many park/resume round trips it took, whether its prefill was chunked and
whether its prompt was an exact prefix hit. The JAX engine also promises
bit-identity with a solo B=1 decode; torch cannot: its matrix products take
another path at one row, so a row of a B=1 decode differs from the same
row of a pool decode in the last bits.

Parked sessions live in the tiered KV store (`repro_torch.serve.kvstore`):
the engine's own store runs its transfers on a background thread, so a
park does not wait for the card. A prefill pool (``prefill_only=True``)
hands its sessions to a decode pool through ``export_session`` /
``import_session``; at the same pool size the decode pool's tokens and
logits equal a monolithic engine's bit for bit.

Observability. ``routing_stats=True`` turns on ``RoutingConfig.stats``
for the prefills: each prefill (monolithic, or the chunked stages of a
job) reports its ``routing/*`` means. ``obs_jsonl`` appends schema-v1
records (`repro_torch.obs`, source ``engine``): ``engine_prefill`` per
prefill with stats on, ``engine_tick`` per step (queue state, the KV
store's and the prefix cache's stats and, on active lanes, the cluster
pages' health read off the ``rlen`` leaves alone, with drift 0.0 and the
last prefill's recall), the store's tier events as records of their own
kind, ``kvstore_park``, ``kvstore_resume``, ``session_export``,
``session_import``, and ``engine_summary`` at ``close()``. Tier events are
also counted by kind (``kvstore_events``) on every step. With no sink and
stats off a step reads nothing back from the card that it did not read
before. Partial prefix reuse is off (ROADMAP.md item 8): see
``_prefill_into``.

On a (data, model) mesh (``mesh=``, a `launch.mesh.Mesh`: one process per
rank, every rank building its engine with the same arguments and stepping
it through the same calls) the engine serves as the JAX package's engine
does on its mesh, slots over the data axis and heads over "model". The
engine takes the whole params and keeps its rank's shards
(`dist.sharding.shard_params`); the k-means centroids stay whole on every
rank (each layer reads its heads' rows), as the JAX engine keeps them
replicated. Each rank's pool holds its heads of ``max_slots / D`` lanes
(`pool.init_pool`), and its prefills and decode steps run the kernels on
its ``Hl / M`` local and ``Hr / M`` routing heads as single-device calls
(`serving`'s mesh paths). The scheduler runs identically on every rank:
every data rank runs each prefill (the slot's owner keeps the lane), each
decodes its own lanes, and the sampled tokens (with ``record_logits``,
the logits rows too) are all-gathered over "data" once per step; the
logits reach the sampler whole on every model rank, so the ranks' tokens
are equal to the bit. A park hands the owner's lane to every data rank,
so parks, resumes and prefix hits keep each rank's shard in its own KV
store and prefix cache. ``export_session`` gathers the shards into the
JAX package's blob (written by rank 0), which any mesh or package
imports; ``import_session`` cuts a blob for the mesh it lands on. The
JSONL records are written by rank 0 only (pass ``obs_jsonl`` on every
rank: the page health is gathered over the heads and the slots), and the
routing stats are the whole model's.
"""
from __future__ import annotations

import functools
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import attn as attn_api
from repro_torch import prng, resolve_device
from repro_torch.configs.base import ModelConfig, with_overrides
from repro_torch.dist import compression as comp
from repro_torch.dist import sharding as shd
from repro_torch.dist.tensor_parallel import gather_head_stats
from repro_torch.obs import JsonlSink, pages_health
from repro_torch.obs import routing_stats as obs_rt
from repro_torch.obs.trace import span
from repro_torch.serve.engine.metrics import EngineMetrics
from repro_torch.serve.engine.pool import (init_pool, read_slot, reset_slot,
                                           write_slot)
from repro_torch.serve.engine.sampling import (SamplingParams,
                                               request_base_key, request_key,
                                               sample_tokens)
from repro_torch.serve.engine.scheduler import FCFSScheduler
from repro_torch.serve.kvstore import KVStore, PrefixCache, StoreConfig
from repro_torch.serve.kvstore.remote import TransportError
from repro_torch.serve.serving import (assemble_prefill_cache,
                                       decode_backends, init_cache,
                                       make_prefill_stages, make_serve_step,
                                       prefill, slice_cache_groups)
from repro_torch.tree import tree_paths, tree_reorder, tree_unflatten

WAITING, PREFILL, DECODE, FINISHED = "WAITING", "PREFILL", "DECODE", "FINISHED"
PARKED, CANCELLED, EXPORTED = "PARKED", "CANCELLED", "EXPORTED"


def _fit_lane(lane, like):
    """A resumed lane fitted to the pool's lane ``like``: dicts in the
    pool's key order (a JAX-written blob keeps the JAX package's sorted
    order) and cluster pages stored narrower than the pool's padded with
    zero columns (the JAX package stores a page row at the head dim, the
    port at the decode kernel's width, whose pad columns are zero). Any
    other difference is left for ``write_slot`` to report."""
    lane = tree_reorder(lane, like)
    pageable = attn_api.pageable_cache_leaves()
    ref = dict(tree_paths(like))

    def fit(path, v):
        r = ref.get(path)
        if (path[-1] in pageable and r is not None and v.dim() == r.dim()
                and v.shape[:-1] == r.shape[:-1]
                and v.shape[-1] < r.shape[-1]):
            return torch.nn.functional.pad(v, (0, r.shape[-1] - v.shape[-1]))
        return v

    return tree_unflatten(lane, [fit(p, v) for p, v in tree_paths(lane)])


def _barrier() -> None:
    """Wait for every process (a mesh of one process has none to wait
    for)."""
    if comp.world_size() > 1:
        dist.barrier()


@dataclass
class Request:
    uid: int
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    arrival_step: int = 0       # engine step at which the request shows up
    priority: int = 0           # higher admits first and preempts lower
    state: str = WAITING
    output: List[int] = field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


class SessionHandle:
    """What ``Engine.submit`` returns: uid + state + park/resume/cancel.

    ``int(handle)`` is the uid, so uid-keyed code (metrics, output maps,
    PRNG streams) takes a handle as it is.
    """

    def __init__(self, engine: "InferenceEngine", request: Request):
        self._engine = engine
        self._request = request

    @property
    def uid(self) -> int:
        return self._request.uid

    def __int__(self) -> int:
        return self._request.uid

    __index__ = __int__

    @property
    def state(self) -> str:
        return {WAITING: "queued", PREFILL: "active", DECODE: "active",
                PARKED: "parked", FINISHED: "finished",
                CANCELLED: "cancelled", EXPORTED: "exported"}[
                    self._request.state]

    @property
    def output(self) -> List[int]:
        return list(self._request.output)

    def park(self) -> None:
        """Evict this session's lane to the KV store and hold it (it will
        not be rescheduled until ``resume()``)."""
        self._engine.park_session(self.uid)

    def resume(self) -> None:
        """Requeue a held (parked) session for readmission."""
        self._engine.resume_session(self.uid)

    def cancel(self) -> None:
        self._engine.cancel_session(self.uid)

    def __repr__(self) -> str:
        return f"SessionHandle(uid={self.uid}, state={self.state!r})"


@dataclass
class _Slot:
    request: Request
    pos: int                    # next decode position (= tokens in context)
    last_token: int
    base_key: torch.Tensor      # request_base_key (2,), on the host
    admit_seq: int = 0          # monotonic placement order (rotation age)
    tokens_at_admit: int = 0    # len(output) when (re)placed: time-slice


@dataclass
class _PrefillJob:
    """A mid-flight chunked prefill occupying a pool slot: activations
    after the last finished depth stage plus the cache chunks those stages
    produced. Parking or preempting a job drops the partial work and
    requeues the request: it has produced no tokens yet, so the cheap exit
    is to redo the prefill on readmission."""
    request: Request
    x: torch.Tensor             # (1, N, d) activations entering stage_idx
    positions: torch.Tensor
    chunks: List = field(default_factory=list)   # per-stage cache chunks
    stats: List = field(default_factory=list)    # per-stage routing stats
    stage_idx: int = 0
    admit_seq: int = 0
    t0: float = 0.0             # wall clock at admission (TTFT accounting)


@dataclass
class _ParkedMeta:
    """Host-side decode state of a parked session (the lane itself lives
    in the KV store). ``pos is None`` marks a session parked before
    prefill: resuming it is a plain (re)prefill."""
    request: Request
    pos: Optional[int] = None
    last_token: int = 0
    base_key: Optional[torch.Tensor] = None
    held: bool = False          # user-parked: stays out until resume()


class InferenceEngine:
    """Admits, schedules, decodes, and retires requests independently.

    ``params`` and ``kstate`` live on ``device`` (default the card; raises
    without one unless ``device="cpu"``); ``impl`` forces an attention
    backend for the prefills and decode steps, as in ``serving``. On a
    ``mesh`` (the module's docstring) ``params`` are the whole model's;
    a model axis that does not divide a layer's local or routing head
    count raises `attn.head_shard`'s `ValueError`, and ``max_slots`` must
    divide over the data ranks.
    """

    def __init__(self, cfg: ModelConfig, params, kstate, *, max_slots: int,
                 max_len: int, token_budget: Optional[int] = None,
                 record_logits: bool = False, mesh=None,
                 obs_jsonl: Optional[str] = None,
                 routing_stats: bool = False,
                 kvstore: Optional[KVStore] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 time_slice: Optional[int] = None,
                 chunked_prefill: Optional[int] = None,
                 prefill_only: bool = False, impl: Optional[str] = None,
                 device="cuda"):
        if chunked_prefill is not None and chunked_prefill < 1:
            raise ValueError("chunked_prefill must be >= 1 stage per step")
        if routing_stats:
            # the prefills compute the routing-health stats; decode-side
            # health comes from the cluster pages' occupancy
            cfg = with_overrides(
                cfg, routing=with_overrides(cfg.routing, stats=True))
        self.routing_stats = routing_stats
        self.device = resolve_device(device)
        # every prefill and decode step resolves its attention backends
        # (and with them the pool's cache layout) from the registry; the
        # resolution is recorded here for observability (on a mesh, a
        # rank's head shard's, which raises where it does not divide)
        self.attn_backends = decode_backends(cfg, impl=impl,
                                             platform=self.device.type,
                                             mesh=mesh)
        self.mesh = mesh
        # this rank's pool lanes: global slots lane0 .. lane0 + lanes - 1
        # (init_pool raises where max_slots does not divide over the data
        # ranks)
        self._lanes, self._lane0 = shd.slot_block(mesh, max_slots)
        # on a mesh the JSONL records come from rank 0; every rank takes
        # part in the page health's gather
        self._obs = bool(obs_jsonl)
        self._sink = (JsonlSink(obs_jsonl, source="engine")
                      if obs_jsonl and (mesh is None or comp.rank() == 0)
                      else None)
        self._last_routing: Dict[str, float] = {}
        self.cfg = cfg
        self.params = (params if mesh is None
                       else shd.shard_params(params, cfg, mesh))
        self.kstate = kstate
        self.max_slots = max_slots
        self.max_len = max_len
        self._serve_step = make_serve_step(cfg, impl=impl, mesh=mesh)
        self._prefill = functools.partial(prefill, cfg=cfg, impl=impl,
                                          return_stats=routing_stats,
                                          mesh=mesh)
        self.pool = init_pool(cfg, max_slots, max_len, device=self.device,
                              mesh=mesh)
        # a prefill clones the cache it fills, so one fresh B=1 lane serves
        # every admission
        self._fresh_lane = init_cache(cfg, 1, max_len, device=self.device,
                                      mesh=mesh)
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.scheduler = FCFSScheduler(token_budget)
        self.metrics = EngineMetrics()
        self.step_count = 0
        self.record_logits = record_logits
        self.logits_trace: Dict[int, List[np.ndarray]] = {}
        # the tiered KV store, where parked sessions live (host tier by
        # default; StoreConfig adds disk spill and a remote transport). The
        # engine-owned default runs async transfers so the admission path
        # never waits for a copy off the card; a caller-provided store
        # keeps whatever mode the caller chose.
        self._owns_kvstore = kvstore is None
        self.kvstore = (kvstore if kvstore is not None
                        else KVStore(StoreConfig(async_transfers=True)))
        # the store's tier events (e.g. kvstore_remote_degraded), drained
        # every step and counted by kind
        self.kvstore_events: Counter = Counter()
        self.prefix_cache = prefix_cache
        # prefill_only: sessions park (held) right after their first token
        # instead of decoding
        self.prefill_only = prefill_only
        # time_slice: decode steps a session may hold a slot while others
        # wait; None = run to completion (park only on priority preemption
        # or an explicit handle.park())
        self.time_slice = time_slice
        self._parked: Dict[int, _ParkedMeta] = {}
        self._admit_seq = 0
        self._rotated_this_step = False
        # chunked_prefill: max depth stages advanced per step() across the
        # outstanding prefill jobs; None = prefill at admission
        self.chunked_prefill = chunked_prefill
        self._prefill_jobs: Dict[int, _PrefillJob] = {}
        if chunked_prefill is not None:
            embed, stages, head = make_prefill_stages(cfg, impl=impl,
                                                      groups_per_stage=1,
                                                      mesh=mesh)
            self._pf_embed = embed
            self._pf_head = head
            self._pf_stages = [(st, st.fn) for st in stages]
            # per-stage slices of the fresh B=1 lane: stages never write
            # their cache argument, so these serve every job
            self._pf_fresh = [
                slice_cache_groups(self._fresh_lane[st.si], st.g0, st.g1)
                for st in stages]

    # -- request intake ----------------------------------------------------
    def submit(self, request: Request) -> SessionHandle:
        if request.prompt_len < 1 or request.max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens>=1")
        reserved = request.prompt_len + request.max_new_tokens
        if reserved > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt+max_new {reserved} exceeds "
                f"pool max_len {self.max_len}")
        budget = self.scheduler.token_budget
        if budget is not None and reserved > budget:
            # would never be admittable; with FCFS head-of-line blocking it
            # would also starve everything queued behind it
            raise ValueError(
                f"request {request.uid}: reserved tokens {reserved} exceed "
                f"the scheduler token budget {budget}")
        if request.output:
            raise ValueError(
                f"request {request.uid} already has output; submit a fresh "
                f"Request (e.g. dataclasses.replace(r, output=[]))")
        if (self.scheduler.has_uid(request.uid)
                or request.uid in self._parked
                or any(j.request.uid == request.uid
                       for j in self._prefill_jobs.values())
                or any(s is not None and s.request.uid == request.uid
                       for s in self.slots)):
            raise ValueError(
                f"request uid {request.uid} is already queued, parked, or "
                f"active; uids key outputs, metrics, and PRNG streams")
        request.state = WAITING
        self.scheduler.submit(request)
        self.metrics.on_submit(request.uid, request.prompt_len,
                               self.step_count)
        return SessionHandle(self, request)

    # -- slot accounting ---------------------------------------------------
    def free_slot_ids(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is None and i not in self._prefill_jobs]

    def tokens_in_flight(self) -> int:
        return (sum(FCFSScheduler.reserved_tokens(s.request)
                    for s in self.slots if s is not None)
                + sum(FCFSScheduler.reserved_tokens(j.request)
                      for j in self._prefill_jobs.values()))

    # -- sampling ----------------------------------------------------------
    def _sample_first(self, req: Request, logits_row) -> int:
        sp = req.sampling
        dev = self.device
        tok = sample_tokens(
            request_key(sp, req.uid, 0, dev)[None], logits_row.float(),
            torch.tensor([sp.temperature], dtype=torch.float32, device=dev),
            torch.tensor([sp.top_k], dtype=torch.int32, device=dev),
            torch.tensor([sp.top_p], dtype=torch.float32, device=dev))
        return int(tok[0])

    # -- park / resume -----------------------------------------------------
    def _tokens_since_admit(self, s: _Slot) -> int:
        return len(s.request.output) - s.tokens_at_admit

    def _park_slot(self, slot: int, *, held: bool) -> None:
        """Evict ``slot``'s session: lane to the KV store, slot freed.

        ``held=False`` requeues the session immediately (preemption /
        rotation); ``held=True`` keeps it out until ``resume_session``.
        """
        s = self.slots[slot]
        uid = s.request.uid
        t0 = time.perf_counter()
        with span("engine/park"):
            ps = self.kvstore.park(uid, read_slot(self.pool, slot,
                                                  self.mesh))
            reset_slot(self.pool, slot, self.mesh)
        dt = time.perf_counter() - t0
        s.request.state = PARKED
        self._parked[uid] = _ParkedMeta(s.request, pos=s.pos,
                                        last_token=s.last_token,
                                        base_key=s.base_key, held=held)
        self.slots[slot] = None
        self.metrics.on_park(uid, self.step_count)
        if not held:
            self.scheduler.submit(s.request)
        if self._sink is not None:
            # an async park's bytes read 0 until its host copy lands
            self._sink.emit("kvstore_park", step=self.step_count, uid=uid,
                            metrics={"park_s": dt,
                                     "bytes": float(ps.nbytes),
                                     "tokens": float(s.pos)})

    def _resume_into(self, slot: int, req: Request) -> None:
        """Stream a parked session's lane back into ``slot`` (bit-exact
        with a never-evicted run: the lane round-trips byte-identical and
        sampling keys are counter-based per uid, not per slot)."""
        meta = self._parked.pop(req.uid)
        t0 = time.perf_counter()
        with span("engine/resume"):
            lane = _fit_lane(self.kvstore.resume(req.uid, device=self.device),
                             self._fresh_lane)
            write_slot(self.pool, slot, lane, self.mesh)
        dt = time.perf_counter() - t0
        req.state = DECODE
        self.slots[slot] = _Slot(
            req, pos=meta.pos, last_token=meta.last_token,
            base_key=meta.base_key, admit_seq=self._admit_seq,
            tokens_at_admit=len(req.output))
        self._admit_seq += 1
        self.metrics.on_resume(req.uid, slot, self.step_count)
        if self._sink is not None:
            self._sink.emit("kvstore_resume", step=self.step_count,
                            uid=req.uid,
                            metrics={"resume_s": dt, "slot": float(slot),
                                     "tokens": float(meta.pos)})

    def _maybe_park_for(self, head: Request) -> bool:
        """Try to free capacity for the queue head by parking one active
        session; True iff a park happened that makes ``head`` admittable."""
        active = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if not active and not self._prefill_jobs:
            return False
        need = FCFSScheduler.reserved_tokens(head)
        budget = self.scheduler.token_budget
        free_now = len(self.free_slot_ids())

        def admits_after(victim_req: Request) -> bool:
            tif = (self.tokens_in_flight()
                   - FCFSScheduler.reserved_tokens(victim_req))
            return budget is None or tif + need <= budget

        # 1. priority preemption: the lowest-priority session strictly
        # below the head's priority gives up its slot. Mid-prefill jobs
        # are the preferred victims: they have produced nothing yet, so
        # dropping one costs a re-prefill instead of a lane round trip
        # through the KV store.
        lower_jobs = [(j.request.priority, j.admit_seq, slot, j)
                      for slot, j in self._prefill_jobs.items()
                      if j.request.priority < head.priority]
        if lower_jobs:
            _, _, slot, j = min(lower_jobs, key=lambda t: t[:3])
            if admits_after(j.request):
                self._drop_prefill_job(slot, held=False)
                return True
        lower = [(s.request.priority, s.admit_seq, i, s)
                 for i, s in active if s.request.priority < head.priority]
        if lower:
            _, _, i, s = min(lower, key=lambda t: t[:3])
            if admits_after(s.request):
                self._park_slot(i, held=False)
                return True
        # 2. time-slice rotation: with every slot busy and peers (at the
        # head's priority or below) waiting, the longest-admitted session
        # that has used up its slice rotates out, at most once per step,
        # so a solo session never thrashes
        if (self.time_slice is not None and free_now == 0
                and not self._rotated_this_step):
            eligible = [(s.admit_seq, i, s) for i, s in active
                        if (self._tokens_since_admit(s) >= self.time_slice
                            and s.request.priority <= head.priority)]
            if eligible:
                _, i, s = min(eligible, key=lambda t: t[:2])
                if admits_after(s.request):
                    self._rotated_this_step = True
                    self._park_slot(i, held=False)
                    return True
        return False

    def park_session(self, uid: int) -> None:
        """Explicitly park a session (handle.park()): active sessions
        evict their lane and are *held*; queued sessions are pulled from
        the queue and held without a lane."""
        for i, s in enumerate(self.slots):
            if s is not None and s.request.uid == uid:
                self._park_slot(i, held=True)
                return
        for slot, job in list(self._prefill_jobs.items()):
            if job.request.uid == uid:
                # mid-prefill: nothing to evict; drop the partial stages
                # and hold the request, resume() re-prefills from scratch
                self._drop_prefill_job(slot, held=True)
                return
        req = self.scheduler.remove(uid)
        if req is not None:
            req.state = PARKED
            self._parked[uid] = _ParkedMeta(req, held=True)
            return
        if uid in self._parked:
            self._parked[uid].held = True
            return
        raise ValueError(f"session {uid} is not active or queued")

    def resume_session(self, uid: int) -> None:
        """Requeue a held session for readmission (its lane streams back
        on placement)."""
        meta = self._parked.get(uid)
        if meta is None:
            raise ValueError(f"session {uid} is not parked")
        if meta.held:
            meta.held = False
            self.scheduler.submit(meta.request)
        if meta.pos is not None:
            self.kvstore.prefetch(uid)

    # -- disaggregation rail (prefill pool -> decode pool) -----------------
    def export_session(self, uid: int, *, name: Optional[str] = None,
                       transport=None) -> str:
        """Ship a parked (post-prefill) session to another engine through
        a transport blob: the lane plus the request/decode state rides in
        one checksummed blob. The session leaves this engine (state
        EXPORTED); ownership transfers to whoever ``import_session``s the
        returned name."""
        meta = self._parked.get(uid)
        if meta is None or meta.pos is None:
            raise ValueError(
                f"session {uid} is not parked with a prefilled lane "
                f"(park it after prefill before exporting)")
        sp = meta.request.sampling
        m = {
            "uid": uid,
            "prompt": [int(t) for t in meta.request.prompt],
            "output": [int(t) for t in meta.request.output],
            "max_new_tokens": meta.request.max_new_tokens,
            "eos_id": meta.request.eos_id,
            "priority": meta.request.priority,
            "sampling": {"temperature": sp.temperature, "top_k": sp.top_k,
                         "top_p": sp.top_p, "seed": sp.seed},
            "pos": meta.pos,
            "last_token": meta.last_token,
            # the JAX package's form: a uint32 key as a list of ints
            "base_key": {"data": [int(k) for k in meta.base_key.tolist()],
                         "dtype": "uint32"},
        }
        if self.mesh is None:
            name = self.kvstore.export(uid, name=name, meta=m,
                                       transport=transport)
        else:
            name = self._export_gathered(uid, name, m, transport)
        self._parked.pop(uid)
        if self.scheduler.has_uid(uid):     # unheld: queued to resume
            self.scheduler.remove(uid)
        meta.request.state = EXPORTED
        if self._sink is not None:
            self._sink.emit("session_export", step=self.step_count,
                            uid=uid, name=name,
                            metrics={"tokens": float(meta.pos)})
        return name

    def _export_gathered(self, uid: int, name: Optional[str], meta: dict,
                         transport) -> str:
        """``export_session`` on a mesh: every rank takes its shard of the
        lane out of its store, the shards are gathered into the whole
        lane, and rank 0 writes the blob a one-device engine would write
        (the JAX package's format)."""
        transport = (transport if transport is not None
                     else self.kvstore.config.remote)
        if transport is None:               # on every rank, before any wait
            raise ValueError("export needs a transport "
                             "(StoreConfig.remote or transport=...)")
        shard = self.kvstore.resume(uid, device=self.device)
        lane = shd.gather_cache(shard, self.mesh, 1)
        name = name if name is not None else f"session/{uid}"
        err = None
        if comp.rank() == 0:
            one = KVStore()
            try:
                one.park(uid, lane)
                one.export(uid, name=name, meta=meta, transport=transport)
            except Exception as e:          # told to every rank below
                err = e
            finally:
                one.close()
        # rank 0's outcome on every rank: a failed write leaves the
        # session parked everywhere and raises on every rank together
        failed = bool(comp.broadcast_from(torch.tensor(
            [int(err is not None)], dtype=torch.int32, device=self.device),
            0))
        if failed:
            self.kvstore.park(uid, shard)
            if err is not None:
                raise err
            raise RuntimeError(f"session {uid}: rank 0 failed to export "
                               f"it to {name!r}")
        return name

    def _import_cut(self, name: str, transport) -> Tuple[int, dict]:
        """``import_session``'s store import on a mesh: every rank reads the
        blob, keeps its part of the lane (`dist.sharding.shard_cache`) in
        its store, and rank 0 deletes the blob once all have read it."""
        transport = (transport if transport is not None
                     else self.kvstore.config.remote)
        uid, m = self.kvstore.import_remote(name, transport=transport,
                                            consume=False)
        lane = self.kvstore.resume(uid, device=self.device)
        self.kvstore.park(uid, shd.shard_cache(lane, self.mesh, 1))
        _barrier()
        if comp.rank() == 0:
            try:
                transport.delete(name)
            except (TransportError, KeyError):
                pass                        # best-effort, as import_remote
        return uid, m

    def import_session(self, name: str, *, transport=None) -> SessionHandle:
        """Adopt a session another engine (this package's or the JAX
        package's) exported: the lane goes into this engine's KV store,
        the request/decode state is rebuilt from the blob meta, and the
        session queues for readmission. Decode continues bit for bit
        where the exporter stopped (counter-based sampling keys make the
        continuation engine-independent)."""
        uid, m = (self.kvstore.import_remote(name, transport=transport)
                  if self.mesh is None else self._import_cut(name, transport))
        if (self.scheduler.has_uid(uid) or uid in self._parked
                or any(j.request.uid == uid
                       for j in self._prefill_jobs.values())
                or any(s is not None and s.request.uid == uid
                       for s in self.slots)):
            self.kvstore.drop(uid)
            raise ValueError(f"imported session uid {uid} collides with a "
                             f"live session here")
        req = Request(uid=uid, prompt=m["prompt"],
                      max_new_tokens=m["max_new_tokens"],
                      eos_id=m["eos_id"],
                      sampling=SamplingParams(**m["sampling"]),
                      priority=m["priority"], state=PARKED,
                      output=list(m["output"]))
        base_key = torch.tensor(m["base_key"]["data"], dtype=torch.int64)
        self._parked[uid] = _ParkedMeta(req, pos=m["pos"],
                                        last_token=m["last_token"],
                                        base_key=base_key, held=False)
        self.scheduler.submit(req)
        self.metrics.on_submit(uid, req.prompt_len, self.step_count)
        if self._sink is not None:
            self._sink.emit("session_import", step=self.step_count,
                            uid=uid, name=name,
                            metrics={"tokens": float(m["pos"])})
        return SessionHandle(self, req)

    def cancel_session(self, uid: int) -> None:
        """Drop a session wherever it is (queue, slot, or KV store)."""
        req = self.scheduler.remove(uid)
        if req is not None and uid not in self._parked:
            req.state = CANCELLED
            return
        meta = self._parked.pop(uid, None)
        if meta is not None:
            if uid in self.kvstore:
                self.kvstore.drop(uid)
            meta.request.state = CANCELLED
            return
        for i, s in enumerate(self.slots):
            if s is not None and s.request.uid == uid:
                reset_slot(self.pool, i, self.mesh)
                self.slots[i] = None
                s.request.state = CANCELLED
                return
        for slot, job in list(self._prefill_jobs.items()):
            if job.request.uid == uid:
                self._prefill_jobs.pop(slot)       # no lane written yet
                job.request.state = CANCELLED
                return
        raise ValueError(f"session {uid} is not queued, parked, or active")

    # -- lifecycle steps ---------------------------------------------------
    def _admit_and_prefill(self) -> None:
        while True:
            head = self.scheduler.peek()
            if head is None:
                return
            free = self.free_slot_ids()
            if not self.scheduler.admittable(head, len(free),
                                             self.tokens_in_flight()):
                if head.uid in self._parked:
                    self.kvstore.prefetch(head.uid)
                if not self._maybe_park_for(head):
                    return
                free = self.free_slot_ids()
            req = self.scheduler.next_admittable(len(free),
                                                self.tokens_in_flight())
            if req is None:
                return
            self._place(free[0], req)

    def _place(self, slot: int, req: Request) -> None:
        meta = self._parked.get(req.uid)
        if meta is not None and meta.pos is not None:
            self._resume_into(slot, req)
        else:
            self._parked.pop(req.uid, None)     # held-before-prefill
            self._prefill_into(slot, req)

    def _prefill_into(self, slot: int, req: Request) -> None:
        t0 = time.perf_counter()
        req.state = PREFILL
        # exact hits only. A partial hit would teacher-force the prompt's
        # tail through B=1 decode steps, whose rows torch computes on
        # another matrix path than a prefill's (and, for cluster pages,
        # with argmax instead of balanced top-k membership), so its lane
        # would not be a miss's bit for bit (ROADMAP.md item 8)
        hit = (self.prefix_cache.get(req.prompt)
               if self.prefix_cache is not None else None)
        if hit is not None:
            # the shared host lane + stored logits row stand in for the
            # model call; write_slot copies the lane into the pool
            self._activate(slot, req, hit.lane_as(self._fresh_lane),
                           torch.tensor(hit.last_logits, device=self.device),
                           t0)
            return
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None, :]
        if self.chunked_prefill is not None:
            # enqueue a depth-staged job holding this slot; its stages run
            # in _advance_prefill_jobs, interleaved with decode steps
            with torch.no_grad():
                x, positions = self._pf_embed(self.params, {"tokens": toks})
            self._prefill_jobs[slot] = _PrefillJob(
                req, x, positions, admit_seq=self._admit_seq, t0=t0)
            self._admit_seq += 1
            return
        with span("engine/prefill"):
            logits, lane, *stats = self._prefill(
                self.params, self.kstate, self._fresh_lane, {"tokens": toks})
        last_logits = logits[:, -1]
        if stats:
            self._emit_prefill_stats(req, stats[0])
        if self.prefix_cache is not None:
            self.prefix_cache.put(req.prompt, lane, last_logits)
        self._activate(slot, req, lane, last_logits, t0)

    def _emit_prefill_stats(self, req: Request, stats_tree) -> None:
        """Fold a prefill's stats into the ``routing/*`` means (one host
        read), kept for the ticks' recall and, with a sink, written as an
        ``engine_prefill`` record."""
        summ = obs_rt.summarize(stats_tree)
        if not summ:
            return
        host = torch.stack(list(summ.values())).cpu().tolist()
        self._last_routing = dict(zip(summ, host))
        if self._sink is not None:
            self._sink.emit("engine_prefill", metrics=self._last_routing,
                            step=self.step_count, uid=req.uid,
                            prompt_len=req.prompt_len)

    def _activate(self, slot: int, req: Request, lane, last_logits,
                  t0: float) -> None:
        """Write a prefilled lane into ``slot`` and sample the first token:
        the shared tail of monolithic, chunked, and prefix-hit prefill.
        ``t0`` is the admission wall clock (for a chunked job the measured
        prefill time includes the decode steps it interleaved with)."""
        write_slot(self.pool, slot, lane, self.mesh)
        tok = self._sample_first(req, last_logits)
        dt = time.perf_counter() - t0
        req.state = DECODE
        req.output.append(tok)
        if self.record_logits:
            self.logits_trace.setdefault(req.uid, []).append(
                last_logits[0].float().cpu().numpy())
        self.metrics.on_prefill(req.uid, slot, self.step_count,
                                req.prompt_len, dt)
        self.metrics.on_token(req.uid)
        self.slots[slot] = _Slot(
            req, pos=req.prompt_len, last_token=tok,
            base_key=request_base_key(req.sampling, req.uid),
            admit_seq=self._admit_seq, tokens_at_admit=0)
        self._admit_seq += 1
        if self._is_finished(req, tok):
            self._retire(slot)
        elif self.prefill_only:
            self._park_slot(slot, held=True)

    # -- chunked prefill ---------------------------------------------------
    def _advance_prefill_jobs(self) -> None:
        """Advance at most ``chunked_prefill`` depth stages across the
        outstanding jobs, oldest job first; a job whose last stage
        completes activates its lane immediately, so it joins this very
        step's decode."""
        budget = self.chunked_prefill
        for slot in sorted(self._prefill_jobs,
                           key=lambda s: self._prefill_jobs[s].admit_seq):
            if budget <= 0:
                return
            job = self._prefill_jobs[slot]
            while budget > 0 and job.stage_idx < len(self._pf_stages):
                _, fn = self._pf_stages[job.stage_idx]
                with span("engine/prefill_stage"):
                    job.x, nc, st_g = fn(self.params, self.kstate,
                                         self._pf_fresh[job.stage_idx],
                                         job.x, job.positions, {})
                job.chunks.append(nc)
                job.stats.append(st_g)
                job.stage_idx += 1
                budget -= 1
            if job.stage_idx == len(self._pf_stages):
                self._finish_prefill_job(slot)

    def _finish_prefill_job(self, slot: int) -> None:
        job = self._prefill_jobs.pop(slot)
        req = job.request
        lane = assemble_prefill_cache([st for st, _ in self._pf_stages],
                                      job.chunks)
        last_logits = self._pf_head(self.params, job.x)[:, -1]
        if self.routing_stats:
            # the stages' stats are this rank's heads' (a monolithic
            # prefill returns the whole model's)
            self._emit_prefill_stats(req, gather_head_stats(job.stats,
                                                            self.mesh))
        if self.prefix_cache is not None:
            self.prefix_cache.put(req.prompt, lane, last_logits)
        self._activate(slot, req, lane, last_logits, job.t0)

    def _drop_prefill_job(self, slot: int, *, held: bool) -> None:
        """Abandon a mid-prefill job (preemption or explicit park): the
        partial stage work is dropped (no lane was written yet) and the
        request requeues as not yet prefilled (_ParkedMeta.pos=None, so
        readmission is a plain re-prefill)."""
        job = self._prefill_jobs.pop(slot)
        req = job.request
        req.state = PARKED
        self._parked[req.uid] = _ParkedMeta(req, held=held)
        self.metrics.on_park(req.uid, self.step_count)
        if not held:
            self.scheduler.submit(req)

    def _is_finished(self, req: Request, tok: int) -> bool:
        return (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    def _retire(self, slot: int) -> None:
        s = self.slots[slot]
        s.request.state = FINISHED
        self.metrics.on_finish(s.request.uid, self.step_count)
        reset_slot(self.pool, slot, self.mesh)
        self.slots[slot] = None

    @torch.no_grad()
    def _decode_once(self) -> None:
        active_ids = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_ids:
            return
        t0 = time.perf_counter()
        # this rank's lanes: global slots lane0 .. lane0 + B - 1 (all of
        # them without a data axis)
        B, lane0, dev = self._lanes, self._lane0, self.device
        local = [i for i in active_ids if lane0 <= i < lane0 + B]
        greedy = all(self.slots[i].request.sampling.temperature <= 0
                     for i in active_ids)
        if local:
            logits, toks = self._decode_lanes(local, greedy)
        else:
            logits = torch.zeros((B, self.cfg.padded_vocab),
                                 dtype=torch.float32, device=dev)
            toks = torch.zeros((B,), dtype=torch.int64, device=dev)
        if B < self.max_slots:
            # every data rank's lanes, in slot order
            group = self.mesh.group("data")
            toks = comp.all_gather_rows(toks, group).reshape(-1)
            if self.record_logits:
                logits = comp.all_gather_rows(logits.float(), group).reshape(
                    self.max_slots, -1)
        toks_host = toks.cpu()                  # device sync
        dt = time.perf_counter() - t0
        self.metrics.on_decode_step(len(active_ids), dt)
        logits_host = (logits.float().cpu().numpy() if self.record_logits
                       else None)
        for i in active_ids:
            s = self.slots[i]
            tok = int(toks_host[i])
            s.request.output.append(tok)
            s.last_token = tok
            s.pos += 1
            self.metrics.on_token(s.request.uid)
            if logits_host is not None:
                self.logits_trace.setdefault(s.request.uid, []).append(
                    logits_host[i])
            if self._is_finished(s.request, tok):
                self._retire(i)

    def _decode_lanes(self, local: List[int], greedy: bool):
        """One ``serve_step`` over this rank's pool lanes (``local``: the
        active global slots among them), then sampling: (logits (B, V),
        tokens (B,) int64, the dtype every data rank gathers), rows of
        inactive lanes garbage."""
        B, lane0, dev = self._lanes, self._lane0, self.device
        tokens = torch.zeros((B,), dtype=torch.int64)
        pos = torch.zeros((B,), dtype=torch.int64)
        act = torch.zeros((B,), dtype=torch.bool)
        for i in local:
            s = self.slots[i]
            tokens[i - lane0], pos[i - lane0] = s.last_token, s.pos
            act[i - lane0] = True
        logits, self.pool = self._serve_step(
            self.params, self.kstate, self.pool, tokens.to(dev),
            pos.to(dev), act.to(dev))
        if greedy:
            # greedy fast path: no sort, no PRNG
            return logits, torch.argmax(logits, dim=-1)
        temps = torch.zeros((B,), dtype=torch.float32)
        tks = torch.zeros((B,), dtype=torch.int32)
        tps = torch.ones((B,), dtype=torch.float32)
        tok_idx = torch.zeros((B,), dtype=torch.int64)
        base_keys = torch.zeros((B, 2), dtype=torch.int64)
        for i in local:
            s = self.slots[i]
            sp = s.request.sampling
            j = i - lane0
            temps[j], tks[j], tps[j] = sp.temperature, sp.top_k, sp.top_p
            tok_idx[j] = len(s.request.output)
            base_keys[j] = s.base_key
        keys = prng.fold_in(base_keys.to(dev), tok_idx.to(dev))
        return logits, sample_tokens(keys, logits, temps.to(dev),
                                     tks.to(dev), tps.to(dev)).long()

    def step(self) -> None:
        """One engine iteration: admit (+ prefill), advance any chunked
        prefill stages, then one decode step over the active slots
        (skipped under ``prefill_only``)."""
        self._rotated_this_step = False
        with span("engine/admit"):
            self._admit_and_prefill()
        if self._prefill_jobs:
            with span("engine/prefill_chunk"):
                self._advance_prefill_jobs()
        if not self.prefill_only:
            with span("engine/decode"):
                self._decode_once()
        self.step_count += 1
        events = self.kvstore.drain_events()
        self.kvstore_events.update(ev["kind"] for ev in events)
        if self._obs:
            self._emit_tick(events)

    def _emit_tick(self, events) -> None:
        """The store's tier events (e.g. ``kvstore_remote_degraded``) as
        records of their own kind, then one ``engine_tick`` record: queue
        and slot state, the store's and the prefix cache's stats and the
        routing health of the active lanes' cluster pages
        (``pages_health`` on the ``rlen`` leaves only: one small host
        read, never the pages). Centroids are frozen in serving, so drift
        is 0; recall is the latest prefill's, the only place the full
        softmax is sampled. On a mesh every rank gathers the page health
        and rank 0 writes the records."""
        health = self._pages_health()
        if self._sink is None:
            return
        for ev in events:
            ev = dict(ev)
            self._sink.emit(ev.pop("kind"), step=self.step_count, **ev)
        active = np.array([s is not None for s in self.slots], bool)
        metrics: Dict[str, float] = {
            "active_slots": float(active.sum()),
            "queued": float(len(self.scheduler)),
            "parked": float(len(self._parked)),
            "prefilling": float(len(self._prefill_jobs)),
            "decode_steps": float(self.metrics.decode_steps),
        }
        metrics.update(self.kvstore.stats())
        if self.prefix_cache is not None:
            metrics.update(self.prefix_cache.stats())
        if health is not None:
            metrics.update(health)
            metrics["routing/drift"] = 0.0
            if "routing/recall" in self._last_routing:
                metrics["routing/recall"] = \
                    self._last_routing["routing/recall"]
        self._sink.emit("engine_tick", metrics=metrics, step=self.step_count)

    def _pages_health(self) -> Optional[Dict[str, float]]:
        """``pages_health`` of the active lanes' cluster pages, from the
        ``rlen`` leaves (on a mesh gathered over the heads and the slots
        first: a collective), or None without pages or active lanes."""
        active = np.array([s is not None for s in self.slots], bool)
        rlens = [leaf for path, leaf in tree_paths(self.pool)
                 if path[-1] == "rlen"]
        if not rlens or not active.any():
            return None
        if self.mesh is not None:
            rlens = [t["rlen"] for t in shd.gather_cache(
                [{"rlen": r} for r in rlens], self.mesh, self.max_slots)]
        # every segment's rlen in one copy, so one wait for the card
        flat = torch.cat([r.reshape(-1) for r in rlens]).cpu().numpy()
        cuts = np.cumsum([r.numel() for r in rlens])[:-1]
        return pages_health(
            [{"rlen": h.reshape(r.shape)}
             for h, r in zip(np.split(flat, cuts), rlens)], active=active)

    def close(self) -> None:
        """Settle KV transfers (raising a failed background park), write
        the ``engine_summary`` record and close the JSONL sink and the
        engine-owned KV store."""
        try:
            self.kvstore.flush()
        finally:
            if self._sink is not None:
                self._sink.emit("engine_summary",
                                metrics=self.metrics.summary())
                self._sink.close()
            if self._owns_kvstore:
                self.kvstore.close()

    def has_work(self) -> bool:
        return (bool(len(self.scheduler)) or bool(self._prefill_jobs)
                or any(s is not None for s in self.slots))

    def run(self, requests: Sequence[Request] = (),
            max_steps: int = 1_000_000) -> Dict[int, List[int]]:
        """Submit ``requests`` at their arrival_step; run until drained."""
        pending = sorted(requests, key=lambda r: (r.arrival_step, r.uid))
        while pending or self.has_work():
            while pending and pending[0].arrival_step <= self.step_count:
                self.submit(pending.pop(0))
            self.step()
            if self.step_count > max_steps:
                raise RuntimeError("engine did not drain the workload")
        return {r.uid: list(r.output) for r in requests}

