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

Not ported (each raises NotImplementedError naming its ROADMAP.md item):
``mesh`` (item 10), ``obs_jsonl`` and ``routing_stats`` (item 9),
``export_session`` / ``import_session`` (item 8). Partial prefix reuse is
off (item 8): see ``_prefill_into``.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.obs.trace import span
from repro_torch.serve.engine.metrics import EngineMetrics
from repro_torch.serve.engine.pool import (init_pool, read_slot, reset_slot,
                                           write_slot)
from repro_torch.serve.engine.sampling import (SamplingParams,
                                               request_base_key, request_key,
                                               sample_tokens)
from repro_torch.serve.engine.scheduler import FCFSScheduler
from repro_torch.serve.kvstore import KVStore, PrefixCache
from repro_torch.serve.serving import (assemble_prefill_cache,
                                       decode_backends, init_cache,
                                       make_prefill_stages, make_serve_step,
                                       prefill, slice_cache_groups)

WAITING, PREFILL, DECODE, FINISHED = "WAITING", "PREFILL", "DECODE", "FINISHED"
PARKED, CANCELLED = "PARKED", "CANCELLED"


def _unported(what: str, item: int, detail: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md item {item}: {detail})")


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
                CANCELLED: "cancelled"}[self._request.state]

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
    backend for the prefills and decode steps, as in ``serving``.
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
        if mesh is not None:
            raise _unported("InferenceEngine(mesh=...)", 10,
                            "sharded serving over several cards")
        if obs_jsonl:
            raise _unported("InferenceEngine(obs_jsonl=...)", 9,
                            "the JSONL sink")
        if routing_stats:
            raise _unported("InferenceEngine(routing_stats=True)", 9,
                            "routing-health stats")
        if chunked_prefill is not None and chunked_prefill < 1:
            raise ValueError("chunked_prefill must be >= 1 stage per step")
        self.cfg = cfg
        self.params = params
        self.kstate = kstate
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        # every prefill and decode step resolves its attention backends
        # (and with them the pool's cache layout) from the registry; the
        # resolution is recorded here for observability
        self.attn_backends = decode_backends(cfg, impl=impl,
                                             platform=self.device.type)
        self._serve_step = make_serve_step(cfg, impl=impl)
        self._prefill = functools.partial(prefill, cfg=cfg, impl=impl)
        self.pool = init_pool(cfg, max_slots, max_len, device=self.device)
        # a prefill clones the cache it fills, so one fresh B=1 lane serves
        # every admission
        self._fresh_lane = init_cache(cfg, 1, max_len, device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.scheduler = FCFSScheduler(token_budget)
        self.metrics = EngineMetrics()
        self.step_count = 0
        self.record_logits = record_logits
        self.logits_trace: Dict[int, List[np.ndarray]] = {}
        # where parked sessions live: the host tier (transfers complete
        # inside park/resume; the JAX engine's default store runs them on a
        # background thread, ROADMAP.md item 8)
        self._owns_kvstore = kvstore is None
        self.kvstore = kvstore if kvstore is not None else KVStore()
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
                                                      groups_per_stage=1)
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
        with span("engine/park"):
            self.kvstore.park(uid, read_slot(self.pool, slot))
            reset_slot(self.pool, slot)
        s.request.state = PARKED
        self._parked[uid] = _ParkedMeta(s.request, pos=s.pos,
                                        last_token=s.last_token,
                                        base_key=s.base_key, held=held)
        self.slots[slot] = None
        self.metrics.on_park(uid, self.step_count)
        if not held:
            self.scheduler.submit(s.request)

    def _resume_into(self, slot: int, req: Request) -> None:
        """Stream a parked session's lane back into ``slot`` (bit-exact
        with a never-evicted run: the lane round-trips byte-identical and
        sampling keys are counter-based per uid, not per slot)."""
        meta = self._parked.pop(req.uid)
        with span("engine/resume"):
            write_slot(self.pool, slot, self.kvstore.resume(req.uid))
        req.state = DECODE
        self.slots[slot] = _Slot(
            req, pos=meta.pos, last_token=meta.last_token,
            base_key=meta.base_key, admit_seq=self._admit_seq,
            tokens_at_admit=len(req.output))
        self._admit_seq += 1
        self.metrics.on_resume(req.uid, slot, self.step_count)

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

    def export_session(self, uid: int, *, name: Optional[str] = None,
                       transport=None) -> str:
        raise _unported("InferenceEngine.export_session", 8,
                        "the session blob and its transports")

    def import_session(self, name: str, *, transport=None) -> SessionHandle:
        raise _unported("InferenceEngine.import_session", 8,
                        "the session blob and its transports")

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
                reset_slot(self.pool, i)
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
            logits, lane = self._prefill(self.params, self.kstate,
                                         self._fresh_lane, {"tokens": toks})
        last_logits = logits[:, -1]
        if self.prefix_cache is not None:
            self.prefix_cache.put(req.prompt, lane, last_logits)
        self._activate(slot, req, lane, last_logits, t0)

    def _activate(self, slot: int, req: Request, lane, last_logits,
                  t0: float) -> None:
        """Write a prefilled lane into ``slot`` and sample the first token:
        the shared tail of monolithic, chunked, and prefix-hit prefill.
        ``t0`` is the admission wall clock (for a chunked job the measured
        prefill time includes the decode steps it interleaved with)."""
        write_slot(self.pool, slot, lane)
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
                    job.x, nc = fn(self.params, self.kstate,
                                   self._pf_fresh[job.stage_idx], job.x,
                                   job.positions, {})
                job.chunks.append(nc)
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
        reset_slot(self.pool, slot)
        self.slots[slot] = None

    @torch.no_grad()
    def _decode_once(self) -> None:
        active_ids = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_ids:
            return
        t0 = time.perf_counter()
        B, dev = self.max_slots, self.device
        tokens = torch.zeros((B,), dtype=torch.int64)
        pos = torch.zeros((B,), dtype=torch.int64)
        act = torch.zeros((B,), dtype=torch.bool)
        for i in active_ids:
            s = self.slots[i]
            tokens[i], pos[i], act[i] = s.last_token, s.pos, True
        logits, self.pool = self._serve_step(
            self.params, self.kstate, self.pool, tokens.to(dev),
            pos.to(dev), act.to(dev))
        if all(self.slots[i].request.sampling.temperature <= 0
               for i in active_ids):
            # greedy fast path: no sort, no PRNG
            toks = torch.argmax(logits, dim=-1)
        else:
            temps = torch.zeros((B,), dtype=torch.float32)
            tks = torch.zeros((B,), dtype=torch.int32)
            tps = torch.ones((B,), dtype=torch.float32)
            tok_idx = torch.zeros((B,), dtype=torch.int64)
            base_keys = torch.zeros((B, 2), dtype=torch.int64)
            for i in active_ids:
                s = self.slots[i]
                sp = s.request.sampling
                temps[i], tks[i], tps[i] = sp.temperature, sp.top_k, sp.top_p
                tok_idx[i] = len(s.request.output)
                base_keys[i] = s.base_key
            keys = prng.fold_in(base_keys.to(dev), tok_idx.to(dev))
            toks = sample_tokens(keys, logits, temps.to(dev), tks.to(dev),
                                 tps.to(dev))
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

    def close(self) -> None:
        """Settle KV transfers and close the engine-owned KV store."""
        self.kvstore.flush()
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

