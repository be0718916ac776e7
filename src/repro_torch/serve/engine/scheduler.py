"""Priority-aware FCFS admission with a token budget (a copy of the JAX
package's scheduler: pure Python).

Requests are ordered by (priority desc, submission seq asc): within one
priority level admission is strictly first-come-first-served, and the
head of the queue blocks until both a free slot AND token budget are
available (no reordering past the head — predictable latency). The token
budget caps the total *reserved* context (prompt + max_new_tokens)
summed over active slots, bounding worst-case in-flight memory even when
max_slots is large relative to the pool's max_len.

Preemption lives in the engine, not here: when the head cannot be
admitted the engine may park a lower-priority (or time-sliced) active
session to the KV store and requeue it (``submit`` again — a fresh seq,
so a rotated session rejoins behind its peers). ``peek``/``remove``
exist for that path and for session cancellation.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

# Named priority classes for Request.priority. Any int works — the queue
# orders by the raw value — but the gaps leave room to nudge individual
# requests within a class (e.g. INTERACTIVE - 1 for a deprioritized but
# still-interactive session). A higher class admits first and, via the
# engine's preemption path, parks (or, mid-prefill, drops and requeues)
# strictly-lower-priority sessions when slots are full.
PRIORITY_BATCH = -10          # throughput traffic: yields to everything
PRIORITY_NORMAL = 0           # the Request default
PRIORITY_INTERACTIVE = 10     # latency-sensitive: preempts lower classes


class FCFSScheduler:
    """Priority-then-FCFS queue with slot + token-budget gating."""

    def __init__(self, token_budget: Optional[int] = None):
        self.token_budget = token_budget
        # sorted ascending by (-priority, seq): highest priority first,
        # FCFS within a level; seq is unique so requests never compare
        self._queue: List[Tuple[int, int, object]] = []
        self._seq = 0

    def submit(self, request) -> int:
        seq = self._seq
        self._seq += 1
        prio = getattr(request, "priority", 0)
        bisect.insort(self._queue, (-prio, seq, request))
        return seq

    def __len__(self) -> int:
        return len(self._queue)

    def has_uid(self, uid: int) -> bool:
        return any(r.uid == uid for _, _, r in self._queue)

    def peek(self):
        """The head request (next to admit), without popping."""
        return self._queue[0][2] if self._queue else None

    def remove(self, uid: int):
        """Pull a request out of the queue (cancel / hold); None if absent."""
        for i, (_, _, r) in enumerate(self._queue):
            if r.uid == uid:
                return self._queue.pop(i)[2]
        return None

    @staticmethod
    def reserved_tokens(request) -> int:
        """Worst-case context this request can occupy."""
        return request.prompt_len + request.max_new_tokens

    def admittable(self, request, free_slots: int,
                   tokens_in_flight: int) -> bool:
        """Would ``request`` fit right now? (No queue-position check.)"""
        if free_slots <= 0:
            return False
        return (self.token_budget is None
                or tokens_in_flight + self.reserved_tokens(request)
                <= self.token_budget)

    def next_admittable(self, free_slots: int, tokens_in_flight: int):
        """Pop and return the head request if it can run now, else None.

        Head-of-line blocking is deliberate: admitting a smaller request
        from behind the head would starve long prompts under load.
        """
        if not self._queue:
            return None
        head = self._queue[0][2]
        if not self.admittable(head, free_slots, tokens_in_flight):
            return None
        return self._queue.pop(0)[2]
