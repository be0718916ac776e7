"""Hash-keyed prefix cache: shared prompts fill their cache lane once
(port of the JAX package's ``serve/kvstore/prefix.py``).

Keys are the SHA-1 of the token prompt (as int64). Two lookup modes:

  exact    (default) the full prompt must match: every hit is
           byte-identical to a miss by construction, which is what the
           engine's parity contract requires for every attention variant.
  partial  longest-prefix match: the longest cached entry whose prompt is
           a prefix of the query comes back with ``matched`` set to its
           length, and the caller teacher-forces ``prompt[matched:]``
           through decode steps.

Partial reuse is exact only for cache layouts whose prefill and decode
write the same state for the same tokens (append and ring). Cluster pages
are not: a prefill fills them by balanced top-k membership, a decode
routes each token to its argmax page. The port's engine takes exact hits
only (see ``engine.py``); ``get(..., partial=True)`` is kept for the
lookup itself.

An entry is the prefilled B=1 lane plus the last-position logits row (so
an exact hit samples the first output token without running the model),
both held as read-only numpy host copies (``writeable=False``; bfloat16
leaves widened to float32, which is exact): entries are shared by
reference across sessions, and a hit's ``lane_as`` copies them back into
tensors of the pool's dtypes, so a hit never aliases the pool.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import Registry
from repro_torch.tree import tree_map


class PrefixHit(NamedTuple):
    """A cache hit: ``lane`` prefilled over ``prompt[:matched]`` and the
    logits row at position ``matched - 1``. ``matched == len(prompt)`` for
    exact hits; shorter only under ``get(..., partial=True)``."""

    lane: Any
    last_logits: np.ndarray
    matched: int

    def lane_as(self, like) -> Any:
        """The lane as tensors (copies) with the dtypes of ``like``, a
        lane of the same layout."""
        return tree_map(lambda a, t: torch.tensor(a).to(t.dtype),
                        self.lane, like)


def _as_tokens(prompt: Sequence[int]) -> np.ndarray:
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt, np.int64)


def _freeze(t: torch.Tensor) -> np.ndarray:
    """A read-only numpy host copy (bfloat16 widened to float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    a = t.to("cpu", copy=True).numpy()
    a.setflags(write=False)
    return a


class PrefixCache:
    """LRU map: SHA-1(prompt tokens) -> PrefixHit, with an optional
    longest-prefix partial lookup."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("PrefixCache capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[str, PrefixHit]" = OrderedDict()
        self.obs = Registry()
        self._hits = self.obs.counter("kvstore/prefix_hits")
        self._partial = self.obs.counter("kvstore/prefix_partial_hits")
        self._misses = self.obs.counter("kvstore/prefix_misses")

    @staticmethod
    def key(prompt: Sequence[int]) -> str:
        return hashlib.sha1(_as_tokens(prompt).tobytes()).hexdigest()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, prompt: Sequence[int],
            partial: bool = False) -> Optional[PrefixHit]:
        """The entry for ``prompt`` (exact), or under ``partial`` the entry
        of the longest cached strict prefix of ``prompt`` (``matched <
        len(prompt)``; the caller owns teacher-forcing the tail). None on a
        miss."""
        toks = _as_tokens(prompt)
        k = hashlib.sha1(toks.tobytes()).hexdigest()
        hit = self._entries.get(k)
        if hit is not None:
            self._entries.move_to_end(k)
            self._hits.inc()
            return hit
        if partial:
            # one incremental SHA-1 sweep over every proper prefix,
            # remembering the longest that names an entry
            best_key = None
            h = hashlib.sha1()
            raw = toks.tobytes()
            for n in range(1, len(toks)):
                h.update(raw[(n - 1) * 8:n * 8])
                pk = h.hexdigest()
                if pk in self._entries:
                    best_key = pk
            if best_key is not None:
                self._entries.move_to_end(best_key)
                self._partial.inc()
                return self._entries[best_key]
        self._misses.inc()
        return None

    def put(self, prompt: Sequence[int], lane, last_logits) -> None:
        """Store read-only host copies of the prefilled ``lane`` and its
        ``last_logits`` (1, V) row."""
        k = self.key(prompt)
        if k in self._entries:
            self._entries.move_to_end(k)
            return
        self._entries[k] = PrefixHit(tree_map(_freeze, lane),
                                     _freeze(last_logits),
                                     len(_as_tokens(prompt)))
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        n = self._hits.value + self._partial.value + self._misses.value
        return (self._hits.value + self._partial.value) / n if n else 0.0

    def stats(self) -> dict:
        return {
            "kvstore/prefix_entries": float(len(self._entries)),
            "kvstore/prefix_hits": self._hits.value,
            "kvstore/prefix_partial_hits": self._partial.value,
            "kvstore/prefix_misses": self._misses.value,
            "kvstore/prefix_hit_rate": self.hit_rate,
        }
