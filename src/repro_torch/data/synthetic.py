"""Deterministic synthetic data pipeline: a numpy copy of the JAX
package's ``data/synthetic.py`` (which needs no JAX either), so batches are
equal to its batches, bit for bit.

Tasks:
  * `markov`   — order-1 Markov chain with a Zipfian, seed-derived transition
                 table; has real mutual information so LM loss decreases.
  * `copy`     — prefix + delimiter + repeat-prefix. Content-based lookup:
                 exactly the access pattern routing attention exploits.
  * `uniform`  — i.i.d. uniform tokens (throughput benchmarks).

Every batch is a pure function of (seed, step) — the loader's checkpoint
state is just the step counter, which makes restart-equivalence exact.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def markov_table(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    # sparse-ish rows: each state transitions mostly to a few successors
    logits = rng.gumbel(size=(vocab, vocab)) * 2.0
    tbl = np.exp(logits - logits.max(1, keepdims=True))
    return (tbl / tbl.sum(1, keepdims=True)).astype(np.float64)


def markov_batch(vocab: int, batch: int, seq: int, seed: int,
                 step: int) -> np.ndarray:
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31))
    tbl = markov_table(vocab, seed)
    cum = np.cumsum(tbl, axis=1)
    toks = np.zeros((batch, seq), np.int32)
    toks[:, 0] = rng.randint(0, vocab, size=batch)
    u = rng.random_sample((batch, seq))
    for t in range(1, seq):
        toks[:, t] = (cum[toks[:, t - 1]] < u[:, t:t + 1]).sum(1)
    return toks


def copy_batch(vocab: int, batch: int, seq: int, seed: int,
               step: int) -> np.ndarray:
    rng = np.random.RandomState((seed * 7_777_777 + step) % (2 ** 31))
    half = (seq - 1) // 2
    prefix = rng.randint(2, vocab, size=(batch, half)).astype(np.int32)
    delim = np.ones((batch, 1), np.int32)       # token 1 = delimiter
    out = np.concatenate([prefix, delim, prefix], axis=1)
    if out.shape[1] < seq:
        pad = np.zeros((batch, seq - out.shape[1]), np.int32)
        out = np.concatenate([out, pad], axis=1)
    return out[:, :seq]


def uniform_batch(vocab: int, batch: int, seq: int, seed: int,
                  step: int) -> np.ndarray:
    rng = np.random.RandomState((seed * 31 + step) % (2 ** 31))
    return rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)


_TASKS = {"markov": markov_batch, "copy": copy_batch, "uniform": uniform_batch}


class SyntheticLoader:
    """Deterministic loader; `state()`/`restore()` checkpoint the cursor.
    Batches are ``{"tokens": (batch, seq + 1) int32}`` numpy arrays."""

    def __init__(self, task: str, vocab: int, batch: int, seq: int,
                 seed: int = 0, start_step: int = 0):
        self.fn = _TASKS[task]
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.step = start_step

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, st: Dict) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        toks = self.fn(self.vocab, self.batch, self.seq + 1, self.seed,
                       self.step)
        self.step += 1
        return {"tokens": toks}
