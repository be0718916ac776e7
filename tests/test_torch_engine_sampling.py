"""The port's PRNG, per-slot sampling and admission scheduler against the
JAX package's.

* `repro_torch.prng` keys, fold_in chains, random bits and uniform floats
  equal ``jax.random``'s (threefry2x32, partitionable) bit for bit, over
  seeds, uids and token indices up to 2^32 - 1: integer arithmetic only.
* gumbel noise: torch's ``log`` may differ from XLA's in the last bits, so
  each value is held within 2 ulps of max(|g|, 1) of JAX's.
* `sample_tokens` on identical logits gives the JAX package's tokens for
  greedy, top-k, top-p, degenerate filters and heterogeneous rows, over a
  fixed set of draws. The rule (the gumbel bits above): a token may differ
  only where two perturbed logits lie within a few ulps of each other, so
  a differing row must show the JAX token and the port's token within 4
  ulps of max(|v|, 1) on the port's own perturbed logits; greedy rows are
  exact.
* the scheduler is a copy of the JAX package's: its tests, copied.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import sampling as jax_sampling
from repro_torch import prng
from repro_torch.serve.engine import (PRIORITY_BATCH, PRIORITY_INTERACTIVE,
                                      FCFSScheduler, Request, SamplingParams,
                                      request_key, sample_tokens)
from repro_torch.serve.engine.sampling import request_base_key

SEEDS = (0, 1, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1)
UIDS = (0, 7, 123456789, 2 ** 32 - 1)
TOKEN_INDICES = (0, 1, 63, 2 ** 31, 2 ** 32 - 1)
GUMBEL_ULPS = 2
TIE_ULPS = 4
V = 256


def _jkey(seed, uid, idx):
    return jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), uid), idx)


def _tkey(seed, uid, idx):
    return prng.fold_in(prng.fold_in(prng.key(seed), uid), idx)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_chains_bitwise(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          prng.key(seed).numpy())
    for uid in UIDS:
        for idx in TOKEN_INDICES:
            jk = np.asarray(_jkey(seed, uid, idx)).astype(np.int64)
            assert np.array_equal(jk, _tkey(seed, uid, idx).numpy()), \
                (seed, uid, idx)
    # the engine's spelling: base key, then the token index folded in
    sp = SamplingParams(temperature=1.0, seed=seed)
    assert np.array_equal(
        np.asarray(jax_sampling.request_key(sp, 9, 4)).astype(np.int64),
        request_key(sp, 9, 4).numpy())


def test_fold_in_vectorised_over_keys():
    """One call over a batch of keys and indices equals one call each."""
    base = torch.stack([request_base_key(SamplingParams(seed=s), u)
                        for s, u in zip(SEEDS, (0, 3, 9, 2 ** 32 - 1, 1, 2))])
    idx = torch.tensor([0, 1, 2 ** 32 - 1, 5, 77, 2 ** 31])
    got = prng.fold_in(base, idx)
    for b in range(len(idx)):
        assert torch.equal(got[b], prng.fold_in(base[b], int(idx[b])))


@pytest.mark.parametrize("shape", [(1,), (257,), (3, 5)])
def test_random_bits_and_uniform_bitwise(shape):
    for seed, uid, idx in ((0, 0, 0), (7, 2 ** 32 - 1, 3),
                           (2 ** 32 - 1, 11, 2 ** 32 - 1)):
        jk, tk = _jkey(seed, uid, idx), _tkey(seed, uid, idx)[None]
        bits = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
        assert np.array_equal(bits, prng.random_bits(tk, shape)[0].numpy())
        u = np.asarray(jax.random.uniform(jk, shape))
        assert np.array_equal(u.view(np.int32),
                              prng.uniform(tk, shape)[0].numpy()
                              .view(np.int32))


def test_gumbel_within_two_ulps():
    worst = 0.0
    for seed in range(8):
        jk, tk = _jkey(seed, seed, 0), _tkey(seed, seed, 0)[None]
        g = np.asarray(jax.random.gumbel(jk, (4096,)))
        t = prng.gumbel(tk, (4096,))[0].numpy()
        scale = np.spacing(np.maximum(np.abs(g), np.float32(1)))
        worst = max(worst, float((np.abs(g - t) / scale).max()))
    assert worst <= GUMBEL_ULPS, worst


def _both(keys_spec, logits, temps, top_ks, top_ps):
    jk = jnp.stack([_jkey(*s) for s in keys_spec])
    jt = np.asarray(jax_sampling.sample_tokens(
        jk, jnp.asarray(logits), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_ks, jnp.int32), jnp.asarray(top_ps, jnp.float32)))
    tk = torch.stack([_tkey(*s) for s in keys_spec])
    args = (torch.from_numpy(logits), torch.tensor(temps, dtype=torch.float32),
            torch.tensor(top_ks, dtype=torch.int32),
            torch.tensor(top_ps, dtype=torch.float32))
    tt = sample_tokens(tk, *args).numpy()
    return jt, tt, tk, args


def _perturbed(tk, logits, temps, top_ks, top_ps):
    """The port's filtered, perturbed logits of each row (the values the
    categorical draw takes the argmax of)."""
    sentinel = []
    real = prng.categorical
    prng.categorical = lambda k, s: sentinel.append(s) or real(k, s)
    try:
        sample_tokens(tk, logits, temps, top_ks, top_ps)
    finally:
        prng.categorical = real
    return (sentinel[0] + prng.gumbel(tk, sentinel[0].shape[-1:])).numpy()


CASES = {
    "greedy": (0.0, 0, 1.0),
    "top_k": (1.0, 40, 1.0),
    "top_p": (0.9, 0, 0.9),
    "top_k_top_p": (0.8, 40, 0.95),
    "degenerate_top_k": (1.3, 1, 1.0),
    "degenerate_top_p": (1.3, 0, 1e-6),
    "no_filter": (1.0, 0, 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_tokens_matches_jax(case):
    temp, top_k, top_p = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    n = 64
    logits = (3.0 * rng.randn(n, V)).astype(np.float32)
    spec = [(seed % 3, 1000 + seed, seed) for seed in range(n)]
    jt, tt, tk, args = _both(spec, logits, [temp] * n, [top_k] * n,
                             [top_p] * n)
    if temp == 0.0 or top_k == 1 or top_p < 1e-3:
        assert np.array_equal(tt, np.argmax(logits, -1))
    diff = np.nonzero(jt != tt)[0]
    if temp == 0.0:
        assert diff.size == 0
    if diff.size:
        pert = _perturbed(tk, *args)
        for r in diff:
            a, b = pert[r, jt[r]], pert[r, tt[r]]
            scale = np.spacing(np.float32(max(abs(a), abs(b), 1.0)))
            assert abs(a - b) <= TIE_ULPS * scale, (case, r, a, b)
    assert diff.size <= 1, (case, diff)


def test_sample_tokens_heterogeneous_rows():
    """One call, per-row settings: greedy, top-k, nucleus, degenerate and
    unfiltered rows side by side give the JAX tokens row for row."""
    rng = np.random.RandomState(2)
    rows = [CASES[c] for c in sorted(CASES)] * 4
    n = len(rows)
    logits = (2.0 * rng.randn(n, V)).astype(np.float32)
    spec = [(1, uid, 3) for uid in range(n)]
    jt, tt, _, _ = _both(spec, logits, [r[0] for r in rows],
                         [r[1] for r in rows], [r[2] for r in rows])
    assert np.array_equal(jt, tt)
    assert tt[[i for i, r in enumerate(rows) if r[0] == 0.0]].tolist() == \
        np.argmax(logits[[i for i, r in enumerate(rows) if r[0] == 0.0]],
                  -1).tolist()


def test_sample_tokens_tied_logits_stable_order():
    """Top-p over tied logits keeps the first of the tie in index order,
    as the JAX package's stable argsort does."""
    logits = np.zeros((4, V), np.float32)
    logits[:, 10] = logits[:, 20] = logits[:, 30] = 5.0
    spec = [(0, uid, 0) for uid in range(4)]
    jt, tt, _, _ = _both(spec, logits, [1.0] * 4, [0] * 4, [0.15] * 4)
    assert np.array_equal(jt, tt) and set(tt.tolist()) == {10}


def test_sampling_topk_support_and_determinism():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(1, 64).astype(np.float32))
    top3 = set(torch.argsort(-logits[0])[:3].tolist())
    sp = SamplingParams(temperature=1.0, top_k=3, seed=7)

    def draw(i):
        return int(sample_tokens(request_key(sp, 0, i)[None], logits,
                                 torch.tensor([1.0]),
                                 torch.tensor([3], dtype=torch.int32),
                                 torch.tensor([1.0]))[0])
    draws = {draw(i) for i in range(40)}
    assert draws <= top3 and len(draws) > 1
    assert draw(5) == draw(5)


# ---------------------------------------------------------------------------
# Scheduling / admission (copied from the JAX package's engine tests)
# ---------------------------------------------------------------------------
def test_fcfs_scheduler_slot_and_budget_gating():
    sched = FCFSScheduler(token_budget=25)
    reqs = [Request(uid=i, prompt=[1] * 6, max_new_tokens=4)
            for i in range(4)]                      # 10 reserved tokens each
    for r in reqs:
        sched.submit(r)
    assert sched.next_admittable(0, 0) is None      # no free slot
    a = sched.next_admittable(4, 0)
    b = sched.next_admittable(3, 10)
    assert (a.uid, b.uid) == (0, 1)                 # FCFS order
    assert sched.next_admittable(2, 20) is None     # 20 + 10 > budget 25
    c = sched.next_admittable(2, 10)                # backpressure released
    assert c.uid == 2 and len(sched) == 1


def test_scheduler_priority_then_fcfs_and_head_of_line():
    sched = FCFSScheduler(token_budget=20)
    batch = Request(uid=0, prompt=[1] * 4, max_new_tokens=4,
                    priority=PRIORITY_BATCH)
    normal = [Request(uid=i, prompt=[1] * 4, max_new_tokens=4)
              for i in (1, 2)]
    big = Request(uid=3, prompt=[1] * 12, max_new_tokens=6)
    urgent = Request(uid=4, prompt=[1] * 2, max_new_tokens=2,
                     priority=PRIORITY_INTERACTIVE)
    for r in (batch, normal[0], big, normal[1], urgent):
        sched.submit(r)
    assert sched.peek().uid == 4 and sched.has_uid(3)
    order = [sched.next_admittable(8, 0).uid for _ in range(3)]
    assert order == [4, 1, 3]                       # priority, then FCFS
    # the head (uid 2, 8 tokens) blocks: nothing behind it jumps ahead
    assert sched.next_admittable(8, 16) is None
    assert sched.remove(2).uid == 2 and sched.remove(2) is None
    assert sched.next_admittable(8, 0).uid == 0 and len(sched) == 0
