"""The paged routing decode split over a thread-block cluster, and the plain
bf16 decode it is held to.

``csrc/routing_decode.cu`` (`routing_decode_cluster`) runs one cluster of S
= min(8, ceil(cap / 32)) CTAs per (batch, routing head): the page's
occupied slots [0, nvalid) split evenly over the ranks, each rank's share
copied in chunks of C rows (8 KB of K a chunk: C = 8192 / (dh * element
size)), each of a CTA's four warps keeping an online softmax over rows w,
w + 4, ... of every chunk, the warps' partials folded in warp order, and
rank 0 combining the CTAs' partials in rank order after the token's own
logit and value, skipping a partial with no slot. The card cannot be
reached here, so `_ranges` mirrors the split and `_split_decode` emulates
that arithmetic in plain PyTorch (fp32). They are helpers of this file, on
no main path. On numpy-seeded inputs:

* the ranks' ranges and their chunks cover [0, nvalid) exactly once, in
  order, at every chip_smoke `DECODE_EDGES` cap, for every nvalid from 0 to
  cap, every S from 1 to 8 and every chunk size the kernel's instances take
  (16, 32 and 64 rows), and the host rule picks every S from 1 to 8;
* the emulation against the fp32 plain version
  (`paged_routing_decode_plain`) at the four serving shapes of
  `DECODE_SHAPES` and at `DECODE_EDGES` pages (empty, one slot, partly
  full, exactly full, wrapped): every (b, h) row within chip_smoke's
  `ROW_REL_TOL` of its own largest value on bf16 inputs (the output
  rounded to bf16 once) and within `FP32_ROW_TOL` in fp32 (only the order
  of fp32 sums differs); ``-s`` prints the readings;
* chip_smoke's `decode_row_errs` refuses two faults that `out_ok`, on the
  largest value of the whole output, passes: one rank's partial dropped,
  and one slot past nvalid read, each in a single row whose output is
  small;
* a page with no occupied slot gives v_new bit for bit, -0.0 included;
* the plain version in bf16 against the Pallas `paged_routing_decode` in
  interpret mode, at dh 64 and 128 and the edge pages, within two bf16
  ulps of the largest value (`PALLAS_ULPS`).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import routing_decode as jax_decode
from repro_torch.kernels import routing_decode as KD

WARPS = 4
MAX_CLUSTER = 8
SLOTS_PER_RANK = 32
CHUNK_BYTES = 8192
NEG = -1e9          # csrc/common.cuh: the max of a partial with no slot
# fp32 emulation vs fp32 plain, each row against its own largest value:
# the two sum the same fp32 products in other orders. A logit is a dot
# product of size up to dh (r and its page's keys point alike, as a
# cluster's members do), so its fp32 rounding alone moves a weight by
# ~1e-6 of itself; the emulation reads up to 2.0e-6 (rt-enwik8's dh 128,
# cap 1000), the kernel on the card up to 1.5e-6 (chip_smoke)
FP32_ROW_TOL = 4e-6
# plain bf16 vs Pallas bf16: each rounds the logits, the probabilities and
# the output to bf16, in other places (reads up to one ulp here)
PALLAS_ULPS = 2


def _cluster_size(cap):
    """The host rule of `launch` in routing_decode.cu."""
    return min(MAX_CLUSTER, -(-cap // SLOTS_PER_RANK))


def _chunk_rows(dh, elsize):
    return CHUNK_BYTES // (dh * elsize)


def _ranges(nvalid, S, C):
    """Per rank, its chunks (first slot, end) of [0, nvalid): the kernel's
    per = ceil(nvalid / S) slots from rank * per on, C rows a chunk."""
    per = -(-nvalid // S)
    out = []
    for rank in range(S):
        lo = min(rank * per, nvalid)
        n = min(lo + per, nvalid) - lo
        out.append([(lo + i, lo + min(i + C, n)) for i in range(0, n, C)])
    return out


def _normalize(x):
    """`normalize_routing` in numpy: rows of norm sqrt(d)."""
    x = x - x.mean(-1, keepdims=True)
    return x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)


def _inputs(rng, B, Hr, dh, kc, cap, pages=None):
    """chip_smoke's `decode_inputs` in numpy: routing vectors r, each key
    r's direction plus noise of a size drawn per slot, N(0, 1) values; with
    ``pages`` head h reads a page of kind h (batch row 0 page 0, the others
    page k - 1)."""
    r = _normalize(rng.standard_normal((B, Hr, dh)))
    spread = rng.uniform(0.5, 3.0, (B, Hr, kc, cap, 1))
    rk = _normalize(r[:, :, None, None]
                    + spread * rng.standard_normal((B, Hr, kc, cap, dh)))
    v_new = rng.standard_normal((B, Hr, dh))
    rv = rng.standard_normal((B, Hr, kc, cap, dh))
    rlen = rng.integers(0, 2 * cap, (B, Hr, kc))
    cluster = rng.integers(0, kc, (B, Hr))
    if pages is not None:
        cluster[0], cluster[1:] = 0, kc - 1
        for b in range(B):
            for h in range(Hr):
                rlen[b, h, cluster[b, h]] = pages[h % len(pages)]
    f = [torch.from_numpy(a.astype(np.float32)) for a in (r, v_new, rk, rv)]
    i = [torch.from_numpy(a.astype(np.int32)) for a in (rlen, cluster)]
    return (*f, *i)


def _nvalid(rlen, cluster, cap):
    return torch.gather(rlen, 2, cluster.long()[..., None])[..., 0].clamp(
        0, cap)


def _split_decode(r, v_new, rk, rv, rlen, cluster, drop=None, past=None):
    """The cluster kernel's arithmetic in fp32 on the inputs' values,
    rounded to their dtype once. ``drop`` = (b, h, rank): that rank's
    partial left out of row (b, h); ``past`` = (b, h): that row reads one
    slot past nvalid."""
    B, Hr, dh = r.shape
    kc, cap = rk.shape[2], rk.shape[3]
    S, C = _cluster_size(cap), _chunk_rows(dh, r.element_size())
    scale = 1.0 / math.sqrt(dh)
    nvalid = _nvalid(rlen, cluster, cap)
    out = torch.empty(B, Hr, dh)
    for b in range(B):
        for h in range(Hr):
            x = r[b, h].float()
            pk = rk[b, h, cluster[b, h]].float()
            pv = rv[b, h, cluster[b, h]].float()
            n = int(nvalid[b, h]) + int(past == (b, h))
            parts = []
            for chunks in _ranges(n, S, C):
                m = [torch.tensor(NEG)] * WARPS
                l = [torch.tensor(0.0)] * WARPS
                acc = [torch.zeros(dh)] * WARPS
                for lo, hi in chunks:
                    logit = (pk[lo:hi] @ x) * scale
                    for w in range(WARPS):
                        rows = torch.tensor(range(lo + w, hi, WARPS),
                                            dtype=torch.long)
                        if not len(rows):
                            continue
                        mx = torch.maximum(m[w], logit[rows - lo].max())
                        alpha = torch.exp(m[w] - mx)
                        p = torch.exp(logit[rows - lo] - mx)
                        l[w] = l[w] * alpha + p.sum()
                        acc[w] = acc[w] * alpha + p @ pv[rows]
                        m[w] = mx
                used = [w for w in range(WARPS) if l[w] > 0]
                M = max((m[w] for w in used), default=torch.tensor(NEG))
                a, L = torch.zeros(dh), torch.tensor(0.0)
                for w in used:
                    f = torch.exp(m[w] - M)
                    a, L = a + f * acc[w], L + f * l[w]
                parts.append((M, L, a))
            self_logit = (x @ x) * scale
            M = max([self_logit] + [m for m, l, _ in parts if l > 0])
            fs = torch.exp(self_logit - M)
            a, L = fs * v_new[b, h].float(), fs
            for rank, (m, l, acc) in enumerate(parts):
                if l > 0 and drop != (b, h, rank):
                    f = torch.exp(m - M)
                    a, L = a + f * acc, L + f * l
            out[b, h] = a / L
    return out.to(r.dtype)


def _row_errs(out, ref):
    return chip_smoke.decode_row_errs(out, ref)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------
def test_host_rule_picks_every_cluster_size():
    picked = {_cluster_size(cap) for cap in range(1, 2049)}
    assert picked == set(range(1, MAX_CLUSTER + 1))
    assert {_chunk_rows(dh, e) for dh in (64, 128) for e in (2, 4)} == {
        16, 32, 64}


@pytest.mark.parametrize("cap", sorted({e[-1] for e in
                                        chip_smoke.DECODE_EDGES}))
def test_ranges_cover_occupied_slots_once(cap):
    for S in range(1, MAX_CLUSTER + 1):
        for C in (16, 32, 64):
            for nvalid in range(cap + 1):
                at = 0
                for rank, chunks in enumerate(_ranges(nvalid, S, C)):
                    per = -(-nvalid // S)
                    for lo, hi in chunks:
                        assert lo == at and 0 < hi - lo <= C
                        assert rank * per <= lo and hi <= (rank + 1) * per
                        at = hi
                assert at == nvalid, (cap, S, C, nvalid)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------
CASES = ([(name, B, Hr, dh, kc, cap, None)
          for name, B, Hr, dh, kc, cap in chip_smoke.DECODE_SHAPES]
         + [("edge", B, Hr, dh, kc, cap, chip_smoke.decode_pages(cap))
            for B, Hr, dh, kc, cap in chip_smoke.DECODE_EDGES
            if cap in (1, 33, 1000)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-dh{c[3]}"
                         f"-cap{c[5]}")
def test_split_matches_plain(case, dtype):
    name, B, Hr, dh, kc, cap, pages = case
    rng = np.random.default_rng(cap + dh)
    args = _inputs(rng, B, Hr, dh, kc, cap, pages)
    args = (*(t.to(dtype) for t in args[:4]), *args[4:])
    got = _split_decode(*args)
    ref = KD.paged_routing_decode_plain(*(t.float() for t in args[:4]),
                                        *args[4:])
    errs = _row_errs(got, ref)
    print(f"\n{name} dh{dh} cap{cap} {dtype}: rows {max(errs):.3e}")
    limit = chip_smoke.ROW_REL_TOL if dtype == torch.bfloat16 else \
        FP32_ROW_TOL
    assert max(errs) <= limit
    empty = _nvalid(args[4], args[5], cap) == 0
    assert got[empty].equal(args[1][empty])


def _small_row(rng, cap, nvalid):
    """rt-enwik8's page size (cap 65, three ranks); row (1, 2) reads
    ``nvalid`` slots and its values and v_new are 1e-3 of the others'."""
    r, v_new, rk, rv, rlen, cluster = _inputs(rng, 2, 4, 128, 4, cap)
    v_new[1, 2] *= 1e-3
    rv[1, 2] *= 1e-3
    rlen[1, 2, cluster[1, 2]] = nvalid
    return (*(t.to(torch.bfloat16) for t in (r, v_new, rk, rv)), rlen,
            cluster)


@pytest.mark.parametrize("fault", ["rank dropped", "slot past nvalid"])
def test_row_check_refuses_what_the_largest_value_passes(fault):
    rng = np.random.default_rng(11)
    if fault == "rank dropped":
        args = _small_row(rng, 65, 60)
        bad = _split_decode(*args, drop=(1, 2, 1))
    else:
        args = _small_row(rng, 65, 3)
        bad = _split_decode(*args, past=(1, 2))
    ref = KD.paged_routing_decode_plain(*(t.float() for t in args[:4]),
                                        *args[4:])
    good = _split_decode(*args)
    assert max(_row_errs(good, ref)) <= chip_smoke.ROW_REL_TOL
    assert chip_smoke.out_ok(bad, ref)
    errs = _row_errs(bad, ref)
    print(f"\n{fault}: row {errs[6]:.3e}, others <= "
          f"{max(errs[:6] + errs[7:]):.3e}")
    assert errs[6] > chip_smoke.ROW_REL_TOL
    assert max(errs[:6] + errs[7:]) <= chip_smoke.ROW_REL_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_empty_page_gives_v_new_exactly(dtype):
    rng = np.random.default_rng(12)
    r, v_new, rk, rv, rlen, cluster = _inputs(rng, 2, 5, 64, 3, 33,
                                              chip_smoke.decode_pages(33))
    v_new[:, 0, 0] = -0.0
    args = (*(t.to(dtype) for t in (r, v_new, rk, rv)), rlen, cluster)
    got = _split_decode(*args)
    empty = _nvalid(rlen, cluster, 33) == 0
    assert int(empty.sum()) == 2
    assert got[empty].view(torch.int16 if dtype == torch.bfloat16
                           else torch.int32).equal(
        args[1][empty].view(torch.int16 if dtype == torch.bfloat16
                            else torch.int32))


# ---------------------------------------------------------------------------
# the plain bf16 decode against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("cap", [1, 31, 65])
def test_plain_bf16_matches_pallas_kernel(dh, cap):
    rng = np.random.default_rng(dh + cap)
    args = _inputs(rng, 2, 5, dh, 3, cap, chip_smoke.decode_pages(cap))
    bf = [t.to(torch.bfloat16) for t in args[:4]]
    got = KD.paged_routing_decode(*bf, *args[4:]).float()
    want = jax_decode.paged_routing_decode(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf),
        *(jnp.asarray(t.numpy()) for t in args[4:]), interpret=True)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    top = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    err = float((got - want).abs().max())
    print(f"\ndh{dh} cap{cap}: {err:.4g} at largest {top:.3g} "
          f"({err / ulp:.1f} ulps)")
    assert err <= PALLAS_ULPS * ulp
