"""The bf16 local-window backward kernels on the tensor cores, and the plain
bf16 backward they are held to.

``csrc/local_attention_bwd.cu`` runs its bf16 dq and dk/dv kernels on
``wgmma`` with the backward bodies the flash and gathered backwards run
(``csrc/attn_bwd_sm90.cuh``): bf16 operands, fp32 sums, P and dS computed
in fp32 on the accumulators and fed to dV += P^T dO, dK += dS^T Q and
dQ += dS K as two bf16 fragments each, hi = bf16(x) and lo = bf16(x - hi).
What a block walks and which tiles a warpgroup masks is each kernel's
policy: `LocalDq` (a block of 128 query rows walks key tiles of 64 rows,
32 at dh 256, over its rows' windows) and `LocalDkv` (a block of 128 key
rows walks query tiles of 64 rows at dh 64, 32 above, over the windows of
the queries that attend its keys; at dh 256 twice, over one half of dK's
and dV's columns each time). The card cannot be reached here, so
`_split_bwd` emulates that arithmetic in plain PyTorch, `_dkv_walk` the
dk/dv walk tile by tile in one sweep or two column halves, and
`_dq_effective` / `_dkv_effective` mirror the two policies. They are
helpers of this file, on no main path. On numpy-seeded inputs:

* the walks and masked tiles of both policies leave exactly the mask:
  every kept pair lies in a walked tile and is kept there, and a tile a
  warpgroup does not mask holds only kept pairs and lies inside the plane
  (w 63, 128, 200 and 512, w > N, causal and not, a pad mask whose tail
  keeps no key), dq's walk at 64- and 32-row key tiles;
* the emulation against the fp32 plain backward (`local_attention_bwd_dq`
  / `_dkv` of ``core/local.py``) with the same lse and D, at one
  rt-enwik8 local head cut to N 2048 (w 256, dh 128), one rt-cifar10 local
  head (N 3072, w 512, dh 64), a ragged padded head (N 200, w 63, its
  last 140 keys padding, so its rows from 126 on keep no key) and one
  recurrentgemma-9b head cut to N 2048 (w 1024, dh 256): dq, dk and
  dv within chip_smoke's `BWD_REL_TOL` of their largest values and every
  row within its `BWD_ROW_REL_TOL` under the window mask
  (`local_grad_row_errs`), and in fact within a hundredth and a tenth of
  them; with P and dS as one bf16 value each, as SDPA rounds them, each of
  dq, dk and dv reads over `BWD_REL_TOL` at the rt-cifar10 head: the
  reason for the split (``-s`` prints the readings);
* the dk/dv walk in two column-half sweeps (dh 256) against one sweep at
  the recurrentgemma head: dk and dv within 1e-6 of their largest values
  (each element keeps its products; only the order of fp32 sums a product
  of another width takes may move it), and one sweep within the split's
  limits of the fp32 plain backward;
* the plain backward in bf16 (`local_attention_bwd_plain`) against
  ``jax.vjp`` of the Pallas `local_attention_kernel` in interpret mode (N a
  multiple of w, GQA 2:1, dh 64, 128 and 256), fed the Pallas forward's
  out and lse: dq, dk and dv within 2^-8 of their largest values;
* chip_smoke's local row check (`local_grad_row_errs`) refuses two faults
  that `BWD_REL_TOL`, on the largest value, passes: a late key row's dk
  left unwritten at the rt-cifar10 head (the last key is kept only by the
  last query, so its row is ~1e-4 of the largest), and a query row that
  keeps no key whose dq is not zero (the ragged padded head).

Tolerances:
* `BWD_REL_TOL` / 100 of the largest value and `BWD_ROW_REL_TOL` / 10 in
  every row, split vs fp32 plain: the hi + lo pair carries ~2^-16 of each
  P and dS into its product, under the order of fp32 sums (~1e-6 of a
  value); on the card the tensor cores' own accumulation adds up to
  ~2.5e-5 a row (``csrc/wgmma_probe.cu``), and chip_smoke's limits must
  hold there;
* 2^-8 of the largest value, plain vs Pallas: both compute in fp32 from
  the same bf16 inputs and round dq, dk and dv to bf16 once (the Pallas
  backward returns them in q's dtype), so they differ by the order of
  fp32 sums, which moves a value across a bf16 rounding boundary now and
  then: one ulp, 2^-8 of the value's binade.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import local_attention as jax_local_kernel
from repro_torch.core import local as core_local
from repro_torch.core import row_dot
from repro_torch.kernels import local_attention as KL

PALLAS_GRAD_TOL = 2.0 ** -8
HB, HBN = 128, 64   # rows a block owns; key rows per dq tile up to dh 192


@pytest.fixture(autouse=True)
def _cpu_masks(monkeypatch):
    """chip_smoke builds its masks on its device: the CPU here."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


def _bf16(rng, *shape):
    """Standard normal values, rounded to bf16."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


def _pad(rng, N, tail):
    """One key in seven padding, the last ``tail`` keys all padding."""
    pad = rng.random(N) >= 1 / 7
    pad[N - tail:] = False
    return pad


def _local_keep(N, w, causal, pad=None):
    """The dense (query, key) mask of local attention from its definition:
    key j's window block is query i's or the one before (also the one after
    when not causal), j <= i when causal, j not padding (w cut to N)."""
    w = min(w, N)
    bi, bj = np.arange(N)[:, None] // w, np.arange(N)[None, :] // w
    m = (bj == bi) | (bj == bi - 1)
    m = m & (np.arange(N)[None, :] <= np.arange(N)[:, None]) if causal \
        else m | (bj == bi + 1)
    return m if pad is None else m & pad[None, :]


# ---------------------------------------------------------------------------
# The policies' walks and masked tiles, mirrored
# ---------------------------------------------------------------------------
def _keys_of(i, N, w, causal):
    """`keys_of` (`LocalDq::row_tag`): the key rows [lo, hi] that query
    rows ``i`` may keep (arrays)."""
    b = i // w
    hi = i if causal else (b + 2) * w - 1
    return np.maximum(0, (b - 1) * w), np.minimum(hi, N - 1)


def _queries_of(j, N, w, causal):
    """`queries_of` (`LocalDkv::key_tag` of a valid key): the query rows
    [lo, hi] that may keep key rows ``j``."""
    b = j // w
    lo = j if causal else np.maximum(0, (b - 1) * w)
    return lo, np.minimum((b + 2) * w - 1, N - 1)


def _dq_effective(N, w, causal, pad, KT=HBN):
    """The (query, key) pairs whose P the dq kernel (`LocalDq`,
    `local_bwd_dq_wgmma`) leaves unmasked: its walk of ``KT``-row key
    tiles (`dq_tile_keys`: 64, and 32 at dh 256), `drop` (the row's
    window, the staged key validity) in the tiles a warpgroup masks
    (`edge`), every pair in those it does not. w cut to N, as the wrapper
    cuts it; only rows and keys inside the plane are stored."""
    w = min(w, N)
    eff = np.zeros((N, N), bool)
    for q0 in range(0, N, HB):
        last = min(q0 + HB, N) - 1
        first = int(_keys_of(q0, N, w, causal)[0]) // KT * KT
        kend = int(_keys_of(last, N, w, causal)[1]) + 1
        for t in range(-(-(kend - first) // KT)):
            k0 = first + t * KT
            ks = np.arange(k0, min(k0 + KT, N))
            for wg in range(2):
                r = q0 + 64 * wg
                rows = np.arange(r, min(r + 64, N))
                if rows.size == 0:
                    continue
                edge = (pad is not None
                        or k0 < _keys_of(r + 63, N, w, causal)[0]
                        or k0 + KT - 1 > _keys_of(r, N, w, causal)[1])
                if not edge:
                    assert k0 + KT <= N, "an unmasked tile past the keys"
                    eff[np.ix_(rows, ks)] = True
                    continue
                lo, hi = _keys_of(rows, N, w, causal)
                keep = (ks[None] >= lo[:, None]) & (ks[None] <= hi[:, None])
                if pad is not None:
                    keep &= pad[ks][None]
                eff[np.ix_(rows, ks)] = keep
    return eff


def _dkv_effective(N, w, causal, pad, BQ):
    """The same for the dk/dv kernel (`LocalDkv`, `local_bwd_dkv_wgmma`):
    each block of 128 key rows walks query tiles of ``BQ`` rows; a padded
    key takes an empty window."""
    w = min(w, N)
    eff = np.zeros((N, N), bool)
    for k0 in range(0, N, HB):
        last = min(k0 + HB, N) - 1
        first = int(_queries_of(k0, N, w, causal)[0]) // BQ * BQ
        qend = int(_queries_of(last, N, w, causal)[1]) + 1
        for t in range(-(-(qend - first) // BQ)):
            q0 = first + t * BQ
            qs = np.arange(q0, min(q0 + BQ, N))
            for wg in range(2):
                a = k0 + 64 * wg
                keys = np.arange(a, min(a + 64, N))
                if keys.size == 0:
                    continue
                edge = (pad is not None or a + 63 >= N
                        or q0 < _queries_of(a + 63, N, w, causal)[0]
                        or q0 + BQ - 1 > _queries_of(a, N, w, causal)[1])
                if not edge:
                    assert q0 + BQ <= N, "an unmasked tile past the queries"
                    eff[np.ix_(qs, keys)] = True
                    continue
                lo, hi = _queries_of(keys, N, w, causal)
                if pad is not None:
                    lo = np.where(pad[keys], lo, 1)
                    hi = np.where(pad[keys], hi, 0)
                eff[np.ix_(qs, keys)] = ((qs[:, None] >= lo[None])
                                         & (qs[:, None] <= hi[None]))
    return eff


LOCAL_WALKS = [(N, w, causal, padded)
               for N, w in ((1, 63), (127, 128), (129, 63), (200, 256),
                            (300, 64), (300, 128), (700, 200), (1100, 512),
                            (3072, 512), (2048, 256))
               for causal in (True, False) for padded in (False, True)]


@pytest.mark.parametrize("case", LOCAL_WALKS, ids=[
    f"N{N}-w{w}-{'causal' if c else 'full'}{'-padded' if p else ''}"
    for N, w, c, p in LOCAL_WALKS])
def test_walks_and_edges_leave_exactly_the_mask(case):
    """dq, and dk/dv with BQ 64 (dh 64) and 32 (dh 128): a pair the mask
    keeps is walked and unmasked; a pair it drops is masked or not walked,
    so an unmasked tile never holds one (a row that keeps no key has lse
    ~ -1e9, and exp(s - lse) would read inf there). A padded case ends in
    a run of padding two windows and N / 6 keys long (all but the first
    key at N <= 2w), so its last rows keep no key. The mask is chip_smoke's
    `local_mask`, held to the definition first."""
    N, w, causal, padded = case
    tail = min(N - 1, 2 * min(w, N) + N // 6)
    pad = _pad(np.random.default_rng(60), N, tail) if padded else None
    keep = _local_keep(N, w, causal, pad)
    tpad = None if pad is None else torch.from_numpy(pad)[None]
    mask = chip_smoke.local_mask(torch, N, w, causal, tpad)
    np.testing.assert_array_equal(mask.reshape(N, N).numpy(), keep)
    if padded and N > 2 * min(w, N):
        assert not keep[-1].any(), "the last row keeps a key"
    for eff in (_dq_effective(N, w, causal, pad),
                _dkv_effective(N, w, causal, pad, 64),
                _dkv_effective(N, w, causal, pad, 32)):
        np.testing.assert_array_equal(eff, keep)


@pytest.mark.parametrize("case", LOCAL_WALKS, ids=[
    f"N{N}-w{w}-{'causal' if c else 'full'}{'-padded' if p else ''}"
    for N, w, c, p in LOCAL_WALKS])
def test_dh256_dq_walk_leaves_exactly_the_mask(case):
    """dq at dh 256 walks key tiles of 32 rows (`dq_tile_keys`), so that
    its owned Q and dO and two stages of K and V fit a block's shared
    memory: the same holds of that walk as of the 64-row one above (dk/dv
    at dh 256 walks 32-row query tiles, held above)."""
    N, w, causal, padded = case
    tail = min(N - 1, 2 * min(w, N) + N // 6)
    pad = _pad(np.random.default_rng(60), N, tail) if padded else None
    np.testing.assert_array_equal(_dq_effective(N, w, causal, pad, 32),
                                  _local_keep(N, w, causal, pad))


# ---------------------------------------------------------------------------
# The tensor-core backward's arithmetic, emulated
# ---------------------------------------------------------------------------
def _operands(x, pairs):
    """x as the kernels feed it to a product: bf16 hi and lo, or one bf16
    value; each exact in fp32."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if pairs else (hi,)


def _split_bwd(q, k, v, do, lse, dsum, keep, pairs=True):
    """(dq, dk, dv) of one head, all fp32, as the bf16 kernels compute
    them: q, k, v, do (N, dh) bf16, lse and D (N,), ``keep`` (N, N) bool.
    fp32 P and dS from the exact bf16 inputs under the mask (a masked P is
    0 by a select, so a row that keeps no key contributes exact zeros),
    each the A operand of its products as ``_operands`` gives it, sums in
    fp32."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    s = q @ k.T * scale
    p = torch.where(keep, torch.exp(s - lse[:, None]), 0.0)
    ds = p * (do @ v.T - dsum[:, None]) * scale
    ds_ops = _operands(ds, pairs)
    dq = sum(a @ k for a in ds_ops)
    dk = sum(a.T @ q for a in ds_ops)
    dv = sum(a.T @ do for a in _operands(p, pairs))
    return dq, dk, dv


def _head(seed, N, w, dh, causal, tail=0):
    """One local head (B 1, H 1): bf16 q, k, v, do, the pad mask (its last
    ``tail`` keys padding, when ``tail``), the fp32 plain forward's lse and
    D = rowsum(do * out) with out rounded to bf16, chip_smoke's window
    mask (N, N), and the fp32 plain backward's (dq, dk, dv) of that
    head."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(rng, 1, 1, N, dh) for _ in range(4))
    pad = _pad(rng, N, tail) if tail else None
    tpad = None if pad is None else torch.from_numpy(pad)[None]
    out, lse = KL.local_attention_plain(q.float(), k.float(), v.float(), w,
                                        causal, tpad)
    dsum = row_dot(do, out.bfloat16())
    args = (q.float(), k.float(), v.float(), do.float(), lse, dsum, w,
            causal, tpad)
    ref = (core_local.local_attention_bwd_dq(*args)[0, 0],
           *(g[0, 0] for g in core_local.local_attention_bwd_dkv(*args)))
    mask = chip_smoke.local_mask(torch, N, w, causal, tpad).reshape(N, N)
    inputs = tuple(t[0, 0] for t in (q, k, v, do, lse, dsum))
    return inputs, mask, ref


def _rel_errs(got, ref, N):
    """Largest |got - ref| of dq, dk, dv over chip_smoke's scale of each
    (`grad_scales`)."""
    return [float((g - r).abs().max()) / s for g, r, s in zip(
        got, ref, chip_smoke.grad_scales(ref, N))]


HEADS = {
    "rt-enwik8-N2048-w256-dh128": (2048, 256, 128, True),
    "rt-cifar10-N3072-w512-dh64": (3072, 512, 64, True),
    # its last 140 keys padding: the rows from 126 on keep no key
    "ragged-N200-w63-padded": (200, 63, 64, True, 140),
    # one recurrentgemma-9b local head (dh 256) cut to N 2048, w 1024
    "recurrentgemma-N2048-w1024-dh256": (2048, 1024, 256, True),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_split_within_limits(name):
    inputs, mask, ref = _head(61, *HEADS[name])
    got = _split_bwd(*inputs, mask)
    rel = _rel_errs(got, ref, mask.shape[0])
    rows = chip_smoke.local_grad_row_errs(got, ref, mask)
    print(f"{name}: largest value {rel}, rows {rows}")
    assert max(rel) <= chip_smoke.BWD_REL_TOL / 100, rel
    assert max(rows) <= chip_smoke.BWD_ROW_REL_TOL / 10, rows


def test_single_bf16_operands_exceed_bwd_rel_tol():
    """One bf16 value for P and dS puts each of dq, dk and dv over
    chip_smoke's limit at the rt-cifar10 head, the split under a hundredth
    of it."""
    inputs, mask, ref = _head(61, *HEADS["rt-cifar10-N3072-w512-dh64"])
    single = _rel_errs(_split_bwd(*inputs, mask, pairs=False), ref, 3072)
    split = _rel_errs(_split_bwd(*inputs, mask), ref, 3072)
    print(f"one bf16 value each: {single}; hi + lo: {split}")
    assert min(single) > chip_smoke.BWD_REL_TOL, single
    assert max(split) < chip_smoke.BWD_REL_TOL / 100, split


def _dkv_walk(q, k, v, do, lse, dsum, keep, halves, BQ=32):
    """(dk, dv) of one head, all fp32, as the bf16 dk/dv kernel builds
    them: query tiles of ``BQ`` rows in order, each tile's P^T and dS^T
    from its S^T = K Q^T and dP^T = V dO^T over all columns, fed as hi +
    lo pairs to dV += P^T dO and dK += dS^T Q in fp32. One sweep with all
    the columns of dK and dV, or (``halves``, dh 256) two sweeps over the
    walk, each computing S^T and dP^T anew and both products over one
    half of the columns (`dkv_col_halves`)."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    N, dh = q.shape
    scale = 1.0 / dh ** 0.5
    dk, dv = torch.zeros(N, dh), torch.zeros(N, dh)
    sweeps = ((slice(0, dh // 2), slice(dh // 2, dh)) if halves
              else (slice(0, dh),))
    for cols in sweeps:
        for q0 in range(0, N, BQ):
            rows = slice(q0, min(q0 + BQ, N))
            st = k @ q[rows].T * scale
            pt = torch.where(keep[rows].T, torch.exp(st - lse[rows][None]),
                             0.0)
            dst = pt * (v @ do[rows].T - dsum[rows][None]) * scale
            for a in _operands(pt, True):
                dv[:, cols] += a @ do[rows, cols]
            for a in _operands(dst, True):
                dk[:, cols] += a @ q[rows, cols]
    return dk, dv


def test_column_half_sweeps_match_one_sweep():
    """dk/dv at dh 256 runs its walk twice, over one half of dK's and dV's
    columns each time: every output element keeps its products and their
    order, only which sweep computes it changes. At the recurrentgemma
    head the two sweeps' dk and dv are within 1e-6 of their largest values
    of one sweep's (the floor of the order of fp32 sums a product of
    another width may take), and one sweep's within the split's limits of
    the fp32 plain backward."""
    inputs, mask, ref = _head(61, *HEADS["recurrentgemma-N2048-w1024-dh256"])
    one = _dkv_walk(*inputs, mask, halves=False)
    two = _dkv_walk(*inputs, mask, halves=True)
    for a, b in zip(two, one):
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= 1e-6, rel
    rel = _rel_errs((ref[0], *one), ref, mask.shape[0])
    rows = chip_smoke.local_grad_row_errs((ref[0], *one), ref, mask)
    print(f"one sweep vs fp32 plain: {rel}, rows {rows}")
    assert max(rel) <= chip_smoke.BWD_REL_TOL / 100, rel
    assert max(rows) <= chip_smoke.BWD_ROW_REL_TOL / 10, rows


# ---------------------------------------------------------------------------
# The plain bf16 backward against the Pallas backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_bf16_backward_matches_pallas(causal, dh):
    """GQA 2:1, N a multiple of w (the Pallas kernel takes no other)."""
    rng = np.random.default_rng(62)
    B, H, Hkv, N, w = 1, 2, 1, 512, 128
    q, do = _bf16(rng, B, H, N, dh), _bf16(rng, B, H, N, dh)
    k, v = _bf16(rng, B, Hkv, N, dh), _bf16(rng, B, Hkv, N, dh)
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (q, k, v, do)]
    j_out, j_lse = jax_local_kernel._fwd_call(*j[:3], w, causal, True)
    _, vjp = jax.vjp(lambda a, b, c: jax_local_kernel.local_attention_kernel(
        a, b, c, w, causal, interpret=True), *j[:3])
    j_grads = [torch.from_numpy(np.asarray(g, np.float32))
               for g in vjp(j[3])]
    out = torch.from_numpy(np.asarray(j_out, np.float32)).bfloat16()
    lse = torch.from_numpy(np.array(j_lse)).reshape(B, H, N)
    grads = KL.local_attention_bwd_plain(q, k, v, out, lse, do, w, causal)
    for g, jg in zip(grads, j_grads):
        assert g.dtype == torch.float32
        rel = float((g.bfloat16().float() - jg).abs().max()
                    / jg.abs().max())
        assert rel <= PALLAS_GRAD_TOL, rel


# ---------------------------------------------------------------------------
# chip_smoke's local row check
# ---------------------------------------------------------------------------
def test_row_check_refuses_an_unwritten_late_key_row():
    """At the rt-cifar10 head, dk with its last key row left at zero: only
    the last query keeps that key, so the row is ~1e-4 of the largest
    value and BWD_REL_TOL passes it; the row check refuses it."""
    inputs, mask, ref = _head(61, *HEADS["rt-cifar10-N3072-w512-dh64"])
    got = list(_split_bwd(*inputs, mask))
    assert max(chip_smoke.local_grad_row_errs(got, ref, mask)) \
        <= chip_smoke.BWD_ROW_REL_TOL
    got[1] = got[1].clone()
    got[1][-1] = 0.0
    assert max(_rel_errs(got, ref, 3072)) <= chip_smoke.BWD_REL_TOL
    rows = chip_smoke.local_grad_row_errs(got, ref, mask)
    assert rows[1] > 100 * chip_smoke.BWD_ROW_REL_TOL, rows


def test_row_check_refuses_a_no_key_row_whose_dq_is_not_zero():
    """The ragged padded head: the rows that keep no key have dq exactly
    zero in the plain version and the emulation, and the row check passes
    them; one such row written as 2^-20 everywhere passes BWD_REL_TOL and
    is refused row by row (a row zero by construction is held to zeros,
    not scaled as a row through one key is)."""
    inputs, mask, ref = _head(61, *HEADS["ragged-N200-w63-padded"])
    got = list(_split_bwd(*inputs, mask))
    empty = np.flatnonzero(~mask.numpy().any(-1))
    assert empty.size > 0
    assert float(ref[0][empty].abs().max()) == 0.0
    assert float(got[0][empty].abs().max()) == 0.0
    assert max(chip_smoke.local_grad_row_errs(got, ref, mask)) \
        <= chip_smoke.BWD_ROW_REL_TOL
    got[0] = got[0].clone()
    got[0][empty[-1]] = 2.0 ** -20
    assert max(_rel_errs(got, ref, 200)) <= chip_smoke.BWD_REL_TOL
    rows = chip_smoke.local_grad_row_errs(got, ref, mask)
    assert rows[0] > chip_smoke.BWD_ROW_REL_TOL, rows
