"""The arithmetic and the walk of the bf16 gathered backward kernels on the
tensor cores.

``csrc/routing_gathered_bwd.cu`` runs the bf16 dq and dk/dv kernels of
the gathered routing blocks on ``wgmma``, with the bodies it shares with
the flash backward (``csrc/attn_bwd_sm90.cuh``): bf16 operands, fp32 sums,
P and dS computed in fp32 on the accumulators and then fed to dV += P^T dO,
dK += dS^T Q and dQ += dS K as two bf16 fragments each, hi = bf16(x) and
lo = bf16(x - hi), under the mask on the rows' positions
(keep = causal ? pos_q >= pos_k : pos_k < SENTINEL). The card cannot be
reached here, so `_split_bwd` emulates that arithmetic in plain PyTorch
(the bf16 inputs exact in fp32, P and dS as hi + lo pairs, sums in fp32),
and `_dkv_mask` / `_dq_mask` mirror the kernels' policies (`GatheredDkv`,
`GatheredDq`): which tiles a block walks and which a warpgroup masks. They
are helpers of this file, on no main path. On numpy-seeded inputs, with
the same lse and D:

* at one rt-cifar10 cluster set (w 512, dh 64, causal shared-QK, positions
  from `balanced_topk` over routing vectors), one rt-enwik8 set (w 256, dh
  128) and a ragged causal separate-QK set whose cluster 0 has queries
  that see no key (w 200), the split reads within 1e-5 of the largest
  value of `routed_attention_blocks_bwd_dq_plain` / `_dkv_plain` in fp32;
* with P and dS rounded to one bf16 value each, as SDPA rounds them, dq,
  dk and dv read over chip_smoke's `BWD_REL_TOL` (1e-3) at the rt-cifar10
  set: the reason for the split;
* chip_smoke's row check under the position mask
  (`gathered_grad_row_errs`, `BWD_ROW_REL_TOL`, each row of dq and dk
  allowed twice its probabilistic fp32 rounding floor,
  `gathered_row_floors`) passes the split and refuses one bf16 value each
  in every one of dq, dk and dv, and, at one cluster of rt-imagenet64's
  window (w 2048) with separate keys, refuses dk or dv with its last key
  row left unwritten, which `BWD_REL_TOL` passes;
* with P split and dS alone as one bf16 value, dq and dk read over both
  `BWD_REL_TOL` and the row check at the rt-cifar10 and rt-enwik8 sets:
  the row check sees the fault the split of dS prevents;
* without the floors, the fp32 plain version summed in another order
  fails that check against itself at the rt-enwik8 set (a query's own
  key dominates its softmax, so dP - D cancels), and reads under a tenth
  of it with them;
* the walked tiles and, within them, the tiles each warpgroup masks give
  exactly the position mask: no kept pair is skipped or masked, and no
  unmasked tile holds a pair the mask drops (sorted and unsorted
  positions, padded keys, ragged w);
* at a small shape the split agrees with the JAX package's Pallas
  backward `_g_bwd_call` in interpret mode within 1e-5 (the fp32 plain
  backward is held to it in ``tests/test_torch_gathered.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import routing_attention as jax_routing
from repro_torch.core import row_dot
from repro_torch.core import routing as core
from repro_torch.core.kmeans import cluster_scores, normalize_routing
from repro_torch.kernels import routing_gathered as K

SPLIT_TOL = 1e-5
FP32_TOL = 1e-5
SENTINEL = K.SENTINEL
HB, HBN = 128, 64          # rows a block owns; key rows per dq tile
# (H, k, w, dh, causal, shared): rt-cifar10's routing blocks (k 6, w 512,
# dh 64), rt-enwik8's (k 32, w 256, dh 128), and a ragged separate-QK set
CIFAR = (4, 6, 512, 64, True, True)
ENWIK8 = (1, 32, 256, 128, True, True)
RAGGED = (2, 3, 200, 64, True, False)
# one cluster of rt-imagenet64's routing window (w 2048, dh 64) with
# separate keys on the queries' positions (as flash's rows are): under
# causality a late key is kept by few queries, and its dk and dv rows are
# ~1e-4 of the largest value
LATE_ROWS = (1, 1, 2048, 64, True, False)
CASES = [CIFAR, ENWIK8, RAGGED]
IDS = ["rt-cifar10-w512-dh64", "rt-enwik8-w256-dh128",
       "separate-QK-w200-dh64"]


def _inputs(seed, H, kc, w, dh, causal, shared, same_pos=False):
    """bf16 blocks qf, kf, vf, do (n, w, dh) from numpy (kf is qf with
    shared-QK: routing vectors of random q, their balanced top-w
    membership and positions, as the routing layers gather them), int32
    positions (separate-QK: sorted random, cluster 0's keys after its
    queries; or, ``same_pos``, the queries' positions), and the forward's
    lse and D from the fp32 plain forward."""
    rng = np.random.default_rng(seed)
    n = H * kc
    bf = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).bfloat16()
    if shared:
        N = kc * w
        r = normalize_routing(bf(1, H, N, dh))
        mu = torch.from_numpy(rng.standard_normal((H, kc, dh)).astype(
            np.float32))
        idx = core.balanced_topk(cluster_scores(r, mu), w)
        pos = torch.arange(N).expand(1, N)
        qg, _, vg, pq, _, _ = core.gather_blocks(r, None, bf(1, H, N, dh),
                                                 idx, idx, pos)
        qf, vf = qg.reshape(n, w, dh), vg.reshape(n, w, dh)
        kf = qf
        pqf = pq.reshape(n, w).to(torch.int32)
        pkf = pqf.clone()
    else:
        qf, kf, vf = bf(n, w, dh), bf(n, w, dh), bf(n, w, dh)
        pqf, pkf = (torch.from_numpy(np.sort(rng.integers(
            0, 4 * w, (n, w)), -1).astype(np.int32)) for _ in range(2))
        if same_pos:
            pkf = pqf.clone()
        else:
            pkf[0] += 4 * w
    do = bf(n, w, dh)
    k32 = qf.float() if shared else kf.float()
    out, lse = K.routed_attention_blocks_plain(qf.float(), k32, vf.float(),
                                               pqf, pkf, causal)
    return qf, kf, vf, pqf, pkf, do, lse, row_dot(do, out.bfloat16())


def _operands(x, pairs):
    """x as the kernels feed it to a product: bf16 hi and lo, or one bf16
    value; each exact in fp32."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if pairs else (hi,)


def _keep(pqf, pkf, causal):
    return chip_smoke.gathered_keep(pqf, pkf, causal)


def _split_bwd(qf, kf, vf, pqf, pkf, do, lse, dsum, causal, pairs=True,
               ds_pairs=None):
    """(dq, dk, dv), all fp32, as the bf16 kernels compute them: fp32 P and
    dS from exact bf16 inputs under the position mask, each the A operand
    of its products as ``_operands`` gives it (dS by ``ds_pairs`` where
    given), sums in fp32."""
    q, k, v, do = (t.float() for t in (qf, kf, vf, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    s = q @ k.transpose(-1, -2) * scale
    p = torch.where(_keep(pqf, pkf, causal), torch.exp(s - lse[..., None]),
                    0.0)
    ds = p * (do @ v.transpose(-1, -2) - dsum[..., None]) * scale
    ds_ops = _operands(ds, pairs if ds_pairs is None else ds_pairs)
    dq = sum(a @ k for a in ds_ops)
    dk = sum(a.transpose(-1, -2) @ q for a in ds_ops)
    dv = sum(a.transpose(-1, -2) @ do for a in _operands(p, pairs))
    return dq, dk, dv


def _plain_bwd(qf, kf, vf, pqf, pkf, do, lse, dsum, causal):
    """The fp32 plain versions of both kernels on the upcast inputs."""
    k32 = qf.float() if kf is qf else kf.float()
    args = (qf.float(), k32, vf.float(), pqf, pkf, do.float(), lse, dsum,
            causal)
    return (K.routed_attention_blocks_bwd_dq_plain(*args),
            *K.routed_attention_blocks_bwd_dkv_plain(*args))


def _row_errs(got, ref, args, causal, floored=True):
    """chip_smoke's row check of dq, dk, dv under the position mask, with
    each row's rounding floor (or without)."""
    qf, kf, vf, pqf, pkf, do, lse, _ = args
    keep = _keep(pqf, pkf, causal)
    floors = (chip_smoke.gathered_row_floors(torch, qf, kf, vf, do, lse, keep)
              if floored else None)
    return chip_smoke.gathered_grad_row_errs(got, ref, keep, floors)


def _rel_errs(got, ref, keep):
    """Largest |got - ref| of dq, dk, dv over chip_smoke's scale of each."""
    return [float((g - r).abs().max()) / s for g, r, s in zip(
        got, ref, chip_smoke.gathered_grad_scales(ref, keep))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_operands_within_1e5(case):
    args = _inputs(30, *case)
    keep = _keep(args[3], args[4], case[4])
    errs = _rel_errs(_split_bwd(*args, case[4]), _plain_bwd(*args, case[4]),
                     keep)
    assert max(errs) <= SPLIT_TOL, errs


def test_single_bf16_operands_exceed_bwd_rel_tol():
    """One bf16 value for P and dS puts each of dq, dk and dv over
    chip_smoke's limit at the rt-cifar10 set, the split under a hundredth
    of it."""
    args = _inputs(30, *CIFAR)
    keep = _keep(args[3], args[4], True)
    ref = _plain_bwd(*args, True)
    single = _rel_errs(_split_bwd(*args, True, pairs=False), ref, keep)
    split = _rel_errs(_split_bwd(*args, True), ref, keep)
    assert min(single) > chip_smoke.BWD_REL_TOL, single
    assert max(split) < chip_smoke.BWD_REL_TOL / 100, split


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_row_check_passes_the_split_and_refuses_one_bf16(case):
    """The split under a tenth of BWD_ROW_REL_TOL in every row; one bf16
    value each refused in each of dq, dk and dv."""
    causal = case[4]
    args = _inputs(30, *case)
    ref = _plain_bwd(*args, causal)
    split = _row_errs(_split_bwd(*args, causal), ref, args, causal)
    single = _row_errs(_split_bwd(*args, causal, pairs=False), ref, args,
                       causal)
    assert max(split) <= chip_smoke.BWD_ROW_REL_TOL / 10, split
    assert min(single) > chip_smoke.BWD_ROW_REL_TOL, single


@pytest.mark.parametrize("case", [CIFAR, ENWIK8], ids=IDS[:2])
def test_ds_as_one_bf16_value_is_refused(case):
    """P as its hi + lo pair, dS alone as one bf16 value: dq and dk over
    BWD_REL_TOL of their largest values and over BWD_ROW_REL_TOL in some
    row. At the rt-enwik8 set most rows of dq and dk sit near their
    rounding floors, so this holds the floors' size too; ``-s`` prints the
    row check also with the worst-case floors (the bound of a dot product
    with dh u in place of sqrt(dh) u, sqrt(dh) times larger)."""
    args = _inputs(30, *case)
    qf, kf, vf, pqf, pkf, do, lse, _ = args
    keep = _keep(pqf, pkf, True)
    ref = _plain_bwd(*args, True)
    got = _split_bwd(*args, True, ds_pairs=False)
    rel = _rel_errs(got, ref, keep)
    rows = _row_errs(got, ref, args, True)
    floors = chip_smoke.gathered_row_floors(torch, qf, kf, vf, do, lse, keep)
    worst = chip_smoke.gathered_grad_row_errs(
        got, ref, keep, [f * case[3] ** 0.5 for f in floors])
    print(f"dS as one bf16 value, w {case[2]} dh {case[3]}: largest value "
          f"{rel[:2]}, rows {rows[:2]}, rows with worst-case floors "
          f"{worst[:2]}")
    assert min(rel[:2]) > chip_smoke.BWD_REL_TOL, rel
    assert min(rows[:2]) > chip_smoke.BWD_ROW_REL_TOL, rows


def test_row_floors_absorb_another_fp32_order():
    """The fp32 plain version with its head dim summed in another order,
    against itself, at the rt-enwik8 set: dP - D cancels where a query's
    own key dominates its softmax, and such dq and dk rows move far over
    BWD_ROW_REL_TOL without floors; with them the check reads under a
    tenth of it."""
    args = _inputs(30, *ENWIK8)
    ref = _plain_bwd(*args, True)
    perm = torch.from_numpy(np.random.default_rng(33).permutation(
        ENWIK8[3]))
    inv = torch.argsort(perm)
    qf, kf, vf, pqf, pkf, do, lse, dsum = args
    q = qf[..., perm]
    other = [g[..., inv] for g in _plain_bwd(
        q, q, vf[..., perm], pqf, pkf, do[..., perm], lse, dsum, True)]
    bare = _row_errs(other, ref, args, True, floored=False)
    floored = _row_errs(other, ref, args, True)
    assert max(bare[:2]) > chip_smoke.BWD_ROW_REL_TOL, bare
    assert max(floored) < chip_smoke.BWD_ROW_REL_TOL / 10, floored


@pytest.mark.parametrize("which", [1, 2], ids=["dk", "dv"])
def test_row_check_refuses_an_unwritten_last_key_row(which):
    """At the LATE_ROWS cluster, dk or dv with its last key row (its latest
    position: only the last query keeps it) left at zero: under BWD_REL_TOL
    of the largest value, refused row by row. (At w 512 such a row can
    reach BWD_REL_TOL of the largest value, so that check may refuse it
    too; with shared-QK a routing vector's score with itself dominates its
    row, so the last key's rows are not small at any w.)"""
    args = _inputs(30, *LATE_ROWS, same_pos=True)
    keep = _keep(args[3], args[4], True)
    ref = _plain_bwd(*args, True)
    got = list(_split_bwd(*args, True))
    got[which] = got[which].clone()
    got[which][:, -1, :] = 0.0
    assert max(_rel_errs(got, ref, keep)) <= chip_smoke.BWD_REL_TOL
    rows = _row_errs(got, ref, args, True)
    assert rows[which] > 100 * chip_smoke.BWD_ROW_REL_TOL, rows


# ---------------------------------------------------------------------------
# The kernels' walk and masked tiles, mirrored
# ---------------------------------------------------------------------------
def _tags(pos, start, rows, w, past):
    """The tags of rows start .. start + rows - 1 of one plane, ``past``
    for the rows past w."""
    out = np.full(rows, past, np.int64)
    end = min(start + rows, w)
    if end > start:
        out[:end - start] = pos[start:end]
    return out


def _walk(needed, rows):
    """The tiles of ``rows`` rows from the first to the last needed row."""
    idx = np.flatnonzero(needed)
    return range(idx[0] // rows, idx[-1] // rows + 1) if idx.size else ()


def _dkv_mask(pq, pk, causal, BQ):
    """The pairs (query, key) of one plane whose P^T element the dk/dv
    kernel (`GatheredDkv`) leaves unmasked: walked query tiles, unmasked
    where the warpgroup's tile is not an edge, else the mask itself."""
    w = len(pq)
    keep = (pq[:, None] >= pk[None, :]) if causal else np.broadcast_to(
        pk[None, :] < SENTINEL, (w, w))
    eff = np.zeros((w, w), bool)
    for k0 in range(0, w, HB):
        keys = _tags(pk, k0, HB, w, SENTINEL)
        kmin = keys.min()
        needed = pq >= kmin if causal else np.full(w, kmin < SENTINEL)
        for wg in range(2):
            kmax = keys[64 * wg:64 * wg + 64].max()
            kr = slice(k0 + 64 * wg, min(k0 + 64 * wg + 64, w))
            for tile in _walk(needed, BQ):
                q0 = tile * BQ
                qs = _tags(pq, q0, BQ, w, -1)
                edge = q0 + BQ > w or (qs.min() < kmax if causal
                                       else kmax >= SENTINEL)
                qr = slice(q0, min(q0 + BQ, w))
                eff[qr, kr] = keep[qr, kr] if edge else True
    return eff, keep


def _dq_mask(pq, pk, causal):
    """The same for the dq kernel (`GatheredDq`): walked key tiles of 64."""
    w = len(pq)
    keep = (pq[:, None] >= pk[None, :]) if causal else np.broadcast_to(
        pk[None, :] < SENTINEL, (w, w))
    eff = np.zeros((w, w), bool)
    for q0 in range(0, w, HB):
        mine = np.arange(q0, q0 + HB) < w
        rows = _tags(pq, q0, HB, w, -1)
        qmax = rows[mine].max()
        needed = pk <= qmax if causal else pk < SENTINEL
        for wg in range(2):
            part = mine[64 * wg:64 * wg + 64]
            qmin = rows[64 * wg:64 * wg + 64][part].min() if part.any() \
                else np.iinfo(np.int32).max
            qr = slice(q0 + 64 * wg, min(q0 + 64 * wg + 64, w))
            for tile in _walk(needed, HBN):
                k0 = tile * HBN
                kmax = _tags(pk, k0, HBN, w, SENTINEL).max()
                edge = kmax > qmin if causal else kmax >= SENTINEL
                kr = slice(k0, min(k0 + HBN, w))
                eff[qr, kr] = keep[qr, kr] if edge else True
    return eff, keep


def _walk_cases():
    """(name, pq, pk, causal) planes that stress the walk and the edges."""
    rng = np.random.default_rng(31)
    cases = []
    for w in (1, 63, 129, 200, 512):
        srt = lambda: np.sort(rng.integers(0, 4 * w, w))  # noqa: E731
        shared = srt()
        cases.append((f"shared-causal-w{w}", shared, shared.copy(), True))
        cases.append((f"separate-causal-w{w}", srt(), srt(), True))
        late = srt() + 4 * w
        cases.append((f"future-keys-w{w}", srt(), late, True))
        pad = srt()
        pad[rng.random(w) < 1 / 7] = SENTINEL
        cases.append((f"padded-noncausal-w{w}", srt(), pad, False))
        cases.append((f"all-padding-w{w}", srt(), np.full(w, SENTINEL),
                       False))
        cases.append((f"unsorted-causal-w{w}", rng.permutation(srt()),
                      rng.permutation(srt()), True))
    return cases


WALK_CASES = _walk_cases()


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_walk_and_edges_leave_exactly_the_mask(case):
    """For dk/dv (BQ 64 at dh 64, 32 at dh 128) and dq: a pair the mask
    keeps is walked and unmasked; a pair it drops is masked or not walked,
    so an unmasked tile never holds one (a query with lse -1e9 there
    would read exp(s - lse) = inf)."""
    _, pq, pk, causal = case
    for eff, keep in (_dkv_mask(pq, pk, causal, 64),
                      _dkv_mask(pq, pk, causal, 32),
                      _dq_mask(pq, pk, causal)):
        np.testing.assert_array_equal(eff, keep)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_matches_pallas_backward(causal):
    """The split against the Pallas `_g_bwd_call` in interpret mode on the
    same bf16-valued inputs in fp32 (separate keys; non-causal with padded
    keys), fed the Pallas forward's out and lse."""
    rng = np.random.default_rng(32)
    n, w, dh, blk = 4, 128, 64, 64
    qf, kf, vf, do = (torch.from_numpy(rng.standard_normal(
        (n, w, dh)).astype(np.float32)).bfloat16() for _ in range(4))
    pqf, pkf = (torch.from_numpy(np.sort(rng.integers(
        0, 4 * w, (n, w)), -1).astype(np.int32)) for _ in range(2))
    if not causal:
        pkf[torch.from_numpy(rng.random((n, w)) < 1 / 7)] = SENTINEL
    j = [jnp.asarray(t.float().numpy()) for t in (qf, kf, vf, do)]
    jpq, jpk = jnp.asarray(pqf.numpy()), jnp.asarray(pkf.numpy())
    j_out, j_lse = jax_routing._g_fwd_call(*j[:3], jpq, jpk, causal, blk,
                                           blk, True)
    j_grads = [np.array(g, np.float32) for g in jax_routing._g_bwd_call(
        *j[:3], jpq, jpk, j_out, j_lse, j[3], causal, blk, blk, True)]
    lse = torch.from_numpy(np.array(j_lse))
    dsum = row_dot(do.float(), torch.from_numpy(np.array(j_out)))
    got = _split_bwd(qf, kf, vf, pqf, pkf, do, lse, dsum, causal)
    keep = _keep(pqf, pkf, causal)
    errs = _rel_errs(got, [torch.from_numpy(g) for g in j_grads], keep)
    assert max(errs) <= FP32_TOL, errs
