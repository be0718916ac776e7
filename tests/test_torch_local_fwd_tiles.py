"""The bf16 local-window and gathered routing forwards on the tensor cores,
and the plain bf16 forwards they are held to.

``csrc/local_attention.cu`` and ``csrc/routing_gathered.cu`` run their
bf16 forwards on ``wgmma`` with the flash forward's body
(``csrc/attn_fwd_sm90.cuh``): 128 query rows a block, key tiles of 128
rows, S = Q K^T as fp32 sums of exact bf16 products, an online softmax in
fp32, P rounded to bf16 per tile as the A operand of O += P V, the output
rounded to bf16 once. What a block walks and which tiles a warpgroup masks
is each kernel's policy: `LocalFwd` (windows on row indices, an optional
key pad mask) and `GatheredFwd` (original positions). The card cannot be
reached here, so `_tc_forward` emulates that arithmetic in plain PyTorch,
and `_local_tiles` / `_gathered_tiles` mirror the two policies. They are
helpers of this file, on no main path. On numpy-seeded inputs:

* the three plain forwards in bf16 (`local_attention_plain`,
  `routed_attention_blocks_plain`, `routed_attention_fused_plain`) against
  their Pallas kernels in interpret mode (`_fwd_call`, `_g_fwd_call`,
  `routed_attention_fused` unpaged and paged, `_f_fwd_call` for the
  fused lse): out within 2^-8 of its largest value, lse within 1e-5. They
  upcast q, k and v and round only the output, as the Pallas kernels do;
  with the bf16 einsums they ran before (their scores rounded to bf16
  before the softmax, P rounded before P V) they read up to 6.3e-3 and
  7.2e-3 of the largest value and 3.0e-3 and 3.1e-2 on lse;
* the emulation against the fp32 plain versions, at one rt-cifar10 local
  head (N 3072, w 512, dh 64), one rt-enwik8 local head (N 2048, w 256,
  dh 128), rt-cifar10's gathered blocks (k 6, w 512, dh 64, causal
  shared-QK), a ragged local shape (N 200, w 63, a pad mask whose tail
  is long enough that its last rows keep no key) and a ragged gathered set (w 200, separate
  keys, a cluster whose queries keep no key): the largest value and every
  row within chip_smoke's `ROW_REL_TOL` (``-s`` prints the readings);
* the walks and masked tiles of both policies leave exactly the mask:
  every kept pair lies in a walked tile, and a tile a warpgroup does not
  mask holds only kept pairs (w dividing 128, not dividing it, w > N, pad
  masks; sorted, unsorted and padded positions, a cluster whose queries
  keep no key);
* chip_smoke's forward row check (`row_rel_err` within ROW_REL_TOL)
  passes the emulation, refuses a forward whose diagonal value tile is
  the previous tile's in four late rows at N 3072 and w 512 (which
  `OUT_REL_TOL`, on the largest value, passes), and refuses a row that
  keeps no key written as anything but zeros.

Tolerances:
* 2^-8 of the largest value and 1e-5 on lse, plain vs Pallas: both compute
  in fp32 from the same bf16 inputs and round only the output, so they
  differ by the order of fp32 sums (~1e-7 of a value, ~5e-7 on lse), which
  moves an output across a bf16 rounding boundary now and then: one ulp,
  2^-8 of the value's binade, under 2^-8 of the largest value for every
  value below half of it;
* `ROW_REL_TOL` (2^-7) and `OUT_REL_TOL` (2^-7), emulation vs fp32 plain:
  chip_smoke's limits on the card. P as one bf16 value and the rounded
  output cost ~2^-9 of a row each (the emulation reads ~3e-3).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import kmeans as jax_kmeans
from repro.core import routing as jax_routing
from repro.kernels import local_attention as jax_local_kernel
from repro.kernels import routing_attention as jax_routing_kernel
from repro_torch.core import routing as core
from repro_torch.core.kmeans import cluster_scores, normalize_routing
from repro_torch.kernels import local_attention as KL
from repro_torch.kernels import routing_attention as KF
from repro_torch.kernels import routing_gathered as KG

PALLAS_OUT_TOL = 2.0 ** -8
PALLAS_LSE_TOL = 1e-5
ROWS = KEYS = 128           # query rows of a block; key rows of a tile
SENTINEL = KG.SENTINEL
NO_KEY_LSE = -1e9 + math.log(1e-30)


def _bf16(rng, *shape):
    """Standard normal values, rounded to bf16."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


def _j(t):
    """A bf16 torch tensor as a bf16 jax array."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _pallas_errs(out, lse, j_out, j_lse):
    ref = torch.from_numpy(np.asarray(j_out, np.float32))
    rel = float((out.float() - ref).abs().max() / ref.abs().max())
    lerr = float((lse - torch.from_numpy(np.array(j_lse))).abs().max())
    return rel, lerr


# ---------------------------------------------------------------------------
# The plain bf16 forwards against their Pallas kernels (the repair)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_local_plain_bf16_matches_pallas(causal, dh):
    """GQA 2:1, N a multiple of w (the Pallas kernel takes no other)."""
    rng = np.random.default_rng(50)
    B, H, Hkv, N, w = 1, 2, 1, 512, 128
    q = _bf16(rng, B, H, N, dh)
    k, v = _bf16(rng, B, Hkv, N, dh), _bf16(rng, B, Hkv, N, dh)
    j_out, j_lse = jax_local_kernel._fwd_call(_j(q), _j(k), _j(v), w, causal,
                                              True)
    out, lse = KL.local_attention_plain(q, k, v, w, causal)
    assert out.dtype == torch.bfloat16
    rel, lerr = _pallas_errs(out, lse.reshape(B * H, N), j_out, j_lse)
    assert rel <= PALLAS_OUT_TOL and lerr <= PALLAS_LSE_TOL, (rel, lerr)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "separate"])
def test_gathered_plain_bf16_matches_pallas(shared):
    """Four blocks of w 256, causal; shared-QK passes the q blocks as k."""
    rng = np.random.default_rng(51)
    n, w, dh = 4, 256, 64
    qf, vf = _bf16(rng, n, w, dh), _bf16(rng, n, w, dh)
    kf = qf if shared else _bf16(rng, n, w, dh)
    pqf = torch.from_numpy(np.sort(rng.integers(0, 4 * w, (n, w)), -1)
                           .astype(np.int32))
    pkf = pqf.clone() if shared else torch.from_numpy(np.sort(
        rng.integers(0, 4 * w, (n, w)), -1).astype(np.int32))
    j_out, j_lse = jax_routing_kernel._g_fwd_call(
        _j(qf), _j(kf), _j(vf), jnp.asarray(pqf.numpy()),
        jnp.asarray(pkf.numpy()), True, 128, 128, True)
    out, lse = KG.routed_attention_blocks_plain(qf, kf, vf, pqf, pkf, True)
    assert out.dtype == torch.bfloat16
    rel, lerr = _pallas_errs(out, lse, j_out, j_lse)
    assert rel <= PALLAS_OUT_TOL and lerr <= PALLAS_LSE_TOL, (rel, lerr)


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_fused_plain_bf16_matches_pallas(paged):
    """Causal shared-QK with padded keys, as the routing layers call it:
    out against `routed_attention_fused` in the forced memory plan, lse
    against `_f_fwd_call`."""
    rng = np.random.default_rng(52)
    B, H, N, dh, kc = 2, 2, 256, 64, 4
    w = N // kc
    q, v = _bf16(rng, B, H, N, dh), _bf16(rng, B, H, N, dh)
    mu = rng.standard_normal((H, kc, dh)).astype(np.float32)
    kvalid = np.ones((B, N), bool)
    kvalid[0, -9:] = False
    kvalid[1, :5] = False
    sq = jax_kmeans.cluster_scores(jnp.asarray(q.float().numpy()),
                                   jnp.asarray(mu))
    idx = np.array(jax_routing.balanced_topk(sq, w, jnp.asarray(kvalid)),
                     np.int32)
    pos = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy()
    j_out = jax_routing_kernel.routed_attention_fused(
        _j(q), None, _j(v), jnp.asarray(idx), jnp.asarray(idx),
        jnp.asarray(pos), causal=True, kvalid=jnp.asarray(kvalid),
        interpret=True, paged=paged)
    qf = _j(q).reshape(B * H, N, dh)
    posk = np.where(kvalid, pos, SENTINEL).astype(np.int32)
    _, j_lse = jax_routing_kernel._f_fwd_call(
        qf, qf, _j(v).reshape(B * H, N, dh),
        jnp.asarray(idx).reshape(B * H, kc, w),
        jnp.asarray(idx).reshape(B * H, kc, w), jnp.asarray(pos),
        jnp.asarray(posk), True, True, w, w, H, True)
    ti = torch.from_numpy(idx)
    out, lse = KF.routed_attention_fused_plain(
        q, None, v, ti, ti, torch.from_numpy(pos), True,
        torch.from_numpy(kvalid))
    assert out.dtype == torch.bfloat16
    rel, lerr = _pallas_errs(out, lse.reshape(B * H, kc, w), j_out, j_lse)
    assert rel <= PALLAS_OUT_TOL and lerr <= PALLAS_LSE_TOL, (rel, lerr)


# ---------------------------------------------------------------------------
# The policies' walks and masked tiles, mirrored
# ---------------------------------------------------------------------------
def _local_window(i, N, w, causal):
    """`LocalFwd::row_tag`: the key rows [lo, hi] query row i may keep."""
    b = i // w
    hi = i if causal else (b + 2) * w - 1
    return max(0, (b - 1) * w), min(hi, N - 1)


def _local_tiles(N, w, causal, padded):
    """For each block of 128 query rows: its first query row and, for each
    walked key tile, the tile's first key and whether each warpgroup masks
    it (`LocalFwd`, `local_fwd_wgmma`; w cut to N, as the wrapper cuts it)."""
    w = min(w, N)
    for q0 in range(0, N, ROWS):
        last = min(q0 + ROWS, N) - 1
        first = max(0, (q0 // w - 1) * w) // KEYS * KEYS
        end = last + 1 if causal else min(N, (last // w + 2) * w)
        tiles = []
        for j in range(-(-(end - first) // KEYS)):
            k0 = first + j * KEYS
            edges = []
            for wg in range(2):
                r = q0 + 64 * wg
                edges.append(padded
                             or k0 < _local_window(r + 63, N, w, causal)[0]
                             or k0 + KEYS - 1 > _local_window(r, N, w,
                                                              causal)[1])
            tiles.append((k0, edges))
        yield q0, tiles


def _gathered_tiles(pq, pk, causal):
    """The same for one plane of gathered blocks (`GatheredFwd`,
    `routing_gathered_wgmma`): the walk from the first to the last key that
    a row of the block keeps; a warpgroup masks a tile unless every pair
    in it keeps."""
    w = len(pq)
    for q0 in range(0, w, ROWS):
        rows = pq[q0:q0 + ROWS]
        qmax = rows.max()
        needed = pk <= qmax if causal else pk < SENTINEL
        idx = np.flatnonzero(needed)
        tiles = []
        if idx.size:
            for t in range(idx[0] // KEYS, idx[-1] // KEYS + 1):
                k0 = t * KEYS
                tags = np.full(KEYS, SENTINEL, np.int64)
                part = pk[k0:k0 + KEYS]
                tags[:part.size] = part
                edges = []
                for wg in range(2):
                    mine = pq[q0 + 64 * wg:q0 + 64 * wg + 64]
                    qmin = mine.min() if mine.size else np.iinfo(np.int32).max
                    edges.append(tags.max() > qmin if causal
                                 else tags.max() >= SENTINEL)
                tiles.append((k0, edges))
        yield q0, tiles


def _effective(tiles, keep):
    """The pairs the kernel leaves unmasked: walked tiles, the mask inside
    the tiles a warpgroup masks, every pair inside those it does not. A
    warpgroup whose rows all lie past the plane stores nothing."""
    N, M = keep.shape
    eff = np.zeros_like(keep)
    for q0, walked in tiles:
        for k0, edges in walked:
            for wg, edge in enumerate(edges):
                qr = slice(q0 + 64 * wg, min(q0 + 64 * wg + 64, N))
                kr = slice(k0, min(k0 + KEYS, M))
                if qr.start >= qr.stop:
                    continue
                if not edge:
                    assert k0 + KEYS <= M, "an unmasked tile past the keys"
                eff[qr, kr] = keep[qr, kr] if edge else True
    return eff


def _local_keep(N, w, causal, pad=None):
    """The dense (N, N) mask of the local forward from its definition: key
    j's window block is query i's or the one before (also the one after
    when not causal), j <= i when causal, j not padding (w cut to N)."""
    w = min(w, N)
    bi, bj = np.arange(N)[:, None] // w, np.arange(N)[None, :] // w
    m = (bj == bi) | (bj == bi - 1)
    m = m & (np.arange(N)[None, :] <= np.arange(N)[:, None]) if causal \
        else m | (bj == bi + 1)
    return m if pad is None else m & pad[None, :]


def _pad(rng, N, tail):
    """One key in seven padding, the last ``tail`` keys all padding."""
    pad = rng.random(N) >= 1 / 7
    pad[N - tail:] = False
    return pad


LOCAL_WALKS = [(N, w, causal, padded)
               for N, w in ((1, 63), (127, 128), (129, 63), (200, 256),
                            (300, 64), (300, 128), (700, 200), (1100, 512),
                            (3072, 512), (2048, 256))
               for causal in (True, False) for padded in (False, True)]


@pytest.mark.parametrize("case", LOCAL_WALKS, ids=[
    f"N{N}-w{w}-{'causal' if c else 'full'}{'-padded' if p else ''}"
    for N, w, c, p in LOCAL_WALKS])
def test_local_walk_and_edges_leave_exactly_the_mask(case):
    N, w, causal, padded = case
    pad = _pad(np.random.default_rng(53), N, N // 6) if padded else None
    keep = _local_keep(N, w, causal, pad)
    eff = _effective(_local_tiles(N, w, causal, padded), keep)
    np.testing.assert_array_equal(eff, keep)


def test_local_unpadded_masks_only_diagonal_and_end_when_128_divides_w():
    """With 128 | w a query tile lies in one window block: causal, only the
    diagonal tile (and a ragged end) is masked."""
    N, w = 3072, 512
    for q0, tiles in _local_tiles(N, w, True, False):
        for k0, edges in tiles:
            assert edges == [k0 == q0] * 2, (q0, k0, edges)


def _gathered_planes():
    """(name, pq, pk, causal) planes that stress the walk and the edges."""
    rng = np.random.default_rng(54)
    cases = []
    for w in (1, 63, 129, 200, 512):
        srt = lambda: np.sort(rng.integers(0, 4 * w, w))  # noqa: E731
        shared = srt()
        cases.append((f"shared-causal-w{w}", shared, shared.copy(), True))
        cases.append((f"separate-causal-w{w}", srt(), srt(), True))
        cases.append((f"no-key-w{w}", srt(), srt() + 4 * w, True))
        pad = srt()
        pad[rng.random(w) < 1 / 7] = SENTINEL
        cases.append((f"padded-noncausal-w{w}", srt(), pad, False))
        cases.append((f"all-padding-w{w}", srt(), np.full(w, SENTINEL),
                      False))
        cases.append((f"unsorted-causal-w{w}", rng.permutation(srt()),
                      rng.permutation(srt()), True))
    return cases


GATHERED_PLANES = _gathered_planes()


@pytest.mark.parametrize("case", GATHERED_PLANES,
                         ids=[c[0] for c in GATHERED_PLANES])
def test_gathered_walk_and_edges_leave_exactly_the_mask(case):
    _, pq, pk, causal = case
    keep = (pq[:, None] >= pk[None, :]) if causal else np.broadcast_to(
        pk[None, :] < SENTINEL, (len(pq), len(pk)))
    eff = _effective(_gathered_tiles(pq, pk, causal), np.array(keep))
    np.testing.assert_array_equal(eff, keep)


# ---------------------------------------------------------------------------
# The tensor-core forward's arithmetic, emulated
# ---------------------------------------------------------------------------
def _tc_forward(q, k, v, keep, tiles):
    """(out bf16, lse fp32) of one plane as the bf16 kernels compute them:
    q (N, dh), k/v (M, dh) bf16, ``keep`` (N, M) bool, ``tiles`` the
    policy's walk (`_local_tiles` / `_gathered_tiles`). Per walked tile:
    fp32 scores of exact bf16 products, masked, the online softmax in fp32,
    P rounded to bf16 for P V, fp32 sums; the output rounded once; a row
    that kept no key writes 0 and NEG + log(1e-30)."""
    q, k, v = (t.float() for t in (q, k, v))
    N, dh = q.shape
    M = k.shape[0]
    sl2 = dh ** -0.5 * math.log2(math.e)
    keep = torch.as_tensor(np.ascontiguousarray(keep))
    out = torch.zeros(N, dh)
    lse = torch.empty(N)
    for q0, walked in tiles:
        rows = slice(q0, min(q0 + ROWS, N))
        n = rows.stop - rows.start
        m = torch.full((n,), -math.inf)
        l = torch.zeros(n)
        acc = torch.zeros(n, dh)
        for k0, _ in walked:
            ks = slice(k0, min(k0 + KEYS, M))
            s = (q[rows] @ k[ks].T).masked_fill(~keep[rows, ks], -math.inf)
            mx = torch.maximum(m, s.max(-1).values)
            ms = torch.where(mx == -math.inf, 0.0, mx * sl2)
            alpha = torch.exp2(m * sl2 - ms)
            p = torch.exp2(s * sl2 - ms[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p.bfloat16().float() @ v[ks]
            m = mx
        inv = torch.where(l > 0, 1.0 / l, 0.0)
        out[rows] = acc * inv[:, None]
        lse[rows] = torch.where(
            m == -math.inf, torch.tensor(NO_KEY_LSE, dtype=torch.float32),
            m * sl2 / math.log2(math.e) + torch.log(l.clamp_min(1e-30)))
    return out.bfloat16(), lse


def _local_case(seed, N, w, dh, causal, tail=0):
    """One local head: bf16 q, k, v (1, 1, N, dh), the mask (with a pad
    mask whose last ``tail`` keys are padding, when ``tail``), the fp32
    plain version's (out, lse) and the emulation's."""
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng, 1, 1, N, dh) for _ in range(3))
    padded = tail > 0
    pad = _pad(rng, N, tail) if padded else None
    tpad = None if pad is None else torch.from_numpy(pad)[None]
    ref = KL.local_attention_plain(q.float(), k.float(), v.float(), w,
                                   causal, tpad)
    keep = _local_keep(N, w, causal, pad)
    tc = _tc_forward(q[0, 0], k[0, 0], v[0, 0], keep,
                     _local_tiles(N, w, causal, padded))
    return (q, k, v, keep), (ref[0][0, 0], ref[1][0, 0]), tc


def _gathered_case(seed, H, kc, w, dh, shared):
    """Causal gathered blocks (n, w, dh): shared-QK from routing vectors
    and their balanced top-w membership, or separate keys with sorted
    positions whose cluster 0 keys all come after its queries. Returns the
    per-plane emulation stacked, and the fp32 plain version's."""
    rng = np.random.default_rng(seed)
    n = H * kc
    if shared:
        N = kc * w
        r = normalize_routing(_bf16(rng, 1, H, N, dh))
        mu = torch.from_numpy(rng.standard_normal((H, kc, dh)).astype(
            np.float32))
        idx = core.balanced_topk(cluster_scores(r, mu), w)
        pos = torch.arange(N).expand(1, N)
        qg, _, vg, pq, _, _ = core.gather_blocks(r, None, _bf16(rng, 1, H, N,
                                                                dh),
                                                 idx, idx, pos)
        qf, vf = qg.reshape(n, w, dh), vg.reshape(n, w, dh)
        kf = qf
        pqf = pq.reshape(n, w).to(torch.int32)
        pkf = pqf.clone()
    else:
        qf, kf, vf = (_bf16(rng, n, w, dh) for _ in range(3))
        pqf, pkf = (torch.from_numpy(np.sort(rng.integers(
            0, 4 * w, (n, w)), -1).astype(np.int32)) for _ in range(2))
        pkf[0] += 4 * w
    ref = KG.routed_attention_blocks_plain(qf.float(), kf.float(),
                                           vf.float(), pqf, pkf, True)
    outs, lses = [], []
    for c in range(n):
        pq, pk = pqf[c].numpy().astype(np.int64), pkf[c].numpy().astype(
            np.int64)
        keep = pq[:, None] >= pk[None, :]
        o, l = _tc_forward(qf[c], kf[c], vf[c], keep,
                           _gathered_tiles(pq, pk, True))
        outs.append(o)
        lses.append(l)
    return ref, (torch.stack(outs), torch.stack(lses))


EMULATED = {
    "rt-cifar10-local-N3072-w512-dh64": ("local", (3072, 512, 64, True)),
    "rt-enwik8-local-N2048-w256-dh128": ("local", (2048, 256, 128, True)),
    "rt-cifar10-gathered-k6-w512-dh64": ("gathered", (4, 6, 512, 64, True)),
    # its last 140 keys padding: the rows from 126 on keep no key
    "ragged-local-N200-w63-padded": ("local", (200, 63, 64, True, 140)),
    "ragged-gathered-w200-separate": ("gathered", (2, 3, 200, 64, False)),
}


@pytest.mark.parametrize("name", list(EMULATED))
def test_tensor_core_forward_within_row_tol(name):
    kind, args = EMULATED[name]
    if kind == "local":
        _, (ref_out, ref_lse), (out, lse) = _local_case(55, *args)
    else:
        (ref_out, ref_lse), (out, lse) = _gathered_case(55, *args)
    rel = chip_smoke.rel_err(out, ref_out)
    row = chip_smoke.row_rel_err(out, ref_out)
    lerr = float((lse - ref_lse).abs().max())
    print(f"{name}: largest value {rel:.3e}, rows {row:.3e}, lse {lerr:.3e}")
    assert rel <= chip_smoke.ROW_REL_TOL and row <= chip_smoke.ROW_REL_TOL
    assert lerr <= chip_smoke.LSE_TOL


# ---------------------------------------------------------------------------
# chip_smoke's forward row check
# ---------------------------------------------------------------------------
def test_row_check_refuses_a_misplaced_value_tile_in_late_rows():
    """One rt-cifar10 local head (N 3072, w 512, dh 64): the last query
    block's first four rows take the previous tile's values for their
    diagonal tile. Those rows keep 1-4 keys of that tile among ~900, so
    the largest value moves by under OUT_REL_TOL; their rows move by ~10%."""
    N, w, dh = 3072, 512, 64
    (q, k, v, keep), (ref_out, _), (out, _) = _local_case(41, N, w, dh, True)
    q0 = N - ROWS
    vbad = v[0, 0].clone()
    vbad[q0:q0 + KEYS] = v[0, 0, q0 - KEYS:q0]
    bad_rows, _ = _tc_forward(q[0, 0], k[0, 0], vbad, keep,
                              _local_tiles(N, w, True, False))
    bad = out.clone()
    bad[q0:q0 + 4] = bad_rows[q0:q0 + 4]
    assert chip_smoke.row_rel_err(out, ref_out) <= chip_smoke.ROW_REL_TOL
    assert chip_smoke.out_ok(bad, ref_out)
    assert chip_smoke.row_rel_err(bad, ref_out) > 4 * chip_smoke.ROW_REL_TOL


def test_row_check_refuses_a_no_key_row_that_is_not_zero():
    """The ragged padded local case: its rows that keep no key are zero in
    the reference and in the emulation, with the same lse; one written as
    2^-10 everywhere passes the largest-value check and fails the row
    check."""
    (_, _, _, keep), (ref_out, ref_lse), (out, lse) = _local_case(
        55, *EMULATED["ragged-local-N200-w63-padded"][1])
    empty = np.flatnonzero(~keep.any(-1))
    assert empty.size > 0
    assert float(ref_out[empty].abs().max()) == 0.0
    assert float(out[empty].float().abs().max()) == 0.0
    assert bool((lse[empty] == ref_lse[empty]).all())
    assert chip_smoke.row_rel_err(out, ref_out) <= chip_smoke.ROW_REL_TOL
    bad = out.clone()
    bad[empty[-1]] = 2.0 ** -10
    assert chip_smoke.out_ok(bad, ref_out)
    assert chip_smoke.row_rel_err(bad, ref_out) > chip_smoke.ROW_REL_TOL
