"""The bf16 fused routing forward on the tensor cores, and the plain bf16
forward it is held to.

``csrc/routing_fused.cu`` runs its bf16 forward (`routing_fused_wgmma`) on
``wgmma`` with the forward body the flash, local and gathered forwards run
(``csrc/attn_fwd_sm90.cuh``): bf16 operands, fp32 scores, the online
softmax in fp32 on the accumulators, P rounded to bf16 once per 128-key
tile for O += P V, fp32 sums, the output rounded once. Its rows are a
cluster's members, read by index from the sequence-layout planes
(gathered by cp.async into the tiles), and the mask is on the members'
positions (keep = causal ? pos_q >= pos_k : pos_k < SENTINEL, a padded key
at SENTINEL). What a block of 128 query members walks and which key tiles
a warpgroup masks is the policy `FusedFwd`. The card cannot be reached
here, so `_tc_forward` emulates that arithmetic in plain PyTorch and
`_fused_tiles` mirrors the policy. They are helpers of this file, on no
main path. On numpy-seeded inputs:

* the walk and masked tiles, with positions read through the membership,
  leave exactly the mask at every chip_smoke `FUSED_EDGES` shape (w 1, 63,
  129, 200; N = k w and N > k w; causal shared-QK, causal separate-QK,
  non-causal with padded keys and a cluster whose keys are all padding),
  with positions in token order and permuted: every kept pair lies in a
  walked tile and is kept there, and a tile a warpgroup does not mask
  holds only kept pairs inside the cluster;
* the emulation against the fp32 plain forward
  (`routed_attention_fused_plain`) at one rt-enwik8 routing head cut to N
  2048 (k 8, w 256, dh 128), one rt-cifar10 routing head (N 3072, k 6, w
  512, dh 64), both causal shared-QK, and a ragged non-causal
  separate-QK set with padded keys (w 200, N 703, cluster 0's keys all
  padding): the largest value and every row within chip_smoke's
  `ROW_REL_TOL` (`fused_fwd_row_errs`), lse within `LSE_TOL`; ``-s``
  prints the readings;
* chip_smoke's fused forward row check passes the emulation and refuses
  two faults that `OUT_REL_TOL`, on the largest value, passes: the last
  query block's first row computed with the previous tile's values
  for their diagonal key tile (rt-cifar10's head shape, keys on the
  queries' members), and a query row that keeps no key written as
  anything but zeros, or with another lse;
* the plain forward in bf16 against the Pallas `routed_attention_fused`
  in interpret mode, unpaged and paged, non-causal separate-QK with
  padded keys and a cluster whose keys are all padding (out), and the
  Pallas forward calls `_f_fwd_call` / `_p_fwd_call` (lse).
  `test_torch_local_fwd_tiles.py` holds the causal shared-QK mode.

Tolerances:
* `ROW_REL_TOL` (2^-7), `OUT_REL_TOL` (2^-7) and `LSE_TOL` (1e-4),
  emulation vs fp32 plain: chip_smoke's limits on the card. P as one bf16
  value and the rounded output cost ~2^-9 of a row each (the emulation
  reads ~3e-3);
* 2^-8 of the largest value and 1e-5 on lse, plain vs Pallas: both compute
  in fp32 from the same bf16 inputs and round only the output, so they
  differ by the order of fp32 sums, which moves an output across a bf16
  rounding boundary now and then: one ulp, 2^-8 of the value's binade.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import routing_attention as jax_routing
from repro_torch.core import routing as core
from repro_torch.core.kmeans import cluster_scores, normalize_routing
from repro_torch.kernels import routing_attention as KR

PALLAS_OUT_TOL = 2.0 ** -8
PALLAS_LSE_TOL = 1e-5
ROWS = KEYS = 128           # query members of a block; key members a tile
SENTINEL = KR.SENTINEL
NO_KEY_LSE = -1e9 + math.log(1e-30)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """chip_smoke builds its tensors on its device: the CPU here."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


def _bf16(rng, *shape):
    """Standard normal values, rounded to bf16."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


def _j(t):
    """A bf16 torch tensor as a bf16 jax array."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _fused_set(seed, B, H, kc, w, N, dh, mode, permuted=False):
    """Sequence-layout bf16 q, k (None with shared-QK), v, int32 q_idx,
    k_idx (B, H, k, w), positions (B, N), kvalid and causal, as chip_smoke's
    `fused_inputs` makes each mode, from numpy. ``permuted``: each batch
    row's positions a random permutation of 0 .. N - 1, so a cluster's
    members are not in position order."""
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng, B, H, N, dh) for _ in range(3))
    mu = torch.from_numpy(rng.standard_normal((H, kc, dh)).astype(
        np.float32))
    r = normalize_routing(q)
    q_idx = core.balanced_topk(cluster_scores(r, mu), w)
    kvalid = None
    if mode == "shared":
        q, k, k_idx = r, None, q_idx
    else:
        if mode == "padded":
            kvalid = torch.from_numpy(rng.random((B, N)) >= 1 / 7)
            kvalid[:, N - w:] = False
        k_idx = core.balanced_topk(cluster_scores(normalize_routing(k), mu),
                                   w, kvalid)
        if mode == "padded":
            k_idx[:, :, 0] = torch.arange(N - w, N)
    pos = np.broadcast_to(np.arange(N), (B, N))
    if permuted:
        pos = np.stack([rng.permutation(N) for _ in range(B)])
    pos = torch.from_numpy(np.ascontiguousarray(pos, np.int32))
    return (q, k, v, q_idx.int().contiguous(), k_idx.int().contiguous(),
            pos, kvalid, mode != "padded")


# ---------------------------------------------------------------------------
# The policy's walk and masked tiles, mirrored
# ---------------------------------------------------------------------------
def _member_pos(pos, idx, n):
    """`FusedFwd::member` then the position: the member index clamped into
    [0, N - 1], its position read from the batch row's plane."""
    return pos[np.clip(idx, 0, n - 1)]


def _keep(pq, pk, causal):
    """`gathered_keep` over one cluster's (query, key) members."""
    if causal:
        return pq[:, None] >= pk[None, :]
    return np.broadcast_to(pk[None, :] < SENTINEL, (len(pq), len(pk)))


def _fused_tiles(pq, pk, causal):
    """The walk of one cluster's forward (`FusedFwd`,
    `routing_fused_wgmma`), per block of 128 query members: (q0, [(k0,
    [edge of warpgroup 0, of warpgroup 1]), ...]). The block walks the key
    tiles from the first to the last key member that one of its rows
    keeps (causal: at or before its largest query position; non-causal:
    not padding); a warpgroup masks a tile when the tile's largest key
    position (SENTINEL past w) is above its smallest query position
    (causal) or is SENTINEL (non-causal)."""
    w = len(pq)
    for q0 in range(0, w, ROWS):
        rows = pq[q0:q0 + ROWS]
        needed = pk <= rows.max() if causal else pk < SENTINEL
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
    warpgroup whose rows all lie past the cluster stores nothing."""
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


def _cluster_positions(pos, kvalid, q_idx, k_idx, b, h, c, N):
    """One cluster's query and key member positions, as the kernel reads
    them (a padded key's at SENTINEL)."""
    pk_plane = pos if kvalid is None else torch.where(kvalid, pos, SENTINEL)
    pq = _member_pos(pos[b].numpy().astype(np.int64),
                     q_idx[b, h, c].numpy(), N)
    pk = _member_pos(pk_plane[b].numpy().astype(np.int64),
                     k_idx[b, h, c].numpy(), N)
    return pq, pk


WALKS = [(e, permuted) for e in chip_smoke.FUSED_EDGES
         for permuted in (False, True)]


@pytest.mark.parametrize("case", WALKS, ids=[
    f"w{w}-N{N}-dh{dh}-{mode}{'-permuted' if p else ''}"
    for (_, _, _, w, N, dh, mode), p in WALKS])
def test_walk_and_edges_leave_exactly_the_mask(case):
    """Each cluster of each head: a pair the mask keeps is walked and
    unmasked; a pair it drops is masked or not walked, so an unmasked tile
    never holds one. The mask is chip_smoke's `fused_keep`, held to the
    definition on the members' positions first."""
    (B, H, kc, w, N, dh, mode), permuted = case
    q, k, v, q_idx, k_idx, pos, kvalid, causal = _fused_set(
        80, B, H, kc, w, N, dh, mode, permuted)
    keep = chip_smoke.fused_keep(torch, q_idx, k_idx, pos, kvalid,
                                 causal).numpy()
    for b in range(B):
        for h in range(H):
            for c in range(kc):
                pq, pk = _cluster_positions(pos, kvalid, q_idx, k_idx, b, h,
                                            c, N)
                want = _keep(pq, pk, causal)
                np.testing.assert_array_equal(keep[b, h, c], want)
                eff = _effective(_fused_tiles(pq, pk, causal), want)
                np.testing.assert_array_equal(eff, want)
    if mode == "padded":
        assert not keep[:, :, 0].any(), "cluster 0 keeps a key"


# ---------------------------------------------------------------------------
# The tensor-core forward's arithmetic, emulated
# ---------------------------------------------------------------------------
def _tc_forward(q, k, v, keep, tiles):
    """(out bf16, lse fp32) of one cluster as the bf16 kernel computes
    them: q (w, dh), k/v (w, dh) bf16 members, ``keep`` (w, w) bool,
    ``tiles`` the policy's walk (`_fused_tiles`). Per walked tile: fp32
    scores of exact bf16 products, masked, the online softmax in fp32, P
    rounded to bf16 for P V, fp32 sums; the output rounded once; a row that
    kept no key writes 0 and NEG + log(1e-30)."""
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


def _emulated(inputs, v_of=None):
    """The emulation's per-cluster (out (B, H, k, w, dh) bf16, lse (B, H,
    k, w) fp32) on ``inputs`` (`_fused_set`'s), the members' blocks
    gathered from the sequence planes. ``v_of(b, h, c, vg)``, when given,
    returns the value rows the kernel would read for that cluster."""
    q, k, v, q_idx, k_idx, pos, kvalid, causal = inputs
    B, H, N, _ = q.shape
    kc = q_idx.shape[2]
    qg, kg, vg, _, _, _ = core.gather_blocks(q, k, v, q_idx.long(),
                                             k_idx.long(), pos.long())
    outs, lses = torch.empty(vg.shape, dtype=torch.bfloat16), torch.empty(
        q_idx.shape)
    for b in range(B):
        for h in range(H):
            for c in range(kc):
                pq, pk = _cluster_positions(pos, kvalid, q_idx, k_idx, b, h,
                                            c, N)
                vc = vg[b, h, c] if v_of is None else v_of(b, h, c, vg)
                outs[b, h, c], lses[b, h, c] = _tc_forward(
                    qg[b, h, c], kg[b, h, c], vc, _keep(pq, pk, causal),
                    _fused_tiles(pq, pk, causal))
    return outs, lses


def _plain(inputs):
    """The fp32 plain forward's (out, lse) on the same bf16 inputs."""
    q, k, v, q_idx, k_idx, pos, kvalid, causal = inputs
    return KR.routed_attention_fused_plain(
        q.float(), None if k is None else k.float(), v.float(), q_idx, k_idx,
        pos, causal, kvalid)


def _row_errs(out, lse, ref, inputs):
    """chip_smoke's fused forward row check."""
    q, k, v, q_idx, k_idx, pos, kvalid, causal = inputs
    return chip_smoke.fused_fwd_row_errs(torch, out, lse, ref[0], ref[1],
                                         q_idx, k_idx, pos, causal, kvalid)


EMULATED = {
    "rt-enwik8-N2048-k8-w256-dh128": (1, 1, 8, 256, 2048, 128, "shared"),
    "rt-cifar10-N3072-k6-w512-dh64": (1, 1, 6, 512, 3072, 64, "shared"),
    # cluster 0's keys all padding: its queries keep no key
    "ragged-w200-N703-separate-noncausal-padded": (1, 2, 3, 200, 703, 64,
                                                   "padded"),
}


@pytest.mark.parametrize("name", list(EMULATED))
def test_tensor_core_forward_within_row_tol(name):
    inputs = _fused_set(81, *EMULATED[name])
    ref = _plain(inputs)
    out, lse = _emulated(inputs)
    rel = chip_smoke.rel_err(out, ref[0])
    row = _row_errs(out, lse, ref, inputs)
    lerr = float((lse - ref[1]).abs().max())
    print(f"{name}: largest value {rel:.3e}, rows {row:.3e}, lse {lerr:.3e}")
    assert rel <= chip_smoke.OUT_REL_TOL and row <= chip_smoke.ROW_REL_TOL
    assert lerr <= chip_smoke.LSE_TOL


# ---------------------------------------------------------------------------
# chip_smoke's fused forward row check
# ---------------------------------------------------------------------------
def test_row_check_refuses_a_misplaced_value_tile_in_late_rows():
    """rt-cifar10's routing head shape (N 3072, k 6, w 512, dh 64),
    causal, separate keys on the queries' own members (so no key is a
    query's own and a late row averages its ~400 keys): in cluster 0, the
    last query block's first row takes the previous key tile's values for
    its diagonal tile. It keeps one key of that tile among 385, so the
    largest value moves by under OUT_REL_TOL; its row moves by over four
    times ROW_REL_TOL."""
    inputs = list(_fused_set(82, 1, 1, 6, 512, 3072, 64, "separate"))
    inputs[4] = inputs[3]
    ref = _plain(inputs)
    out, lse = _emulated(inputs)
    w = out.shape[-2]
    q0 = w - ROWS

    def stale(b, h, c, vg):
        vc = vg[b, h, c].clone()
        if c == 0:
            vc[q0:q0 + KEYS] = vg[b, h, c, q0 - KEYS:q0]
        return vc
    bad_rows, _ = _emulated(inputs, stale)
    bad = out.clone()
    bad[0, 0, 0, q0] = bad_rows[0, 0, 0, q0]
    assert _row_errs(out, lse, ref, inputs) <= chip_smoke.ROW_REL_TOL
    assert chip_smoke.out_ok(bad, ref[0])
    assert _row_errs(bad, lse, ref, inputs) > 4 * chip_smoke.ROW_REL_TOL


def test_row_check_refuses_a_no_key_row_that_is_not_zero():
    """The ragged padded set: cluster 0's rows keep no key and are zero in
    the plain version and in the emulation, with the same lse; one written
    as 2^-10 everywhere passes the largest-value check and fails the row
    check, and so does one whose lse is not the plain version's."""
    inputs = _fused_set(81, *EMULATED[
        "ragged-w200-N703-separate-noncausal-padded"])
    q, k, v, q_idx, k_idx, pos, kvalid, causal = inputs
    ref = _plain(inputs)
    out, lse = _emulated(inputs)
    empty = ~chip_smoke.fused_keep(torch, q_idx, k_idx, pos, kvalid,
                                   causal).any(-1)
    assert bool(empty[:, :, 0].all())
    assert float(ref[0][empty].abs().max()) == 0.0
    assert float(out[empty].float().abs().max()) == 0.0
    assert bool(lse[empty].equal(ref[1][empty]))
    assert _row_errs(out, lse, ref, inputs) <= chip_smoke.ROW_REL_TOL
    bad = out.clone()
    bad[0, 0, 0, -1] = 2.0 ** -10
    assert chip_smoke.out_ok(bad, ref[0])
    assert _row_errs(bad, lse, ref, inputs) > chip_smoke.ROW_REL_TOL
    bad_lse = lse.clone()
    bad_lse[0, 0, 0, -1] = 0.0
    assert _row_errs(out, bad_lse, ref, inputs) == math.inf


# ---------------------------------------------------------------------------
# The plain bf16 forward against the Pallas forward, padded keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_plain_bf16_noncausal_padded_matches_pallas(paged):
    """B 1, H 2, N 256, k 4, w 64, dh 64, non-causal separate-QK, one key
    in seven padding and cluster 0's keys all padding: out against
    `routed_attention_fused` in the forced memory plan, lse against the
    plan's forward call (`_f_fwd_call`, `_p_fwd_call`)."""
    B, H, kc, w, N, dh = 1, 2, 4, 64, 256, 64
    q, k, v, q_idx, k_idx, pos, kvalid, causal = _fused_set(
        83, B, H, kc, w, N, dh, "padded")
    assert not causal
    jqi, jki = jnp.asarray(q_idx.numpy()), jnp.asarray(k_idx.numpy())
    jpos, jkv = jnp.asarray(pos.numpy()), jnp.asarray(kvalid.numpy())
    j_out = jax_routing.routed_attention_fused(
        _j(q), _j(k), _j(v), jqi, jki, jpos, causal=False, kvalid=jkv,
        interpret=True, paged=paged)
    qf, kf, vf = (_j(t).reshape(B * H, N, dh) for t in (q, k, v))
    qi, ki = jqi.reshape(B * H, kc, w), jki.reshape(B * H, kc, w)
    posk = jnp.where(jkv, jpos, SENTINEL).astype(jnp.int32)
    if paged:
        def member_pos(p, idx):
            src = jnp.broadcast_to(p[:, None, :], (B, H, N)).reshape(B * H,
                                                                     N)
            return jnp.take_along_axis(src, idx.reshape(B * H, kc * w),
                                       axis=1).reshape(B * H, kc, w)
        _, j_lse = jax_routing._p_fwd_call(
            qf, kf, vf, qi, ki, member_pos(jpos, qi), member_pos(posk, ki),
            False, False, w, w, True)
    else:
        _, j_lse = jax_routing._f_fwd_call(qf, kf, vf, qi, ki, jpos, posk,
                                           False, False, w, w, H, True)
    out, lse = KR.routed_attention_fused_plain(q, k, v, q_idx, k_idx, pos,
                                               False, kvalid)
    assert out.dtype == torch.bfloat16
    ref = torch.from_numpy(np.asarray(j_out, np.float32))
    rel = float((out.float() - ref).abs().max() / ref.abs().max())
    lerr = float((lse.reshape(B * H, kc, w)
                  - torch.from_numpy(np.array(j_lse))).abs().max())
    assert float(ref[:, :, 0].abs().max()) == 0.0, "no-key rows not zero"
    assert rel <= PALLAS_OUT_TOL and lerr <= PALLAS_LSE_TOL, (rel, lerr)
