"""The bf16 fused routing backward kernels on the tensor cores, and the
plain bf16 backward they are held to.

``csrc/routing_fused_bwd.cu`` runs its bf16 dq and dk/dv kernels on
``wgmma`` with the backward bodies the flash, local and gathered backwards
run (``csrc/attn_bwd_sm90.cuh``): bf16 operands, fp32 sums, P and dS
computed in fp32 on the accumulators and fed to dV += P^T dO, dK += dS^T Q
and dQ += dS K as two bf16 fragments each, hi = bf16(x) and lo = bf16(x -
hi). Their rows are a cluster's members, read by index from the
sequence-layout planes (gathered by cp.async into the tiles), and the mask
is on the members' positions (keep = causal ? pos_q >= pos_k : pos_k <
SENTINEL, a padded key at SENTINEL). What a block walks and which tiles a
warpgroup masks is each kernel's policy: `FusedDkv` (a block of 128 key
members walks query tiles of 64 rows at dh 64, 32 at dh 128) and `FusedDq`
(a block of 128 query members walks 64-row key tiles). The card cannot be
reached here, so `_split_bwd` emulates that arithmetic in plain PyTorch and
`_dkv_effective` / `_dq_effective` mirror the two policies. They are
helpers of this file, on no main path. On numpy-seeded inputs:

* the walks and masked tiles of both policies, with positions read through
  the membership, leave exactly the mask at every chip_smoke
  `FUSED_EDGES` shape (w 1, 63, 129, 200; N = k w and N > k w; causal
  shared-QK, causal separate-QK, non-causal with padded keys and a cluster
  whose keys are all padding), with positions in token order and
  permuted: every kept pair lies in a walked tile and is kept there, and
  a tile a warpgroup does not mask holds only kept pairs inside the
  cluster;
* the emulation against the fp32 plain backward (`routed_attention_bwd_dq`
  / `_dkv` of ``core/routing.py``) with the same lse and D, at one
  rt-enwik8 routing head cut to N 2048 (k 8, w 256, dh 128) and one
  rt-cifar10 routing head (N 3072, k 6, w 512, dh 64), causal shared-QK:
  dq, dk and dv within chip_smoke's `BWD_REL_TOL` / 100 of their largest
  values and every row within `BWD_ROW_REL_TOL` / 10 under the position
  mask (`fused_grad_row_errs`, the gathered row check with its rounding
  floors on the members' blocks); ``-s`` prints the readings;
* the plain backward in bf16 (`routed_attention_fused_bwd_plain`, its
  per-cluster blocks scatter-added) against ``jax.vjp`` of the Pallas
  `routed_attention_fused` in interpret mode, unpaged and paged, causal
  shared-QK and non-causal separate-QK with padded keys: dq, dk and dv
  within 2^-8 of their largest values;
* chip_smoke's fused row check refuses two faults that `BWD_REL_TOL`, on
  the largest value, passes: a late key row's dk left unwritten (one
  cluster of w 2048, separate keys on the queries' members, so the last
  key is kept only by the last query and its row is ~1e-4 of the
  largest), and a query row that keeps no key whose dq is not zero (the
  cluster whose keys are all padding).

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
from repro.kernels import routing_attention as jax_routing
from repro_torch.core import routing as core
from repro_torch.core import row_dot
from repro_torch.core.kmeans import cluster_scores, normalize_routing
from repro_torch.kernels import routing_attention as KR

PALLAS_GRAD_TOL = 2.0 ** -8
SENTINEL = KR.SENTINEL
HB, HBN = 128, 64           # rows a block owns; key rows per dq tile


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """chip_smoke builds its tensors on its device: the CPU here."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


def _bf16(rng, *shape):
    """Standard normal values, rounded to bf16."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


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
# The policies' walks and masked tiles, mirrored
# ---------------------------------------------------------------------------
def _member_pos(pos, idx, n):
    """`FusedRows::member` then the position: the member index clamped into
    [0, N - 1], its position read from the batch row's plane."""
    return pos[np.clip(idx, 0, n - 1)]


def _tags(p, start, rows, w, past):
    """The tags of tile rows start .. start + rows - 1 of a cluster,
    ``past`` for the rows past w."""
    out = np.full(rows, past, np.int64)
    end = min(start + rows, w)
    if end > start:
        out[:end - start] = p[start:end]
    return out


def _walk(needed, rows):
    """`walk`: the tiles of ``rows`` rows from the first to the last
    needed row."""
    idx = np.flatnonzero(needed)
    return range(idx[0] // rows, idx[-1] // rows + 1) if idx.size else ()


def _keep(pq, pk, causal):
    """`routing_keep` over one cluster's (query, key) members."""
    if causal:
        return pq[:, None] >= pk[None, :]
    return np.broadcast_to(pk[None, :] < SENTINEL, (len(pq), len(pk)))


def _dkv_effective(pq, pk, causal, BQ):
    """The (query, key) pairs of one cluster whose P^T element the dk/dv
    kernel (`FusedDkv`, `routing_fused_dkv_wgmma`) leaves unmasked: its
    walk from the block's smallest key position, `drop` in the tiles a
    warpgroup masks (`edge`), every pair in those it does not."""
    w = len(pq)
    keep = _keep(pq, pk, causal)
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
    return eff


def _dq_effective(pq, pk, causal):
    """The same for the dq kernel (`FusedDq`, `routing_fused_dq_wgmma`):
    walked key tiles of 64 up to the block's largest query position."""
    w = len(pq)
    keep = _keep(pq, pk, causal)
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
    return eff


WALKS = [(e, permuted) for e in chip_smoke.FUSED_EDGES
         for permuted in (False, True)]


@pytest.mark.parametrize("case", WALKS, ids=[
    f"w{w}-N{N}-dh{dh}-{mode}{'-permuted' if p else ''}"
    for (_, _, _, w, N, dh, mode), p in WALKS])
def test_walks_and_edges_leave_exactly_the_mask(case):
    """dk/dv (BQ 64 at dh 64, 32 at dh 128) and dq, each cluster of each
    head: a pair the mask keeps is walked and unmasked; a pair it drops is
    masked or not walked, so an unmasked tile never holds one (a query
    with lse -1e9 there would read exp(s - lse) = inf). The mask is
    chip_smoke's `fused_keep`, held to the definition on the members'
    positions first."""
    (B, H, kc, w, N, dh, mode), permuted = case
    q, k, v, q_idx, k_idx, pos, kvalid, causal = _fused_set(
        70, B, H, kc, w, N, dh, mode, permuted)
    keep = chip_smoke.fused_keep(torch, q_idx, k_idx, pos, kvalid,
                                 causal).numpy()
    pk_plane = pos if kvalid is None else torch.where(kvalid, pos, SENTINEL)
    BQ = 64 if dh == 64 else 32
    for b in range(B):
        for h in range(H):
            for c in range(kc):
                pq = _member_pos(pos[b].numpy(), q_idx[b, h, c].numpy(), N)
                pk = _member_pos(pk_plane[b].numpy(),
                                 k_idx[b, h, c].numpy(), N)
                want = _keep(pq, pk, causal)
                np.testing.assert_array_equal(keep[b, h, c], want)
                for eff in (_dkv_effective(pq, pk, causal, BQ),
                            _dq_effective(pq, pk, causal)):
                    np.testing.assert_array_equal(eff, want)
    if mode == "padded":
        assert not keep[:, :, 0].any(), "cluster 0 keeps a key"


# ---------------------------------------------------------------------------
# The tensor-core backward's arithmetic, emulated
# ---------------------------------------------------------------------------
def _operands(x, pairs):
    """x as the kernels feed it to a product: bf16 hi and lo, or one bf16
    value; each exact in fp32."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if pairs else (hi,)


def _split_bwd(q, k, v, q_idx, k_idx, pos, do, lse, dsum, causal,
               kvalid=None):
    """Per-cluster (dq, dk, dv) (B, H, k, w, dh), all fp32, as the bf16
    kernels compute them: the members' rows of the exact bf16 inputs, fp32
    P and dS under the position mask (`fused_keep`; a masked P is 0 by a
    select), each the A operand of its products as a hi + lo pair, sums
    in fp32."""
    qg, kg, vg, _, _, _ = core.gather_blocks(q, k, v, q_idx.long(),
                                             k_idx.long(), pos.long())
    qg, kg, vg, do = (t.float() for t in (qg, kg, vg, do))
    keep = chip_smoke.fused_keep(torch, q_idx, k_idx, pos, kvalid, causal)
    scale = 1.0 / qg.shape[-1] ** 0.5
    s = qg @ kg.transpose(-1, -2) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ vg.transpose(-1, -2) - dsum[..., None]) * scale
    ds_ops = _operands(ds, True)
    dq = sum(a @ kg for a in ds_ops)
    dk = sum(a.transpose(-1, -2) @ qg for a in ds_ops)
    dv = sum(a.transpose(-1, -2) @ do for a in _operands(p, True))
    return dq, dk, dv


def _head(seed, N, kc, dh, mode="shared", w=None):
    """One routing head (B 1, H 1): the `_fused_set` inputs with w = N / k
    (or ``w``), bf16 do per cluster, the fp32 plain forward's lse and D =
    rowsum(do * out) with out rounded to bf16, and the fp32 plain
    backward's per-cluster (dq, dk, dv)."""
    w = w or N // kc
    q, k, v, q_idx, k_idx, pos, kvalid, causal = _fused_set(
        seed, 1, 1, kc, w, N, dh, mode)
    rng = np.random.default_rng(seed + 1)
    do = _bf16(rng, 1, 1, kc, w, dh)
    up = lambda t: None if t is None else t.float()  # noqa: E731
    out, lse = KR.routed_attention_fused_plain(
        q.float(), up(k), v.float(), q_idx, k_idx, pos, causal, kvalid)
    dsum = row_dot(do, out.bfloat16())
    a32 = (q.float(), up(k), v.float(), q_idx.long(), k_idx.long(),
           pos.long(), do.float(), lse, dsum, causal, kvalid)
    ref = (core.routed_attention_bwd_dq(*a32),
           *core.routed_attention_bwd_dkv(*a32))
    inputs = (q, k, v, q_idx, k_idx, pos, do, lse, dsum, causal, kvalid)
    return inputs, ref


def _rel_errs(got, ref, inputs):
    """Largest |got - ref| of dq, dk, dv over chip_smoke's scale of each
    (`gathered_grad_scales` under the fused mask)."""
    q, k, v, q_idx, k_idx, pos, do, lse, dsum, causal, kvalid = inputs
    keep = chip_smoke.fused_keep(torch, q_idx, k_idx, pos, kvalid, causal)
    return [float((g - r).abs().max()) / s for g, r, s in zip(
        got, ref, chip_smoke.gathered_grad_scales(ref, keep))]


def _row_errs(got, ref, inputs):
    """chip_smoke's fused row check of dq, dk, dv."""
    q, k, v, q_idx, k_idx, pos, do, lse, dsum, causal, kvalid = inputs
    return chip_smoke.fused_grad_row_errs(torch, q, k, v, q_idx, k_idx, pos,
                                          do, lse, got, ref, causal, kvalid)


HEADS = {
    "rt-enwik8-N2048-k8-w256-dh128": (2048, 8, 128),
    "rt-cifar10-N3072-k6-w512-dh64": (3072, 6, 64),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_split_within_limits(name):
    inputs, ref = _head(71, *HEADS[name])
    got = _split_bwd(*inputs)
    rel = _rel_errs(got, ref, inputs)
    rows = _row_errs(got, ref, inputs)
    print(f"{name}: largest value {rel}, rows {rows}")
    assert max(rel) <= chip_smoke.BWD_REL_TOL / 100, rel
    assert max(rows) <= chip_smoke.BWD_ROW_REL_TOL / 10, rows


# ---------------------------------------------------------------------------
# The plain bf16 backward against the Pallas backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("mode", ["shared", "padded"],
                         ids=["shared-causal", "separate-noncausal-padded"])
def test_plain_bf16_backward_matches_pallas(mode, paged):
    """B 1, H 2, N 256, k 4, w 64, dh 64: the port's plain bf16 forward and
    backward, the blocks scatter-added to sequence layout (shared-QK: dq
    and dk onto q, each rounded to bf16 first, as JAX sums the two
    cotangents of q in its dtype), against the Pallas kernels' VJP on the
    same bf16 inputs."""
    B, H, kc, w, N, dh = 1, 2, 4, 64, 256, 64
    q, k, v, q_idx, k_idx, pos, kvalid, causal = _fused_set(
        72, B, H, kc, w, N, dh, mode)
    do = _bf16(np.random.default_rng(73), B, H, kc, w, dh)
    shared = k is None
    prim = (q, v) if shared else (q, k, v)
    jkv = None if kvalid is None else jnp.asarray(kvalid.numpy())

    def jfn(*xs):
        jq, jk, jv = (xs[0], None, xs[1]) if shared else xs
        return jax_routing.routed_attention_fused(
            jq, jk, jv, jnp.asarray(q_idx.numpy()),
            jnp.asarray(k_idx.numpy()), jnp.asarray(pos.numpy()),
            causal=causal, kvalid=jkv, interpret=True, paged=paged)

    j_prim = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in prim]
    _, vjp = jax.vjp(jfn, *j_prim)
    j_grads = [torch.from_numpy(np.asarray(g, np.float32))
               for g in vjp(jnp.asarray(do.float().numpy()).astype(
                   jnp.bfloat16))]

    out, lse = KR.routed_attention_fused(q, k, v, q_idx, k_idx, pos, causal,
                                         kvalid)
    dqg, dkg, dvg = KR.routed_attention_fused_bwd_plain(
        q, k, v, q_idx, k_idx, pos, out, lse, do, causal, kvalid)
    for g in (dqg, dkg, dvg):
        assert g.dtype == torch.float32
    qi, ki = q_idx.long(), k_idx.long()
    dq = core.scatter_add_rows(dqg, qi, N)
    dk = core.scatter_add_rows(dkg, ki, N)
    dv = core.scatter_add_rows(dvg, ki, N)
    grads = [g.bfloat16() for g in (dq, dk, dv)]
    if shared:
        # JAX adds q's two cotangents, each already in q's dtype
        grads = [grads[0] + grads[1], grads[2]]
    for g, jg in zip(grads, j_grads):
        rel = float((g.float() - jg).abs().max() / jg.abs().max())
        assert rel <= PALLAS_GRAD_TOL, rel


# ---------------------------------------------------------------------------
# chip_smoke's fused row check
# ---------------------------------------------------------------------------
def test_row_check_refuses_an_unwritten_late_key_row():
    """One cluster of w 2048 (N 4096, k 2, dh 64) with separate keys on the
    queries' members, causal: dk with the last key row of cluster 0 (its
    latest position, kept only by the last query) left at zero passes
    BWD_REL_TOL; the row check refuses it."""
    N, kc, dh = 4096, 2, 64
    inputs, _ = _head(74, N, kc, dh, mode="separate")
    q, k, v, q_idx, _, pos, _, _, _, causal, kvalid = inputs
    # the keys on the queries' own members (separate k and v rows)
    out, lse = KR.routed_attention_fused_plain(
        q.float(), k.float(), v.float(), q_idx, q_idx, pos, causal)
    rng = np.random.default_rng(75)
    do = _bf16(rng, 1, 1, kc, N // kc, dh)
    dsum = row_dot(do, out.bfloat16())
    inputs = (q, k, v, q_idx, q_idx, pos, do, lse, dsum, causal, kvalid)
    a32 = (q.float(), k.float(), v.float(), q_idx.long(), q_idx.long(),
           pos.long(), do.float(), lse, dsum, causal)
    ref = (core.routed_attention_bwd_dq(*a32),
           *core.routed_attention_bwd_dkv(*a32))
    got = list(_split_bwd(*inputs))
    assert max(_row_errs(got, ref, inputs)) <= chip_smoke.BWD_ROW_REL_TOL
    got[1] = got[1].clone()
    got[1][0, 0, 0, -1] = 0.0
    assert max(_rel_errs(got, ref, inputs)) <= chip_smoke.BWD_REL_TOL
    rows = _row_errs(got, ref, inputs)
    assert rows[1] > 100 * chip_smoke.BWD_ROW_REL_TOL, rows


def test_row_check_refuses_a_no_key_row_whose_dq_is_not_zero():
    """Non-causal with padded keys (w 63, N 189, k 3): cluster 0's keys are
    all padding, so its queries keep no key and their dq is exactly zero
    in the plain version and the emulation, which the row check passes;
    one such row written as 2^-20 everywhere passes BWD_REL_TOL and is
    refused row by row (the gathered check alone scales a no-key dq row by
    dv's largest row)."""
    inputs, ref = _head(76, 189, 3, 64, mode="padded", w=63)
    q, k, v, q_idx, k_idx, pos, do, lse, dsum, causal, kvalid = inputs
    keep = chip_smoke.fused_keep(torch, q_idx, k_idx, pos, kvalid, causal)
    empty = ~keep.any(-1)
    assert bool(empty[0, 0, 0].all())
    got = list(_split_bwd(*inputs))
    assert float(ref[0][empty].abs().max()) == 0.0
    assert float(got[0][empty].abs().max()) == 0.0
    assert max(_row_errs(got, ref, inputs)) <= chip_smoke.BWD_ROW_REL_TOL
    got[0] = got[0].clone()
    got[0][0, 0, 0, -1] = 2.0 ** -20
    assert max(_rel_errs(got, ref, inputs)) <= chip_smoke.BWD_REL_TOL
    gathered_only = chip_smoke.gathered_grad_row_errs(
        got, ref, keep, None)
    assert gathered_only[0] <= chip_smoke.BWD_ROW_REL_TOL, gathered_only
    rows = _row_errs(got, ref, inputs)
    assert rows[0] > chip_smoke.BWD_ROW_REL_TOL, rows
