"""The arithmetic of the bf16 flash backward kernels on the tensor cores.

``csrc/flash_attention_bwd.cu`` runs the bf16 dq and dk/dv kernels on
``wgmma``: bf16 operands, fp32 sums. P and dS are computed in fp32 on the
accumulators and are then the A operands of dV += P^T dO, dK += dS^T Q and
dQ += dS K. Each goes in as two bf16 fragments, hi = bf16(x) and
lo = bf16(x - hi), each product run twice into one fp32 accumulator. The
card cannot be reached here, so `_split_bwd` emulates that arithmetic in
plain PyTorch: the bf16 inputs exact in fp32, P and dS as hi + lo pairs,
sums in fp32. It is a helper of this file, on no main path. On the same
numpy-seeded inputs, with the same lse and D, it is held against the
kernels' fp32 plain versions (`flash_attention_bwd_dq_plain`,
`flash_attention_bwd_dkv_plain`):

* at one head of qwen2-0.5b's train shape (N 4096, dh 64, causal) and at two
  of chip_smoke's ragged `FLASH_EDGES`, the split reads within 1e-5 of the
  largest reference value (it leaves each P and dS element within 2^-16
  of itself; 1.5e-6 to 4.3e-6 at these cases);
* with P and dS rounded to one bf16 value each, as SDPA rounds them,
  dq, dk and dv read over chip_smoke's `BWD_REL_TOL` (1e-3) at N 4096
  (1.69e-3, 2.61e-3, 1.41e-3): the reason for the split;
* row by row (chip_smoke's `grad_row_errs`: each query row of dq, each key
  row of dk and dv, rows that are zero in exact arithmetic scaled by dv's
  largest row), the split reads under a tenth of `BWD_ROW_REL_TOL` (1e-3;
  ~6e-6 here) and one bf16 value each over it (2.8e-3 to 4.0e-3);
* that row check refuses dk or dv with the last key row left unwritten,
  a fault that stays under `BWD_REL_TOL` of the largest value (under
  causality the last key sums one P ~ 1/N term);
* at a small shape, the split agrees with the JAX package's Pallas
  backward `_bwd_call` in interpret mode within 1e-5 (the fp32 plain
  backward is held to it in ``tests/test_torch_flash_tiles.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import flash_attention as jax_flash
from repro_torch.core import row_dot
from repro_torch.kernels import common
from repro_torch.kernels import flash_attention as flash_k

SPLIT_TOL = 1e-5
FP32_TOL = 1e-5
# (H, Hkv, N, M, dh, causal): one head of qwen2-0.5b's train shape, then
# two of chip_smoke.FLASH_EDGES
QWEN2_HEAD = (1, 1, 4096, 4096, 64, True)
EDGE_CASES = [(14, 2, 127, 129, 64, True), (4, 2, 129, 200, 128, False)]
EDGE_IDS = [f"{'causal' if c else 'full'}-H{h}kv{g}-N{n}M{m}-dh{d}"
            for h, g, n, m, d, c in EDGE_CASES]


def _inputs(seed, H, Hkv, N, M, dh, causal):
    """bf16 q, k, v, do from numpy, and the forward's lse and D from the
    fp32 plain forward on them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16() for s in ((1, H, N, dh), (1, Hkv, M, dh),
                                          (1, Hkv, M, dh), (1, H, N, dh)))
    out, lse = flash_k.flash_attention_plain(q, k, v, causal)
    return q, k, v, do, lse, row_dot(do, out)


def _operands(x, pairs):
    """x as the kernels feed it to a product: bf16 hi and lo, or one bf16
    value; each exact in fp32."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if pairs else (hi,)


def _split_bwd(q, k, v, do, lse, dsum, causal, pairs=True):
    """(dq, dk, dv per query head), all fp32, as the bf16 kernels compute
    them: fp32 P and dS from exact bf16 inputs, each the A operand of its
    products as ``_operands`` gives it, sums in fp32."""
    H, Hkv, N, M, dh = q.shape[1], k.shape[1], q.shape[2], k.shape[2], \
        q.shape[3]
    k, v = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
    q, k, v, do = (t.float() for t in (q, k, v, do))
    scale = 1.0 / dh ** 0.5
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse[..., None])
    if causal:
        p = torch.where(torch.ones(N, M, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (do @ v.transpose(-1, -2) - dsum[..., None]) * scale
    dq = sum(a @ k for a in _operands(ds, pairs))
    dk = sum(a.transpose(-1, -2) @ q for a in _operands(ds, pairs))
    dv = sum(a.transpose(-1, -2) @ do for a in _operands(p, pairs))
    return dq, dk, dv


def _plain_bwd(q, k, v, do, lse, dsum, causal):
    """The fp32 plain versions of both kernels on the upcast inputs."""
    args = (q.float(), k.float(), v.float(), do.float(), lse, dsum, causal)
    return (flash_k.flash_attention_bwd_dq_plain(*args),
            *flash_k.flash_attention_bwd_dkv_plain(*args))


def _rel_errs(got, ref, M):
    """Largest |got - ref| of dq, dk, dv over chip_smoke's scale of each
    (its largest reference value; dv's for dq and dk when M = 1)."""
    return [float((g - r).abs().max()) / s
            for g, r, s in zip(got, ref, chip_smoke.grad_scales(ref, M))]


@pytest.mark.parametrize("case", [QWEN2_HEAD, *EDGE_CASES],
                         ids=["qwen2-head-N4096-dh64", *EDGE_IDS])
def test_split_operands_within_1e5(case):
    H, Hkv, N, M, dh, causal = case
    args = _inputs(20, H, Hkv, N, M, dh, causal)
    errs = _rel_errs(_split_bwd(*args, causal), _plain_bwd(*args, causal), M)
    assert max(errs) <= SPLIT_TOL, errs


def test_single_bf16_operands_exceed_bwd_rel_tol():
    """One bf16 value for P and dS puts each of dq, dk and dv over
    chip_smoke's limit at qwen2's N 4096, the split under a hundredth of
    it."""
    H, Hkv, N, M, dh, causal = QWEN2_HEAD
    args = _inputs(20, H, Hkv, N, M, dh, causal)
    ref = _plain_bwd(*args, causal)
    single = _rel_errs(_split_bwd(*args, causal, pairs=False), ref, M)
    split = _rel_errs(_split_bwd(*args, causal), ref, M)
    assert min(single) > chip_smoke.BWD_REL_TOL, single
    assert max(split) < chip_smoke.BWD_REL_TOL / 100, split


@pytest.mark.parametrize("case", [QWEN2_HEAD, *EDGE_CASES],
                         ids=["qwen2-head-N4096-dh64", *EDGE_IDS])
def test_row_check_passes_the_split_and_refuses_one_bf16(case):
    H, Hkv, N, M, dh, causal = case
    args = _inputs(20, H, Hkv, N, M, dh, causal)
    ref = _plain_bwd(*args, causal)
    split = chip_smoke.grad_row_errs(_split_bwd(*args, causal), ref, causal)
    single = chip_smoke.grad_row_errs(
        _split_bwd(*args, causal, pairs=False), ref, causal)
    assert max(split) <= chip_smoke.BWD_ROW_REL_TOL / 10, split
    assert min(single) > chip_smoke.BWD_ROW_REL_TOL, single


@pytest.mark.parametrize("which", [1, 2], ids=["dk", "dv"])
def test_row_check_refuses_an_unwritten_last_key_row(which):
    """At qwen2's N 4096 (causal), dk or dv with its last key row left at
    zero: under BWD_REL_TOL of the largest value, refused row by row."""
    H, Hkv, N, M, dh, causal = QWEN2_HEAD
    args = _inputs(20, H, Hkv, N, M, dh, causal)
    ref = _plain_bwd(*args, causal)
    got = list(_split_bwd(*args, causal))
    got[which] = got[which].clone()
    got[which][..., -1, :] = 0.0
    assert max(_rel_errs(got, ref, M)) <= chip_smoke.BWD_REL_TOL
    rows = chip_smoke.grad_row_errs(got, ref, causal)
    assert rows[which] > 100 * chip_smoke.BWD_ROW_REL_TOL, rows


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_matches_pallas_backward(causal):
    """The split (group-summed) against the Pallas `_bwd_call` in
    interpret mode on the same bf16-valued inputs in fp32, fed the Pallas
    forward's out and lse."""
    H, Hkv, N, M, dh = 4, 2, 256, 256, 64
    q, k, v, do, _, _ = _inputs(21, H, Hkv, N, M, dh, causal)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    j_out, j_lse = jax_flash._fwd_call(jq, jk, jv, causal, 128, 128, True)
    j_grads = [np.array(g, np.float32) for g in jax_flash._bwd_call(
        jq, jk, jv, j_out, j_lse, jdo, causal, 128, 128, True)]
    lse = torch.from_numpy(np.array(j_lse)).reshape(1, H, N)
    dsum = row_dot(do.float(), torch.from_numpy(np.array(j_out)))
    args = (q, k, v, do, lse, dsum)
    dq, dk, dv = _split_bwd(*args, causal)
    got = (dq, common.group_sum(dk, Hkv), common.group_sum(dv, Hkv))
    errs = _rel_errs(got, [torch.from_numpy(g) for g in j_grads], M)
    assert max(errs) <= FP32_TOL, errs
