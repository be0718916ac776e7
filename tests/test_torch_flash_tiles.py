"""The flash kernels at the shapes their 128-row tiles make ragged.

The bf16 flash forward (``csrc/flash_attention.cu``) takes 128 query rows
per block and walks key tiles of 128 rows, masking the ragged last tile and
the tiles that cross the diagonal; `chip_smoke.py` holds it and the two
backward kernels to their plain versions on the card (`check_flash`,
`check_flash_edges`). On the CPU the wrappers run those plain versions
(``core/attention.py``). Here, on the same numpy inputs, at N and M of 1,
127, 129 and 200 (M != N with the causal mask on row indices), GQA 14:2 and
7:1, dh 64 and 128, in fp32 and bf16:

* `flash_attention_plain` and `flash_attention` (out, lse) against the JAX
  package's Pallas forward `_fwd_call` in interpret mode;
* the backward kernels' plain versions and the group sum
  (`flash_attention_bwd`) against its Pallas backward `_bwd_call`, both fed
  the Pallas forward's out and lse;
* the `FlashAttention` Function, forward and gradients, against
  ``jax.vjp`` of the Pallas `flash_attention`;
* `flash_attention_bwd_dkv` returns dk and dv per *query* head, (B, H, M,
  dh) in fp32, also for bf16 inputs, and their GQA group sums are the
  backward's dk and dv exactly;
* chip_smoke's bf16 qwen2 gate passes the sound path and refuses its
  negative control;
* chip_smoke's row-by-row output check (`ROW_REL_TOL`) passes the bf16
  forward and refuses a misplaced value tile in a late row, an error the
  largest-value limit `OUT_REL_TOL` can miss at N 4096.

The Pallas kernel takes blocks that divide N and M: each call gets the
largest divisor up to 128. Every difference of an output or a gradient is
taken relative to the largest reference value of that output. With a
single key (M = 1) dq and dk are zero in exact arithmetic (a softmax over
one key has no gradient), so both read as rounding and are scaled by dv's
largest reference value.

Tolerances, and why:

* fp32 1e-5, also on lse (relative to its largest value): the frameworks
  sum the same fp32 products in other orders.
* bf16 2^-7 on outputs and gradients: both sides compute in fp32 from the
  same bf16 inputs (the Pallas kernels upcast q, k, v and do) and each
  rounds its bf16 results once, half a bf16 ulp (2^-9 of the value) each,
  so 2^-7 of the largest value is two ulps at the top of the range; the
  Function's gradients are rounded to bf16 too. The same limit as
  chip_smoke's `OUT_REL_TOL`.
* bf16 lse 1e-4 absolute: lse stays fp32 on both sides (chip_smoke's
  `LSE_TOL`).

The plain bf16 forward used to run its einsums in bf16, rounding the logits
and P, and read up to 1.30e-2 of the largest output and 9.7e-3 on lse
against the Pallas kernel at these cases; it now upcasts as the Pallas
kernel does and reads at most 1.14e-3 and 1.2e-6, so
`test_flash_forward_ragged_matches_pallas` holds it to the limits above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as flash_k

FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
BF16_LSE_TOL = 1e-4
DTYPES = ["float32", "bfloat16"]
# (causal, H, Hkv, N, M, dh)
TILE_CASES = [(True, 14, 2, 127, 129, 64), (False, 7, 1, 200, 127, 64),
              (True, 7, 1, 129, 200, 128), (False, 14, 2, 200, 1, 128),
              (True, 14, 2, 1, 1, 64), (True, 14, 2, 200, 200, 128)]
TILE_IDS = [f"{'causal' if c else 'full'}-H{h}kv{g}-N{n}M{m}-dh{d}"
            for c, h, g, n, m, d in TILE_CASES]


def _block(n):
    """The largest divisor of n up to 128: the Pallas kernel's block."""
    return max(d for d in range(1, min(n, 128) + 1) if n % d == 0)


def _inputs(seed, H, Hkv, N, M, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((1, H, N, dh), (1, Hkv, M, dh),
                               (1, Hkv, M, dh), (1, H, N, dh)))


def _t(x, dtype):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x, dtype=dtype)


def _assert_rel(got, want, tol, scale=None):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale, tol)


def _assert_grads(got, want, M, tol):
    """dq, dk, dv against their references; with M = 1 dq and dk are
    scaled by dv's largest reference value."""
    dv_scale = float(np.abs(np.asarray(want[2], np.float32)).max())
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_rel(g, w, tol, dv_scale if M == 1 and i < 2 else None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,H,Hkv,N,M,dh", TILE_CASES, ids=TILE_IDS)
def test_flash_forward_ragged_matches_pallas(causal, H, Hkv, N, M, dh,
                                             dtype):
    """The plain forward and the wrapper on CPU tensors (which runs it)
    against the Pallas forward: in bf16 within 2^-7 of the largest output
    and 1e-4 on lse, as the plain version computes in fp32 and rounds only
    the output."""
    q, k, v, _ = _inputs(51, H, Hkv, N, M, dh)
    j_out, j_lse = jax_flash._fwd_call(_j(q, dtype), _j(k, dtype),
                                       _j(v, dtype), causal, _block(N),
                                       _block(M), True)
    inputs = (_t(q, dtype), _t(k, dtype), _t(v, dtype))
    for out, lse in (flash_k.flash_attention_plain(*inputs, causal),
                     flash_k.flash_attention(*inputs, causal)):
        assert out.dtype == getattr(torch, dtype)
        assert lse.dtype == torch.float32
        j_l = np.asarray(j_lse, np.float32).reshape(lse.shape)
        if dtype == "float32":
            _assert_rel(out, j_out, FP32_TOL)
            _assert_rel(lse, j_l, FP32_TOL)
        else:
            _assert_rel(out, j_out, BF16_TOL)
            assert float(np.abs(lse.numpy() - j_l).max()) <= BF16_LSE_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,H,Hkv,N,M,dh", TILE_CASES, ids=TILE_IDS)
def test_flash_backward_ragged_matches_pallas(causal, H, Hkv, N, M, dh,
                                              dtype):
    """Both backward kernels' plain versions and the group sum against the
    Pallas backward, both on the Pallas forward's out and lse."""
    q, k, v, do = _inputs(52, H, Hkv, N, M, dh)
    jq, jk, jv, jdo = (_j(x, dtype) for x in (q, k, v, do))
    j_out, j_lse = jax_flash._fwd_call(jq, jk, jv, causal, _block(N),
                                       _block(M), True)
    j_grads = jax_flash._bwd_call(jq, jk, jv, j_out, j_lse, jdo, causal,
                                  _block(N), _block(M), True)
    lse = torch.from_numpy(np.array(j_lse)).reshape(1, H, N)
    grads = flash_k.flash_attention_bwd(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), _t(j_out, dtype), lse,
        _t(do, dtype), causal)
    _assert_grads(grads, j_grads, M,
                  FP32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,H,Hkv,N,M,dh", TILE_CASES, ids=TILE_IDS)
def test_flash_function_ragged_matches_pallas_vjp(causal, H, Hkv, N, M, dh,
                                                  dtype):
    q, k, v, do = _inputs(53, H, Hkv, N, M, dh)
    j_out, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal, bq=_block(N), bk=_block(M), interpret=True),
        *(_j(x, dtype) for x in (q, k, v)))
    j_grads = vjp(_j(do, dtype))
    leaves = [_t(x, dtype).requires_grad_(True) for x in (q, k, v)]
    out = flash_k.FlashAttention.apply(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, _t(do, dtype))
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    _assert_rel(out.detach(), j_out, tol)
    for g, leaf in zip(grads, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
    _assert_grads(grads, j_grads, M, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,H,Hkv,N,M,dh",
                         [(True, 14, 2, 200, 200, 128),
                          (True, 7, 1, 129, 200, 64)],
                         ids=["causal-H14kv2-N200M200-dh128",
                              "causal-H7kv1-N129M200-dh64"])
def test_flash_dkv_is_per_query_head_fp32(causal, H, Hkv, N, M, dh, dtype):
    """dk and dv per *query* head, (B, H, M, dh) fp32, whose GQA group sums
    are the backward's dk and dv."""
    q, k, v, do = (_t(x, dtype) for x in _inputs(54, H, Hkv, N, M, dh))
    out, lse = flash_k.flash_attention(q, k, v, causal)
    dsum = (do.float() * out.float()).sum(-1)
    dk, dv = flash_k.flash_attention_bwd_dkv(q, k, v, do, lse, dsum, causal)
    for g in (dk, dv):
        assert g.shape == (1, H, M, dh) and g.dtype == torch.float32
    _, gk, gv = flash_k.flash_attention_bwd(q, k, v, out, lse, do, causal)
    for per_head, summed in ((dk, gk), (dv, gv)):
        torch.testing.assert_close(
            per_head.reshape(1, Hkv, H // Hkv, M, dh).sum(2), summed,
            rtol=0, atol=0)


def test_bf16_gate_refuses_first_query_head_only(monkeypatch):
    """chip_smoke's bf16 qwen2 gate on reduced qwen2 in bf16, with the
    kernel backend's glue forced on the CPU (the Function over the plain
    versions): it passes the sound path, SDPA in place of the flash
    kernels reads a nonzero yardstick, the path repeats itself exactly,
    and the negative control reads far above the limit."""
    import chip_smoke
    from repro_torch import attn
    from repro_torch.configs import reduced_config, with_overrides
    from repro_torch.models.model import init_model
    resolve = attn.resolve
    monkeypatch.setattr(attn, "resolve", lambda *a, platform=None, **kw:
                        resolve(*a, platform="cuda", **kw))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cfg = with_overrides(reduced_config("qwen2-0.5b"), dtype="bfloat16")
    params, kstate = init_model(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(55).integers(0, cfg.vocab_size, (2, 65))
    out = chip_smoke.full_train_gate_bf16(torch, cfg, params, kstate,
                                          {"tokens": torch.from_numpy(tokens)})
    assert out["sdpa"]["grad_rel_median"] > 0
    assert out["kernel"]["grad_rel_median"] <= out["grad_median_limit"]
    assert out["repeat"]["grad_rel_max"] == 0
    assert out["first_head_only"]["grad_rel_median"] > 5 * out[
        "grad_median_limit"]


def test_row_check_refuses_a_misplaced_value_tile():
    """At qwen2's N 4096 (one kv head, dh 64, causal, bf16) the bf16
    forward reads ~2^-9 row by row; the last query row with keys 256..383
    given the values of keys 384..511 (one 128-key value tile misplaced)
    moves that row by ~30%, an error that can stay under OUT_REL_TOL of
    the largest output (an early row's); chip_smoke's row check refuses
    it."""
    import chip_smoke
    q, k, v, _ = _inputs(7, 2, 1, 4096, 4096, 64)
    q, k, v = (_t(x, "bfloat16") for x in (q, k, v))
    ref, _ = flash_k.flash_attention_plain(q.float(), k.float(), v.float())
    out, _ = flash_k.flash_attention(q, k, v)
    assert chip_smoke.out_ok(out, ref)
    assert chip_smoke.row_rel_err(out, ref) <= chip_smoke.ROW_REL_TOL
    v_bad = v.clone()
    v_bad[..., 256:384, :] = v[..., 384:512, :]
    ref_bad, _ = flash_k.flash_attention_plain(q.float(), k.float(),
                                               v_bad.float())
    bad = out.clone()
    bad[..., -1, :] = ref_bad[..., -1, :].to(bad.dtype)
    assert chip_smoke.row_rel_err(bad, ref) > 10 * chip_smoke.ROW_REL_TOL
