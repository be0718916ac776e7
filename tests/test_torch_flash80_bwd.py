"""The bf16 flash backward at dh 80 (hubert-xlarge's heads) on its own
kernel width, on the CPU, against the JAX package.

The bf16 flash kernels, the dq and dk/dv kernels among them, have a
dh-80 instance (`flash_attention.BF16_WIDTHS`); fp32 keeps the dh-64 and
dh-128 ones (`WIDTHS`), dh 80 zero-padded to 128. The CPU takes the
card's widths for the same dtype, so here:

* a bf16 dh-80 backward runs the plain dq and dk/dv versions at width 80
  and never calls `common.pad_heads`, nor does its forward
  (tests/test_torch_flash80_fwd.py holds the forward); fp32 runs all
  three at 128 (tests/test_torch_encoder.py holds fp32); a bf16 dh 72
  pads to 80, dh 96 to 128;
* the `FlashAttention` gradients of bf16 dh-80 inputs (through the plain
  versions) match ``jax.vjp`` of the Pallas `flash_attention` in interpret
  mode on the same values upcast to fp32, non-causal and causal, MHA and
  GQA 4:1, within GRAD_REL_TOL of each gradient's largest value;
* the kernel-side checks (`_dims`) take 80 for bf16 only.

GRAD_REL_TOL: the port's Function rounds the forward's output to bf16
before D = rowsum(do * out) and returns bf16 gradients, each a rounding of
2^-9 of a value; the JAX reference keeps fp32 throughout. Readings are
1.3-4.1e-3 of the largest value; 2^-7 (7.8e-3: two bf16 ulps at the top
of the range, chip_smoke.py's OUT_REL_TOL) holds them, and a gradient at
the wrong scale or from a misplaced column reads O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro_torch.kernels import common
from repro_torch.kernels import flash_attention as flash_k

GRAD_REL_TOL = 2.0 ** -7
# (causal, H, Hkv)
CASES = [(False, 4, 4), (True, 4, 4), (False, 4, 1), (True, 4, 1)]
IDS = [f"{'causal' if c else 'full'}-H{h}kv{g}" for c, h, g in CASES]


def _inputs(seed, H, Hkv, dh, N=32):
    """bf16-rounded q, k, v, do as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, H, N, dh)) for _ in range(2))
    k, v = (rng.standard_normal((1, Hkv, N, dh)) for _ in range(2))
    return [torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
            for x in (q, k, v, do)]


def _spy(monkeypatch):
    """Records the width each plain version is called at, and each
    `common.pad_heads` call, in the order they come."""
    calls = []
    for name in ("flash_attention_plain", "flash_attention_bwd_dq_plain",
                 "flash_attention_bwd_dkv_plain"):
        def spy(*a, _f=getattr(flash_k, name), _n=name, **kw):
            calls.append((_n, a[0].shape[-1]))
            return _f(*a, **kw)
        monkeypatch.setattr(flash_k, name, spy)
    pad = common.pad_heads

    def pad_spy(what, dh, *ts, **kw):
        calls.append(("pad_heads", dh))
        return pad(what, dh, *ts, **kw)
    monkeypatch.setattr(common, "pad_heads", pad_spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_backward_widths_by_dtype(dtype, monkeypatch):
    """bf16: forward, dq and dk/dv at 80 with no pad; fp32: all three
    padded to 128. Every output dh-80 wide."""
    calls = _spy(monkeypatch)
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(80, 2, 2, 80))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = flash_k.FlashAttention.apply(*leaves, False)
    fwd = list(calls)
    grads = torch.autograd.grad(out, leaves, do)
    bwd = calls[len(fwd):]
    assert out.shape == q.shape and all(g.shape == q.shape for g in grads)
    if dtype == torch.bfloat16:
        assert fwd == [("flash_attention_plain", 80)]
        assert bwd == [("flash_attention_bwd_dq_plain", 80),
                       ("flash_attention_bwd_dkv_plain", 80)]
    else:
        assert fwd == [("pad_heads", 80), ("flash_attention_plain", 128)]
        assert bwd == [("pad_heads", 80), ("flash_attention_bwd_dq_plain", 128),
                       ("pad_heads", 80),
                       ("flash_attention_bwd_dkv_plain", 128)]


@pytest.mark.parametrize("dh,width", [(72, 80), (96, 128), (64, 64)])
def test_bf16_backward_pads_to_the_next_width(dh, width, monkeypatch):
    """A bf16 head dim between the backward's widths pads to the next one
    (80 or 128), a width itself runs as it is; dq, dk and dv come back dh
    wide and match the unpadded plain versions."""
    calls = _spy(monkeypatch)
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(dh, 2, 1, dh, N=24))
    lse = torch.randn(1, 2, 24)
    dsum = torch.randn(1, 2, 24)
    dq = flash_k.flash_attention_bwd_dq(q, k, v, do, lse, dsum, True)
    dk, dv = flash_k.flash_attention_bwd_dkv(q, k, v, do, lse, dsum, True)
    pads = [("pad_heads", dh)] if dh != width else []
    assert calls == [*pads, ("flash_attention_bwd_dq_plain", width),
                     *pads, ("flash_attention_bwd_dkv_plain", width)]
    scale = common.head_scale(dh)
    ref_dq = flash_k.ref.full_attention_bwd_dq(q, k, v, do, lse, dsum, True,
                                               scale)
    ref_dk, ref_dv = flash_k.ref.full_attention_bwd_dkv(q, k, v, do, lse,
                                                        dsum, True, scale)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.shape[-1] == dh
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal,H,Hkv", CASES, ids=IDS)
def test_bf16_dh80_grads_match_pallas_vjp(causal, H, Hkv):
    """The Function's bf16 gradients at dh 80 (dq and dk/dv unpadded)
    against jax.vjp of the Pallas kernel on the same values in fp32."""
    q, k, v, do = _inputs(81 + H + Hkv + causal, H, Hkv, 80)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal, bq=16, bk=16, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_(True)
              for x in (q, k, v)]
    grads = torch.autograd.grad(flash_k.FlashAttention.apply(*leaves, causal),
                                leaves, torch.from_numpy(do).bfloat16())
    for g, jg, x in zip(grads, vjp(jnp.asarray(do)), (q, k, v)):
        jg = np.asarray(jg)
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        err = np.abs(g.float().numpy() - jg).max() / np.abs(jg).max()
        assert err <= GRAD_REL_TOL, err


def test_kernel_checks_take_80_for_the_bf16_backward_only():
    """The bf16 backward takes 80 (as the bf16 forward now does:
    tests/test_torch_flash80_fwd.py); fp32 refuses it."""
    q = torch.zeros(1, 2, 8, 80, dtype=torch.bfloat16)
    dims = flash_k._dims("bwd", q, q, flash_k.BF16_WIDTHS)
    assert dims[-2:] == (80, common.DTYPE_CODES[torch.bfloat16])
    assert flash_k._widths(q) == (64, 80, 128)
    assert flash_k._widths(q.float()) == flash_k.WIDTHS == (64, 128)
    with pytest.raises(ValueError, match="head_dim 80 unsupported"):
        flash_k._dims("bwd", q.float(), q.float(), flash_k.WIDTHS)
