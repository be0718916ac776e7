"""The bf16 flash forward at dh 80 (hubert-xlarge's heads) on its own
kernel width, on the CPU, against the JAX package.

In bf16 all three flash kernels have a dh-80 instance
(`flash_attention.BF16_WIDTHS`); fp32 keeps the dh-64 and dh-128 ones
(`WIDTHS`), dh 80 zero-padded to 128. The CPU takes the card's widths for
the same dtype, so here:

* a bf16 dh-80 forward runs `flash_attention_plain` at width 80 and never
  calls `common.pad_heads`; a bf16 dh 72 pads to 80, dh 96 to 128, dh 64
  runs as it is; an fp32 dh 80 pads to 128. Each output comes back dh
  wide and matches the plain version at the true dh, unpadded;
* the bf16 dh-80 `flash_attention` (out, lse) matches the Pallas
  `_fwd_call` in interpret mode on the same bf16-rounded values in fp32,
  non-causal and causal, MHA 4:4 and GQA 4:1;
* the kernel-side checks (`_dims`) take 80 for the bf16 forward.

OUT_REL_TOL: the port rounds its output to bf16 (half an ulp, 2^-9 of a
value) and the Pallas kernel keeps fp32; both compute in fp32 from the
same values in another order, so out may differ by 2^-7 of its largest
value (two bf16 ulps at the top of the range, chip_smoke.py's
OUT_REL_TOL), where a misplaced column or a wrong scale reads O(1).
LSE_TOL: lse stays fp32 on both sides, only the order of the sums
differs (chip_smoke.py's LSE_TOL, 1e-4 absolute).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro_torch.kernels import common
from repro_torch.kernels import flash_attention as flash_k

OUT_REL_TOL = 2.0 ** -7
LSE_TOL = 1e-4
# (causal, H, Hkv)
CASES = [(False, 4, 4), (True, 4, 4), (False, 4, 1), (True, 4, 1)]
IDS = [f"{'causal' if c else 'full'}-H{h}kv{g}" for c, h, g in CASES]


def _inputs(seed, H, Hkv, dh, N=32):
    """bf16-rounded q, k, v as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, N, dh))
    k, v = (rng.standard_normal((1, Hkv, N, dh)) for _ in range(2))
    return [torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
            for x in (q, k, v)]


def _spy(monkeypatch):
    """Records the width the plain forward is called at, and each
    `common.pad_heads` call, in the order they come."""
    calls = []
    plain = flash_k.flash_attention_plain

    def spy(*a, **kw):
        calls.append(("flash_attention_plain", a[0].shape[-1]))
        return plain(*a, **kw)
    monkeypatch.setattr(flash_k, "flash_attention_plain", spy)
    pad = common.pad_heads

    def pad_spy(what, dh, *ts, **kw):
        calls.append(("pad_heads", dh))
        return pad(what, dh, *ts, **kw)
    monkeypatch.setattr(common, "pad_heads", pad_spy)
    return calls


@pytest.mark.parametrize("dtype,dh,width", [
    (torch.bfloat16, 80, 80), (torch.bfloat16, 72, 80),
    (torch.bfloat16, 96, 128), (torch.bfloat16, 64, 64),
    (torch.float32, 80, 128)],
    ids=["bf16-80", "bf16-72", "bf16-96", "bf16-64", "fp32-80"])
def test_forward_widths_by_dtype(dtype, dh, width, monkeypatch):
    """The forward runs its plain version at the kernel width of its dtype,
    padding only a head dim that is not one; out comes back dh wide and,
    with lse, matches the plain version at the true dh, unpadded."""
    calls = _spy(monkeypatch)
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _inputs(dh, 2, 1, dh, N=24))
    out, lse = flash_k.flash_attention(q, k, v, True)
    pads = [("pad_heads", dh)] if dh != width else []
    assert calls == [*pads, ("flash_attention_plain", width)]
    ref_out, ref_lse = flash_k.ref.full_attention(
        q.float(), k.float(), v.float(), True, return_lse=True,
        scale=common.head_scale(dh))
    assert out.dtype == dtype and out.shape == q.shape
    # zero columns add exact zeros to the scores: the padded and unpadded
    # plain versions differ by the order of fp32 sums at most, and bf16
    # rounds the output once (OUT_REL_TOL)
    tol = OUT_REL_TOL if dtype == torch.bfloat16 else 1e-6
    err = float((out.float() - ref_out).abs().max() / ref_out.abs().max())
    assert err <= tol, err
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal,H,Hkv", CASES, ids=IDS)
def test_bf16_dh80_forward_matches_pallas(causal, H, Hkv):
    """The bf16 dh-80 forward (unpadded) against the Pallas kernel in
    interpret mode on the same values in fp32."""
    q, k, v = _inputs(181 + H + Hkv + causal, H, Hkv, 80)
    j_out, j_lse = jax_flash._fwd_call(*map(jnp.asarray, (q, k, v)), causal,
                                       16, 16, True)
    j_out = np.asarray(j_out)
    out, lse = flash_k.flash_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = np.abs(out.float().numpy() - j_out).max() / np.abs(j_out).max()
    assert err <= OUT_REL_TOL, err
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(j_lse).reshape(q.shape[:3]),
                               rtol=0, atol=LSE_TOL)


def test_dims_take_80_for_the_bf16_forward():
    q = torch.zeros(1, 2, 8, 80, dtype=torch.bfloat16)
    assert flash_k._widths(q) == flash_k.BF16_WIDTHS == (64, 80, 128)
    dims = flash_k._dims("flash_attention", q, q, flash_k._widths(q))
    assert dims[-2:] == (80, common.DTYPE_CODES[torch.bfloat16])
    with pytest.raises(ValueError, match="head_dim 80 unsupported"):
        flash_k._dims("flash_attention", q.float(), q.float(),
                      flash_k._widths(q.float()))
