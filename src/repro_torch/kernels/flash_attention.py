"""Dense (full) flash attention: wrappers of the CUDA kernels
``csrc/flash_attention.cu`` (forward; replaces the TPU kernel `_kernel` of
the JAX package's ``kernels/flash_attention.py``) and
``csrc/flash_attention_bwd.cu`` (replaces `_bwd_dq_kernel` and
`_bwd_dkv_kernel`), and `FlashAttention`, the autograd Function over them.

`flash_attention` takes q (B,H,N,dh), k/v (B,Hkv,M,dh) and returns (out
(B,H,N,dh) in q's dtype, lse (B,H,N) fp32). Scale 1/sqrt(dh); the causal
mask compares row indices (query row i sees key rows j <= i, also when
M != N), as the TPU kernel does. Any N, M >= 1. Every wrapper sends a CPU
tensor to its plain PyTorch version (``core/attention.py``) and launches
its kernel on a CUDA tensor, or raises.

The kernels have dh-64 and dh-128 instances (`WIDTHS`), and in bf16 all
three one of dh 80 too (`BF16_WIDTHS`: hubert-xlarge's heads, whose
tensor maps read the rows at their true width; TMA fills the tiles'
columns past 80 with zeros in shared memory). Any other head dim up to
128 runs zero-padded to the next width of its dtype (`common.pad_heads`)
with the scale of its true head dim (`common.head_scale`, passed to the
kernels), and out, dq, dk and dv are cut back to it; zero columns change
no score, and the gradients' pad columns come out zero. The CPU takes the
card's widths for the same dtype, so the CPU tests go through the
padding, or its absence, as the card does: a bf16 dh-80 forward or
backward runs its plain versions at 80, and never pads; fp32 pads dh 80
to 128. On the card a head dim over 128 raises; on the CPU it runs the
plain version unpadded.

All three kernels do 4 to 8 * dh flops per attended pair on inputs read
once, far above the card's bf16 ridge, so the tensor cores bound them. The
dtype alone picks each kernel's design. In bf16 all three run ``wgmma`` on
tiles that TMA loads (``csrc/sm90.cuh``), with the softmax and the
backward's P and dS in fp32 on the accumulators: the forward rounds P to
bf16 as the operand of P V, as SDPA does; the dq and dk/dv kernels feed P
and dS to their products as hi + lo bf16 pairs, which keeps dq, dk and dv
within a few 1e-5 of their largest fp32 value, where one bf16 value each
would put them 1.4-2.6e-3 off (chip_smoke.py allows 1e-3). In fp32 they
keep the FMA tiles (`FlashTile`, `DqTile`, `DkvTile`) shared with the
local-window and routing kernels, whose products stay full fp32, as
PyTorch's fp32 matmul does (no TF32). TMA needs 16-byte aligned bases and
row strides: the wrappers take contiguous, 16-byte aligned tensors
(checked before the padding, whose copies are fresh allocations), and
the widths 64, 80 and 128 give rows of 128, 160 or 256 bytes in bf16.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import attention as ref
from repro_torch.core import row_dot, upcast
from repro_torch.kernels import common as C
from repro_torch.obs.trace import span

# the kernels' head-dim instances (`common.SUPPORTED_HEAD_DIMS`), and the
# bf16 kernels' (dh 80 on its own instance)
WIDTHS = C.SUPPORTED_HEAD_DIMS
BF16_WIDTHS = (64, 80, 128)
LAUNCHES = C.counter("flash_attention")
LAUNCHES_BWD_DQ = C.counter("flash_attention_bwd_dq")
LAUNCHES_BWD_DKV = C.counter("flash_attention_bwd_dkv")

# pointers, then the ints (.., dtype), then the scale and the stream
_TAIL = [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + _TAIL
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + _TAIL
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + _TAIL


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: Optional[float] = None):
    """The plain PyTorch version of the forward kernel: (out in q's dtype,
    lse in at least fp32). It computes in at least fp32 and rounds only
    the output, as the TPU kernel does (it upcasts q, k and v). ``scale``
    defaults to 1 / sqrt(dh)."""
    out, lse = ref.full_attention(upcast(q), upcast(k), upcast(v), causal,
                                  return_lse=True, scale=scale)
    return out.to(q.dtype), lse


# the plain PyTorch versions of the two backward kernels
flash_attention_bwd_dq_plain = ref.full_attention_bwd_dq
flash_attention_bwd_dkv_plain = ref.full_attention_bwd_dkv


def _widths(q):
    """The kernels' head-dim instances for ``q``'s dtype."""
    return BF16_WIDTHS if q.dtype == torch.bfloat16 else WIDTHS


def _padded(what, dh, *tensors, widths):
    """``tensors`` zero-padded to the kernel width of ``dh`` (the first
    of ``widths`` that holds it); at a width, and in a CPU call wider than
    the widest, they pass as they are, with no call to `pad_heads`."""
    if dh in widths or (tensors[0].device.type == "cpu"
                        and dh > widths[-1]):
        return tensors
    return C.pad_heads(what, dh, *tensors, widths=widths)


def _check(what, q, k, v, **more):
    B, H, N, dh = q.shape
    Hkv, M = k.shape[1], k.shape[2]
    # the message is built only when the check fails (`C.check_tensors`)
    if not (k.shape == v.shape == (B, Hkv, M, dh) and H % Hkv == 0
            and N > 0 and M > 0):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    C.require(q.dtype == k.dtype == v.dtype, f"{what}: mixed dtypes")
    C.check_tensors(what, q=q, k=k, v=v, **more)


def _dims(what, q, k, widths):
    B, H, N, dh = q.shape
    C.head_dim_ok(what, dh, widths)
    return B, H, k.shape[1], N, k.shape[2], dh, C.dtype_code(what, q)


@span("kernels/flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    what = "flash_attention"
    _check(what, q, k, v)
    dh = q.shape[-1]
    scale = C.head_scale(dh)
    widths = _widths(q)
    q, k, v = _padded(what, dh, q, k, v, widths=widths)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal, scale)
        return C.unpad_heads(dh, out)[0], lse
    B, H, Hkv, N, M, width, code = _dims(what, q, k, widths)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    fn = C.load("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(C.ptr(q), C.ptr(k), C.ptr(v), C.ptr(out), C.ptr(lse), B, H,
             Hkv, N, M, width, int(causal), code, scale, C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return C.unpad_heads(dh, out)[0], lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def _check_bwd(what, q, k, v, do, lse, dsum):
    B, H, N, _ = q.shape
    C.require(do.shape == q.shape and do.dtype == q.dtype,
              f"{what}: do must match q")
    C.require(lse.shape == dsum.shape == (B, H, N)
              and lse.dtype == dsum.dtype == upcast(q).dtype,
              f"{what}: lse and D must be (B, H, N) in q's accumulation "
              f"dtype")
    _check(what, q, k, v, do=do, lse=lse, dsum=dsum)


def flash_attention_bwd_dq(q, k, v, do, lse, dsum, causal: bool = True):
    """dq (B,H,N,dh) fp32 from the forward's lse and D = rowsum(do * out)
    (both (B,H,N) fp32)."""
    what = "flash_attention_bwd_dq"
    _check_bwd(what, q, k, v, do, lse, dsum)
    dh = q.shape[-1]
    scale = C.head_scale(dh)
    widths = _widths(q)
    q, k, v, do = _padded(what, dh, q, k, v, do, widths=widths)
    if q.device.type == "cpu":
        return C.unpad_heads(dh, flash_attention_bwd_dq_plain(
            q, k, v, do, lse, dsum, causal, scale))[0]
    B, H, Hkv, N, M, width, code = _dims(what, q, k, widths)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = C.load("flash_attention_bwd", "flash_attention_bwd_dq",
                _DQ_ARGTYPES)
    err = fn(C.ptr(q), C.ptr(k), C.ptr(v), C.ptr(do), C.ptr(lse),
             C.ptr(dsum), C.ptr(dq), B, H, Hkv, N, M, width, int(causal),
             code, scale, C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DQ.bump()
    return C.unpad_heads(dh, dq)[0]


def flash_attention_bwd_dkv(q, k, v, do, lse, dsum, causal: bool = True):
    """(dk, dv) per *query* head (B,H,M,dh) fp32; `flash_attention_bwd`
    sums them over each kv head's query group."""
    what = "flash_attention_bwd_dkv"
    _check_bwd(what, q, k, v, do, lse, dsum)
    dh = q.shape[-1]
    scale = C.head_scale(dh)
    widths = _widths(q)
    q, k, v, do = _padded(what, dh, q, k, v, do, widths=widths)
    if q.device.type == "cpu":
        return C.unpad_heads(dh, *flash_attention_bwd_dkv_plain(
            q, k, v, do, lse, dsum, causal, scale))
    B, H, Hkv, N, M, width, code = _dims(what, q, k, widths)
    dk = torch.empty((B, H, M, width), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    fn = C.load("flash_attention_bwd", "flash_attention_bwd_dkv",
                _DKV_ARGTYPES)
    err = fn(C.ptr(q), C.ptr(k), C.ptr(v), C.ptr(do), C.ptr(lse),
             C.ptr(dsum), C.ptr(dk), C.ptr(dv), B, H, Hkv, N, M, width,
             int(causal), code, scale, C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DKV.bump()
    return C.unpad_heads(dh, dk, dv)


@span("kernels/flash_attention_bwd")
def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True):
    """(dq (B,H,N,dh), dk, dv (B,Hkv,M,dh)) in at least fp32 through the
    two backward kernels (their plain versions for CPU tensors)."""
    dsum = row_dot(do, out)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, dsum, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dsum, causal)
    return dq, C.group_sum(dk, k.shape[1]), C.group_sum(dv, k.shape[1])


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool = True):
    """The plain PyTorch version of the whole backward (both kernels and
    the group sum): recomputes p from the saved lse, as the kernels do."""
    dsum = row_dot(do, out)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, dsum, causal)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, dsum, causal)
    return dq, C.group_sum(dk, k.shape[1]), C.group_sum(dv, k.shape[1])


class FlashAttention(torch.autograd.Function):
    """Differentiable dense attention through the kernels:
    ``FlashAttention.apply(q, k, v, causal)`` -> out."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None
