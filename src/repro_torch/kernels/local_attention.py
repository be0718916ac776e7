"""Blocked local-window attention: wrappers of the CUDA kernels
``csrc/local_attention.cu`` (forward; replaces the TPU kernel `_kernel` of
the JAX package's ``kernels/local_attention.py``) and
``csrc/local_attention_bwd.cu`` (replaces `_bwd_dq_kernel` and
`_bwd_dkv_kernel`), and `LocalAttention`, the autograd Function over them.

`local_attention` takes q (B,H,N,dh), k/v (B,Hkv,N,dh) and returns
(out (B,H,N,dh), lse (B,H,N) fp32). Any N (a ragged last block is masked in
the kernels) and an optional (B,N) key pad mask are taken, forward and
backward alike. Every wrapper sends a CPU tensor to its plain PyTorch
version (``core/local.py``) and launches its kernel on a CUDA tensor, or
raises.

The dtype alone picks each kernel's design. In bf16 they run ``wgmma`` on
tiles that TMA loads, each block walking only its rows' windows: the
forward with the flash forward's body (``csrc/attn_fwd_sm90.cuh``), P
rounded to bf16 as the operand of P V; dq and dk/dv with the backward
bodies the flash and gathered backwards run (``csrc/attn_bwd_sm90.cuh``),
P and dS fed to their products as hi + lo bf16 pairs. In fp32 they run the
FMA tiles `FlashTile`, `DqTile` and `DkvTile`. TMA needs 16-byte aligned
bases and row strides: the wrappers take contiguous, 16-byte aligned
tensors (checked), and the kernels' widths dh 64, 128, 192 or 256 give
rows of 128, 256, 384 or 512 bytes in bf16. Any other head dim up to 256
(rt-pg19's 129) runs zero-padded to the next width (`common.pad_heads`,
on both devices), with the scale of the true head dim, and the outputs
are cut back to it. At dh 256 (recurrentgemma-9b's local-attention
layers) the bf16 kernels run the same tensor-core bodies: dq walks 32-row
key tiles, dk/dv sweeps its query tiles twice, over one half of dK's and
dV's columns each time (``csrc/attn_bwd_sm90.cuh``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import local as ref
from repro_torch.core import row_dot, upcast
from repro_torch.kernels import common as C
from repro_torch.obs.trace import span

# the kernels' head-dim instances (`common.LOCAL_HEAD_DIMS`)
WIDTHS = C.LOCAL_HEAD_DIMS
LAUNCHES = C.counter("local_attention")
LAUNCHES_BWD_DQ = C.counter("local_attention_bwd_dq")
LAUNCHES_BWD_DKV = C.counter("local_attention_bwd_dkv")

# pointers, then the ints (.., dtype), then the scale and the stream
_TAIL = [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + _TAIL
_DQ_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + _TAIL
_DKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + _TAIL


def local_attention_plain(q, k, v, window: int, causal: bool = True,
                          pad_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None):
    """The plain PyTorch version of the forward kernel: (out in q's dtype,
    lse in at least fp32). It computes in at least fp32 and rounds only
    the output, as the TPU kernel does (it upcasts q, k and v). ``scale``
    defaults to 1 / sqrt(dh)."""
    out, lse = ref.local_attention(upcast(q), upcast(k), upcast(v), window,
                                   causal, pad_mask, return_lse=True,
                                   scale=scale)
    return out.to(q.dtype), lse


def _check(what, q, k, v, pad_mask, **more):
    B, H, N, dh = q.shape
    Hkv = k.shape[1]
    C.require(k.shape == v.shape == (B, Hkv, N, dh) and H % Hkv == 0,
              f"{what}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
              f"v {tuple(v.shape)}")
    C.require(q.dtype == k.dtype == v.dtype, f"{what}: mixed dtypes")
    C.require(pad_mask is None or (pad_mask.shape == (B, N)
                                   and pad_mask.dtype == torch.bool),
              f"{what}: pad_mask must be (B, N) bool")
    C.check_tensors(what, q=q, k=k, v=v, **more)


def _kvalid(what, q, pad_mask):
    if pad_mask is None:
        return None
    kvalid = pad_mask.to(torch.uint8).contiguous()
    C.check_tensors(what, q=q, pad_mask=kvalid)
    return kvalid


def _opt_ptr(t):
    return None if t is None else C.ptr(t)


@span("kernels/local_attention")
def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, causal: bool = True,
                    pad_mask: Optional[torch.Tensor] = None):
    what = "local_attention"
    _check(what, q, k, v, pad_mask)
    B, H, N, dh = q.shape
    scale = C.head_scale(dh)
    q, k, v = C.pad_heads(what, dh, q, k, v, widths=WIDTHS)
    if q.device.type == "cpu":
        out, lse = local_attention_plain(q, k, v, window, causal, pad_mask,
                                         scale)
        return C.unpad_heads(dh, out)[0], lse
    code = C.dtype_code(what, q)
    kvalid = _kvalid(what, q, pad_mask)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    fn = C.load("local_attention", "local_attention_fwd", _ARGTYPES)
    err = fn(C.ptr(q), C.ptr(k), C.ptr(v), _opt_ptr(kvalid), C.ptr(out),
             C.ptr(lse), B, H, k.shape[1], N, q.shape[-1], min(window, N),
             int(causal), code, scale, C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return C.unpad_heads(dh, out)[0], lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def _check_bwd(what, q, k, v, do, lse, dsum, pad_mask):
    B, H, N, _ = q.shape
    C.require(do.shape == q.shape and do.dtype == q.dtype,
              f"{what}: do must match q")
    C.require(lse.shape == dsum.shape == (B, H, N)
              and lse.dtype == dsum.dtype == upcast(q).dtype,
              f"{what}: lse and D must be (B, H, N) in q's accumulation "
              f"dtype")
    _check(what, q, k, v, pad_mask, do=do, lse=lse, dsum=dsum)


def local_attention_bwd_dq(q, k, v, do, lse, dsum, window: int,
                           causal: bool = True, pad_mask=None):
    """dq (B,H,N,dh) fp32 from the forward's lse and D = rowsum(do * out)
    (both (B,H,N) fp32)."""
    what = "local_attention_bwd_dq"
    _check_bwd(what, q, k, v, do, lse, dsum, pad_mask)
    B, H, N, dh = q.shape
    scale = C.head_scale(dh)
    q, k, v, do = C.pad_heads(what, dh, q, k, v, do, widths=WIDTHS)
    if q.device.type == "cpu":
        return C.unpad_heads(dh, ref.local_attention_bwd_dq(
            q, k, v, do, lse, dsum, window, causal, pad_mask, scale))[0]
    code = C.dtype_code(what, q)
    kvalid = _kvalid(what, q, pad_mask)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = C.load("local_attention_bwd", "local_attention_bwd_dq",
                _DQ_ARGTYPES)
    err = fn(C.ptr(q), C.ptr(k), C.ptr(v), C.ptr(do), C.ptr(lse),
             C.ptr(dsum), _opt_ptr(kvalid), C.ptr(dq), B, H, k.shape[1], N,
             q.shape[-1], min(window, N), int(causal), code, scale,
             C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DQ.bump()
    return C.unpad_heads(dh, dq)[0]


def local_attention_bwd_dkv(q, k, v, do, lse, dsum, window: int,
                            causal: bool = True, pad_mask=None):
    """(dk, dv) per *query* head (B,H,N,dh) fp32; `local_attention_bwd`
    sums them over each kv head's query group."""
    what = "local_attention_bwd_dkv"
    _check_bwd(what, q, k, v, do, lse, dsum, pad_mask)
    B, H, N, dh = q.shape
    scale = C.head_scale(dh)
    q, k, v, do = C.pad_heads(what, dh, q, k, v, do, widths=WIDTHS)
    if q.device.type == "cpu":
        return C.unpad_heads(dh, *ref.local_attention_bwd_dkv(
            q, k, v, do, lse, dsum, window, causal, pad_mask, scale))
    code = C.dtype_code(what, q)
    kvalid = _kvalid(what, q, pad_mask)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    fn = C.load("local_attention_bwd", "local_attention_bwd_dkv",
                _DKV_ARGTYPES)
    err = fn(C.ptr(q), C.ptr(k), C.ptr(v), C.ptr(do), C.ptr(lse),
             C.ptr(dsum), _opt_ptr(kvalid), C.ptr(dk), C.ptr(dv), B, H,
             k.shape[1], N, q.shape[-1], min(window, N), int(causal), code,
             scale, C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DKV.bump()
    return C.unpad_heads(dh, dk, dv)


@span("kernels/local_attention_bwd")
def local_attention_bwd(q, k, v, out, lse, do, window: int,
                        causal: bool = True, pad_mask=None):
    """(dq (B,H,N,dh), dk, dv (B,Hkv,N,dh)) in at least fp32 through the
    two backward kernels (their plain versions for CPU tensors)."""
    dsum = row_dot(do, out)
    dq = local_attention_bwd_dq(q, k, v, do, lse, dsum, window, causal,
                                pad_mask)
    dk, dv = local_attention_bwd_dkv(q, k, v, do, lse, dsum, window, causal,
                                     pad_mask)
    return dq, C.group_sum(dk, k.shape[1]), C.group_sum(dv, k.shape[1])


def local_attention_bwd_plain(q, k, v, out, lse, do, window: int,
                              causal: bool = True, pad_mask=None):
    """The plain PyTorch version of the whole backward (both kernels and
    the group sum): recomputes p from the saved lse, as the kernels do."""
    dsum = row_dot(do, out)
    dq = ref.local_attention_bwd_dq(q, k, v, do, lse, dsum, window, causal,
                                    pad_mask)
    dk, dv = ref.local_attention_bwd_dkv(q, k, v, do, lse, dsum, window,
                                         causal, pad_mask)
    return dq, C.group_sum(dk, k.shape[1]), C.group_sum(dv, k.shape[1])


class LocalAttention(torch.autograd.Function):
    """Differentiable local-window attention through the kernels:
    ``LocalAttention.apply(q, k, v, window, causal, pad_mask)`` -> (out,
    lse); lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, pad_mask):
        out, lse = local_attention(q, k, v, window, causal, pad_mask)
        ctx.save_for_backward(q, k, v, out, lse, pad_mask)
        ctx.window, ctx.causal = window, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, pad_mask = ctx.saved_tensors
        dq, dk, dv = local_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.window, ctx.causal, pad_mask)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)
