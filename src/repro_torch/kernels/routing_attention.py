"""Fused gather-free routed attention: wrappers of the CUDA kernels
``csrc/routing_fused.cu`` (forward; replaces the TPU kernels `_f_fwd_kernel`
and `_p_fwd_kernel` of the JAX package's ``kernels/routing_attention.py``:
on Hopper one kernel serves both of the TPU's memory plans) and
``csrc/routing_fused_bwd.cu`` (replaces `_f_dq_kernel`/`_p_dq_kernel` and
`_f_dkv_kernel`/`_p_dkv_kernel`), and `RoutedAttentionFused`, the autograd
Function over them.

`routed_attention_fused` takes sequence-layout q/v (B,H,N,dh), k like q or
None (shared-QK: keys are q's rows), the (B,H,k,w) int32 membership of
queries and keys, (B,N) int32 original positions and an optional (B,N)
key-valid mask, and returns per-cluster outputs (B,H,k,w,dh) and their
lse (B,H,k,w) fp32. The backward kernels return per-cluster gradient
blocks; the Function scatter-adds them to sequence layout. Every wrapper
sends a CPU tensor to its plain PyTorch version (``core/routing.py``:
gather the blocks, attend) and launches its kernel on a CUDA tensor, or
raises.

The dtype picks the design, and nothing falls back: bf16 (dh 64, 128 and
192) runs on Hopper's tensor cores (`routing_fused_wgmma`, and
`routing_fused_dq_wgmma` / `routing_fused_dkv_wgmma`: the shared forward
and backward bodies, each cluster's member rows gathered by cp.async
straight from the sequence planes, no gathered copy in device memory);
fp32 runs the FMA kernels (`routing_fused_kernel`, and the backward's),
which keep full fp32 products. Any other head dim up to 192 (rt-pg19's
129) runs zero-padded to the next width (`common.pad_heads`, on both
devices), with the scale of the true head dim, and the outputs are cut
back to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import routing as ref
from repro_torch.core import row_dot, upcast
from repro_torch.kernels import common as C
from repro_torch.obs.trace import span

LAUNCHES = C.counter("routing_fused")
LAUNCHES_BWD_DQ = C.counter("routing_fused_bwd_dq")
LAUNCHES_BWD_DKV = C.counter("routing_fused_bwd_dkv")
SENTINEL = 2 ** 30          # position of a padded key inside the kernels

# pointers, then the ints (.., dtype), then the scale and the stream
_TAIL = [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + _TAIL
_DQ_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + _TAIL
_DKV_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + _TAIL


def routed_attention_fused_plain(q, k, v, q_idx, k_idx, positions,
                                 causal: bool = True,
                                 kvalid: Optional[torch.Tensor] = None,
                                 scale: Optional[float] = None):
    """The plain PyTorch version of the forward kernel: (out in q's dtype,
    lse in at least fp32). It computes in at least fp32 and rounds only
    the output, as the TPU kernel does (it upcasts q, k and v). ``scale``
    defaults to 1 / sqrt(dh)."""
    out, lse = ref.gathered_block_attention(
        upcast(q), None if k is None else upcast(k), upcast(v), q_idx.long(),
        k_idx.long(), positions.long(), causal, kvalid, return_lse=True,
        scale=scale)
    return out.to(q.dtype), lse


def _check(what, q, k, v, q_idx, k_idx, positions, kvalid, **more):
    kk = q if k is None else k
    B, H, N, dh = q.shape
    kc, w = q_idx.shape[2], q_idx.shape[3]
    C.require(kk.shape == v.shape == q.shape,
              f"{what}: q/k/v shapes differ")
    C.require(q_idx.shape == k_idx.shape == (B, H, kc, w) and w <= N,
              f"{what}: membership must be (B, H, k, w) with w <= N")
    C.require(positions.shape == (B, N), f"{what}: positions must be (B, N)")
    C.require(q_idx.dtype == k_idx.dtype == positions.dtype == torch.int32,
              f"{what}: indices and positions must be int32")
    C.require(q.dtype == kk.dtype == v.dtype, f"{what}: mixed dtypes")
    C.require(kvalid is None or (kvalid.shape == (B, N)
                                 and kvalid.dtype == torch.bool),
              f"{what}: kvalid must be (B, N) bool")
    C.check_tensors(what, q=q, k=kk, v=v, q_idx=q_idx, k_idx=k_idx,
                    positions=positions, **more)


def _key_positions(positions, kvalid):
    """Key positions as the kernels read them: SENTINEL for padded keys."""
    if kvalid is None:
        return positions
    return torch.where(kvalid, positions, SENTINEL).to(torch.int32)


@span("kernels/routed_attention_fused")
def routed_attention_fused(q: torch.Tensor, k: Optional[torch.Tensor],
                           v: torch.Tensor, q_idx: torch.Tensor,
                           k_idx: torch.Tensor, positions: torch.Tensor,
                           causal: bool = True,
                           kvalid: Optional[torch.Tensor] = None):
    what = "routed_attention_fused"
    _check(what, q, k, v, q_idx, k_idx, positions, kvalid)
    B, H, N, dh = q.shape
    kc, w = q_idx.shape[2], q_idx.shape[3]
    scale = C.head_scale(dh)
    q, k, v = C.pad_heads(what, dh, q, k, v)
    if q.device.type == "cpu":
        out, lse = routed_attention_fused_plain(
            q, k, v, q_idx, k_idx, positions, causal, kvalid, scale)
        return C.unpad_heads(dh, out)[0], lse
    kk = q if k is None else k
    code = C.dtype_code(what, q)
    pos_k = _key_positions(positions, kvalid)
    out = torch.empty((B, H, kc, w, q.shape[-1]), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((B, H, kc, w), dtype=torch.float32, device=q.device)
    fn = C.load("routing_fused", "routing_fused_fwd", _ARGTYPES)
    err = fn(C.ptr(q), C.ptr(kk), C.ptr(v), C.ptr(q_idx), C.ptr(k_idx),
             C.ptr(positions), C.ptr(pos_k), C.ptr(out), C.ptr(lse),
             B * H, H, N, kc, w, q.shape[-1], int(causal), code, scale,
             C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return C.unpad_heads(dh, out)[0], lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def _check_bwd(what, q, k, v, q_idx, k_idx, positions, do, lse, dsum,
               kvalid):
    B, H, N, dh = q.shape
    kc, w = q_idx.shape[2], q_idx.shape[3]
    C.require(do.shape == (B, H, kc, w, dh) and do.dtype == q.dtype,
              f"{what}: do must be (B, H, k, w, dh) in q's dtype")
    C.require(lse.shape == dsum.shape == (B, H, kc, w)
              and lse.dtype == dsum.dtype == upcast(q).dtype,
              f"{what}: lse and D must be (B, H, k, w) in q's accumulation "
              f"dtype")
    _check(what, q, k, v, q_idx, k_idx, positions, kvalid, do=do, lse=lse,
           dsum=dsum)


def routed_attention_fused_bwd_dq(q, k, v, q_idx, k_idx, positions, do,
                                  lse, dsum, causal: bool = True,
                                  kvalid=None):
    """Per-cluster dq blocks (B,H,k,w,dh) fp32 from the per-cluster output
    gradient ``do`` and the forward's lse and D = rowsum(do * out)."""
    what = "routed_attention_fused_bwd_dq"
    _check_bwd(what, q, k, v, q_idx, k_idx, positions, do, lse, dsum, kvalid)
    B, H, N, dh = q.shape
    kc, w = q_idx.shape[2], q_idx.shape[3]
    scale = C.head_scale(dh)
    q, k, v, do = C.pad_heads(what, dh, q, k, v, do)
    if q.device.type == "cpu":
        return C.unpad_heads(dh, ref.routed_attention_bwd_dq(
            q, k, v, q_idx.long(), k_idx.long(), positions.long(), do, lse,
            dsum, causal, kvalid, scale))[0]
    kk = q if k is None else k
    code = C.dtype_code(what, q)
    pos_k = _key_positions(positions, kvalid)
    dq = torch.empty(do.shape, dtype=torch.float32, device=q.device)
    fn = C.load("routing_fused_bwd", "routing_fused_bwd_dq", _DQ_ARGTYPES)
    err = fn(C.ptr(q), C.ptr(kk), C.ptr(v), C.ptr(q_idx), C.ptr(k_idx),
             C.ptr(positions), C.ptr(pos_k), C.ptr(do), C.ptr(lse),
             C.ptr(dsum), C.ptr(dq), B * H, H, N, kc, w, q.shape[-1],
             int(causal), code, scale, C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DQ.bump()
    return C.unpad_heads(dh, dq)[0]


def routed_attention_fused_bwd_dkv(q, k, v, q_idx, k_idx, positions, do,
                                   lse, dsum, causal: bool = True,
                                   kvalid=None):
    """Per-cluster (dk, dv) blocks (B,H,k,w,dh) fp32; with shared-QK
    (``k=None``) dk is the gradient of q's rows taken as keys."""
    what = "routed_attention_fused_bwd_dkv"
    _check_bwd(what, q, k, v, q_idx, k_idx, positions, do, lse, dsum, kvalid)
    B, H, N, dh = q.shape
    kc, w = q_idx.shape[2], q_idx.shape[3]
    scale = C.head_scale(dh)
    q, k, v, do = C.pad_heads(what, dh, q, k, v, do)
    if q.device.type == "cpu":
        return C.unpad_heads(dh, *ref.routed_attention_bwd_dkv(
            q, k, v, q_idx.long(), k_idx.long(), positions.long(), do, lse,
            dsum, causal, kvalid, scale))
    kk = q if k is None else k
    code = C.dtype_code(what, q)
    pos_k = _key_positions(positions, kvalid)
    dk = torch.empty(do.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    fn = C.load("routing_fused_bwd", "routing_fused_bwd_dkv", _DKV_ARGTYPES)
    err = fn(C.ptr(q), C.ptr(kk), C.ptr(v), C.ptr(q_idx), C.ptr(k_idx),
             C.ptr(positions), C.ptr(pos_k), C.ptr(do), C.ptr(lse),
             C.ptr(dsum), C.ptr(dk), C.ptr(dv), B * H, H, N, kc, w,
             q.shape[-1], int(causal), code, scale, C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DKV.bump()
    return C.unpad_heads(dh, dk, dv)


@span("kernels/routed_attention_fused_bwd")
def routed_attention_fused_bwd(q, k, v, q_idx, k_idx, positions, out, lse,
                               do, causal: bool = True, kvalid=None):
    """Per-cluster (dqg, dkg, dvg) through the two backward kernels (their
    plain versions for CPU tensors)."""
    dsum = row_dot(do, out)
    dq = routed_attention_fused_bwd_dq(q, k, v, q_idx, k_idx, positions, do,
                                       lse, dsum, causal, kvalid)
    dk, dv = routed_attention_fused_bwd_dkv(q, k, v, q_idx, k_idx,
                                            positions, do, lse, dsum,
                                            causal, kvalid)
    return dq, dk, dv


def routed_attention_fused_bwd_plain(q, k, v, q_idx, k_idx, positions, out,
                                     lse, do, causal: bool = True,
                                     kvalid=None):
    """The plain PyTorch version of the whole backward: per-cluster (dqg,
    dkg, dvg), p recomputed from the saved lse as the kernels do."""
    dsum = row_dot(do, out)
    args = (q, k, v, q_idx.long(), k_idx.long(), positions.long(), do, lse,
            dsum, causal, kvalid)
    return (ref.routed_attention_bwd_dq(*args),
            *ref.routed_attention_bwd_dkv(*args))


class RoutedAttentionFused(torch.autograd.Function):
    """Differentiable fused routed attention through the kernels:
    ``RoutedAttentionFused.apply(q, k, v, q_idx, k_idx, positions, causal,
    kvalid)`` -> (per-cluster out, lse); lse carries no gradient.

    The backward scatter-adds the per-cluster gradient blocks to sequence
    layout (`core.routing.scatter_add_rows`: a token's <= k cluster copies
    add in cluster order, the same in every run). With shared-QK
    (``k=None``) q's rows served as both queries and keys, so q's gradient
    is the sum of both scatters."""

    @staticmethod
    def forward(ctx, q, k, v, q_idx, k_idx, positions, causal, kvalid):
        out, lse = routed_attention_fused(q, k, v, q_idx, k_idx, positions,
                                          causal, kvalid)
        ctx.save_for_backward(q, k, v, q_idx, k_idx, positions, out, lse,
                              kvalid)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, q_idx, k_idx, positions, out, lse, kvalid = ctx.saved_tensors
        dqg, dkg, dvg = routed_attention_fused_bwd(
            q, k, v, q_idx, k_idx, positions, out, lse, do.contiguous(),
            ctx.causal, kvalid)
        N, dh = q.shape[2], q.shape[3]
        qi, ki = q_idx.long(), k_idx.long()
        # one scatter per membership: with shared-QK all three gradients
        # share q's, otherwise dk and dv share k's
        if k is None:
            dq, dk, dv = ref.scatter_add_rows(
                torch.cat([dqg, dkg, dvg], -1), qi, N).split(dh, -1)
            return ((dq + dk).to(q.dtype), None, dv.to(v.dtype), None, None,
                    None, None, None)
        dq = ref.scatter_add_rows(dqg, qi, N)
        dk, dv = ref.scatter_add_rows(torch.cat([dkg, dvg], -1), ki,
                                      N).split(dh, -1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)
