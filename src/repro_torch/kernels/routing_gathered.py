"""Gathered routed attention: wrappers of the CUDA kernels
``csrc/routing_gathered.cu`` (forward; replaces the TPU kernel `_kernel` of
the JAX package's ``kernels/routing_attention.py``) and
``csrc/routing_gathered_bwd.cu`` (replaces `_g_dq_kernel` and
`_g_dkv_kernel`), and `RoutedAttentionBlocks`, the autograd Function over
them.

The kernels take cluster blocks that the caller has already gathered, as
XLA gathers them for the TPU kernels: q/k/v (n, w, dh) with n = B*H*k
(shared-QK passes the q blocks as k), each row's original position
(n, w) int32, a padded key at ``SENTINEL``. `routed_attention_blocks`
returns (out (n, w, dh), lse (n, w) fp32); the two backward kernels take
the output gradient, the lse and D = rowsum(do * out) (computed outside
them, as the JAX package does) and return fp32 block gradients.
`attend_blocks` is the (B, H, k, w, dh) form the routing module calls:
flatten, mark padded keys, run the Function.

Every wrapper sends a CPU tensor to its plain PyTorch version (the block
forms of ``core/routing.py``) and launches its kernel on a CUDA tensor, or
raises. In bf16 all three kernels run ``wgmma`` on tiles that TMA loads,
through the flash kernels' bodies (``csrc/attn_fwd_sm90.cuh``,
``csrc/attn_bwd_sm90.cuh``) under a mask on the rows' positions; in fp32
the FMA tiles. This path is a forced impl (``"cuda_gathered"``);
auto-selection takes the fused gather-free kernels
(`kernels.routing_attention`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import routing as ref
from repro_torch.core import row_dot, upcast
from repro_torch.kernels import common as C
from repro_torch.obs.trace import span

LAUNCHES = C.counter("routing_gathered")
LAUNCHES_BWD_DQ = C.counter("routing_gathered_bwd_dq")
LAUNCHES_BWD_DKV = C.counter("routing_gathered_bwd_dkv")
SENTINEL = 2 ** 30          # position of a padded key inside the kernels

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DKV_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


def _plain_args(pqf, pkf):
    """Positions as the plain block forms take them: int64, and the keys'
    validity (a padded key carries SENTINEL)."""
    return pqf.long(), pkf.long(), pkf < SENTINEL


def routed_attention_blocks_plain(qf, kf, vf, pqf, pkf, causal: bool = True):
    """The plain PyTorch version of the forward kernel: (out in q's dtype,
    lse in at least fp32). It computes in at least fp32 and rounds only
    the output, as the TPU kernel does (it upcasts q, k and v)."""
    pq, pk, valid = _plain_args(pqf, pkf)
    out, lse = ref.block_attention(upcast(qf), upcast(kf), upcast(vf), pq, pk,
                                   causal, valid, return_lse=True)
    return out.to(qf.dtype), lse


def _check(what, qf, kf, vf, pqf, pkf, **more):
    C.require(qf.dim() == 3 and kf.shape == vf.shape == qf.shape,
              f"{what}: q/k/v must be (n, w, dh) blocks of one shape, got "
              f"{tuple(qf.shape)} {tuple(kf.shape)} {tuple(vf.shape)}")
    C.require(pqf.shape == pkf.shape == qf.shape[:2],
              f"{what}: positions must be (n, w)")
    C.require(pqf.dtype == pkf.dtype == torch.int32,
              f"{what}: positions must be int32")
    C.require(qf.dtype == kf.dtype == vf.dtype, f"{what}: mixed dtypes")
    C.check_tensors(what, q=qf, k=kf, v=vf, pos_q=pqf, pos_k=pkf, **more)


@span("kernels/routed_attention_blocks")
def routed_attention_blocks(qf: torch.Tensor, kf: torch.Tensor,
                            vf: torch.Tensor, pqf: torch.Tensor,
                            pkf: torch.Tensor, causal: bool = True):
    what = "routed_attention_blocks"
    _check(what, qf, kf, vf, pqf, pkf)
    if qf.device.type == "cpu":
        return routed_attention_blocks_plain(qf, kf, vf, pqf, pkf, causal)
    n, w, dh = qf.shape
    C.head_dim_ok(what, dh)
    code = C.dtype_code(what, qf)
    out = torch.empty_like(qf)
    lse = torch.empty((n, w), dtype=torch.float32, device=qf.device)
    fn = C.load("routing_gathered", "routing_gathered_fwd", _ARGTYPES)
    err = fn(C.ptr(qf), C.ptr(kf), C.ptr(vf), C.ptr(pqf), C.ptr(pkf),
             C.ptr(out), C.ptr(lse), n, w, dh, int(causal), code, C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return out, lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def _check_bwd(what, qf, kf, vf, pqf, pkf, do, lse, dsum):
    C.require(do.shape == qf.shape and do.dtype == qf.dtype,
              f"{what}: do must match q")
    C.require(lse.shape == dsum.shape == qf.shape[:2]
              and lse.dtype == dsum.dtype == upcast(qf).dtype,
              f"{what}: lse and D must be (n, w) in q's accumulation dtype")
    _check(what, qf, kf, vf, pqf, pkf, do=do, lse=lse, dsum=dsum)


def routed_attention_blocks_bwd_dq_plain(qf, kf, vf, pqf, pkf, do, lse,
                                         dsum, causal: bool = True):
    pq, pk, valid = _plain_args(pqf, pkf)
    return ref.block_bwd_dq(qf, kf, vf, pq, pk, do, lse, dsum, causal, valid)


def routed_attention_blocks_bwd_dkv_plain(qf, kf, vf, pqf, pkf, do, lse,
                                          dsum, causal: bool = True):
    pq, pk, valid = _plain_args(pqf, pkf)
    return ref.block_bwd_dkv(qf, kf, vf, pq, pk, do, lse, dsum, causal,
                             valid)


def routed_attention_blocks_bwd_dq(qf, kf, vf, pqf, pkf, do, lse, dsum,
                                   causal: bool = True):
    """dq (n, w, dh) fp32 from the output gradient ``do``, the forward's
    lse and D = rowsum(do * out)."""
    what = "routed_attention_blocks_bwd_dq"
    _check_bwd(what, qf, kf, vf, pqf, pkf, do, lse, dsum)
    if qf.device.type == "cpu":
        return routed_attention_blocks_bwd_dq_plain(qf, kf, vf, pqf, pkf, do,
                                                    lse, dsum, causal)
    n, w, dh = qf.shape
    C.head_dim_ok(what, dh)
    code = C.dtype_code(what, qf)
    dq = torch.empty((n, w, dh), dtype=torch.float32, device=qf.device)
    fn = C.load("routing_gathered_bwd", "routing_gathered_bwd_dq",
                _DQ_ARGTYPES)
    err = fn(C.ptr(qf), C.ptr(kf), C.ptr(vf), C.ptr(pqf), C.ptr(pkf),
             C.ptr(do), C.ptr(lse), C.ptr(dsum), C.ptr(dq), n, w, dh,
             int(causal), code, C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DQ.bump()
    return dq


def routed_attention_blocks_bwd_dkv(qf, kf, vf, pqf, pkf, do, lse, dsum,
                                    causal: bool = True):
    """(dk, dv) (n, w, dh) fp32; with shared-QK (``kf is qf``) dk is the
    gradient of q's blocks taken as keys."""
    what = "routed_attention_blocks_bwd_dkv"
    _check_bwd(what, qf, kf, vf, pqf, pkf, do, lse, dsum)
    if qf.device.type == "cpu":
        return routed_attention_blocks_bwd_dkv_plain(qf, kf, vf, pqf, pkf,
                                                     do, lse, dsum, causal)
    n, w, dh = qf.shape
    C.head_dim_ok(what, dh)
    code = C.dtype_code(what, qf)
    dk = torch.empty((n, w, dh), dtype=torch.float32, device=qf.device)
    dv = torch.empty_like(dk)
    fn = C.load("routing_gathered_bwd", "routing_gathered_bwd_dkv",
                _DKV_ARGTYPES)
    err = fn(C.ptr(qf), C.ptr(kf), C.ptr(vf), C.ptr(pqf), C.ptr(pkf),
             C.ptr(do), C.ptr(lse), C.ptr(dsum), C.ptr(dk), C.ptr(dv), n, w,
             dh, int(causal), code, C.stream())
    C.check(err, what)
    LAUNCHES_BWD_DKV.bump()
    return dk, dv


@span("kernels/routed_attention_blocks_bwd")
def routed_attention_blocks_bwd(qf, kf, vf, pqf, pkf, out, lse, do,
                                causal: bool = True):
    """(dq, dk, dv) fp32 blocks through the two backward kernels (their
    plain versions for CPU tensors)."""
    dsum = row_dot(do, out)
    dq = routed_attention_blocks_bwd_dq(qf, kf, vf, pqf, pkf, do, lse, dsum,
                                        causal)
    dk, dv = routed_attention_blocks_bwd_dkv(qf, kf, vf, pqf, pkf, do, lse,
                                             dsum, causal)
    return dq, dk, dv


def routed_attention_blocks_bwd_plain(qf, kf, vf, pqf, pkf, out, lse, do,
                                      causal: bool = True):
    """The plain PyTorch version of the whole backward: (dq, dk, dv), p
    recomputed from the saved lse as the kernels do."""
    dsum = row_dot(do, out)
    args = (qf, kf, vf, pqf, pkf, do, lse, dsum, causal)
    return (routed_attention_blocks_bwd_dq_plain(*args),
            *routed_attention_blocks_bwd_dkv_plain(*args))


class RoutedAttentionBlocks(torch.autograd.Function):
    """Differentiable gathered routed attention through the kernels:
    ``RoutedAttentionBlocks.apply(qf, kf, vf, pqf, pkf, causal)`` -> (out,
    lse); lse carries no gradient. With shared-QK the same tensor comes in
    as ``qf`` and ``kf``, and autograd adds its two gradients, as the JAX
    package's VJP of ``kg = qg`` does."""

    @staticmethod
    def forward(ctx, qf, kf, vf, pqf, pkf, causal):
        out, lse = routed_attention_blocks(qf, kf, vf, pqf, pkf, causal)
        ctx.save_for_backward(qf, kf, vf, pqf, pkf, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qf, kf, vf, pqf, pkf, out, lse = ctx.saved_tensors
        dq, dk, dv = routed_attention_blocks_bwd(
            qf, kf, vf, pqf, pkf, out, lse, do.contiguous(), ctx.causal)
        return (dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None,
                None, None)


def attend_blocks(qg, kg, vg, pos_q, pos_k, causal: bool = True,
                  valid_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-cluster outputs (B, H, k, w, dh) of gathered blocks qg/kg/vg
    (``kg is qg`` for shared-QK) with their (B, H, k, w) positions and the
    keys' validity, through `RoutedAttentionBlocks` (the counterpart of
    the JAX package's ``routed_attention_blocks``)."""
    B, H, kc, w, dh = qg.shape
    n = B * H * kc
    qf = qg.reshape(n, w, dh)
    kf = qf if kg is qg else kg.reshape(n, w, dh)
    pkf = pos_k if valid_k is None else torch.where(valid_k, pos_k, SENTINEL)
    out, _ = RoutedAttentionBlocks.apply(
        qf, kf, vg.reshape(n, w, dh),
        pos_q.reshape(n, w).to(torch.int32).contiguous(),
        pkf.reshape(n, w).to(torch.int32).contiguous(), causal)
    return out.reshape(B, H, kc, w, dh)
