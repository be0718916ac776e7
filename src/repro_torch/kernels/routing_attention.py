"""Fused gather-free routed attention, forward: wrapper of the CUDA kernel
``csrc/routing_fused.cu`` (replaces the TPU kernels `_f_fwd_kernel` and
`_p_fwd_kernel` of the JAX package's ``kernels/routing_attention.py``: on
Hopper one kernel serves both of the TPU's memory plans).

`routed_attention_fused` takes sequence-layout q/v (B,H,N,dh), k like q or
None (shared-QK: keys are q's rows), the (B,H,k,w) int32 membership of
queries and keys, (B,N) int32 original positions and an optional (B,N)
key-valid mask, and returns per-cluster outputs (B,H,k,w,dh) and their
lse (B,H,k,w) fp32. A CPU tensor goes to the plain PyTorch version
(`routed_attention_fused_plain`: gather the blocks, attend); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.routing import gathered_block_attention
from repro_torch.kernels import common as C

LAUNCHES = C.counter("routing_fused")
SENTINEL = 2 ** 30          # position of a padded key inside the kernel

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def routed_attention_fused_plain(q, k, v, q_idx, k_idx, positions,
                                 causal: bool = True,
                                 kvalid: Optional[torch.Tensor] = None):
    """The plain PyTorch version of the kernel: (out, lse)."""
    return gathered_block_attention(q, k, v, q_idx.long(), k_idx.long(),
                                    positions.long(), causal, kvalid,
                                    return_lse=True)


def routed_attention_fused(q: torch.Tensor, k: Optional[torch.Tensor],
                           v: torch.Tensor, q_idx: torch.Tensor,
                           k_idx: torch.Tensor, positions: torch.Tensor,
                           causal: bool = True,
                           kvalid: Optional[torch.Tensor] = None):
    what = "routed_attention_fused"
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
                    positions=positions)
    if q.device.type == "cpu":
        return routed_attention_fused_plain(q, k, v, q_idx, k_idx, positions,
                                            causal, kvalid)
    C.head_dim_ok(what, dh)
    code = C.dtype_code(what, q)
    pos_k = positions
    if kvalid is not None:
        pos_k = torch.where(kvalid, positions, SENTINEL).to(torch.int32)
    out = torch.empty((B, H, kc, w, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, kc, w), dtype=torch.float32, device=q.device)
    fn = C.load("routing_fused", "routing_fused_fwd", _ARGTYPES)
    err = fn(C.ptr(q), C.ptr(kk), C.ptr(v), C.ptr(q_idx), C.ptr(k_idx),
             C.ptr(positions), C.ptr(pos_k), C.ptr(out), C.ptr(lse),
             B * H, H, N, kc, w, dh, int(causal), code, C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return out, lse
