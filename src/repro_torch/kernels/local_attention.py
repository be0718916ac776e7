"""Blocked local-window attention, forward: wrapper of the CUDA kernel
``csrc/local_attention.cu`` (replaces the TPU kernel `_kernel` of the JAX
package's ``kernels/local_attention.py``).

`local_attention` takes q (B,H,N,dh), k/v (B,Hkv,N,dh) and returns
(out (B,H,N,dh), lse (B,H,N) fp32). A CPU tensor goes to the plain PyTorch
version (`local_attention_plain`, from ``core/local.py``); a CUDA tensor
launches the kernel or raises. Any N (a ragged last block is masked in the
kernel) and an optional (B,N) key pad mask are taken.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.local import local_attention as _local_reference
from repro_torch.kernels import common as C

LAUNCHES = C.counter("local_attention")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def local_attention_plain(q, k, v, window: int, causal: bool = True,
                          pad_mask: Optional[torch.Tensor] = None):
    """The plain PyTorch version of the kernel: (out, lse)."""
    return _local_reference(q, k, v, window, causal, pad_mask,
                            return_lse=True)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, causal: bool = True,
                    pad_mask: Optional[torch.Tensor] = None):
    what = "local_attention"
    B, H, N, dh = q.shape
    Hkv = k.shape[1]
    C.require(k.shape == v.shape == (B, Hkv, N, dh) and H % Hkv == 0,
              f"{what}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
              f"v {tuple(v.shape)}")
    C.require(q.dtype == k.dtype == v.dtype, f"{what}: mixed dtypes")
    C.require(pad_mask is None or (pad_mask.shape == (B, N)
                                   and pad_mask.dtype == torch.bool),
              f"{what}: pad_mask must be (B, N) bool")
    C.check_tensors(what, q=q, k=k, v=v)
    if q.device.type == "cpu":
        return local_attention_plain(q, k, v, window, causal, pad_mask)
    C.head_dim_ok(what, dh)
    code = C.dtype_code(what, q)
    kvalid = None
    if pad_mask is not None:
        kvalid = pad_mask.to(torch.uint8).contiguous()
        C.check_tensors(what, q=q, pad_mask=kvalid)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    fn = C.load("local_attention", "local_attention_fwd", _ARGTYPES)
    err = fn(C.ptr(q), C.ptr(k), C.ptr(v),
             None if kvalid is None else C.ptr(kvalid), C.ptr(out),
             C.ptr(lse), B, H, Hkv, N, dh, min(window, N), int(causal),
             code, C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return out, lse
