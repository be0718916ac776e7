"""Paged routing decode: wrapper of the CUDA kernel ``csrc/routing_decode.cu``
(replaces the TPU kernel `_decode_kernel` of the JAX package's
``kernels/routing_decode.py``).

One decoded token of routed attention over the cluster-paged cache: the
token's normalized routing vector r scores the min(rlen, cap) occupied
slots of its argmax page plus itself, fp32 softmax, weighted sum of the
page values and its own value. Stage 1 (`_route_token`) and the ring-slot
write (`_write_page_slot`) stay in `attn.backends`, shared with the plain
path, so both paths walk the same cache trajectory.

A CPU tensor goes to the plain PyTorch version
(`paged_routing_decode_plain`: gather the page, attend); a CUDA tensor
launches the kernel or raises. The kernel spreads a page's occupied slots
over a thread-block cluster of up to 8 CTAs per (batch, head), copies them
by bulk async copies and combines the CTAs' partial softmaxes in
distributed shared memory: one launch per call, nothing written to device
memory but the output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common as C

LAUNCHES = C.counter("routing_decode")
# the head dims the kernel is built for; rt-pg19's 129 waits for a padded
# cache or a ragged-row copy (a 258-byte row is no multiple of the bulk
# copies' 16 bytes)
HEAD_DIMS = C.SUPPORTED_HEAD_DIMS
WAITS_FOR = ("ROADMAP Queue 1: serve rt-pg19: the paged decode at head dim "
             "129")

_BIG_NEG = -1e9
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def paged_routing_decode_plain(r, v_new, rk, rv, rlen, cluster):
    """r/v_new (B,Hr,dh), rk/rv (B,Hr,kc,cap,dh), rlen (B,Hr,kc),
    cluster (B,Hr) -> o (B,Hr,dh): the JAX reference decode's op order."""
    B, Hr, dh = r.shape
    cap = rk.shape[3]
    c = cluster.long()
    sel = c[:, :, None, None, None].expand(B, Hr, 1, cap, dh)
    page_k = torch.gather(rk, 2, sel)[:, :, 0]
    page_v = torch.gather(rv, 2, sel)[:, :, 0]
    plen = torch.gather(rlen, 2, c[..., None])[..., 0]
    nvalid = plen.clamp_max(cap)
    logits = torch.einsum("bhd,bhcd->bhc", r, page_k).float() / float(dh) ** 0.5
    slot_ok = torch.arange(cap, device=r.device) < nvalid[..., None]
    logits = logits.masked_fill(~slot_ok, _BIG_NEG)
    self_logit = (torch.einsum("bhd,bhd->bh", r, r) / float(dh) ** 0.5).float()
    attn = torch.softmax(torch.cat([logits, self_logit[..., None]], -1), -1)
    vals = torch.cat([page_v, v_new[:, :, None, :]], 2)
    return torch.einsum("bhc,bhcd->bhd", attn.to(vals.dtype), vals)


def paged_routing_decode(r: torch.Tensor, v_new: torch.Tensor,
                         rk: torch.Tensor, rv: torch.Tensor,
                         rlen: torch.Tensor,
                         cluster: torch.Tensor) -> torch.Tensor:
    what = "paged_routing_decode"
    B, Hr, dh = r.shape
    kc, cap = rk.shape[2], rk.shape[3]
    C.require(v_new.shape == r.shape and rk.shape == rv.shape
              == (B, Hr, kc, cap, dh),
              f"{what}: shapes r {tuple(r.shape)} rk {tuple(rk.shape)}")
    C.require(rlen.shape == (B, Hr, kc) and cluster.shape == (B, Hr),
              f"{what}: rlen must be (B, Hr, kc) and cluster (B, Hr)")
    C.require(rlen.dtype == cluster.dtype == torch.int32,
              f"{what}: rlen and cluster must be int32")
    C.require(r.dtype == v_new.dtype == rk.dtype == rv.dtype,
              f"{what}: mixed dtypes")
    C.require(kc >= 1 and cap >= 1, f"{what}: an empty page cache")
    # on CUDA tensors this also holds every pointer to 16-byte alignment,
    # which the kernel's bulk copies and vector reads need
    C.check_tensors(what, r=r, v_new=v_new, rk=rk, rv=rv, rlen=rlen,
                    cluster=cluster)
    if r.device.type == "cpu":
        return paged_routing_decode_plain(r, v_new, rk, rv, rlen, cluster)
    if dh not in HEAD_DIMS:
        raise NotImplementedError(f"{what}: head_dim {dh}: the kernel takes "
                                  f"{HEAD_DIMS} ({WAITS_FOR})")
    code = C.dtype_code(what, r)
    out = torch.empty_like(r)
    fn = C.load("routing_decode", "routing_decode_fwd", _ARGTYPES)
    err = fn(C.ptr(r), C.ptr(v_new), C.ptr(rk), C.ptr(rv), C.ptr(rlen),
             C.ptr(cluster), C.ptr(out), B * Hr, kc, cap, dh, code,
             C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return out
