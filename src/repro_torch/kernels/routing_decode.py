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

The kernel is built for head dims 64, 128 and 192. The pages store a head
dim up to 192 at the first of those that holds it (`page_width`: rt-pg19's
129 at 192, as the local and fused wrappers pad it, `common.pad_heads`);
the pad columns are zero and never written. The kernel takes r, v_new
and o at their own dh columns and the softmax scale of the true head dim
(`common.head_scale`), so a padded head dim costs no copy; the plain
version reads the first dh columns of the pages, so it gives the same
bits on padded pages as on unpadded ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common as C

LAUNCHES = C.counter("routing_decode")
# the widest head dim the kernel takes (its dh-192 instance)
MAX_HEAD_DIM = C.PADDED_HEAD_DIMS[-1]

_BIG_NEG = -1e9
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def page_width(dh: int) -> int:
    """The width the cluster pages store head dim ``dh`` at: the kernel's
    width for it (`common.padded_head_dim`) up to MAX_HEAD_DIM, ``dh``
    itself above, where only the plain version serves (on the CPU)."""
    return dh if dh > MAX_HEAD_DIM else C.padded_head_dim("pages", dh)


def paged_routing_decode_plain(r, v_new, rk, rv, rlen, cluster):
    """r/v_new (B,Hr,dh), rk/rv (B,Hr,kc,cap,width >= dh), rlen (B,Hr,kc),
    cluster (B,Hr) -> o (B,Hr,dh): the JAX reference decode's op order, on
    the first dh columns of the pages (their pad columns are never read)."""
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
    """r/v_new (B,Hr,dh), rk/rv (B,Hr,kc,cap,width >= dh; on the card a
    kernel width, 64, 128 or 192: the cache's `page_width`), rlen
    (B,Hr,kc) int32, cluster (B,Hr) int32 -> o (B,Hr,dh)."""
    what = "paged_routing_decode"
    B, Hr, dh = r.shape
    kc, cap, width = rk.shape[2:]
    C.require(v_new.shape == r.shape and rk.shape == rv.shape
              == (B, Hr, kc, cap, width) and width >= dh,
              f"{what}: shapes r {tuple(r.shape)} rk {tuple(rk.shape)}")
    C.require(rlen.shape == (B, Hr, kc) and cluster.shape == (B, Hr),
              f"{what}: rlen must be (B, Hr, kc) and cluster (B, Hr)")
    C.require(rlen.dtype == cluster.dtype == torch.int32,
              f"{what}: rlen and cluster must be int32")
    C.require(r.dtype == v_new.dtype == rk.dtype == rv.dtype,
              f"{what}: mixed dtypes")
    C.require(kc >= 1 and cap >= 1, f"{what}: an empty page cache")
    # on CUDA tensors this also holds every pointer to 16-byte alignment,
    # which the kernel's bulk copies and vector reads need; under padded
    # pages the kernel reads r and v_new element by element (their rows,
    # dh wide, are no 16-byte multiple, as rt-pg19's 129)
    C.check_tensors(what, ("r", "v_new") if width != dh else (), r=r,
                    v_new=v_new, rk=rk, rv=rv, rlen=rlen, cluster=cluster)
    if r.device.type == "cpu":
        return paged_routing_decode_plain(r, v_new, rk, rv, rlen, cluster)
    C.require(width in C.PADDED_HEAD_DIMS,
              f"{what}: pages {width} wide: the kernel takes pages of width "
              f"{C.PADDED_HEAD_DIMS} (head dim {dh} is stored at "
              f"{page_width(dh)}, `page_width`)")
    code = C.dtype_code(what, r)
    out = torch.empty_like(r)
    fn = C.load("routing_decode", "routing_decode_fwd", _ARGTYPES)
    err = fn(C.ptr(r), C.ptr(v_new), C.ptr(rk), C.ptr(rv), C.ptr(rlen),
             C.ptr(cluster), C.ptr(out), B * Hr, kc, cap, dh, width, code,
             C.head_scale(dh), C.stream())
    C.check(err, what)
    LAUNCHES.bump()
    return out
