"""Gradient wire compression: chunked int8-quantized mean over a process
group (port of the JAX package's ``dist/compression.py``; a
``torch.distributed`` process group takes the place of its mapped axis).

  ``int8_psum_mean(x, group)``           stateless; each call eats the
      quantization error (~1% relative).
  ``int8_ef_psum_mean(x, err, group)``   error feedback: returns ``(mean,
      new_err)``, the fp32 residual carrying exactly what the wire dropped,
      so it is re-injected next step and the time-averaged applied mean is
      unbiased.

The two hops of ``int8_psum_mean`` over n ranks:

  1. the local tensor is flattened to fp32, padded and split into n equal
     chunks; each chunk is group-quantized (symmetric int8, one fp32 scale
     per 128 values, round half to even, clipped to +-127);
  2. one ``all_to_all_single`` exchanges the int8 chunks (and their fp32
     scales), so rank j holds every rank's j-th chunk;
  3. each rank dequantizes and averages its chunk in fp32, re-quantizes the
     mean, and an all-gather of the int8 codes (and scales) rebuilds the
     whole mean everywhere.

At world size 1, or with no process group initialized, both are the
identity, as the JAX functions are on a 1-device axis.

Backends: NCCL takes the CUDA tensors as they are. gloo carries CUDA
tensors through the host, and its all-to-all takes none, so under gloo
every collective here runs on host copies (decided by the group's backend).
`wire_bytes` counts the int8 and fp32 bytes this process has handed to
other ranks through these collectives since `reset_wire_bytes`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

_EPS = 1e-30
QUANT_GROUP = 128                    # values per fp32 scale
_WIRE = {"int8": 0, "fp32": 0}


def world_size(group=None) -> int:
    """Ranks in ``group`` (the default group); 1 with no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 with no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` that ``group``'s backend takes: on the
    host under gloo, where it is."""
    dev = "cpu" if dist.get_backend(group) == "gloo" else t.device
    return t.detach().to(dev, copy=True).contiguous()


def _count(t: torch.Tensor, elements: float) -> None:
    _WIRE["int8" if t.dtype == torch.int8 else "fp32"] += int(
        elements * t.element_size())


def wire_bytes() -> Dict[str, int]:
    """Bytes this process sent to other ranks: int8 codes and fp32 (the
    scales, and the exact means of small tensors)."""
    return dict(_WIRE)


def reset_wire_bytes() -> None:
    for k in _WIRE:
        _WIRE[k] = 0


def all_to_all_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Row j of ``t`` (n, ...) goes to rank j; row i of the result came
    from rank i."""
    src = _staged(t, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    n = world_size(group)
    _count(t, t.numel() * (n - 1) / n)
    return out.to(t.device)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *t.shape): row i is rank i's ``t``."""
    src = _staged(t, group)
    n = world_size(group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    _count(t, t.numel() * (n - 1))
    return torch.stack(parts).to(t.device)


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The fp32 sum of ``t`` over the ranks, in ``t``'s dtype and on its
    device; ``t`` itself at world size 1."""
    n = world_size(group)
    if n == 1:
        return t
    x = _staged(t.float(), group)
    dist.all_reduce(x, group=group)
    _count(x, x.numel() * 2 * (n - 1) / n)
    return x.to(device=t.device, dtype=t.dtype)


def all_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The exact fp32 mean of ``t`` over the ranks (the sum over n, as the
    JAX ``pmean``), in ``t``'s dtype and on its device."""
    n = world_size(group)
    if n == 1:
        return t
    return (all_sum(t.float(), group) / n).to(t.dtype)


def _quantize(x: torch.Tensor, group: int = QUANT_GROUP
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., M) fp32 -> int8 codes (..., M) + scales (..., M // group)."""
    g = x.reshape(*x.shape[:-1], x.shape[-1] // group, group)
    amax = g.abs().amax(-1, keepdim=True)
    scale = amax.clamp_min(_EPS) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor,
                group: int = QUANT_GROUP) -> torch.Tensor:
    g = q.float().reshape(*q.shape[:-1], q.shape[-1] // group, group)
    return (g * scale[..., None]).reshape(q.shape)


def _pad_chunks(x: torch.Tensor, n: int, group: int = QUANT_GROUP
                ) -> Tuple[torch.Tensor, int]:
    """Flatten to fp32 and split into ``n`` equal group-aligned chunks."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % (n * group)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, -1), pad        # row j is bound for rank j


def _wire_mean(chunks: torch.Tensor, group=None):
    """Two-hop int8 mean of per-rank ``chunks`` (n, c).

    Returns ``(out, e1, e2)``: the rebuilt full mean (n*c,), the local
    hop-1 quantization error (n, c) — what THIS rank failed to put on the
    wire — and the hop-2 re-quantization error (c,) of the mean chunk this
    rank owns.
    """
    q, s = _quantize(chunks)
    e1 = chunks - _dequantize(q, s)
    q = all_to_all_rows(q, group)                  # int8 on the wire
    s = all_to_all_rows(s, group)
    mean = _dequantize(q, s).mean(0)
    q2, s2 = _quantize(mean)
    e2 = mean - _dequantize(q2, s2)
    q2 = all_gather_rows(q2, group).reshape(-1)    # int8 again
    s2 = all_gather_rows(s2, group).reshape(-1)
    return _dequantize(q2, s2), e1, e2


def int8_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` with the int8 wire
    format; shape- and dtype-preserving, accumulated in fp32."""
    n = world_size(group)
    if n == 1:
        return x
    shape, dtype = x.shape, x.dtype
    chunks, pad = _pad_chunks(x, n)
    out, _, _ = _wire_mean(chunks, group)
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(dtype)


def int8_ef_psum_mean(x: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback mean of ``x`` over the ranks, int8 wire.

    Compresses ``x + err`` and returns ``(mean, new_err)``, ``new_err``
    (fp32, ``err``'s shape) being everything this round dropped: the whole
    hop-1 quantization error (this rank's contribution that never reached
    the wire), plus, on the chunk this rank owns, n times the hop-2
    (re-quantization) error, since it was lost from the mean itself and the
    next round divides the re-injection by n again. The residual stays
    within half a hop-1 step plus n halves of a hop-2 step per element.
    """
    n = world_size(group)
    if n == 1:
        return x, err
    shape, dtype = x.shape, x.dtype
    comp = x.float() + err.float().reshape(shape)
    chunks, pad = _pad_chunks(comp, n)
    out, e1, e2 = _wire_mean(chunks, group)
    e1[rank(group)] += n * e2
    new_err = e1.reshape(-1)
    if pad:
        out, new_err = out[:-pad], new_err[:-pad]
    return (out.reshape(shape).to(dtype),
            new_err.reshape(err.shape).float())
