"""Megatron-style collectives of the model axis (no counterpart file in the
JAX package: there GSPMD inserts these from the rule table's placements).

Every function takes the `Mesh` (`repro_torch.launch.mesh`) and works over
its model group; on a model axis of one rank each is the identity.

  `ModelAxis.enter(h)`  before a column-parallel product: the identity
      forward with an all-reduce backward (`CopyToModel`), or with
      sequence parallelism the gather of the sequence shards, whose
      backward is a reduce-scatter (`GatherSeq`).
  `ModelAxis.exit(o)`   after a row-parallel product: the all-reduce
      forward with an identity backward (`ReduceFromModel`), or the
      reduce-scatter over the sequence, whose backward is a gather
      (`ScatterSeq`).
  `vocab_embed`          the vocab-parallel lookup of a (V / M, d) table.
  `vocab_lse_target`     the log-sum-exp and target logit of vocab-parallel
      logits: max, sum of exponentials and target logit reduced over the
      model axis, no full-vocabulary logits in memory.

The sums are deterministic and equal to the bit on every rank: each rank
sums its 1 / M chunk of the ranks' tensors in rank order (an all-to-all),
and an all-gather hands the chunks round. That is a reduce-scatter and an
all-gather, the bytes of a ring all-reduce. gloo carries CUDA tensors
through the host (several ranks on one card, which NCCL refuses), so under
gloo every collective runs on host copies (`compression._staged`).
`wire_bytes` counts the bytes this process has sent over model groups
since `reset_wire_bytes`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.compression import _staged

_WIRE = {"model": 0}


def wire_bytes() -> int:
    """Bytes this process sent to other ranks over a model group."""
    return _WIRE["model"]


def reset_wire_bytes() -> None:
    _WIRE["model"] = 0


def _size(mesh) -> int:
    return 1 if mesh is None else mesh.size("model")


def _gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """(M, *t.shape): row i is model rank i's ``t``."""
    group = mesh.group("model")
    src = _staged(t, group)
    M = _size(mesh)
    parts = [torch.empty_like(src) for _ in range(M)]
    dist.all_gather(parts, src, group=group)
    _WIRE["model"] += t.numel() * t.element_size() * (M - 1)
    return torch.stack(parts).to(t.device)


def _exchange_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Row j of ``t`` (M, ...) goes to model rank j; row i of the result
    came from model rank i."""
    group = mesh.group("model")
    src = _staged(t, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    M = _size(mesh)
    _WIRE["model"] += t.numel() * t.element_size() * (M - 1) // M
    return out.to(t.device)


def all_gather_dim(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Model ranks' ``t`` concatenated along ``dim`` in rank order."""
    if _size(mesh) == 1:
        return t
    return torch.cat(list(_gather_rows(t.contiguous(), mesh).unbind(0)), dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model rank's block (of M along ``dim``) of the sum of the
    ranks' ``t``, summed in fp32 in rank order, in ``t``'s dtype."""
    M = _size(mesh)
    if M == 1:
        return t
    rows = torch.stack(t.chunk(M, dim)).contiguous()
    return _exchange_rows(rows, mesh).float().sum(0).to(t.dtype)


def all_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the model ranks' ``t``, in fp32 in rank order (one rank
    sums each chunk, so every rank gets the same bits), in ``t``'s
    dtype."""
    M = _size(mesh)
    if M == 1:
        return t
    flat = t.reshape(-1)
    pad = (-flat.numel()) % M
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    part = _exchange_rows(flat.reshape(M, -1), mesh).float().sum(0)
    full = _gather_rows(part.to(t.dtype), mesh).reshape(-1)
    return full[:t.numel()].reshape(t.shape)


def all_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of the model ranks' ``t``."""
    if _size(mesh) == 1:
        return t
    return _gather_rows(t.contiguous(), mesh).amax(0)


# ---------------------------------------------------------------------------
# The conjugate pairs
# ---------------------------------------------------------------------------
class CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated activation
    entering a column-parallel product (each rank's gradient is a partial
    sum over its columns)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return all_sum(g.contiguous(), ctx.mesh), None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product (or of a vocab-parallel lookup) added up."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_sum(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherSeq(torch.autograd.Function):
    """The sequence shards (B, N / M, ...) gathered into (B, N, ...);
    backward: the gradient reduce-scattered back to the shards."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_dim(x, 1, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.contiguous(), 1, ctx.mesh), None


class ScatterSeq(torch.autograd.Function):
    """Partial sums (B, N, ...) reduce-scattered over the sequence into
    this rank's (B, N / M, ...); backward: the shards' gradients
    gathered."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return reduce_scatter_dim(x.contiguous(), 1, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), 1, ctx.mesh), None


def gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """`GatherSeq` (the identity on one model rank)."""
    return x if _size(mesh) == 1 else GatherSeq.apply(x, mesh)


class ModelAxis:
    """The model axis a forward runs on: the mesh, this rank's coordinate
    and whether the residual stream is sequence-parallel."""

    def __init__(self, mesh, seq_parallel: bool = False):
        self.mesh = mesh
        self.size = _size(mesh)
        self.rank = mesh.coord("model")
        self.seq_parallel = bool(seq_parallel) and self.size > 1

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel product."""
        if self.size == 1:
            return h
        if self.seq_parallel:
            return GatherSeq.apply(h, self.mesh)
        return CopyToModel.apply(h, self.mesh)

    def exit(self, o: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product (or a vocab-parallel lookup)."""
        if self.size == 1:
            return o
        if self.seq_parallel:
            return ScatterSeq.apply(o, self.mesh)
        return ReduceFromModel.apply(o, self.mesh)

    def seq_rows(self, n_local: int):
        """(offset, full length) of this rank's rows of the residual
        stream: its slice of the sequence under sequence parallelism."""
        if not self.seq_parallel:
            return 0, n_local
        return self.rank * n_local, n_local * self.size


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and cross entropy
# ---------------------------------------------------------------------------
def _local_ids(tokens: torch.Tensor, lo: int, n: int):
    local = tokens.long() - lo
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def vocab_embed(tok: torch.Tensor, tokens: torch.Tensor,
                axis: ModelAxis) -> torch.Tensor:
    """Rows of a vocab-parallel table ``tok`` (V / M, d) for ``tokens``
    (B, N): each rank looks up the tokens of its vocabulary block, zeros
    elsewhere, and `ModelAxis.exit` adds the ranks' rows (with sequence
    parallelism, into this rank's slice of the sequence)."""
    n = tok.shape[0]
    ids, inside = _local_ids(tokens, axis.rank * n, n)
    rows = tok[ids].masked_fill(~inside[..., None], 0)
    return axis.exit(rows)


class _VocabLseTarget(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, mesh, lo):
        n = logits.shape[-1]
        m = all_max(logits.amax(-1), mesh)
        e = torch.exp(logits - m[..., None])
        s = all_sum(e.sum(-1), mesh)
        ids, inside = _local_ids(targets, lo, n)
        t = torch.gather(logits, -1, ids[..., None])[..., 0]
        tgt = all_sum(torch.where(inside, t, 0.0), mesh)
        ctx.save_for_backward(e / s[..., None], ids, inside)
        return torch.log(s) + m, tgt

    @staticmethod
    def backward(ctx, dlse, dtgt):
        p, ids, inside = ctx.saved_tensors
        g = p * dlse[..., None]
        g.scatter_add_(-1, ids[..., None],
                       torch.where(inside, dtgt, 0.0)[..., None])
        return g, None, None, None


def vocab_lse_target(logits: torch.Tensor, targets: torch.Tensor,
                     axis: ModelAxis):
    """(lse, target logit), each (B, S), of vocab-parallel fp32 logits
    (B, S, V / M): equal on every model rank; their gradients flow back
    to this rank's block of the logits only."""
    return _VocabLseTarget.apply(logits, targets, axis.mesh,
                                 axis.rank * logits.shape[-1])
