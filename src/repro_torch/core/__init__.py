"""The port's math references: k-means routing, local, full and routed
attention in plain PyTorch."""
import torch


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least fp32: bf16 is widened, float64 (gradient checks)
    kept."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def row_dot(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(do * out) in at least fp32: the softmax-backward term
    every attention backward kernel takes (computed outside the kernels,
    as the JAX package does)."""
    return (upcast(do) * upcast(out)).sum(-1)
