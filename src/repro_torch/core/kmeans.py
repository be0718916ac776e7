"""Online spherical k-means for routing attention (PyTorch port of the JAX
package's ``core/kmeans.py``).

Routing vectors are projected onto the scaled unit ball with a
scale/bias-free LayerNorm (`normalize_routing`), which makes maximum inner
product search equal to nearest-centroid search. Centroids `mu` (H_r, k, dh)
fp32 are state, not parameters: `ema_update` moves them by an exponential
moving average of the (mean of the) vectors assigned to them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class KMeansState(NamedTuple):
    mu: torch.Tensor        # (H_r, k, dh) float32


def init_kmeans(num_heads: int, num_clusters: int, head_dim: int, *,
                generator: torch.Generator, device) -> KMeansState:
    """Random unit-ball init, scaled like the routing vectors (sqrt(d))."""
    mu = torch.randn((num_heads, num_clusters, head_dim), generator=generator,
                     device=device, dtype=torch.float32)
    mu = mu / (torch.linalg.vector_norm(mu, dim=-1, keepdim=True) + 1e-6)
    return KMeansState(mu=mu * float(head_dim) ** 0.5)


def normalize_routing(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with scale/bias disabled (paper Section 4.1): output rows
    have norm sqrt(d). Statistics in fp32, result in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def cluster_scores(r: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """r: (B, H, N, dh), mu: (H, k, dh) -> (B, H, N, k) fp32 affinities."""
    return torch.einsum("bhnd,hkd->bhnk", r.float(), mu.float())


def nearest_onehot(scores: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Argmax assignment as a masked fp32 one-hot (B, H, N, k)."""
    k = scores.shape[-1]
    onehot = torch.nn.functional.one_hot(scores.argmax(-1), k).float()
    if mask is not None:
        onehot = onehot * mask[:, None, :, None].float()
    return onehot


def ema_update(state: KMeansState, r_q: torch.Tensor,
               r_k: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               decay: float = 0.999) -> KMeansState:
    """EMA centroid update (Algorithm 1 line 31), mean-of-members variant;
    empty clusters keep their centroid. r_k=None is the shared-QK case."""
    def one_side(r):
        onehot = nearest_onehot(cluster_scores(r, state.mu), mask)
        sums = torch.einsum("bhnk,bhnd->hkd", onehot, r.float())
        return sums, onehot.sum((0, 2))

    sums, cnts = one_side(r_q)
    if r_k is not None:
        s2, c2 = one_side(r_k)
        sums, cnts = sums + s2, cnts + c2
    means = sums / cnts.clamp_min(1.0)[..., None]
    occupied = (cnts > 0)[..., None]
    new_mu = torch.where(occupied,
                         decay * state.mu + (1.0 - decay) * means, state.mu)
    return KMeansState(mu=new_mu.detach())
