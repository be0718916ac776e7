"""Per-request sampling, vectorised across heterogeneous pool slots (port
of the JAX package's ``serve/engine/sampling.py``).

One ``sample_tokens`` call handles the whole pool each step: every slot
carries its own temperature / top-k / top-p (temperature 0 = greedy) and
its own counter-based PRNG stream
``fold_in(fold_in(key(seed), uid), token_index)`` (`repro_torch.prng`, the
JAX package's threefry2x32 keys bit for bit), so a request's sampled
tokens do not depend on which slot it lands in or which co-tenants share
the pool.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import prng


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 => greedy (argmax)
    top_k: int = 0               # 0 or >= vocab => disabled
    top_p: float = 1.0           # >= 1 => disabled
    seed: int = 0


def request_base_key(params: SamplingParams, uid: int,
                     device="cpu") -> torch.Tensor:
    """Per-request key root (2,); the engine folds the token index in."""
    return prng.fold_in(prng.key(params.seed, device), uid)


def request_key(params: SamplingParams, uid: int, token_index: int,
                device="cpu") -> torch.Tensor:
    """Counter-based key: independent of slot placement and co-tenants."""
    return prng.fold_in(request_base_key(params, uid, device), token_index)


@torch.no_grad()
def sample_tokens(keys, logits, temperature, top_k, top_p) -> torch.Tensor:
    """keys (B, 2); logits (B, V); temperature / top_p (B,) fp32; top_k (B,)
    int, all on one device.

    Rows with temperature <= 0 take the argmax of the raw logits (the first
    maximum); the rest are top-k then top-p filtered at their own
    temperature and sampled from their own key. Returns (B,) int32.
    """
    V = logits.shape[-1]
    lg = logits.float()
    greedy_tok = torch.argmax(lg, dim=-1)
    scaled = lg / torch.clamp(temperature, min=1e-6)[:, None]
    # per-row top-k: mask everything below the k-th largest logit
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, torch.clamp(top_k - 1, 0, V - 1)[:, None]
                       .long())
    use_k = (top_k > 0) & (top_k < V)
    scaled = torch.where(use_k[:, None] & (scaled < kth), -torch.inf, scaled)
    # per-row nucleus: keep the smallest prefix of descending-probability
    # tokens whose exclusive cumulative mass is < top_p (the top-1 always
    # survives). The sort is stable, as jnp.argsort is: the order of tied
    # logits decides which of them the prefix keeps.
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_lg = torch.gather(scaled, 1, order)
    probs = torch.softmax(sorted_lg, dim=-1)
    keep_sorted = (torch.cumsum(probs, -1) - probs) < top_p[:, None]
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    use_p = top_p < 1.0
    scaled = torch.where(use_p[:, None] & ~keep, -torch.inf, scaled)
    sampled = prng.categorical(keys, scaled)
    return torch.where(temperature <= 0.0, greedy_tok,
                       sampled).to(torch.int32)
