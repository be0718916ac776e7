"""JAX's default PRNG (threefry2x32) on torch tensors.

The serve engine samples each request from its own counter-based stream,
``fold_in(fold_in(key(seed), uid), token_index)``, so a request's tokens do
not depend on its slot or its co-tenants. This module computes those keys
and the random values drawn from them as ``jax.random`` does with the
threefry2x32 implementation and ``jax_threefry_partitionable=True`` (the
default of the JAX the reference package runs on), so the port's streams
are the reference's:

  key(seed)               ``jax.random.PRNGKey(seed)`` (32-bit seeds: the
                          high word is 0, the low word the seed mod 2^32)
  fold_in(keys, data)     ``jax.random.fold_in``
  random_bits(keys, shape)  32-bit ``jax.random.bits``
  uniform(keys, shape)    float32 ``jax.random.uniform``
  gumbel(keys, shape)     float32 ``jax.random.gumbel`` (mode "low")
  categorical(keys, logits)  ``jax.random.categorical`` over the last axis

A key is an int64 tensor of shape (..., 2) holding two uint32 words; every
function takes a batch of keys (leading axes) and works on any device.
The words are carried in int64 and masked to 32 bits after each addition
and shift, so the keys and bits equal JAX's exactly. ``gumbel`` applies
torch's ``log``, which may differ from XLA's in the last bits, so a sampled
token can differ from JAX's only where two perturbed logits lie within a
few ulps of each other.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the count words (x1, x2) under
    the key words (k1, k2); int64 tensors of uint32 values, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = (((b << r) | (b >> (32 - r))) & _MASK) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & _MASK
    return a, b


def key(seed: Union[int, torch.Tensor], device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (..., 2) int64 words (0, seed mod
    2^32)."""
    lo = _u32(seed, device)
    return torch.stack([torch.zeros_like(lo), lo], -1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count (0, data) under each
    key; ``data`` (uint32 values) broadcasts against the keys' batch."""
    d = _u32(data, keys.device)
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], -1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` per key: (..., *shape) int64.
    The partitionable form hashes each element's flat index (high word 0
    below 2^32 elements) and folds the two output words by xor."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 2 ** 32:
        raise NotImplementedError("random bits of 2^32 elements or more")
    lo = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    lead = keys.shape[:-1] + (1,) * len(shape)
    a, b = threefry2x32(keys[..., 0].reshape(lead), keys[..., 1].reshape(lead),
                        torch.zeros_like(lo), lo)
    return a ^ b


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` in [minval, maxval): the top 23 bits
    as the mantissa of a float in [1, 2), less 1, scaled."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``jax.random.gumbel`` (mode "low"): -log(-log(u)), u uniform
    in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row:
    argmax of the logits plus Gumbel noise (the first maximum)."""
    noise = gumbel(keys, logits.shape[-1:]).to(logits.dtype)
    return torch.argmax(noise + logits, dim=-1)
