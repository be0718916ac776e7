"""Attention backend registry: (variant, impl) -> Backend
(port of the JAX package's ``attn/registry.py``).

Resolution (`resolve`): among the backends registered for the spec's
variant, drop the CUDA-only ones off the card, then take the highest
``priority``. Kernel backends register with ``needs_cuda=True``:
auto-selection picks them for CUDA tensors and never elsewhere, while an
explicit ``impl=`` runs anywhere (on CPU tensors every kernel wrapper
takes its plain version).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from repro_torch.attn.spec import AttentionSpec


class BackendResolutionError(ValueError):
    """No registered backend satisfies the call."""


@dataclass(frozen=True)
class CacheLayout:
    """Decode-cache layout owned by a backend.

    ``init(spec, B, max_len, dtype, device)``   build the cache-leaf dict
    ``fill(spec, cache, q, k, v, *, positions, state)``
                                               fill it from prefix q/k/v
    """

    name: str
    init: Callable
    fill: Callable


@dataclass(frozen=True)
class Backend:
    """apply(spec, q, k, v, *, state, positions, pad_mask, update_state)
          -> (out, new_state)
    decode(spec, q, k, v, *, cache, pos, state) -> (out, new_cache)"""

    variant: str
    impl: str
    apply: Callable
    decode: Callable
    layout: CacheLayout
    needs_cuda: bool = False
    priority: int = 0

    @property
    def key(self) -> Tuple[str, str]:
        return (self.variant, self.impl)

    @property
    def name(self) -> str:
        return f"{self.variant}/{self.impl}"


_REGISTRY: Dict[Tuple[str, str], Backend] = {}


def register(backend: Backend) -> Backend:
    if backend.key in _REGISTRY:
        raise ValueError(f"backend {backend.name} already registered")
    _REGISTRY[backend.key] = backend
    return backend


def get(variant: str, impl: str) -> Backend:
    b = _REGISTRY.get((variant, impl))
    if b is None:
        impls = sorted(i for v, i in _REGISTRY if v == variant)
        raise BackendResolutionError(
            f"no backend registered for variant={variant!r} impl={impl!r};"
            f" registered impls for this variant: {impls or 'none'}")
    return b


def resolve(spec: AttentionSpec, *, impl: Optional[str] = None,
            platform: str = "cpu") -> Backend:
    """Pick the backend for a call on ``platform`` tensors, or raise.
    ``impl`` forces one."""
    if impl is not None:
        return get(spec.variant, impl)
    cands = [b for b in _REGISTRY.values() if b.variant == spec.variant]
    ok = [b for b in cands if platform == "cuda" or not b.needs_cuda]
    if not ok:
        raise BackendResolutionError(
            f"no registered backend for variant {spec.variant!r} runs on "
            f"platform {platform!r} (registered: "
            f"{[b.name for b in cands] or 'none'})")
    return max(ok, key=lambda b: b.priority)
