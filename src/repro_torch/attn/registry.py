"""Attention backend registry: (variant, impl) -> Backend + capabilities
(port of the JAX package's ``attn/registry.py``).

Resolution (`resolve`): among the backends registered for the spec's
variant, drop those whose capabilities do not cover the call (a decode
path needed, a pad mask or explicit positions present, a gradient taken,
a CUDA-only backend off the card), then take the highest ``priority``.
Kernel backends register with ``needs_cuda=True``: auto-selection picks
them for CUDA tensors and never elsewhere, while an explicit ``impl=``
runs anywhere (on CPU tensors every kernel wrapper takes its plain
version). Every other gap of a forced ``impl=`` raises
`BackendResolutionError`, naming the backend auto-selection would use.
A backend's decode kernel may take head dims only up to its widest
instance (``decode_max_head_dim``): a decode cache on the card at a wider
head dim raises `ValueError` (`attn.init_decode_cache`), and never falls
back to a plain backend.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.attn.spec import AttentionSpec


class BackendResolutionError(ValueError):
    """No registered backend satisfies the call (or a forced one can't)."""


@dataclass(frozen=True)
class CacheLayout:
    """Decode-cache layout owned by a backend.

    ``init(spec, B, max_len, dtype, device)``   build the cache-leaf dict
    ``fill(cache, prefix, *, positions)``      fill it from the `Prefix`
                                               (roped keys, routing vectors,
                                               centroid scores) the
                                               prefill's attention computed
    ``reset_values``    leaf name -> its value in a fresh lane (default 0:
                        the ring positions ``lpos`` reset to -1); the slot
                        pool's ``reset_slot`` writes them
    ``head_axes``   leaf name -> the axis of the heads once the leaves are
                    stacked over a segment's groups, (G, B, head, ...), as
                    the JAX package's layouts declare it
    ``pageable_leaves`` leaf names laid out as cluster pages (B, H, kc, cap,
                        ...) whose occupied prefix per page is
                        ``min(page_len_leaf, cap)``: the KV store keeps only
                        that prefix of a parked lane
    ``page_len_leaf``   the (B, H, kc) int leaf counting writes per page
    """

    name: str
    init: Callable
    fill: Callable
    reset_values: Mapping[str, int] = field(default_factory=dict)
    head_axes: Mapping[str, int] = field(default_factory=dict)
    pageable_leaves: Tuple[str, ...] = ()
    page_len_leaf: str = ""


@dataclass(frozen=True)
class Capabilities:
    """What a backend can serve. ``needs_cuda`` gates auto-selection only;
    the other flags hold for a forced ``impl=`` too.

    ``supports_positions``: the causal mask honours caller-supplied
    positions; a kernel that masks by row index declares False, so a call
    with positions goes to (or, forced, refuses into) the reference.
    ``supports_grad``: the apply path is differentiable (autograd of
    PyTorch ops, or a kernel with a backward Function).
    ``decode_max_head_dim``: the widest head dim the decode path's kernel
    takes on the card (None: any); a narrower one runs zero-padded to one
    of its widths.
    """

    supports_decode: bool = False
    supports_pad_mask: bool = True
    supports_positions: bool = True
    supports_grad: bool = False
    needs_cuda: bool = False
    decode_max_head_dim: Optional[int] = None


@dataclass(frozen=True)
class Backend:
    """apply(spec, q, k, v, *, state, positions, pad_mask, update_state)
          -> (out, new_state, prefix): the `Prefix` a cache fill reuses
          (empty for a variant without a decode layout); a routing
          variant with ``RoutingConfig.stats`` appends its RoutingStats
    decode(spec, q, k, v, *, cache, pos, state) -> (out, new_cache)
          [supports_decode only, with its ``layout``]"""

    variant: str
    impl: str
    apply: Callable
    caps: Capabilities
    decode: Optional[Callable] = None
    layout: Optional[CacheLayout] = None
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
    if backend.caps.supports_decode and (backend.decode is None
                                         or backend.layout is None):
        raise ValueError(f"{backend.name}: supports_decode without a decode "
                         f"fn and a CacheLayout")
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


def backends_for(variant: str) -> List[Backend]:
    return [b for b in _REGISTRY.values() if b.variant == variant]


def _merged(field_of, what: str) -> Dict[str, object]:
    """leaf name -> value over every registered layout's ``field_of``
    pairs; two layouts that disagree on a leaf raise."""
    out: Dict[str, object] = {}
    for lo in (b.layout for b in _REGISTRY.values() if b.layout is not None):
        for leaf, val in field_of(lo):
            prev = out.setdefault(leaf, val)
            if prev != val:
                raise ValueError(f"conflicting {what} for cache leaf "
                                 f"{leaf!r}: {prev!r} vs {val!r} (layout "
                                 f"{lo.name!r})")
    return out


def cache_head_axes() -> Dict[str, int]:
    """leaf name -> head axis (pool coordinates) over the registered
    layouts (`dist.sharding.cache_sharding` reads it)."""
    return _merged(lambda lo: lo.head_axes.items(), "head axes")


def cache_reset_values() -> Dict[str, int]:
    """leaf name -> reset value over the registered layouts (the slot
    pool's ``reset_slot``; leaves not listed reset to 0)."""
    return _merged(lambda lo: lo.reset_values.items(), "reset values")


def pageable_cache_leaves() -> Dict[str, str]:
    """leaf name -> its page-length leaf, for the cluster-page leaves of
    the registered layouts (the KV store's page compaction)."""
    return _merged(lambda lo: ((leaf, lo.page_len_leaf)
                               for leaf in lo.pageable_leaves),
                   "page-length leaves")


def _gaps(b: Backend, *, decode: bool, padded: bool, positioned: bool,
          needs_grad: bool, platform: str, forced: bool) -> List[str]:
    """Capability gaps of ``b`` for this call. ``needs_cuda`` counts only
    against auto-selection."""
    gaps = []
    if decode and not b.caps.supports_decode:
        gaps.append("call needs a decode path (cache given) but "
                    "supports_decode=False")
    if padded and not b.caps.supports_pad_mask:
        gaps.append("call has a pad_mask but supports_pad_mask=False")
    if positioned and not b.caps.supports_positions:
        gaps.append("call has explicit positions but the backend masks "
                    "by row index (supports_positions=False)")
    if needs_grad and not b.caps.supports_grad:
        gaps.append("call is differentiated but supports_grad=False")
    if not forced and b.caps.needs_cuda and platform != "cuda":
        gaps.append(f"needs_cuda on platform {platform!r}")
    return gaps


def resolve(spec: AttentionSpec, *, decode: bool = False,
            padded: bool = False, positioned: bool = False,
            needs_grad: bool = False, impl: Optional[str] = None,
            platform: str = "cpu") -> Backend:
    """Pick the backend for a call on ``platform`` tensors, or raise.
    ``impl`` forces one; a capability it lacks is an error."""
    kw = dict(decode=decode, padded=padded, positioned=positioned,
              needs_grad=needs_grad, platform=platform)
    if impl is not None:
        b = get(spec.variant, impl)
        gaps = _gaps(b, forced=True, **kw)
        if gaps:
            msg = (f"forced backend {b.name} cannot serve this call:\n  - "
                   + "\n  - ".join(gaps))
            ok = [c for c in backends_for(spec.variant)
                  if not _gaps(c, forced=False, **kw)]
            if ok:
                alt = max(ok, key=lambda c: c.priority)
                msg += (f"\nauto-selection (impl=None) would serve this "
                        f"call with {alt.name}")
            raise BackendResolutionError(msg)
        return b
    cands = backends_for(spec.variant)
    ok = [b for b in cands if not _gaps(b, forced=False, **kw)]
    if not ok:
        detail = "; ".join(
            f"{b.name}: {', '.join(_gaps(b, forced=False, **kw))}"
            for b in cands)
        raise BackendResolutionError(
            f"no registered backend for variant {spec.variant!r} covers "
            f"this call on platform {platform!r} ({detail or 'none'})")
    return max(ok, key=lambda b: b.priority)
