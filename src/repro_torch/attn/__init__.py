"""repro_torch.attn — the attention-backend API of the port (counterpart of
the JAX package's ``repro.attn``).

    spec = attn.spec_for_layer(cfg, "local+routing")
    out = attn.attend(spec, q, k, v, state=mu, positions=pos)     # train
    out = attn.attend(spec, q, k, v, state=mu, positions=pos,
                      fill=c)                                     # prefill
    out = attn.attend(spec, q, k, v, state=mu, cache=c, pos=p)    # decode

``attend`` resolves the best registered backend whose capabilities cover
the call on the tensors' device (the CUDA kernels for CUDA tensors, plain
PyTorch on the CPU); ``impl=`` forces one and raises
`BackendResolutionError` when it cannot serve the call.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.attn import backends as _backends       # noqa: F401 (registers)
from repro_torch.attn.registry import (Backend,  # noqa: F401
                                       BackendResolutionError, CacheLayout,
                                       backends_for, cache_head_axes,
                                       cache_reset_values,
                                       pageable_cache_leaves, resolve)
from repro_torch.attn.spec import (AttentionSpec, head_shard,  # noqa: F401
                                   head_split, seq_shardable,
                                   spec_for_layer, specs_for_model,
                                   variant_for_layer)


class AttnOutput(NamedTuple):
    out: torch.Tensor                   # (B, H, N, dh)
    state: Optional[torch.Tensor]       # centroids (routing variants)
    cache: Optional[dict] = None        # updated decode cache (decode and
                                        # filling prefill calls)
    stats: Optional[object] = None      # obs.RoutingStats (routing variants
    #                                     with RoutingConfig.stats=True)


def attend(spec: AttentionSpec, q, k, v, *, state=None, positions=None,
           pad_mask=None, update_state: bool = True, cache=None, pos=None,
           impl: Optional[str] = None, fill=None) -> AttnOutput:
    """Run the attention ``spec`` describes on un-roped q/k/v.

    Prefill mode (``cache=None``): returns (out, new_state, and for a
    routing variant with ``RoutingConfig.stats`` its obs.RoutingStats as
    ``stats``); with ``fill``
    (a decode cache of ``spec``, per the layout `init_decode_cache`
    builds) also that cache filled from the keys, routing vectors and
    centroid scores this attention computed, which needs ``positions``.
    Decode mode (``cache`` given): q/k/v are one token (N=1) at position
    ``pos`` (B,); returns the updated cache. ``state`` carries the layer's
    centroids. A call under autograd with q, k or v requiring grad
    resolves only differentiable backends.
    """
    platform = q.device.type
    if cache is not None:
        if pad_mask is not None:
            raise ValueError("attend(cache=...) is single-token decode; "
                             "validity lives in the cache, not a pad_mask")
        backend = resolve(spec, decode=True, impl=impl, platform=platform)
        out, new_cache = backend.decode(spec, q, k, v, cache=cache, pos=pos,
                                        state=state)
        return AttnOutput(out=out, state=state, cache=new_cache)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v))
    backend = resolve(spec, padded=pad_mask is not None,
                      positioned=positions is not None,
                      needs_grad=needs_grad, impl=impl, platform=platform)
    # (out, new_state, prefix) or, with routing-health stats on, (out,
    # new_state, prefix, stats)
    out, new_state, prefix, *stats = backend.apply(
        spec, q, k, v, state=state, positions=positions, pad_mask=pad_mask,
        update_state=update_state)
    new_cache = None if fill is None else _layout(spec, platform).fill(
        fill, prefix, positions=positions)
    return AttnOutput(out=out, state=new_state, cache=new_cache,
                      stats=stats[0] if stats else None)


def decode_backend(spec: AttentionSpec, impl: Optional[str] = None,
                   platform: Optional[str] = None, mesh=None) -> Backend:
    """The backend decode calls for ``spec`` resolve to on ``platform``
    (default: "cuda" when a card is present, else "cpu"); the serve engine
    records it and reads the pool's cache layouts from it. On a ``mesh``
    whose model axis holds M > 1 ranks, the backend of a rank's head shard
    (`head_shard`, which raises `ValueError` where a head count does not
    divide by M): each rank's decode is a single-device call on its heads,
    so the kernel backend resolves there as on one device (the JAX package
    falls back to its reference under a mesh)."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if mesh is not None:
        spec = head_shard(spec, mesh.size("model"))
    return resolve(spec, decode=True, impl=impl, platform=platform)


def _layout(spec: AttentionSpec, platform: str):
    """The cache layout of the decode backend that resolves on
    ``platform`` (the plain and the kernel backend of a variant share
    one). On the card, a head dim wider than its decode kernel takes
    raises `BackendResolutionError` (a `ValueError`): serving does not
    fall back to the plain backend."""
    b = resolve(spec, decode=True, platform=platform)
    top = b.caps.decode_max_head_dim
    if platform == "cuda" and top is not None and spec.head_dim > top:
        raise BackendResolutionError(
            f"{b.name}: decode on the card at head_dim {spec.head_dim}: its "
            f"kernel's widest instance is {top}")
    return b.layout


def init_decode_cache(spec: AttentionSpec, B: int, max_len: int, dtype,
                      device):
    """The cache-leaf dict declared by the resolved backend."""
    dev = torch.device(device)
    return _layout(spec, dev.type).init(spec, B, max_len, dtype, dev)
