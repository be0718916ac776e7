"""Slot-pooled KV cache: a fixed pool of independent cache lanes (port of
the JAX package's ``serve/engine/pool.py``).

The pool is ``serving.init_cache(cfg, max_slots, max_len)``: every cache
leaf is laid out (G, B, ...) with the slot (batch) axis at position 1, so
a lane is ``leaf[:, slot]`` across the cache layouts (local ring, cluster
pages, append cache). On top of that layout:

  write_slot(pool, slot, src)  copy a B=1 cache (one freshly prefilled or
                               resumed request) into lane ``slot``
  reset_slot(pool, slot)       return lane ``slot`` to its fresh state
                               (zeros; ring positions back to -1, the
                               layouts' ``reset_values``) without
                               reallocating, so a freed lane is reusable
  read_slot(pool, slot)        lane ``slot`` as a B=1 cache (a copy)

The engine owns its pool, so ``write_slot`` and ``reset_slot`` write the
pool's leaves in place and return the pool. ``write_slot`` validates the
lane first: its structure, each leaf's rank, group axis, batch axis of 1,
trailing shape (which encodes max_len and the page capacity) and dtype
must agree with the pool; a mismatched lane raises instead of being cast
or broadcast into the pool, where it would corrupt decode far from the
call site.

On a (data, model) mesh (``mesh=``) each rank holds its part of the pool
(`serving.init_cache`): its heads, and its data coordinate's ``max_slots
/ D`` lanes, slot s living on data rank s // (max_slots / D). The slot
arguments stay the global slot ids: ``write_slot`` and ``reset_slot``
write the slot's owner's lane and leave the other data ranks' pools as
they are, and ``read_slot`` hands the owner's lane to every data rank (a
broadcast over the data group: a collective that every rank of the mesh
calls for the same slot), so a parked lane lands in each rank's own KV
store.
"""
from __future__ import annotations

import torch

from typing import Optional

from repro_torch import attn as attn_api
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import compression as comp
from repro_torch.dist.sharding import dp_axes, slot_block
from repro_torch.serve.serving import init_cache
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten


def _data_ranks(mesh) -> int:
    return 1 if mesh is None else mesh.size(dp_axes(mesh))


def init_pool(cfg: ModelConfig, max_slots: int, max_len: int,
              device="cuda", mesh=None):
    """A pool of ``max_slots`` independent cache lanes on ``device``
    (default the card; raises without one unless ``device="cpu"``); on a
    ``mesh`` this rank's part of it (``max_slots`` must divide over the
    data ranks: `dist.sharding.slot_block`)."""
    if max_slots % _data_ranks(mesh):
        raise ValueError(f"max_slots={max_slots} does not divide over "
                         f"{_data_ranks(mesh)} data ranks")
    return init_cache(cfg, max_slots, max_len, device=device, mesh=mesh)


def _path_str(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def _max_slots(pool, mesh) -> int:
    """The whole pool's slot count (`init_pool` cut it evenly)."""
    return tree_leaves(pool)[0].shape[1] * _data_ranks(mesh)


def _check_slot(pool, slot, mesh=None) -> int:
    """The validated global slot id."""
    max_slots = _max_slots(pool, mesh)
    s = int(slot)
    if not 0 <= s < max_slots:
        raise ValueError(
            f"slot {s} out of range for a pool of {max_slots} lanes")
    return s


def _owner(pool, slot, mesh):
    """(data rank owning global ``slot``, its lane index there)."""
    lanes, _ = slot_block(mesh, _max_slots(pool, mesh))
    return divmod(_check_slot(pool, slot, mesh), lanes)


def _local(pool, slot, mesh) -> Optional[int]:
    """This rank's lane index of global ``slot``, None where another data
    rank owns it."""
    s = _check_slot(pool, slot, mesh)
    lanes, lane0 = slot_block(mesh, _max_slots(pool, mesh))
    return s - lane0 if lane0 <= s < lane0 + lanes else None


def _check_lane(pool, src) -> None:
    """Validate a B=1 lane against the pool before it is written."""
    p_paths, s_paths = tree_paths(pool), tree_paths(src)
    p_tree = [p for p, _ in p_paths]
    s_tree = [p for p, _ in s_paths]
    if p_tree != s_tree:
        raise ValueError(
            f"lane cache structure does not match the pool: pool leaves "
            f"{[_path_str(p) for p in p_tree]} vs src leaves "
            f"{[_path_str(p) for p in s_tree]}")
    for (path, p), (_, s) in zip(p_paths, s_paths):
        name = _path_str(path)
        if s.dim() != p.dim():
            raise ValueError(
                f"cache leaf {name}: rank mismatch — pool "
                f"{tuple(p.shape)} vs src {tuple(s.shape)}")
        if s.shape[0] != p.shape[0]:
            raise ValueError(
                f"cache leaf {name}: scan-group axis mismatch — pool "
                f"{p.shape[0]} groups vs src {s.shape[0]}")
        if s.shape[1] != 1:
            raise ValueError(
                f"cache leaf {name}: expected a B=1 lane, got batch axis "
                f"{s.shape[1]} (shape {tuple(s.shape)})")
        if s.shape[2:] != p.shape[2:]:
            raise ValueError(
                f"cache leaf {name}: trailing shape mismatch (max_len / "
                f"page capacity disagreement) — pool {tuple(p.shape[2:])} "
                f"vs src {tuple(s.shape[2:])}")
        if s.dtype != p.dtype:
            raise ValueError(
                f"cache leaf {name}: dtype mismatch — pool {p.dtype} vs "
                f"src {s.dtype}; build the lane with the pool's dtype "
                f"instead of relying on a silent cast")


@torch.no_grad()
def write_slot(pool, slot, src, mesh=None):
    """Copy the single-lane cache ``src`` (B=1, same max_len; any device)
    into lane ``slot`` of ``pool``, in place (on a ``mesh``: on the slot's
    owner). Raises ValueError on a structure, shape or dtype disagreement
    before anything is written."""
    _check_lane(pool, src)
    s = _local(pool, slot, mesh)
    if s is None:
        return pool
    for (_, p), (_, v) in zip(tree_paths(pool), tree_paths(src)):
        p[:, s].copy_(v[:, 0])
    return pool


@torch.no_grad()
def reset_slot(pool, slot, mesh=None):
    """Reset lane ``slot`` to its fresh state in place (the registered
    layouts' reset values; every other leaf 0; on a ``mesh``: on the
    slot's owner)."""
    s = _local(pool, slot, mesh)
    if s is None:
        return pool
    fills = attn_api.cache_reset_values()
    for path, leaf in tree_paths(pool):
        leaf[:, s].fill_(fills.get(path[-1], 0))
    return pool


def read_slot(pool, slot, mesh=None):
    """Lane ``slot`` as a B=1 cache: a copy, on the pool's device. On a
    ``mesh`` with D > 1 data ranks every data rank gets the owner's lane
    (a collective over the data group)."""
    d, s = _owner(pool, slot, mesh)
    lane = tree_map(lambda p: p[:, s:s + 1].clone(), pool)
    if _data_ranks(mesh) == 1:
        return lane
    group = mesh.group("data")
    return tree_unflatten(lane, [comp.broadcast_from(t, d, group)
                                 for t in tree_leaves(lane)])
