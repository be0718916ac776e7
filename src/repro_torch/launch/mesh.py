"""Mesh shapes of the port (port of the JAX package's ``launch/mesh.py``).

A `Mesh` is a (data, model) grid over the processes of the default process
group, one device each, rank ``r = d * M + m`` at coordinates (d, m). It
carries its shape, its axis names, this rank's coordinates and the process
groups of its two axes: the data group of a rank holds the ranks of its
model coordinate, its model group the ranks of its data coordinate. Every
rank creates every group, in the same order (``torch.distributed.new_group``
is collective). The production meshes (16x16, and 2x16x16 with a "pod"
axis) carry a shape and names only, no groups: the rule table
(`repro_torch.dist.sharding`) takes them, as the JAX package's dry run
takes an abstract mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.dist import compression as comp


class Mesh:
    """A named device grid. ``shape`` maps each axis name to its size, in
    the mesh's axis order; ``coords`` this rank's coordinate on each axis
    (None for an abstract mesh); ``groups`` an axis name to its process
    group: None where the axis is one rank (the collectives skip it) or
    is the whole world (the default group)."""

    def __init__(self, shape: Dict[str, int],
                 coords: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, object]] = None):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.coords = None if coords is None else dict(coords)
        self.groups = dict(groups or {})

    def size(self, axis) -> int:
        """Ranks along ``axis`` (a name, a tuple of names or None); a name
        the mesh lacks counts 1."""
        if axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            n = 1
            for a in axis:
                n *= self.size(a)
            return n
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return 0 if self.coords is None else self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production grid's shape and names (no processes behind it)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def feasible_mesh_shape(n: int, data: int, model: int) -> Tuple[int, int]:
    """Largest (data, model) grid that fits on ``n`` devices.

    When the request fits, it is returned unchanged. When it oversubscribes,
    the model axis is preserved as far as possible — clamped to the largest
    divisor of ``n`` not exceeding the request — and data fills the rest,
    instead of silently dropping model parallelism altogether.
    """
    if data * model <= n:
        return data, model
    model = max(m for m in range(1, min(model, n) + 1) if n % m == 0)
    return n // model, model


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The clamped (data, model) grid over the world's processes, with this
    rank's coordinates and the axes' process groups. Raises `ValueError`
    for a grid that leaves processes out (every process is a rank of the
    port's train step)."""
    n, r = comp.world_size(), comp.rank()
    data, model = feasible_mesh_shape(n, data, model)
    if data * model != n:
        raise ValueError(f"mesh ({data}x{model}) leaves {n - data * model} "
                         f"of {n} processes out")
    groups = {}
    if n > 1:
        for axis, size, ranks_of in (
                ("data", data,
                 lambda m: [d * model + m for d in range(data)]),
                ("model", model,
                 lambda d: [d * model + m for m in range(model)])):
            if size == n:
                groups[axis] = None          # the default group
                continue
            if size == 1:
                continue
            other = n // size
            for j in range(other):       # every rank, in the same order
                ranks = ranks_of(j)
                g = dist.new_group(ranks)
                if r in ranks:
                    groups[axis] = g
    return Mesh({"data": data, "model": model},
                {"data": r // model, "model": r % model}, groups)
