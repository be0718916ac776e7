"""Mesh shapes of the port (port of the JAX package's ``launch/mesh.py``):
a (data, model) grid over the processes of the default process group, one
device each. The port runs the data axis only: a grid whose model axis
stays above 1 after clamping, and the production meshes, wait for ROADMAP
item 10 (the rule table, model-axis meshes, sequence parallelism, FSDP,
the dry run and the engine's mesh)."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.dist import compression as comp

_MODEL_AXIS = ("a model axis above 1 waits for ROADMAP item 10 (the rule "
               "table, model-axis meshes, --seq-parallel, FSDP, dryrun and "
               "the engine's mesh)")


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(f"the production meshes: {_MODEL_AXIS}")


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


def make_host_mesh(data: int = 1, model: int = 1) -> Dict[str, int]:
    """The clamped grid ``{"data": D, "model": 1}`` over the world's
    processes. Raises `NotImplementedError` for a model axis above 1, and
    `ValueError` for a data axis that leaves processes out (every process
    of the port's data-parallel step is a rank of the data axis)."""
    n = comp.world_size()
    data, model = feasible_mesh_shape(n, data, model)
    if model > 1:
        raise NotImplementedError(f"mesh ({data}x{model}): {_MODEL_AXIS}")
    if data != n:
        raise ValueError(f"mesh ({data}x{model}) leaves {n - data} of {n} "
                         f"processes out of the data axis")
    return {"data": data, "model": model}
