"""Carry the JAX package's trees across to the port, as numpy arrays.

`params_from_jax` converts a parameter tree (``init_model``'s params with
their stacked (G, ...) segment leaves; it works on any tree, caches
included), `kstate_from_jax` the centroid tree (per segment {layer: mu
(G, Hr, k, dh)}) in fp32. The caller hands over numpy leaves (for example
``jax.tree.map(np.asarray, tree)``); nothing here imports jax. bfloat16
leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) go
through a 16-bit integer view. `tree_to_numpy` goes the other way, with
bfloat16 widened to float32. `opt_state_from_jax` and `train_state_from_jax`
carry an Adam or an Adafactor state and a whole JAX ``TrainState`` across,
so the port can continue a JAX training run mid-trajectory; its int8
error-feedback residuals ((D, *shape) fp32 leaves) come across as this
rank's row. On a mesh with a model axis (``mesh=``, ``cfg=``) the state
comes across as this rank's shards, its local+routing heads grouped as
`dist.sharding.shard_state` groups them; `cache_from_jax` carries a JAX
decode cache or slot pool into a rank's part of it
(`dist.sharding.shard_cache`), so pages can be held against the JAX
package's on any mesh.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.dist import compression as comp
from repro_torch.train.train_step import TrainState
from repro_torch.tree import tree_map


def _leaf_to_torch(x: Any, device) -> Any:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """A JAX tree of numpy leaves (``init_model`` params, a cache) -> the
    same tree of tensors on ``device``, dtypes kept."""
    return tree_map(lambda x: _leaf_to_torch(x, device), tree)


def cache_from_jax(tree: Any, device="cpu", mesh=None,
                   batch: int = 1) -> Any:
    """A JAX decode cache or slot pool (numpy leaves (G, B, ...), ``batch``
    = B) -> the port's, on a ``mesh`` this rank's part: its heads and,
    where B divides over the data ranks, its slots. The JAX package
    stores cluster-page rows at the head dim, the port at the decode
    kernel's width: the leaves keep the JAX package's widths."""
    full = params_from_jax(tree, device)
    if mesh is None:
        return full
    from repro_torch.dist.sharding import shard_cache
    return shard_cache(full, mesh, batch)


def kstate_from_jax(tree: Any, device="cpu") -> Any:
    """The JAX centroid tree (numpy leaves) -> port kstate, fp32."""
    return tree_map(lambda x: _leaf_to_torch(x, device).float(), tree)


def tree_to_numpy(tree: Any) -> Any:
    """Port tensors -> numpy (bfloat16 widened to float32)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(conv, tree)


def opt_state_from_jax(opt_state: Any, device="cpu") -> Any:
    """The JAX package's Adam state ({"m", "v": fp32 trees, "count"}) or
    Adafactor state ({"stats": a tree of {"vr", "vc"} or {"v"} fp32
    leaves, "count"}), numpy leaves -> the port's (``count`` a Python
    int)."""
    count = int(np.asarray(opt_state["count"]))
    if "stats" in opt_state:
        return {"stats": kstate_from_jax(opt_state["stats"], device),
                "count": count}
    return {"m": kstate_from_jax(opt_state["m"], device),
            "v": kstate_from_jax(opt_state["v"], device),
            "count": count}


def ef_state_from_jax(ef_state: Any, device="cpu") -> Any:
    """The JAX package's residuals ((D, *shape) fp32 numpy leaves, row i
    device i's) -> the port's: this rank's row (1, *shape) when the default
    process group has D ranks, every row with no group (at D = 1 its only
    row; at D > 1 the port's step refuses the state)."""
    n, r = comp.world_size(), comp.rank()

    def row(x):
        t = _leaf_to_torch(x, device).float()
        if n == 1:
            return t
        if t.shape[0] != n:
            raise ValueError(f"residual of {t.shape[0]} rows for {n} ranks")
        return t[r:r + 1].clone()
    return tree_map(row, ef_state)


def train_state_from_jax(ts: Any, device="cpu", mesh=None, cfg=None):
    """A JAX ``TrainState`` (numpy leaves) -> the port's ``TrainState``
    (residuals by `ef_state_from_jax`), so the port can continue a JAX
    run; on a ``mesh`` whose model axis holds more than one rank, this
    rank's shards of it (``cfg`` names the model: its head grouping)."""
    ef = getattr(ts, "ef_state", None)
    full = TrainState(params=params_from_jax(ts.params, device),
                      kstate=kstate_from_jax(ts.kstate, device),
                      opt_state=opt_state_from_jax(ts.opt_state, device),
                      step=int(np.asarray(ts.step)),
                      ef_state=None if ef is None else ef_state_from_jax(
                          ef, device))
    if mesh is None or mesh.size("model") <= 1:
        return full
    from repro_torch.dist.sharding import shard_state
    return shard_state(full, cfg, mesh)
