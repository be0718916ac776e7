"""Carry the JAX package's trees across to the port, as numpy arrays.

`params_from_jax` converts a parameter tree (``init_model``'s params with
their stacked (G, ...) segment leaves; it works on any tree, caches
included), `kstate_from_jax` the centroid tree (per segment {layer: mu
(G, Hr, k, dh)}) in fp32. The caller hands over numpy leaves (for example
``jax.tree.map(np.asarray, tree)``); nothing here imports jax. bfloat16
leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) go
through a 16-bit integer view. `tree_to_numpy` goes the other way, with
bfloat16 widened to float32. `opt_state_from_jax` and `train_state_from_jax`
carry an Adam state and a whole JAX ``TrainState`` across, so the port can
continue a JAX training run mid-trajectory.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

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
    """The JAX package's Adam state ({"m", "v": fp32 trees, "count"}, numpy
    leaves) -> the port's (``count`` a Python int)."""
    return {"m": kstate_from_jax(opt_state["m"], device),
            "v": kstate_from_jax(opt_state["v"], device),
            "count": int(np.asarray(opt_state["count"]))}


def train_state_from_jax(ts: Any, device="cpu"):
    """A JAX ``TrainState`` (numpy leaves; no int8_ef residual) -> the
    port's ``TrainState``, so a test can continue a JAX run."""
    if getattr(ts, "ef_state", None) is not None:
        raise NotImplementedError("int8_ef residuals are not ported")
    return TrainState(params=params_from_jax(ts.params, device),
                      kstate=kstate_from_jax(ts.kstate, device),
                      opt_state=opt_state_from_jax(ts.opt_state, device),
                      step=int(np.asarray(ts.step)))
