"""Carry the JAX package's trees across to the port, as numpy arrays.

`params_from_jax` converts a parameter tree (``init_model``'s params with
their stacked (G, ...) segment leaves; it works on any tree, caches
included), `kstate_from_jax` the centroid tree (per segment {layer: mu
(G, Hr, k, dh)}) in fp32. The caller hands over numpy leaves (for example
``jax.tree.map(np.asarray, tree)``); nothing here imports jax. bfloat16
leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) go
through a 16-bit integer view. `tree_to_numpy` goes the other way, with
bfloat16 widened to float32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

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
