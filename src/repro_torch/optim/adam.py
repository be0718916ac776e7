"""Adam (Kingma & Ba 2015) — the paper's optimizer for all LMs but PG-19
(port of the JAX package's ``optim/adam.py``).

Functional API: `init(params) -> state`, `update(grads, state, params, lr)
-> (new_params, new_state)`; nothing is updated in place. Moments are fp32
whatever the parameter dtype: the update is computed in fp32 and cast back
to the parameter's dtype (bf16 for the paper configs). The bias
corrections are computed in fp32, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def adam(b1=0.9, b2=0.98, eps=1e-9, weight_decay=0.0):
    def init(params):
        def f32(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(f32, params), "v": tree_map(f32, params),
                "count": 0}

    def update(grads, state, params, lr, model=None):
        # elementwise: a model-axis shard (``model``) updates on its own
        count = state["count"] + 1
        c = np.float32(count)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** c)

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32.square()
            step = (m / bc1) / ((v / bc2).sqrt() + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (p.float() - lr * step).to(p.dtype), m, v

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(params))]
        return (tree_unflatten(params, [o[0] for o in out]),
                {"m": tree_unflatten(params, [o[1] for o in out]),
                 "v": tree_unflatten(params, [o[2] for o in out]),
                 "count": count})

    return init, update
