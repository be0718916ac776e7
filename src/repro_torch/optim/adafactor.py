"""Adafactor (Shazeer & Stern 2018) — the paper's PG-19 optimizer (port of
the JAX package's ``optim/adafactor.py``).

Sublinear memory: the second moment of a leaf of two or more dims is
factored into row statistics ``vr`` (the mean over the last axis) and
column statistics ``vc`` (the mean over the second-to-last), so a stacked
(G, d_in, d_out) weight keeps (G, d_in) and (G, d_out) and a stacked (G, d)
bias keeps (G,) and (d,); a 1-D leaf keeps its full statistics ``v``.
Relative step sizes (the update scaled by max(RMS(param), 1e-3)), RMS-1
update clipping, beta2 = 1 - t^-0.8, no momentum.

Functional API, as `optim.adam`: `init(params) -> state`, `update(grads,
state, params, lr) -> (new_params, new_state)`; nothing is updated in
place. The state is ``{"stats": {...: {"vc", "vr"} | {"v"}}, "count"}``
with the JAX package's keys (in the order JAX flattens them), ``count`` a
Python int. Everything is
computed in fp32 and the new parameters are cast back to each leaf's
dtype; beta2 is computed in fp32 from the step count, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_EPS1 = 1e-30
_EPS2 = 1e-3
_CLIP = 1.0


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(min_dim_size_to_factor: int = 32):
    """``min_dim_size_to_factor`` is accepted and unused, as in the JAX
    package: every leaf of two or more dims is factored."""
    def init(params):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z),
                        "vr": torch.zeros(p.shape[:-1], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"stats": tree_map(one, params), "count": 0}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        beta2 = np.float32(1.0) - np.float32(count) ** np.float32(-0.8)
        keep, take = float(beta2), float(np.float32(1.0) - beta2)

        def upd(g, s, p):
            g32 = g.float()
            g2 = g32.square() + _EPS1
            if _factored(p.shape):
                vr = keep * s["vr"] + take * g2.mean(-1)
                vc = keep * s["vc"] + take * g2.mean(-2)
                # V-hat = vr vc / mean(vr)  (Shazeer-Stern eq. 4-6)
                r = vr / vr.mean(-1, keepdim=True).clamp_min(_EPS1)
                u = g32 * torch.rsqrt(r[..., None] * vc[..., None, :]
                                      + _EPS1)
                new_s = {"vc": vc, "vr": vr}
            else:
                v = keep * s["v"] + take * g2
                u = g32 * torch.rsqrt(v + _EPS1)
                new_s = {"v": v}
            rms_u = torch.sqrt(u.square().mean() + _EPS1)
            u = u / (rms_u / _CLIP).clamp_min(1.0)
            p32 = p.float()
            scale = torch.sqrt(p32.square().mean()).clamp_min(_EPS2)
            return (p32 - lr * scale * u).to(p.dtype), new_s

        stats = tree_leaves_dicts(state["stats"], params)
        out = [upd(g, s, p) for g, s, p in zip(
            tree_leaves(grads), stats, tree_leaves(params))]
        return (tree_unflatten(params, [o[0] for o in out]),
                {"stats": tree_unflatten(params, [o[1] for o in out]),
                 "count": count})

    return init, update


def tree_leaves_dicts(stats, params):
    """The per-leaf statistics dicts of ``stats``, in the `tree_leaves`
    order of ``params`` (each leaf of ``params`` holds one dict there)."""
    out = []
    tree_map(lambda _, s: out.append(s), params, stats)
    return out
