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

On a model axis (``update(..., model=(mesh, dims))``, ``dims`` the dim of
each param leaf cut over "model", or None) the params and grads are this
rank's shards and the statistics stay whole (the rule table replicates
vr/vc): a mean over a cut dim is summed over the model ranks, one over
another dim is gathered, and the update's and the parameter's RMS are
summed over the ranks too, so every rank computes its block of the
unsharded update and the same statistics to the bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import tensor_parallel as tpar
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

    def update(grads, state, params, lr, model=None):
        count = state["count"] + 1
        beta2 = np.float32(1.0) - np.float32(count) ** np.float32(-0.8)
        keep, take = float(beta2), float(np.float32(1.0) - beta2)
        mesh, dims = model if model is not None else (None, None)
        M = 1 if mesh is None else mesh.size("model")

        def upd(g, s, p, cut):
            if cut is not None and M == 1:
                cut = None
            nd = p.dim()

            def mean(x, dim):
                """``x.mean(dim)`` of the unsharded x, whole."""
                if cut is None:
                    return x.mean(dim)
                if dim % nd == cut:
                    return tpar.all_sum(x.sum(dim), mesh) / (
                        x.shape[dim] * M)
                return tpar.all_gather_dim(x.mean(dim),
                                           cut - (cut > dim % nd), mesh)

            def block(x, dim):
                """This rank's block of a whole x along ``dim``."""
                n = x.shape[dim] // M
                return x.narrow(dim, mesh.coord("model") * n, n)

            def mean_all(x):
                if cut is None:
                    return x.mean()
                return tpar.all_sum(x.sum(), mesh) / (x.numel() * M)

            g32 = g.float()
            g2 = g32.square() + _EPS1
            if _factored(p.shape):
                vr = keep * s["vr"] + take * mean(g2, nd - 1)
                vc = keep * s["vc"] + take * mean(g2, nd - 2)
                # V-hat = vr vc / mean(vr)  (Shazeer-Stern eq. 4-6)
                r = vr / vr.mean(-1, keepdim=True).clamp_min(_EPS1)
                r_l, vc_l = r, vc
                if cut is not None and cut != nd - 1:
                    r_l = block(r, cut)
                if cut is not None and cut != nd - 2:
                    vc_l = block(vc, cut - (cut > nd - 2))
                u = g32 * torch.rsqrt(r_l[..., None] * vc_l[..., None, :]
                                      + _EPS1)
                new_s = {"vc": vc, "vr": vr}
            else:
                v = keep * s["v"] + take * g2
                u = g32 * torch.rsqrt(v + _EPS1)
                new_s = {"v": v}
            rms_u = torch.sqrt(mean_all(u.square()) + _EPS1)
            u = u / (rms_u / _CLIP).clamp_min(1.0)
            p32 = p.float()
            scale = torch.sqrt(mean_all(p32.square())).clamp_min(_EPS2)
            return (p32 - lr * scale * u).to(p.dtype), new_s

        stats = tree_leaves_dicts(state["stats"], params)
        pl = tree_leaves(params)
        out = [upd(g, s, p, c) for g, s, p, c in zip(
            tree_leaves(grads), stats, pl,
            dims if dims is not None else [None] * len(pl))]
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
