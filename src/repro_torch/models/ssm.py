"""Mamba2 SSD (state-space duality) mixer, arXiv:2405.21060 (port of the
JAX package's ``models/ssm.py``).

Chunked dual form (`ssd_chunked`): an intra-chunk quadratic term over (Q x
Q) blocks plus an inter-chunk linear state recurrence, a Python loop over
the chunks where the JAX package scans them. Each chunk's body runs under
`torch.utils.checkpoint` when gradients are recorded, as the JAX package
checkpoints its ``chunk_step``: the backward keeps only the (B,H,N,P)
state chain, not each chunk's (B,Q,Q,H) decay tensor. A step-by-step
recurrence (`ssd_naive`) is the test oracle and the decode path.

Per-head state (N, P), N = ``ssm_state``, P = the head dim. The B and C
projections use one group (mamba2's default), broadcast over the heads.
``A_log``, ``D`` and ``dt_bias`` are fp32 leaves in any model dtype, and
the scans run in fp32. Plain PyTorch: the JAX package computes the scans
in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L


class SSMSpec(NamedTuple):
    d_inner: int
    nheads: int
    headdim: int
    nstate: int
    conv: int
    chunk: int


def ssm_spec(cfg) -> SSMSpec:
    d_inner = cfg.ssm_expand * cfg.d_model
    headdim = 64
    nheads = cfg.ssm_heads or d_inner // headdim
    return SSMSpec(d_inner, nheads, d_inner // nheads, cfg.ssm_state,
                   cfg.ssm_conv, cfg.ssm_chunk)


def init_ssd(gen: torch.Generator, cfg, device):
    s = ssm_spec(cfg)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    conv_ch = s.d_inner + 2 * s.nstate
    proj_out = 2 * s.d_inner + 2 * s.nstate + s.nheads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.dense_init(gen, d, proj_out, dt, device),
        "conv_w": (torch.randn((s.conv, conv_ch), generator=gen,
                               device=device) * 0.1).to(dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, s.nheads, **f32)),
        "D": torch.ones((s.nheads,), **f32),
        "dt_bias": torch.full((s.nheads,), -2.0, **f32),
        "norm": L.init_norm(s.d_inner, "rmsnorm", dt, device),
        "out_proj": L.dense_init(gen, s.d_inner, d, dt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C), state: (B,K-1,C) or
    None (zeros). Returns (out (B,S,C), new state: the last K-1 inputs)."""
    K, S = w.shape[0], x.shape[1]
    xp = (F.pad(x, (0, 0, K - 1, 0)) if state is None
          else torch.cat([state.to(x.dtype), x], 1))
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    return out, (xp[:, -(K - 1):] if K > 1 else None)


def _split_proj(zxbcdt: torch.Tensor, s: SSMSpec):
    z = zxbcdt[..., :s.d_inner]
    xBC = zxbcdt[..., s.d_inner:2 * s.d_inner + 2 * s.nstate]
    dt = zxbcdt[..., -s.nheads:]
    return z, xBC, dt


def checkpointed(fn, *args):
    """``fn(*args)``, under `torch.utils.checkpoint` when autograd records
    (the backward recomputes it), else plainly."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _ssd_chunk(s_prev, xq, dtq, bq, cq, A, causal):
    """One chunk: the intra-chunk (quadratic) and inter-chunk (state)
    terms, then the state recurrence. xq (B,Q,H,P), dtq (B,Q,H), bq/cq
    (B,Q,N), s_prev (B,H,N,P), all fp32."""
    lg = dtq * A                                       # log-decay <= 0
    cum = torch.cumsum(lg, 1)
    xbar = xq * dtq[..., None]
    cb = torch.einsum("bqn,bkn->bqk", cq, bq)
    decay = cum[:, :, None, :] - cum[:, None, :, :]    # (B,Q,Q,H)
    # the mask *inside* the exp: exp of the (positive) acausal deltas
    # overflows, and its gradient through a select poisons the backward
    decay = torch.where(causal[None, :, :, None], decay, -1e9)
    m = cb[..., None] * torch.exp(decay)
    y_intra = torch.einsum("bqkh,bkhp->bqhp", m, xbar)
    y_inter = torch.einsum("bqn,bqh,bhnp->bqhp", cq, torch.exp(cum), s_prev)
    tot = cum[:, -1, :]                                # (B,H)
    w_in = torch.exp(tot[:, None, :] - cum)
    cs = torch.einsum("bqn,bqh,bqhp->bhnp", bq, w_in, xbar)
    s_new = s_prev * torch.exp(tot)[..., None, None] + cs
    return s_new, y_intra + y_inter


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32 (< 0), Bm
    and Cm (B,S,N). Returns (y (B,S,H,P) fp32, final state (B,H,N,P)
    fp32). A ragged last chunk is computed at its own length (the JAX
    package pads it with zeros, which changes no earlier position)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    state = (torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                         device=xh.device)
             if init_state is None else init_state.float())
    iq = torch.arange(Q, device=xh.device)
    causal = iq[:, None] >= iq[None, :]
    xf, bf, cf = xh.float(), Bm.float(), Cm.float()
    ys = []
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        state, y = checkpointed(
            _ssd_chunk, state, xf[:, c0:c0 + q], dt[:, c0:c0 + q],
            bf[:, c0:c0 + q], cf[:, c0:c0 + q], A, causal[:q, :q])
        ys.append(y)
    return torch.cat(ys, 1), state


def ssd_naive(xh, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step oracle: h_t = exp(dt A) h + B (dt x); y_t = C . h."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    xf, bf, cf = xh.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * A)                              # (B,H)
        inc = torch.einsum("bn,bhp->bhnp", bf[:, t],
                           xf[:, t] * dt[:, t, :, None])
        h = h * da[..., None, None] + inc
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    return torch.stack(ys, 1), h


def apply_ssd(p, x: torch.Tensor, cfg,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None, decode: bool = False):
    """The whole mamba2 mixer. x (B,S,d) -> (y (B,S,d), (conv_state
    (B,K-1,d_inner + 2N), ssm_state (B,H,N,P) fp32)): the states after the
    last position, from ``conv_state`` and ``ssm_state`` (zeros when None).
    ``decode`` runs the step recurrence (`ssd_naive`) instead of the
    chunked form."""
    s = ssm_spec(cfg)
    B, S, _ = x.shape
    zxbcdt = L.dense(x, p["in_proj"])
    z, xBC, dtr = _split_proj(zxbcdt, s)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs = xBC[..., :s.d_inner]
    Bm = xBC[..., s.d_inner:s.d_inner + s.nstate]
    Cm = xBC[..., s.d_inner + s.nstate:]
    dt = F.softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, s.nheads, s.headdim)
    if decode:
        y, new_state = ssd_naive(xh, dt, A, Bm, Cm, ssm_state)
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, ssm_state)
    y = y + xh.float() * p["D"][:, None]
    y = y.reshape(B, S, s.d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = L.apply_norm(p["norm"], y, "rmsnorm")
    return L.dense(y, p["out_proj"]), (new_conv, new_state)
