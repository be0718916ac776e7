"""RG-LRU recurrent mixer, RecurrentGemma / Griffin, arXiv:2402.19427
(port of the JAX package's ``models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)           recurrence gate
    i_t = sigmoid(W_x x_t + b_x)           input gate
    a_t = a ** (c * r_t),  a = sigmoid(Lambda)  (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence h = a h + b runs over chunks of 512 steps, a Python
loop carrying h from chunk to chunk, each chunk's body under
`torch.utils.checkpoint` when gradients are recorded (the JAX package's
checkpointed ``lax.scan`` over chunks). Inside a chunk, a log-depth
(Hillis-Steele) scan of (a, b) pairs takes the JAX package's
``lax.associative_scan``: log2(512) = 9 combining sweeps, never a Python
loop over steps. The two scans combine the pairs in different orders, so
they agree to fp32 rounding, not bit for bit. A step-by-step recurrence
(`rglru_naive`) is the decode path and the test oracle. The block: linear
in -> causal conv (width 4) -> RG-LRU, gated by a GeLU branch -> linear out.
``w_a``, ``w_x``, ``b_a``, ``b_x`` and ``lam`` are fp32 leaves in any model
dtype, and the recurrence runs in fp32. Plain PyTorch: the JAX package
computes it in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv, checkpointed

_C = 8.0
CHUNK = 512


def init_rglru(gen: torch.Generator, cfg, device):
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = getattr(torch, cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": L.dense_init(gen, d, w, dt, device),
        "w_gate_branch": L.dense_init(gen, d, w, dt, device),
        "conv_w": (torch.randn((4, w), generator=gen, device=device)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "w_a": L.dense_init(gen, w, w, torch.float32, device),
        "b_a": torch.zeros((w,), **f32),
        "w_x": L.dense_init(gen, w, w, torch.float32, device),
        "b_x": torch.zeros((w,), **f32),
        # Lambda such that a lies in [0.9, 0.999] roughly
        "lam": torch.linspace(2.2, 6.9, w, **f32),
        "w_out": L.dense_init(gen, w, d, dt, device),
    }


def _gates(p, u: torch.Tensor):
    """u (B,S,w) fp32 -> the per-step decay a_t and input b_t."""
    r = torch.sigmoid(L.dense(u, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(L.dense(u, p["w_x"]) + p["b_x"])
    log_a = _C * r * torch.log(torch.sigmoid(p["lam"]))   # a_t = a ** (c r)
    a_t = torch.exp(log_a)
    b_t = torch.sqrt(torch.clamp_min(1.0 - a_t.square(), 1e-12)) * (i * u)
    return a_t, b_t


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every h_t of h = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1, by a
    Hillis-Steele scan: at offset d each pair takes in the pair d steps
    back, (a1, b1) then (a2, b2) combining to (a1 a2, a2 b1 + b2); the
    steps before the start combine with the identity (1, 0)."""
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def _chunk_scan(h, aq, bq):
    """One chunk from the carried state h (B,w): (last state, (B,Q,w))."""
    bq = torch.cat([bq[:, :1] + aq[:, :1] * h[:, None], bq[:, 1:]], 1)
    hq = _scan(aq, bq)
    return hq[:, -1], hq


def _gated_chunk_scan(h, p, uq):
    """`_chunk_scan` of the gates of one chunk of the conv output ``uq``:
    the (B,Q,w) fp32 gate tensors live only inside the chunk (and its
    recompute)."""
    aq, bq = _gates(p, uq.float())
    return _chunk_scan(h, aq, bq)


def rglru_scan(a, b, h0: Optional[torch.Tensor] = None,
               chunk: int = CHUNK) -> torch.Tensor:
    """The linear recurrence h = a h_prev + b over (B,S,w), from ``h0``
    (zeros when None), chunk by chunk."""
    B, S, w = a.shape
    h = (torch.zeros((B, w), dtype=a.dtype, device=a.device) if h0 is None
         else h0.to(a.dtype))
    hs = []
    for c0 in range(0, S, chunk):
        h, hq = checkpointed(_chunk_scan, h, a[:, c0:c0 + chunk],
                             b[:, c0:c0 + chunk])
        hs.append(hq)
    return torch.cat(hs, 1)


def rglru_fused(p, u: torch.Tensor, h0: Optional[torch.Tensor] = None,
                chunk: int = CHUNK) -> torch.Tensor:
    """The gates and the recurrence per chunk (B,S,w) -> (B,S,w) fp32: the
    full-length fp32 gate tensors never exist, and the backward recomputes
    each chunk's gate products."""
    B, S, w = u.shape
    h = (torch.zeros((B, w), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    hs = []
    for c0 in range(0, S, chunk):
        h, hq = checkpointed(_gated_chunk_scan, h, p, u[:, c0:c0 + chunk])
        hs.append(hq)
    return torch.cat(hs, 1)


def rglru_naive(a, b, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step by step: the decode path and the oracle."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1)


def apply_rglru(p, x: torch.Tensor, cfg,
                conv_state: Optional[torch.Tensor] = None,
                h_state: Optional[torch.Tensor] = None,
                decode: bool = False):
    """x (B,S,d) -> (y (B,S,d), (conv_state (B,3,w), h_state (B,w) fp32)):
    the states after the last position, from ``conv_state`` and
    ``h_state`` (zeros when None). ``decode`` runs the step recurrence."""
    gate = F.gelu(L.dense(x, p["w_gate_branch"]).float(), approximate="tanh")
    u = L.dense(x, p["w_in"])
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    if decode:
        a, b = _gates(p, u.float())
        h = rglru_naive(a, b, h_state)
    else:
        h = rglru_fused(p, u, h_state)
    y = (h * gate).to(x.dtype)
    return L.dense(y, p["w_out"]), (new_conv, h[:, -1])
