"""Shared layers: norms, RoPE, MLPs, projections, embeddings (port of the
JAX package's ``models/layers.py``).

Plain functions on nested dicts of tensors. `init_*` draws from an explicit
``torch.Generator`` on the target device, with the JAX package's shapes
(weights stored (d_in, d_out), applied as ``x @ w``). Matmuls run in the
parameter dtype; norm statistics and rope angles in fp32.

The weight products of a layer (q, k, v, o, the FFN's up, gate and down)
go through `dense`, which marks them for remat "save_dots"
(`models.transformer.save_dots_policy`): the products whose operands share
no batch axis, the set the JAX package's
``checkpoint_dots_with_no_batch_dims`` keeps.
"""
from __future__ import annotations

import threading

import torch

_WEIGHT_PRODUCT = threading.local()


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a weight ``w`` (d_in, d_out), marked while it runs as a
    weight product (`in_weight_product`)."""
    _WEIGHT_PRODUCT.on = True
    try:
        return x @ w
    finally:
        _WEIGHT_PRODUCT.on = False


def in_weight_product() -> bool:
    """Whether the calling thread is inside `dense`'s product."""
    return getattr(_WEIGHT_PRODUCT, "on", False)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / d_in ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(d: int, kind: str, dtype, device):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    if kind == "rmsnorm":
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, N, dh); positions: (B, N) integer. Rotates interleaved
    (even, odd) pairs, as the JAX package does. An odd head dim (rt-pg19's
    129) has a last column with no partner: the leading dh - 1 columns are
    rotated as a head of dh - 1, and the last passes through. (The JAX
    package's `apply_rope` takes even head dims only: its pairs and its
    frequencies differ in length at an odd one.)"""
    if x.shape[-1] % 2:
        return torch.cat([apply_rope(x[..., :-1], positions, theta),
                          x[..., -1:]], -1)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU / ReLU)
# ---------------------------------------------------------------------------
def init_mlp(gen, d: int, d_ff: int, act: str, dtype, device):
    p = {"w_up": dense_init(gen, d, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d, dtype, device)}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d, d_ff, dtype, device)
    return p


def apply_mlp(p, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    up = dense(x, p["w_up"])
    if act == "swiglu":
        gate = dense(x, p["w_gate"])
        h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    elif act == "gelu":
        h = torch.nn.functional.gelu(up.float(),
                                     approximate="tanh").to(x.dtype)
    else:
        h = torch.relu(up)
    return dense(h, p["w_down"])


# ---------------------------------------------------------------------------
# QKV / output projections (GQA)
# ---------------------------------------------------------------------------
def init_attn_proj(gen, cfg, device):
    d, dh = cfg.d_model, cfg.head_dim_
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    dt = getattr(torch, cfg.dtype)
    p = {"wq": dense_init(gen, d, H * dh, dt, device),
         "wk": dense_init(gen, d, Hkv * dh, dt, device),
         "wv": dense_init(gen, d, Hkv * dh, dt, device),
         "wo": dense_init(gen, H * dh, d, dt, device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((Hkv * dh,), dtype=dt, device=device)
        p["bv"] = torch.zeros((Hkv * dh,), dtype=dt, device=device)
    return p


def qkv_project(p, x: torch.Tensor, cfg):
    """x: (B,N,d) -> q (B,H,N,dh), k/v (B,Hkv,N,dh), un-roped (the
    attention backends rope per variant), each contiguous. The head counts
    are the weights' (a tensor-parallel rank holds a column block of
    them)."""
    B, N, _ = x.shape
    dh = cfg.head_dim_
    q, k, v = dense(x, p["wq"]), dense(x, p["wk"]), dense(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, N, -1, dh).transpose(1, 2).contiguous()
    k = k.reshape(B, N, -1, dh).transpose(1, 2).contiguous()
    v = v.reshape(B, N, -1, dh).transpose(1, 2).contiguous()
    return q, k, v


def out_project(p, o: torch.Tensor) -> torch.Tensor:
    """o: (B,H,N,dh) -> (B,N,d)."""
    B, H, N, dh = o.shape
    return dense(o.transpose(1, 2).reshape(B, N, H * dh), p["wo"])


# ---------------------------------------------------------------------------
# Embeddings / logits
# ---------------------------------------------------------------------------
def init_embed(gen, vocab: int, d: int, dtype, device, tie: bool):
    p = {"tok": (torch.randn((vocab, d), generator=gen, device=device)
                 * 0.02).to(dtype)}
    if not tie:
        p["unembed"] = dense_init(gen, d, vocab, dtype, device)
    return p


def embed(p, tokens: torch.Tensor, axis=None) -> torch.Tensor:
    """Token rows; on a model axis (``axis``, a
    `dist.tensor_parallel.ModelAxis` of more than one rank) the table is
    this rank's vocabulary block, and the lookup is vocab-parallel."""
    if axis is not None and axis.size > 1:
        from repro_torch.dist.tensor_parallel import vocab_embed
        return vocab_embed(p["tok"], tokens, axis)
    return p["tok"][tokens]


def logits_out(p, x: torch.Tensor, tie: bool,
               softcap: float = 0.0) -> torch.Tensor:
    """fp32 logits; with this rank's vocabulary block of ``tok`` or
    ``unembed`` (tensor parallelism), this rank's block of them."""
    lg = (x @ p["tok"].T) if tie else (x @ p["unembed"])
    lg = lg.float()
    if softcap:
        lg = softcap * torch.tanh(lg / softcap)
    return lg
