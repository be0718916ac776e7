"""Config registry of the port: the dense family (the paper's Routing
Transformer models and four full-attention models).

`get_config(arch)` returns the full published config; `reduced_config(arch)`
returns the same-family miniature the CPU parity tests run. Both are copies
of the JAX package's registry functions, restricted to that family.
"""
from __future__ import annotations

from repro_torch.configs import (granite_8b, paper, phi4_mini_3_8b,
                                 qwen2_0_5b, starcoder2_3b)
from repro_torch.configs.base import (ModelConfig, RoutingConfig,  # noqa: F401
                                      with_overrides)

ARCHS = {
    "granite-8b": granite_8b.config,
    "qwen2-0.5b": qwen2_0_5b.config,
    "starcoder2-3b": starcoder2_3b.config,
    "phi4-mini-3.8b": phi4_mini_3_8b.config,
    # the paper's own models
    "rt-wikitext103": paper.wikitext103,
    "rt-enwik8": paper.enwik8,
    "rt-imagenet64": paper.imagenet64,
    "rt-pg19": paper.pg19,
    "rt-cifar10": paper.cifar10,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]()


def reduced_config(arch: str) -> ModelConfig:
    """Same-family miniature: few layers/width, tiny vocab (dense family)."""
    cfg = get_config(arch)
    H = 4
    Hkv = max(1, (cfg.num_kv_heads * H) // cfg.num_heads)
    return with_overrides(
        cfg, num_layers=2, d_model=64, num_heads=H, num_kv_heads=Hkv,
        head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
        max_seq_len=512,
        routing=with_overrides(cfg.routing, num_clusters=4, local_window=32,
                               routing_layers=(), routing_heads=0),
        attn_window=32, dropout=0.0)
