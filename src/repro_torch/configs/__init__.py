"""Config registry of the port: the dense family (the paper's Routing
Transformer models and four full-attention models).

`get_config(arch)` returns the full published config; `reduced_config(arch)`
returns the same-family miniature the CPU parity tests run. Both are copies
of the JAX package's registry functions, restricted to that family, as are
`routing_for_seq` (k ~ sqrt(n) and the segment fold for a sequence length)
and `with_routing` (the paper's local+routing attention on any dense arch).
"""
from __future__ import annotations

import math

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


def _pow2_round(x: int) -> int:
    return 2 ** max(0, round(math.log2(max(x, 1))))


def routing_for_seq(cfg: ModelConfig, seq_len: int,
                    segments: int = 0) -> ModelConfig:
    """Scale k ~ sqrt(n) (the paper's choice) for a sequence length.

    ``segments=0`` -> auto: shard-local routing (16 segments, the TP width
    of the production mesh) at 32k tokens and more, else one segment.
    Decode ignores the segments (the cluster-paged cache is already
    local)."""
    if segments == 0:
        segments = 16 if seq_len >= 32768 else 1
    n_local = max(seq_len // max(segments, 1), 1)
    k = min(_pow2_round(int(math.sqrt(n_local))), max(n_local // 16, 1))
    return with_overrides(cfg, routing=with_overrides(
        cfg.routing, num_clusters=max(k, 1), window=0, segments=segments))


def with_routing(cfg: ModelConfig) -> ModelConfig:
    """The paper's technique on a dense arch: local+routing attention (half
    the heads local, half routing, the paper's default split); an ssm
    config, which has no attention, comes back as it is."""
    if cfg.family == "ssm":
        return cfg
    return with_overrides(cfg, attention="local+routing")


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
