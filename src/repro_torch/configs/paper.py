"""The paper's own Routing Transformer configs (Tables 1-5, 7), copied
from the JAX package's ``configs/paper.py``.

These drive the benchmark harnesses 1:1. Quality numbers in the paper come
from multi-week TPUv3-128 runs; here the configs define the exact
architectures, the benchmarks measure their step mechanics + roofline.
"""
from repro_torch.configs.base import ModelConfig, RoutingConfig


def wikitext103() -> ModelConfig:
    """Table 2: 10L, 16 heads, k=16, window 256, test ppl 15.8."""
    return ModelConfig(
        name="rt-wikitext103", family="dense", num_layers=10, d_model=1024,
        num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=267735,
        attention="local+routing",
        routing=RoutingConfig(num_clusters=16, local_window=256),
        attn_window=256, position="rope", norm="layernorm", act="relu",
        dropout=0.3, max_seq_len=4096)


def enwik8() -> ModelConfig:
    """Table 3: 12L, 8 heads, k=32, window 256, seq 8192, 0.99 bpb."""
    return ModelConfig(
        name="rt-enwik8", family="dense", num_layers=12, d_model=1024,
        num_heads=8, num_kv_heads=8, d_ff=4096, vocab_size=256,
        attention="local+routing",
        routing=RoutingConfig(num_clusters=32, local_window=256),
        attn_window=256, position="rope", norm="layernorm", act="relu",
        dropout=0.4, max_seq_len=8192)


def imagenet64() -> ModelConfig:
    """Table 4: 24L, 16 heads, k=8, window 2048, seq 12288, 3.43 b/d."""
    return ModelConfig(
        name="rt-imagenet64", family="dense", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=256,
        attention="local+routing",
        routing=RoutingConfig(num_clusters=8, window=2048,
                              local_window=2048),
        attn_window=2048, position="rope", norm="layernorm", act="relu",
        max_seq_len=12288)


def pg19() -> ModelConfig:
    """Table 5: 22L, 8 heads, d=1032, seq 8192, 2 routing heads in the
    last two layers only, Adafactor — test ppl 33.2 (SOTA)."""
    return ModelConfig(
        name="rt-pg19", family="dense", num_layers=22, d_model=1032,
        num_heads=8, num_kv_heads=8, d_ff=4128, vocab_size=98000,
        attention="local+routing",
        routing=RoutingConfig(num_clusters=16, local_window=512,
                              routing_heads=2, routing_layers=(20, 21)),
        attn_window=512, position="rope", norm="layernorm", act="relu",
        max_seq_len=8192)


def cifar10(routing_heads: int = 4, routing_layers: int = 4,
            window: int = 512) -> ModelConfig:
    """Table 1 ablation grid: 12L, 8 heads total, routing heads/layers and
    attention window varied; k=6."""
    L = 12
    rl = tuple(range(L - routing_layers, L)) if routing_layers < L else ()
    return ModelConfig(
        name=f"rt-cifar10-r{routing_heads}x{routing_layers}w{window}",
        family="dense", num_layers=L, d_model=512, num_heads=8,
        num_kv_heads=8, d_ff=2048, vocab_size=256,
        attention="local+routing" if routing_heads else "local",
        routing=RoutingConfig(num_clusters=6, window=window,
                              local_window=window,
                              routing_heads=routing_heads,
                              routing_layers=rl),
        attn_window=window, position="rope", norm="layernorm", act="relu",
        max_seq_len=3072)
