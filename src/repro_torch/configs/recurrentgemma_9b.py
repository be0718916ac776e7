"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2
(arXiv:2402.19427, Griffin).

38L d_model=4096 16H (kv=1, head_dim 256) d_ff=12288 vocab=256000; block
pattern (rglru, rglru, local-attn), attention window 2048.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", num_layers=38,
        d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000, attention="local",
        hybrid_pattern=("rglru", "rglru", "attn"), attn_window=2048,
        lru_width=4096, position="rope", norm="rmsnorm", act="gelu",
        max_seq_len=1_048_576)
