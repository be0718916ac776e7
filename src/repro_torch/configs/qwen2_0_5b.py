"""qwen2-0.5b [dense] — GQA + QKV bias (arXiv:2407.10671; hf).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense", num_layers=24, d_model=896,
        num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151936,
        attention="full", qkv_bias=True, tie_embeddings=True,
        position="rope", norm="rmsnorm", act="swiglu", max_seq_len=32768,
        rope_theta=1_000_000.0)
