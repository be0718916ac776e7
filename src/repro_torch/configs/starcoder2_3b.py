"""starcoder2-3b [dense] — GQA + RoPE code model (arXiv:2402.19173; hf).

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152; LayerNorm + GeLU
MLP (starcoder2 keeps the GPT-style block).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense", num_layers=30, d_model=3072,
        num_heads=24, num_kv_heads=2, d_ff=12288, vocab_size=49152,
        attention="full", position="rope", norm="layernorm", act="gelu",
        qkv_bias=True, max_seq_len=16384)
