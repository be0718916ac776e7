"""hubert-xlarge [audio] — encoder-only masked prediction
(arXiv:2106.07447).

48L d_model=1280 16H (head_dim 80, no GQA) d_ff=5120 vocab=504 (codebook
targets). The conv waveform front end is a stub, as in the JAX package:
the model reads precomputed frame embeddings (B, S, d). Non-causal, no
positional encoding; an encoder has no decode.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder", num_layers=48, d_model=1280,
        num_heads=16, num_kv_heads=16, head_dim=80, d_ff=5120,
        vocab_size=504, attention="full", is_causal=False, position="none",
        norm="layernorm", act="gelu", mask_prob=0.08, max_seq_len=32768)
