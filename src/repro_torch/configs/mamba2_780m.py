"""mamba2-780m [ssm] — SSD state-space duality (arXiv:2405.21060).

48L d_model=1536, attention-free (d_ff=0: pure mixer stack), vocab 50280,
ssm_state N=128, expand 2 (d_inner 3072, 48 SSD heads of dim 64).
Routing attention is INAPPLICABLE (no attention) — DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
        num_heads=24, num_kv_heads=24, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_chunk=256, ssm_conv=4,
        position="none", norm="rmsnorm", tie_embeddings=True,
        max_seq_len=1_048_576)
