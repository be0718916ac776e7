"""Config system of the PyTorch port: a copy of the JAX package's
``configs/base.py`` (plain dataclasses, no framework import).

Plain dataclasses (no pydantic dependency in the hot path) with:
  * `ModelConfig`   — architecture definition (one per assigned arch).
  * `RoutingConfig` — the paper's technique knobs (Section 4.1 / Algorithm 1).
  * `TrainConfig`   — optimizer / schedule / batch.
  * `MeshConfig`    — parallelism layout.
  * `RunConfig`     — the composed, launchable unit.

Configs are immutable; use `dataclasses.replace` (re-exported as
`with_overrides`) to derive variants (smoke-test reductions, dry-run shapes).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def with_overrides(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Routing attention (the paper's contribution)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RoutingConfig:
    """Knobs for content-based sparse attention (Roy et al. 2020, Alg. 1)."""

    num_clusters: int = 16          # k; paper uses k ~ sqrt(n)
    window: int = 0                 # w tokens per cluster; 0 => n // k
    decay: float = 0.999            # lambda, EMA decay for centroids
    share_qk: bool = True           # causal LM: K <- Q (paper Section 4.1)
    scatter_mode: str = "mean"      # {"mean", "last"}: duplicate resolution
    # Fraction of heads doing routing (rest local). Paper: 0.5 everywhere
    # except PG-19 (2 heads, last 2 layers only).
    routing_heads: int = 0          # 0 => heads // 2
    routing_layers: Tuple[int, ...] = ()  # () => all layers
    local_window: int = 256         # window of the local-attention heads
    causal: bool = True             # encoder mode uses False
    # Beyond-paper: route within `segments` sequence chunks instead of
    # globally. With segments == TP width, the segment dim aligns with the
    # model-axis sequence sharding and balanced top-k becomes shard-LOCAL
    # (no seq re-gathers -- the measured collective bottleneck of naive
    # GSPMD routing, EXPERIMENTS.md SPerf). Global receptive field is
    # restored across layers by the local heads + depth (hierarchical
    # routing). segments=1 == the paper's global routing.
    segments: int = 1
    # Routing-health telemetry (repro.obs): compute the RoutingStats aux
    # pytree (occupancy entropy, dead clusters, centroid drift, balanced-
    # vs-nearest mismatch, sampled attention recall) inside the jitted
    # step. Off by default and a true no-op when off: the stats branch is
    # a static python conditional, so the compiled HLO is byte-identical
    # to a build without the flag (asserted in tests/test_obs.py).
    stats: bool = False
    stats_probes: int = 8           # probe queries for the recall estimate


# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense|moe|ssm|hybrid|encoder|vlm
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4           # GQA
    head_dim: int = 0               # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 8192
    # attention backend: full | local | routing | local+routing
    attention: str = "full"
    routing: RoutingConfig = field(default_factory=RoutingConfig)
    # positional encoding: rope | none (encoder conv-pos stubbed as learned)
    position: str = "rope"
    rope_theta: float = 10000.0
    qkv_bias: bool = False          # qwen2 uses True
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu | relu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # activation/param dtype
    # --- MoE ---
    moe_experts: int = 0            # 0 => dense FFN
    moe_top_k: int = 1
    moe_interleave: int = 1         # MoE every Nth layer (1 => all layers)
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = True  # llama4-style shared expert
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0              # N, state dim per head (mamba2: 128)
    ssm_heads: int = 0              # SSD heads (d_inner // headdim)
    ssm_expand: int = 2
    ssm_chunk: int = 256            # SSD chunk length
    ssm_conv: int = 4               # depthwise conv width
    # --- hybrid (recurrentgemma) ---
    hybrid_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    lru_width: int = 0              # rg-lru hidden width (0 => d_model)
    attn_window: int = 2048         # local attention window of hybrid/enc
    # --- encoder (hubert) ---
    is_causal: bool = True          # encoder => False
    mask_prob: float = 0.08         # hubert masked prediction
    # --- vlm ---
    cross_attn_layers: Tuple[int, ...] = ()  # layer idxs with cross-attn
    num_image_tokens: int = 1601    # stub vision frontend tokens
    # --- logits ---
    logit_softcap: float = 0.0
    dropout: float = 0.0
    # KV chunk of the full-attention reference: None => auto (the
    # AttentionSpec resolves a chunk when N > 4096), 0 => force one-shot
    # softmax even for long N, c > 0 => force chunk c
    attn_chunk: Optional[int] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a multiple of 256 so vocab-TP
        shards cleanly on any mesh (Megatron-style). Logits above
        `vocab_size` are masked to -1e9 in apply_model."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline term)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        dh, H, Hkv = self.head_dim_, self.num_heads, self.num_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            # in_proj (z,x,B,C,dt) + out_proj + conv + norms
            nheads = self.ssm_heads or max(1, d_in // 64)
            per = d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d + d
            return emb + L * per
        attn = d * (H * dh) + d * (2 * Hkv * dh) + (H * dh) * d
        ffn_dense = 3 * d * f if self.act == "swiglu" else 2 * d * f
        if self.family == "moe":
            n_moe = len([i for i in range(L) if i % self.moe_interleave == 0])
            n_dense = L - n_moe
            ffn = n_moe * (self.moe_experts * ffn_dense
                           + (ffn_dense if self.moe_shared_expert else 0)
                           + d * self.moe_experts)  # router
            ffn += n_dense * ffn_dense
            return emb + L * attn + ffn + L * 2 * d
        if self.family == "hybrid":
            pat = self.hybrid_pattern or ("rglru",)
            w = self.lru_width or d
            n_lru = sum(1 for i in range(L) if pat[i % len(pat)] == "rglru")
            n_att = L - n_lru
            lru = d * w * 3 + w * d + 2 * w * 4   # gates approx
            return emb + n_att * attn + L * ffn_dense + n_lru * lru + L * 2 * d
        return emb + L * (attn + ffn_dense + 2 * d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        dense_like = with_overrides(
            self, family="dense",
            d_ff=self.d_ff * (self.moe_top_k + (1 if self.moe_shared_expert else 0)))
        return dense_like.param_count()


# ---------------------------------------------------------------------------
# Training / parallelism / run
# ---------------------------------------------------------------------------
GRAD_COMPRESSION_MODES = ("none", "int8_ef")


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 512
    optimizer: str = "adam"         # adam | adafactor
    lr: float = 2e-4                # paper: 2e-4 Adam (PG19: adafactor 0.01)
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    schedule: str = "vaswani"       # vaswani rsqrt | linear_warmup_rsqrt | const
    warmup_steps: int = 1000
    steps: int = 100
    grad_accum: int = 1             # microbatch accumulation
    accum_dtype: str = "float32"    # grad accumulation dtype (400B: bf16)
    remat: str = "full"             # none | full | save_dots
    seed: int = 0
    grad_compression: str = "none"  # GRAD_COMPRESSION_MODES
    z_loss: float = 0.0

    def __post_init__(self):
        # fail at construction, not as a KeyError deep inside the jitted
        # train step after minutes of compilation
        if self.grad_compression not in GRAD_COMPRESSION_MODES:
            raise ValueError(
                f"grad_compression must be one of {GRAD_COMPRESSION_MODES}, "
                f"got {self.grad_compression!r}")


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (1,)
    axes: Tuple[str, ...] = ("data",)
    fsdp: bool = True               # shard params over "data" too (zero-3)
    seq_parallel: bool = False      # Megatron-SP on residual stream


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    mode: str = "train"             # train | prefill | decode


# ---------------------------------------------------------------------------
# Assigned input-shape cells (applies to every LM arch)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)
