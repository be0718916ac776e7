"""AttentionSpec — the declarative description of one attention site
(port of the JAX package's ``attn/spec.py``).

A spec says *what* attention a layer computes (variant, window/cluster
geometry, causality, GQA split, rope); the registry
(`repro_torch.attn.registry`) says *how* (which backend implements it on
the tensors' device). ``spec_for_layer(cfg, variant)`` is the one place
config fields are interpreted, and is cached.

Chunking contract (`chunk`): ``None`` = auto: the full-attention reference
takes an online-softmax KV chunk when the sequence is long (N > 4096);
``0`` = one-shot softmax; ``c > 0`` = chunk c. `resolve_chunk` settles it
at call time, since the auto rule depends on the sequence length.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig, RoutingConfig, with_overrides

VARIANTS = ("full", "local", "routing", "local+routing")

# Non-routing layers of a routing_layers-suffix config fall back to the
# cheapest variant that keeps the paper's locality prior.
_DOWNGRADE = {"local+routing": "local", "routing": "local"}

AUTO_CHUNK_THRESHOLD = 4096
AUTO_CHUNK = 1024


@dataclass(frozen=True)
class AttentionSpec:
    """One attention site.

    variant        full | local | routing | local+routing
    num_heads      query heads H
    num_kv_heads   key/value heads (GQA; == H for MHA)
    head_dim       per-head dim
    causal         causal mask on original positions
    window         local-attention window (variants with a local part)
    rope_theta     rotary base, or None for no rope (routing heads are
                   never roped — routing vectors are content)
    chunk          KV chunk of the full variant: None=auto, 0=one-shot
    routing        RoutingConfig (variants with a routing part)
    routing_heads  Hr of the local+routing head split (0 elsewhere)
    """

    variant: str
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int = 0
    rope_theta: Optional[float] = None
    chunk: Optional[int] = None
    routing: Optional[RoutingConfig] = None
    routing_heads: int = 0

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown attention variant {self.variant!r}; "
                             f"expected one of {VARIANTS}")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"num_heads {self.num_heads} not divisible by "
                             f"num_kv_heads {self.num_kv_heads}")
        if "local" in self.variant and self.window <= 0:
            raise ValueError(f"variant {self.variant!r} needs window > 0")
        if "routing" in self.variant and self.routing is None:
            raise ValueError(f"variant {self.variant!r} needs a "
                             f"RoutingConfig")
        if self.variant == "local+routing":
            head_split(self)    # raises on GQA-misaligned splits

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def head_split(spec) -> Tuple[int, int, int, int]:
    """(H_local, H_routing, Hkv_local, Hkv_routing) of a local+routing
    split. ``spec`` may be an AttentionSpec (its ``routing_heads`` wins
    when set) or a ModelConfig (Hr from ``routing.routing_heads``; 0 =
    half the heads). Local heads come first."""
    H, Hkv = spec.num_heads, spec.num_kv_heads
    g = H // Hkv
    rh = getattr(spec, "routing_heads", 0) or spec.routing.routing_heads
    Hr = min(rh or H // 2, H)
    Hl = H - Hr
    if Hkv == 1:
        return Hl, Hr, 1, 1
    if Hr % g or Hl % g:
        raise ValueError(f"routing head split {Hl}/{Hr} must align with "
                         f"GQA groups g={g}")
    return Hl, Hr, Hl // g, Hr // g


@functools.lru_cache(maxsize=None)
def head_shard(spec: AttentionSpec, tp: int) -> AttentionSpec:
    """The spec of one rank's head shard over a ``tp``-way model axis: the
    rank runs ``H / tp`` query and ``Hkv / tp`` KV heads, and a
    local+routing spec ``Hl / tp`` local and ``Hr / tp`` routing heads
    (with their KV heads), local first, as `head_split` orders the full
    spec. Raises `ValueError` where a count does not divide by ``tp``:
    explicit tensor parallelism cannot leave a head axis replicated."""
    if tp <= 1:
        return spec
    counts = {"num_heads": spec.num_heads, "num_kv_heads": spec.num_kv_heads}
    if spec.variant == "local+routing":
        Hl, Hr, kvl, kvr = head_split(spec)
        counts.update(Hl=Hl, Hr=Hr, Hkv_l=kvl, Hkv_r=kvr)
    bad = {k: v for k, v in counts.items() if v % tp}
    if bad:
        raise ValueError(f"{spec.variant}: head counts {bad} do not divide "
                         f"over a {tp}-way model axis")
    return replace(spec, num_heads=spec.num_heads // tp,
                   num_kv_heads=spec.num_kv_heads // tp,
                   routing_heads=spec.routing_heads // tp)


def variant_for_layer(cfg: ModelConfig, layer_idx: int) -> str:
    """The config's variant on routing layers (or everywhere when
    routing_layers is empty), the downgraded variant elsewhere."""
    rl = set(cfg.routing.routing_layers)
    if not rl or layer_idx in rl:
        return cfg.attention
    return _DOWNGRADE.get(cfg.attention, cfg.attention)


def _normalized_routing(cfg: ModelConfig) -> RoutingConfig:
    rc = cfg.routing
    if rc.causal != cfg.is_causal:
        rc = with_overrides(rc, causal=cfg.is_causal)
    if not cfg.is_causal and rc.share_qk:
        rc = with_overrides(rc, share_qk=False)
    return rc


@functools.lru_cache(maxsize=None)
def spec_for_layer(cfg: ModelConfig, variant: str) -> AttentionSpec:
    """The normalized AttentionSpec of a layer running ``variant`` under
    ``cfg``. Degenerate local+routing splits collapse to the surviving
    variant, so backends never see an empty head group."""
    rope = cfg.rope_theta if cfg.position == "rope" else None
    common = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  head_dim=cfg.head_dim_, causal=cfg.is_causal,
                  rope_theta=rope, chunk=cfg.attn_chunk)
    if variant == "full":
        return AttentionSpec(variant="full", **common)
    if variant == "local":
        return AttentionSpec(variant="local", window=cfg.attn_window,
                             **common)
    rc = _normalized_routing(cfg)
    if variant == "routing":
        return AttentionSpec(variant="routing", routing=rc, **common)
    if variant == "local+routing":
        spec = AttentionSpec(variant="local+routing", routing=rc,
                             window=rc.local_window,
                             routing_heads=head_split(
                                 with_overrides(cfg, routing=rc))[1],
                             **common)
        Hl, Hr, _, _ = head_split(spec)
        if Hr == 0:
            return replace(spec, variant="local", routing=None,
                           routing_heads=0)
        if Hl == 0:
            return replace(spec, variant="routing", window=0,
                           routing_heads=0)
        return spec
    raise ValueError(f"unknown attention variant {variant!r}")


def specs_for_model(cfg: ModelConfig) -> Tuple[AttentionSpec, ...]:
    """The distinct AttentionSpecs of the model's stack, in layer order
    (`dist.sharding.make_constrain_fn` validates them); none for the ssm
    family, which has no attention. A hybrid model's are its attention
    layers' (variant_for_layer of every layer, as the JAX package's)."""
    if cfg.family == "ssm":
        return ()
    out = []
    for i in range(cfg.num_layers):
        s = spec_for_layer(cfg, variant_for_layer(cfg, i))
        if s not in out:
            out.append(s)
    return tuple(out)


def seq_shardable(spec: AttentionSpec, tp: int) -> bool:
    """Whether sequence-sharding the residual stream over a ``tp``-way
    model axis keeps this spec's routing shard-local: full and local
    attention see the whole sequence anyway; routing's balanced top-k is
    shard-local only when its segment fold aligns with the model axis
    (``RoutingConfig.segments % tp == 0``)."""
    if tp <= 1 or spec.routing is None:
        return True
    return spec.routing.segments % tp == 0


def resolve_chunk(spec: AttentionSpec, seq_len: int) -> int:
    """The KV chunk of a call: an explicit value wins (0 = one-shot), None
    chunks long sequences."""
    if spec.chunk is not None:
        return spec.chunk
    return AUTO_CHUNK if seq_len > AUTO_CHUNK_THRESHOLD else 0
