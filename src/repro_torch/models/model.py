"""Top-level model of the port: embed -> stack -> final norm -> logits,
plus the LM loss.

`init_model` builds random weights from a seed with the JAX package's
shapes and tree layout (``params["embed"]``, ``params["final_norm"]``,
``params["stack"]`` per segment stacked over groups) and the k-means
centroids per segment. It draws from a ``torch.Generator``, so its numbers
differ from the JAX package's ``init_model``; tests carry JAX weights
across with `repro_torch.interop` instead. `apply_model` returns (logits,
new_kstate): the dense family has no auxiliary losses, so the JAX
package's third output (MoE aux terms, all zero here) is left out; with
``return_stats=True`` the third element is the routing-health stats the
JAX package carries in that aux dict.

Batch dict keys: ``tokens`` (B,S) int, optional ``positions`` (B,S) int
and ``pad_mask`` (B,S) bool.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """(params, kstate) on ``device`` (default the card; raises without
    one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {
        "embed": L.init_embed(gen, cfg.padded_vocab, cfg.d_model, dt, dev,
                              cfg.tie_embeddings),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
    }
    params["stack"], kstate = T.init_stack(gen, cfg, dev)
    return params, kstate


def apply_model(params, kstate, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig, *, impl: Optional[str] = None,
                remat: str = "none", drop_seed: Optional[int] = None,
                return_stats: bool = False):
    """(logits (B,S,V) fp32, new_kstate). The routing layers always
    return their EMA centroid update; it is functional: the caller (the
    train step) decides whether to keep it. ``return_stats`` adds a third
    element: the stack's routing-health stats (`T.apply_stack`), None
    unless ``cfg.routing.stats`` is on."""
    x = L.embed(params["embed"], batch["tokens"])
    x, new_kstate, *stats = T.apply_stack(
        params["stack"], kstate, x, cfg, positions=batch.get("positions"),
        pad_mask=batch.get("pad_mask"), impl=impl, remat=remat,
        drop_seed=drop_seed, return_stats=return_stats)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.logits_out(params["embed"], x, cfg.tie_embeddings,
                          cfg.logit_softcap)
    return (mask_vocab_pad(logits, cfg), new_kstate, *stats)


def mask_vocab_pad(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rows of the 256-aligned embedding table past the vocabulary never
    win: their logits are set to -1e9."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) < \
        cfg.vocab_size
    return logits.masked_fill(~valid, -1e9)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            pad_mask: Optional[torch.Tensor] = None, z_loss: float = 0.0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross entropy in fp32. logits (B,S,V), targets (B,S).
    The metrics are detached."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - tgt
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=logits.device)
    if pad_mask is not None:
        mask = mask * pad_mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    metrics = {"nll": loss.detach(), "tokens": denom}
    if z_loss:
        zl = z_loss * ((lse ** 2) * mask).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl.detach()
    return loss, metrics


def next_token_batch(batch: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Shift tokens for next-token prediction: inputs[t] predicts
    tokens[t+1]."""
    toks = batch["tokens"]
    inputs = dict(batch)
    inputs["tokens"] = toks[:, :-1]
    for k in ("positions", "pad_mask"):
        if k in batch:
            inputs[k] = batch[k][:, :-1]
    return inputs, toks[:, 1:]
