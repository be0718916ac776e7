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

On a mesh whose model axis holds M > 1 ranks (``mesh=``, with
``constrain_fn`` from `dist.sharding.make_constrain_fn`), the params and
centroids are this rank's shards: the embedding and the LM head are
vocab-parallel, `apply_model` returns this rank's (B,S,V/M) block of the
logits and `lm_loss` (``axis=``) reduces the cross entropy over the model
axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.tensor_parallel import ModelAxis, vocab_lse_target
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
                return_stats: bool = False, constrain_fn=None, mesh=None):
    """(logits (B,S,V) fp32, new_kstate). The routing layers always
    return their EMA centroid update; it is functional: the caller (the
    train step) decides whether to keep it. ``return_stats`` adds a third
    element: the stack's routing-health stats (`T.apply_stack`), None
    unless ``cfg.routing.stats`` is on. With ``mesh`` (a model axis of M >
    1 ranks) the logits are this rank's vocabulary block (B,S,V/M) and the
    batch's rows are this rank's data rows (see the module docstring)."""
    axis = model_axis(mesh, constrain_fn)
    x = L.embed(params["embed"], batch["tokens"], axis)
    x, new_kstate, *stats = T.apply_stack(
        params["stack"], kstate, x, cfg, positions=batch.get("positions"),
        pad_mask=batch.get("pad_mask"), impl=impl, remat=remat,
        drop_seed=drop_seed, return_stats=return_stats,
        constrain_fn=constrain_fn, axis=axis)
    epilogue = getattr(constrain_fn, "epilogue", None)
    if epilogue is not None:
        x = epilogue(x)           # SP: gather the sequence for the LM head
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if axis is not None and not axis.seq_parallel:
        x = axis.enter(x)
    logits = L.logits_out(params["embed"], x, cfg.tie_embeddings,
                          cfg.logit_softcap)
    lo = 0 if axis is None else axis.rank * logits.shape[-1]
    return (mask_vocab_pad(logits, cfg, lo), new_kstate, *stats)


def model_axis(mesh, constrain_fn=None) -> Optional[ModelAxis]:
    """The `ModelAxis` of ``mesh`` (sequence-parallel when
    ``constrain_fn`` says so), or None without a model axis of more than
    one rank."""
    if mesh is None or mesh.size("model") <= 1:
        return None
    return ModelAxis(mesh, getattr(constrain_fn, "seq_parallel", False))


def mask_vocab_pad(logits: torch.Tensor, cfg: ModelConfig,
                   lo: int = 0) -> torch.Tensor:
    """Rows of the 256-aligned embedding table past the vocabulary never
    win: their logits are set to -1e9. ``lo``: the first vocabulary row of
    a vocab-parallel block of the logits."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(lo, lo + logits.shape[-1],
                         device=logits.device) < cfg.vocab_size
    return logits.masked_fill(~valid, -1e9)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            pad_mask: Optional[torch.Tensor] = None, z_loss: float = 0.0,
            axis: Optional[ModelAxis] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross entropy in fp32. logits (B,S,V), targets (B,S).
    The metrics are detached. With ``axis`` the logits are this rank's
    vocabulary block and the log-sum-exp and target logit are reduced
    over the model axis (`vocab_lse_target`)."""
    logits = logits.float()
    if axis is not None and axis.size > 1:
        lse, tgt = vocab_lse_target(logits, targets, axis)
    else:
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
