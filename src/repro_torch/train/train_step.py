"""Training step: loss, grads, microbatch accumulation, optimizer update
(port of the JAX package's ``train/train_step.py``, one device).

`make_train_step(run)` returns ``(TrainState, batch) -> (TrainState,
metrics)``. The k-means routing state rides in TrainState and is refreshed
from the forward pass (functional EMA, no gradient). Gradient accumulation
loops over microbatches, carrying the centroids from one to the next; the
remat policy applies inside the model stack. Gradients come from
``torch.autograd.grad`` on detached copies of the parameter leaves, so
nothing accumulates in ``.grad`` and the state stays functional: the step
returns new parameter and optimizer trees (the old ones are freed when the
caller drops the old state).

Data parallelism runs over a ``torch.distributed`` process group (one
process per rank, `repro_torch.launch.distributed.initialize`). With
``TrainConfig.grad_compression == "int8_ef"``, or with more than one rank,
`make_train_step` returns the data-parallel step (the counterpart of the
JAX package's ``shard_map`` step): every rank takes the global batch,
differentiates its own rows, and the gradient mean goes over the wire as
int8 with an error-feedback residual carried in ``TrainState.ef_state``
(``int8_ef``), or as the exact fp32 mean; the optimizer update runs on
every rank on the same mean, so the ranks stay equal bit for bit.

On a (data, model) mesh whose model axis holds M > 1 ranks
(`make_train_step(run, mesh=, constrain_fn=)`, `make_tp_train_step`) each
rank holds its shards of the state (`init_train_state(mesh=)`,
`dist.sharding.shard_state`) and runs the model tensor-parallel over its
model group (and, with a ``constrain_fn`` of ``seq_parallel``,
sequence-parallel); the gradient mean goes over its data group, the norm
of the clip sums the shards' squares over the model group, Adam updates
its shards and Adafactor reduces its statistics over the model group.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.attn.spec import spec_for_layer
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.dist import compression as comp
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.models.model import (apply_model, init_model, lm_loss,
                                      model_axis, next_token_batch)
from repro_torch.models.transformer import build_segments, fold_seed
from repro_torch.obs import routing_stats as obs_rt
from repro_torch.obs.trace import span
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    kstate: Any
    opt_state: Any
    step: int
    # fp32 error-feedback residuals of int8 gradient compression: a
    # param-shaped tree of (1, *param.shape) leaves, this rank's row of the
    # JAX package's (D, *param.shape) residual (a checkpoint holds all D
    # rows). None when grad_compression == "none".
    ef_state: Any = None


def init_ef_state(params):
    """Zero residuals, (1, *param.shape) fp32 per leaf: this rank's row."""
    return tree_map(lambda p: torch.zeros((1, *p.shape), dtype=torch.float32,
                                          device=p.device), params)


def init_train_state(run: RunConfig, seed: int = 0, device="cuda",
                     mesh=None, fsdp: bool = False) -> TrainState:
    """Fresh parameters, centroids and optimizer state on ``device``
    (default the card; raises without one unless ``device="cpu"``), and
    zero residuals when ``grad_compression == "int8_ef"``. Each rank holds
    only its own residual row, so the data-parallel size is not needed
    here. On a ``mesh`` whose model axis holds M > 1 ranks, this rank's
    shards of the same state (`dist.sharding.shard_state`: every rank
    draws the whole state from ``seed`` and keeps its part). ``fsdp``
    raises `NotImplementedError` (ROADMAP item 10)."""
    if fsdp:
        raise NotImplementedError(
            "fsdp=True: the FSDP compute path waits for ROADMAP item 10 "
            "(with item 12's families above 20 B parameters)")
    params, kstate = init_model(run.model, seed=seed, device=device)
    opt_init, _ = make_optimizer(run.train)
    ef = (init_ef_state(params)
          if run.train.grad_compression == "int8_ef" else None)
    ts = TrainState(params, kstate, opt_init(params), 0, ef)
    if mesh is not None and mesh.size("model") > 1:
        ts = shd.shard_state(ts, run.model, mesh)
    return ts


def make_loss_fn(run: RunConfig, impl: Optional[str] = None,
                 constrain_fn=None, mesh=None):
    """``loss_fn(params, kstate, batch, drop_seed) -> (loss, (new_kstate,
    metrics))``; ``batch["tokens"]`` is (B, S+1). With ``mesh`` (a model
    axis of M > 1 ranks) the params and centroids are this rank's shards
    and the loss and the routing-health stats are the whole model's, on
    every model rank."""
    mc, tc = run.model, run.train
    axis = model_axis(mesh, constrain_fn)

    def loss_fn(params, kstate, batch, drop_seed):
        inputs, targets = next_token_batch(batch)
        logits, new_k, rstats = apply_model(
            params, kstate, inputs, mc, impl=impl, remat=tc.remat,
            drop_seed=drop_seed, return_stats=True,
            constrain_fn=constrain_fn, mesh=mesh)
        loss, metrics = lm_loss(logits, targets, inputs.get("pad_mask"),
                                tc.z_loss, axis)
        metrics = dict(metrics)
        if rstats is not None and axis is not None:
            # each model rank computed its routing heads' stats: gather
            # them along the head axis (rank order is head order)
            rstats = _gather_heads(rstats, axis.mesh)
        if rstats is not None:
            # routing-health stats (RoutingConfig.stats): model-wide
            # scalars ("routing/entropy", ...) and per-layer detail
            # ("rt/{seg}/{layer}/{field}", leading (G,) group axis)
            metrics.update(obs_rt.summarize(rstats))
            metrics.update(obs_rt.flatten(rstats))
        metrics["loss"] = loss.detach()
        return loss, (new_k, metrics)

    return loss_fn


def _gather_heads(seg_stats, mesh):
    """The stack's routing-health stats (a list over segments of {layer:
    RoutingStats}, leaves (G, H/M, ...)) with the model ranks' heads
    gathered: the whole model's (G, H, ...)."""
    return [{li: type(st)(*(tpar.all_gather_dim(x, 1, mesh) for x in st))
             for li, st in seg.items()} for seg in seg_stats]


def value_and_grad(loss_fn, cfg: Optional[ModelConfig] = None):
    """``(params, *args) -> ((loss, aux), grads)`` with grads shaped like
    params (the counterpart of ``jax.value_and_grad(has_aux=True)``). With
    ``cfg``, the leaves `unread_leaves` names get a zero gradient, as in
    JAX; any other leaf the loss does not use raises."""
    def vg(params, *args):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        unread = None if cfg is None else unread_leaves(params, cfg)
        with torch.enable_grad():
            loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
            grads = leaf_grads(loss, leaves, unread)
        return (loss.detach(), aux), tree_unflatten(params, grads)
    return vg


def unread_leaves(params, cfg: ModelConfig) -> List[bool]:
    """Flags, in `tree_leaves` order, of the parameters the loss never
    reads: the key projection (``wk``, ``bk``) of a layer whose every head
    is causal shared-QK routing, since its keys are its queries."""
    flags = tree_map(lambda _: False, params)
    for seg, (pattern, _) in zip(flags["stack"], build_segments(cfg)):
        for layer, s in zip(seg, pattern):
            spec = spec_for_layer(cfg, s.attn)
            if (spec.variant == "routing" and spec.causal
                    and spec.routing.share_qk):
                for name in ("wk", "bk"):
                    if name in layer["attn"]:
                        layer["attn"][name] = True
    return tree_leaves(flags)


def leaf_grads(loss, leaves, unread: Optional[List[bool]] = None,
               **kwargs):
    """``torch.autograd.grad`` of ``loss`` for every leaf: zeros for the
    leaves flagged in ``unread``; a leaf the loss does not use and
    ``unread`` does not flag raises."""
    unread = unread or [False] * len(leaves)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, **kwargs)
    cut = [i for i, (g, u) in enumerate(zip(grads, unread))
           if g is None and not u]
    if cut:
        raise RuntimeError(f"parameter leaves {cut} are not used by the "
                           f"loss")
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def global_norm(tree, model=None) -> torch.Tensor:
    """The L2 norm over every leaf. ``model`` (mesh, dims): the leaves
    whose dim is not None are this rank's shards, whose squares are summed
    over the model group; the others (replicated, equal on every rank)
    count once."""
    leaves = tree_leaves(tree)
    if model is None:
        return torch.sqrt(sum(g.float().square().sum() for g in leaves))
    mesh, dims = model
    zero = leaves[0].new_zeros((), dtype=torch.float32)
    repl = sum((g.float().square().sum() for g, d in zip(leaves, dims)
                if d is None), zero)
    cut = sum((g.float().square().sum() for g, d in zip(leaves, dims)
               if d is not None), zero)
    return torch.sqrt(repl + tpar.all_sum(cut, mesh))


def clip_by_global_norm(grads, max_norm: float, model=None):
    gn = global_norm(grads, model)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def make_grad_fn(run: RunConfig, loss_fn):
    """``(params, kstate, batch, drop_seed) -> (grads, new_kstate,
    metrics)`` with microbatch accumulation per `TrainConfig.grad_accum`:
    the batch is cut into ``grad_accum`` consecutive row blocks, each
    microbatch starts from the centroids the previous one left, grads sum
    in ``accum_dtype`` and are divided by the count, and the metrics are
    the microbatch means (the per-layer stats tensors elementwise). Every microbatch gets the same dropout seed, as
    in the JAX package."""
    tc = run.train
    vg = value_and_grad(loss_fn, run.model)

    def grad_fn(params, kstate, batch, drop_seed):
        A = tc.grad_accum
        if A <= 1:
            (_, (new_k, metrics)), grads = vg(params, kstate, batch,
                                              drop_seed)
            return grads, new_k, dict(metrics)
        B = batch["tokens"].shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into grad_accum={A} "
                             f"microbatches")
        acc_dt = getattr(torch, tc.accum_dtype)
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                              device=p.device), params)
        kst, mlist = kstate, []
        for a in range(A):
            mb = {k: v[a * (B // A):(a + 1) * (B // A)]
                  for k, v in batch.items()}
            (_, (kst, metrics)), g = vg(params, kst, mb, drop_seed)
            gacc = tree_map(lambda x, y: x + y.to(acc_dt), gacc, g)
            mlist.append(metrics)
        grads = tree_map(lambda g: g / A, gacc)
        metrics = {k: torch.stack([m[k] for m in mlist]).mean(0)
                   for k in mlist[0]}
        return grads, kst, metrics

    return grad_fn


def _finish_step(tc, schedule, opt_update, ts: TrainState, grads, new_k,
                 metrics, new_ef, model=None):
    """Shared tail: clip, lr, optimizer update, state assembly (``model``:
    (mesh, dims) of a tensor-parallel state, see `global_norm`)."""
    with span("train/optimizer"):
        grads, gn = clip_by_global_norm(grads, tc.grad_clip, model)
        lr = schedule(ts.step + 1)
        new_params, new_opt = opt_update(grads, ts.opt_state, ts.params, lr,
                                         model=model)
    metrics["grad_norm"] = gn
    metrics["lr"] = lr
    return (TrainState(new_params, new_k, new_opt, ts.step + 1, new_ef),
            metrics)


def _drop_seed(run: RunConfig, step: int) -> Optional[int]:
    """The dropout seed of ``step`` (None with dropout off)."""
    return (fold_seed(run.train.seed, step) if run.model.dropout > 0
            else None)


def make_train_step(run: RunConfig, impl: Optional[str] = None,
                    constrain_fn=None, mesh=None):
    """``train_step(ts, batch) -> (new_ts, metrics)``; the metrics are
    0-d tensors (``lr`` a float; with ``RoutingConfig.stats`` also the
    ``routing/*`` scalars and the per-layer ``rt/*`` (G, H) tensors) and
    are not synchronized with the host. The loss and backward run under
    the span ``train/grad``, the clip and optimizer update under
    ``train/optimizer``.
    ``impl`` forces an attention backend (``"torch"``: the plain path);
    by default CUDA tensors take the kernels. On a ``mesh`` whose model
    axis holds more than one rank, the tensor-parallel step
    (`make_tp_train_step`, ``constrain_fn`` from
    `dist.sharding.make_constrain_fn`); else, with ``int8_ef`` compression
    or more than one rank in the default process group, the data-parallel
    step (`make_compressed_train_step`, over the mesh's data group)."""
    if mesh is not None and mesh.size("model") > 1:
        return make_tp_train_step(run, impl, constrain_fn, mesh)
    if (run.train.grad_compression == "int8_ef"
            or comp.world_size() > 1):
        return make_compressed_train_step(
            run, impl, None if mesh is None else mesh.group("data"))
    tc = run.train
    loss_fn = make_loss_fn(run, impl)
    _, opt_update = make_optimizer(tc)
    schedule = make_schedule(tc, run.model.d_model)
    grad_fn = make_grad_fn(run, loss_fn)

    def train_step(ts: TrainState, batch: Dict[str, torch.Tensor]):
        with span("train/grad"):
            grads, new_k, metrics = grad_fn(ts.params, ts.kstate, batch,
                                            _drop_seed(run, ts.step))
        return _finish_step(tc, schedule, opt_update, ts, grads, new_k,
                            metrics, ts.ef_state)

    return train_step


def exchange_grads(grads, ef_state, group=None):
    """The data-parallel gradient mean over ``group``'s D ranks:
    ``(mean_grads, new_ef_state)``. With residuals (``ef_state``, leaves
    (1, *shape)) a leaf of at least D * 128 values goes through
    `int8_ef_psum_mean`; smaller ones (norm scales, biases: padding to
    D * 128 would outweigh the payload saved) take the exact fp32 mean and
    keep their residual, which stays zero. Without residuals every leaf
    takes the exact fp32 mean. The identity at D = 1."""
    D = comp.world_size(group)
    gl = tree_leaves(grads)
    el = (tree_leaves(ef_state) if ef_state is not None
          else [None] * len(gl))
    means, errs = [], []
    for g, e in zip(gl, el):
        if e is not None and g.numel() >= D * comp.QUANT_GROUP:
            m, ne = comp.int8_ef_psum_mean(g, e[0], group)
            e = ne[None]
        else:
            m = comp.all_mean(g, group)
        means.append(m)
        errs.append(e)
    return (tree_unflatten(grads, means),
            None if ef_state is None else tree_unflatten(ef_state, errs))


def sync_metrics(metrics: Dict[str, torch.Tensor], group=None):
    """Means over the ranks of per-rank means (exact for equal shards), but
    ``tokens``, a count, which is summed."""
    return {k: (comp.all_sum(v, group) if k == "tokens"
                else comp.all_mean(v, group)) for k, v in metrics.items()}


def make_compressed_train_step(run: RunConfig, impl: Optional[str] = None,
                               group=None):
    """Data-parallel train step over ``group`` (default: the default
    process group; one rank with none), with int8 error-feedback gradient
    compression when ``grad_compression == "int8_ef"``.

    Every rank is handed the global batch and differentiates its own
    ``global_batch / D`` rows (rank r: rows r * B / D to (r + 1) * B / D),
    with the same dropout seed on every rank, as inside the JAX package's
    ``shard_map``. The gradient mean is `exchange_grads`; the centroids'
    float leaves take the exact fp32 mean and the metrics `sync_metrics`;
    the shared tail (clip, lr, optimizer) runs on every rank on the same
    mean. At D = 1 the exchange is the identity and the step is the
    uncompressed step, bit for bit. Without compression at D > 1 the step
    equals one process's step on the whole batch at dropout 0 (with
    dropout each rank draws its shard's mask from the shared seed, not its
    rows of the global batch's mask).
    """
    tc = run.train
    D = comp.world_size(group)
    r = comp.rank(group)
    compress = tc.grad_compression == "int8_ef"
    if tc.global_batch % D:
        raise ValueError(f"global_batch={tc.global_batch} must divide over "
                         f"{D} data-parallel ranks")
    loss_fn = make_loss_fn(run, impl)
    _, opt_update = make_optimizer(tc)
    schedule = make_schedule(tc, run.model.d_model)
    grad_fn = make_grad_fn(run, loss_fn)

    def train_step(ts: TrainState, batch: Dict[str, torch.Tensor]):
        if compress:
            lead = ({e.shape[0] for e in tree_leaves(ts.ef_state)}
                    if ts.ef_state is not None else None)
            if lead != {1}:
                # a residual of other rows would put another rank's
                # error into this rank's exchange: the bias error feedback
                # exists to cancel
                raise ValueError(
                    f"ef_state rows {sorted(lead or ())} per rank, expected "
                    f"1 (this rank's row of {D}); build the state with "
                    f"init_train_state under grad_compression='int8_ef'")
        B = batch["tokens"].shape[0]
        if B % D:
            raise ValueError(f"batch of {B} rows does not split over {D} "
                             f"data-parallel ranks")
        rows = slice(r * B // D, (r + 1) * B // D)
        local = {k: v[rows] for k, v in batch.items()}
        with span("train/grad"):
            grads, new_k, metrics = grad_fn(ts.params, ts.kstate, local,
                                            _drop_seed(run, ts.step))
        with span("train/exchange"):
            mean_g, new_ef = exchange_grads(
                grads, ts.ef_state if compress else None, group)
            new_k = tree_map(lambda a: comp.all_mean(a, group)
                             if a.is_floating_point() else a, new_k)
            metrics = sync_metrics(metrics, group)
        return _finish_step(tc, schedule, opt_update, ts, mean_g, new_k,
                            metrics, new_ef if compress else ts.ef_state)

    return train_step


def make_tp_train_step(run: RunConfig, impl: Optional[str] = None,
                       constrain_fn=None, mesh=None):
    """The train step on a (data, model) mesh with M > 1 model ranks: the
    gradients of `make_tp_grad_fn`, then the clip, whose norm sums the
    shards' squares over the model group, and the optimizer: Adam updates
    each shard, Adafactor reduces its statistics over the model group.
    ``int8_ef`` raises `ValueError` (data-parallel only, as in the JAX
    package). The routing-health stats (``RoutingConfig.stats``) are the
    whole model's: each rank's heads' stats gathered over the model
    group (`make_loss_fn`).
    """
    tc = run.train
    if tc.grad_compression == "int8_ef":
        raise ValueError(
            "int8_ef grad compression is data-parallel only; got a mesh "
            f"with model axis size {mesh.size('model')}")
    grad_fn = make_tp_grad_fn(run, impl, constrain_fn, mesh)
    _, opt_update = make_optimizer(tc)
    schedule = make_schedule(tc, run.model.d_model)

    def train_step(ts: TrainState, batch: Dict[str, torch.Tensor]):
        grads, new_k, metrics = grad_fn(ts.params, ts.kstate, batch,
                                        _drop_seed(run, ts.step))
        dims = shd.model_dims(shd.grads_placements(mesh, grads), grads)
        return _finish_step(tc, schedule, opt_update, ts, grads, new_k,
                            metrics, ts.ef_state, model=(mesh, dims))

    return train_step


def make_tp_grad_fn(run: RunConfig, impl: Optional[str] = None,
                    constrain_fn=None, mesh=None):
    """``(params, kstate, batch, drop_seed) -> (grads, new_kstate,
    metrics)`` of this rank's shards on a (data, model) mesh.

    Each rank is handed the global batch and takes the rows of its data
    coordinate (D data ranks: rows d * B / D to (d + 1) * B / D); the model
    ranks of one data coordinate run the model tensor-parallel on their
    shards (`models.transformer`), sequence-parallel when ``constrain_fn``
    says so. The gradients of the replicated leaves come out equal on the
    model ranks (the conjugate collectives; under sequence parallelism
    each rank's part of a norm's gradient, from its slice of the
    sequence, is summed over the model group). Over D > 1 the gradients,
    float centroids and metrics take the exact fp32 mean over the data
    group, as the data-parallel step's."""
    D = mesh.size("data")
    if run.train.global_batch % D:
        raise ValueError(f"global_batch={run.train.global_batch} must "
                         f"divide over {D} data-parallel ranks")
    seq_parallel = getattr(constrain_fn, "seq_parallel", False)
    dgroup = mesh.group("data")
    d = mesh.coord("data")
    grad_fn = make_grad_fn(run, make_loss_fn(run, impl, constrain_fn, mesh))

    def tp_grad_fn(params, kstate, batch, drop_seed):
        B = batch["tokens"].shape[0]
        if B % D:
            raise ValueError(f"batch of {B} rows does not split over {D} "
                             f"data-parallel ranks")
        rows = slice(d * B // D, (d + 1) * B // D)
        local = {k: v[rows] for k, v in batch.items()}
        with span("train/grad"):
            grads, new_k, metrics = grad_fn(params, kstate, local,
                                            drop_seed)
        with span("train/exchange"):
            if seq_parallel:
                dims = shd.model_dims(shd.grads_placements(mesh, grads),
                                      grads)
                grads = _sum_replicated(grads, dims, mesh)
            if D > 1:
                grads, _ = exchange_grads(grads, None, dgroup)
                new_k = tree_map(lambda a: comp.all_mean(a, dgroup)
                                 if a.is_floating_point() else a, new_k)
                metrics = sync_metrics(metrics, dgroup)
        return grads, new_k, metrics

    return tp_grad_fn


def _sum_replicated(grads, dims, mesh):
    """The replicated leaves' gradients summed over the model group (one
    flat buffer): under sequence parallelism each rank's is the part of
    its slice of the sequence."""
    leaves = tree_leaves(grads)
    idx = [i for i, dm in enumerate(dims) if dm is None]
    if not idx:
        return grads
    flat = torch.cat([leaves[i].float().reshape(-1) for i in idx])
    flat = tpar.all_sum(flat, mesh)
    out = list(leaves)
    for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
        out[i] = part.reshape(leaves[i].shape).to(leaves[i].dtype)
    return tree_unflatten(grads, out)
