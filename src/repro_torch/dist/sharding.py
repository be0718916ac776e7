"""The sharding rule table for ("data", "model") meshes (port of the JAX
package's ``dist/sharding.py``): one place that says how every tree of the
system is laid out.

  params / optimizer state   Megatron-style tensor parallelism over
      "model": column-parallel up/qkv projections (output dim sharded),
      row-parallel down/out projections (input dim sharded), vocab-
      parallel embedding. With ``fsdp=True`` each 2D weight is also
      sharded over the data axes on its non-model dim (zero-3; the table
      says so, the port's step does not run it yet: ROADMAP item 10).
  batches                    leading (batch) dim over the data axes.
  activations                ``make_constrain_fn(mesh, seq_parallel)``: the
      residual stream's layout between layer groups; with sequence
      parallelism each model rank holds a slice of the sequence, gathered
      by the function's ``.epilogue`` before the LM head.
  decode caches / slot pools  slot axis (position 1) over the data axes
      and head axes over "model".

Rules are name-based over the leaf *path*, the innermost recognized name
winning: Adam's m/v trees reuse the param names and inherit their layout,
Adafactor's factored statistics (vr/vc) stay replicated. A dim that does
not divide its axis stays replicated.

A placement is a tuple with one entry per dim: None, an axis name or a
tuple of axis names (the counterpart of a ``PartitionSpec``). PyTorch has
no GSPMD, so the port makes a placement real itself: `shard_tree` cuts a
full tree into this rank's shards over "model" and `gather_tree` puts the
shards back together (`repro_torch.dist.tensor_parallel` holds the
collectives the model runs on them). Both take the head grouping of
local+routing layers (`head_groups`): a rank holds ``Hl / M`` local and
``Hr / M`` routing heads, so the attention leaves' head axis is permuted
before it is cut (see `repro_torch.models.transformer`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_paths, tree_unflatten

# Column-parallel 2D cores (d_in, d_out): d_out over "model". Leading
# stacked dims (scan groups G) are handled by indexing from the end.
_COL_PARALLEL = {"wq", "wk", "wv", "w_up", "w_gate", "in_proj", "w_in",
                 "w_gate_branch", "w_a", "w_x", "unembed"}
# Row-parallel (d_in, d_out): d_in over "model".
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "w_out"}
_MODEL_BIAS = {"bq", "bk", "bv"}       # follow their column-parallel weight
_VOCAB_PARALLEL = {"tok"}              # (V, d): padded vocab over "model"
# Small / irregular leaves that stay replicated, and Adafactor's factored
# moments (vr/vc drop a dim against their param, so the weight rules must
# not fire through them).
_REPLICATED = {"vr", "vc", "scale", "bias", "router", "conv_w", "conv_b",
               "A_log", "D", "dt_bias", "b_a", "b_x", "mask_emb",
               "xgate_attn", "xgate_ffn", "count"}

Placement = Tuple[Any, ...]


def _cache_head_axes() -> Dict[str, int]:
    """Decode-cache head axes, as the attention backends declare them (and
    the SSD recurrent state's, which the JAX package appends)."""
    from repro_torch import attn
    hints = dict(attn.cache_head_axes())
    hints["state"] = 2
    return hints


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------
def dp_axes(mesh):
    """The data-parallel axes: multi-pod meshes fold "pod" into them."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _fits(shape, dim, mesh, axis) -> bool:
    size = mesh.size(axis)
    return size > 1 and shape[dim] % size == 0


def _names(path) -> List[str]:
    return [k for k in path if isinstance(k, str)]


# ---------------------------------------------------------------------------
# Parameter / optimizer-state rules
# ---------------------------------------------------------------------------
def _rule(names: Sequence[str], nd: int) -> Optional[str]:
    """The rule of the innermost recognized name of a leaf's path."""
    for name in reversed(names):
        if name in _REPLICATED:
            return "repl"
        if name in _COL_PARALLEL and nd >= 2:
            return "col"
        if name in _ROW_PARALLEL and nd >= 2:
            return "row"
        if name in _MODEL_BIAS and nd >= 1:
            return "bias"
        if name in _VOCAB_PARALLEL and nd >= 2:
            return "vocab"
    return None


def _model_dim(rule: Optional[str], nd: int) -> Optional[int]:
    """The dim a rule puts over "model" (None: replicated)."""
    return {"col": nd - 1, "bias": nd - 1, "row": nd - 2,
            "vocab": nd - 2}.get(rule)


def _leaf_spec(names, shape, mesh, fsdp: bool) -> Placement:
    nd = len(shape)
    dp = dp_axes(mesh)
    spec: List[Any] = [None] * nd
    rule = _rule(names, nd)
    md = _model_dim(rule, nd)
    if md is not None and _fits(shape, md, mesh, "model"):
        spec[md] = "model"
    if fsdp and rule in ("col", "row", "vocab"):
        other = nd - 2 if rule == "col" else nd - 1
        if _fits(shape, other, mesh, dp):
            spec[other] = dp
    return tuple(spec)


def _map_paths(fn, tree):
    return tree_unflatten(tree, [fn(p, leaf) for p, leaf in tree_paths(tree)])


def placement_at(placements, path) -> Placement:
    """The placement of the leaf at ``path`` (a `tree_paths` path of the
    tree the placements describe: a placement is itself a tuple, so a
    placement tree is read along the value tree's paths)."""
    for k in path:
        placements = placements[k]
    return placements


def model_dims(placements, tree) -> List[Optional[int]]:
    """Per leaf of ``tree`` (`tree_leaves` order), the dim its placement
    puts over "model", or None."""
    out = []
    for path, _ in tree_paths(tree):
        p = placement_at(placements, path)
        out.append(next((d for d, ax in enumerate(p) if _on_model(ax)),
                        None))
    return out


def _on_model(ax) -> bool:
    return ax == "model" or (isinstance(ax, tuple) and "model" in ax)


def params_sharding(mesh, params, fsdp: bool = False):
    """Name-rule placements for a param-shaped tree (params, Adam moments,
    grads: anything whose leaf paths end in the param names)."""
    return _map_paths(lambda p, leaf: _leaf_spec(_names(p), _shape(leaf),
                                                 mesh, fsdp), params)


def kstate_sharding(mesh, kstate):
    """k-means centroids, leaves (G, Hr, kc, dh): the routing-head axis
    over "model" (aligned with the head-sharded attention), else
    replicated."""
    def one(_, leaf):
        shape = _shape(leaf)
        spec: List[Any] = [None] * len(shape)
        if len(shape) >= 3 and _fits(shape, 1, mesh, "model"):
            spec[1] = "model"
        return tuple(spec)
    return _map_paths(one, kstate)


def ef_sharding(mesh, ef_state):
    """Error-feedback residuals, leaves (D, *param_shape): the leading
    per-device axis over the data axes, the other dims by the param name
    rules (which index from the end); no fsdp."""
    def one(path, leaf):
        shape = _shape(leaf)
        spec = list(_leaf_spec(_names(path), shape, mesh, fsdp=False))
        if _fits(shape, 0, mesh, dp_axes(mesh)):
            spec[0] = dp_axes(mesh)
        return tuple(spec)
    return None if ef_state is None else _map_paths(one, ef_state)


def train_state_sharding(mesh, ts, fsdp: bool = False):
    """Placements of a TrainState (params, kstate, opt_state, step,
    ef_state): the optimizer state by the param rules, the step
    replicated, the residuals by `ef_sharding`."""
    from repro_torch.train.train_step import TrainState
    return TrainState(
        params=params_sharding(mesh, ts.params, fsdp),
        kstate=kstate_sharding(mesh, ts.kstate),
        opt_state=params_sharding(mesh, ts.opt_state, fsdp),
        step=(),
        ef_state=ef_sharding(mesh, ts.ef_state))


# ---------------------------------------------------------------------------
# Data / activation / cache rules
# ---------------------------------------------------------------------------
def batch_sharding(mesh, batch):
    """Input batches: leading dim over the data axes (when it divides)."""
    dp = dp_axes(mesh)

    def one(_, leaf):
        shape = _shape(leaf)
        spec: List[Any] = [None] * len(shape)
        if shape and _fits(shape, 0, mesh, dp):
            spec[0] = dp
        return tuple(spec)
    return _map_paths(one, batch)


def replicated(mesh, tree):
    """Fully replicated placements (metrics, small shared state)."""
    return _map_paths(lambda p, leaf: (), tree)


def cache_sharding(mesh, cache, batch: int):
    """Decode caches / engine slot pools: leaves (G, B, ...), slots over the
    data axes and the head axes over "model" where the attention backends
    declare them."""
    dp = dp_axes(mesh)
    head_axes = _cache_head_axes()

    def one(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        shape = _shape(leaf)
        spec: List[Any] = [None] * len(shape)
        if (len(shape) >= 2 and shape[1] == batch
                and _fits(shape, 1, mesh, dp)):
            spec[1] = dp
        ax = head_axes.get(name)
        if (ax is not None and len(shape) > ax
                and _fits(shape, ax, mesh, "model")):
            spec[ax] = "model"
        return tuple(spec)
    return _map_paths(one, cache)


def make_constrain_fn(mesh, seq_parallel: bool = False,
                      fsdp_prefetch: bool = False, attn_specs=()):
    """The residual stream's layout between layer groups (and at stack
    entry): x (B, N, d) holds the rows of this rank's data coordinate and,
    with ``seq_parallel``, its model coordinate's N / M slice of the
    sequence (Megatron-SP: norms, dropout and residual adds run on 1/M of
    the tokens). The collectives that make that layout are the model's
    (`repro_torch.dist.tensor_parallel.ModelAxis`), so the function returns
    x as it is; it carries ``.seq_parallel`` for them, and with it an
    ``.epilogue`` that gathers the sequence back before the LM head.

    With ``seq_parallel``, ``attn_specs`` (`attn.specs_for_model`) are
    validated: a routing spec whose segment fold does not align with the
    model axis (`attn.seq_shardable`) raises `ValueError`, as in the JAX
    package. ``fsdp_prefetch`` (the zero-3 gather at group entry) raises
    `NotImplementedError`: FSDP compute waits for ROADMAP item 10.
    """
    if fsdp_prefetch:
        raise NotImplementedError(
            "fsdp_prefetch: the FSDP compute path waits for ROADMAP item 10 "
            "(with item 12's families above 20 B parameters)")
    tp = mesh.size("model")
    if seq_parallel and attn_specs:
        from repro_torch import attn
        bad = [f"{s.variant}/segments={s.routing.segments}"
               for s in attn_specs if not attn.seq_shardable(s, tp)]
        if bad:
            raise ValueError(
                f"seq_parallel over a {tp}-way model axis, but "
                f"{len(bad)} attention spec(s) route globally "
                f"(RoutingConfig.segments must be a multiple of {tp} for "
                f"shard-local balanced top-k): {bad}")
    sp = seq_parallel and tp > 1

    def constrain(x):
        # the layout is made by the model's collectives (ModelAxis); the
        # stream between groups is already this rank's part
        return x

    constrain.seq_parallel = sp
    if sp:
        def epilogue(x):
            from repro_torch.dist import tensor_parallel as tpar
            return tpar.gather_seq(x, mesh)
        constrain.epilogue = epilogue
    return constrain


# ---------------------------------------------------------------------------
# Making placements real: cut a full tree, gather the shards back
# ---------------------------------------------------------------------------
_Q_LEAVES = {"wq": -1, "bq": -1, "wo": -2}
_KV_LEAVES = {"wk": -1, "wv": -1, "bk": -1, "bv": -1}
# Adafactor's statistics whose last dim is a head-grouped param dim
_STAT_AXES = {("wq", "vc"), ("bq", "vc"), ("wk", "vc"), ("wv", "vc"),
              ("bk", "vc"), ("bv", "vc"), ("wo", "vr")}


def head_groups(cfg, tp: int) -> Dict[Tuple[int, int], Tuple[list, list]]:
    """For each (segment, pattern index) of a local+routing layer, the
    head order that puts rank m's heads at block m of a ``tp``-way cut:
    ``(q_order, kv_order)``, each a list of full-model head indices, rank
    0's ``Hl / tp`` local heads then its ``Hr / tp`` routing heads, then
    rank 1's, ... Other variants cut their heads contiguously (absent).
    Raises `ValueError` where a head count does not divide by ``tp``."""
    from repro_torch.attn.spec import head_shard, head_split, spec_for_layer
    from repro_torch.models.transformer import build_segments
    out = {}
    if tp <= 1:
        return out
    for si, (pattern, _) in enumerate(build_segments(cfg)):
        for i, ls in enumerate(pattern):
            spec = spec_for_layer(cfg, ls.attn)
            head_shard(spec, tp)                    # raises if uneven
            if spec.variant != "local+routing":
                continue
            Hl, Hr, kvl, kvr = head_split(spec)

            def order(nl, nr):
                a, b = nl // tp, nr // tp
                return [h for m in range(tp)
                        for h in (list(range(m * a, (m + 1) * a))
                                  + list(range(nl + m * b,
                                               nl + (m + 1) * b)))]
            out[(si, i)] = (order(Hl, Hr), order(kvl, kvr))
    return out


def _head_perm(path, nd: int, groups) -> Optional[Tuple[int, list]]:
    """(dim, head order) of a head-grouped leaf at ``path``, else None."""
    if not groups or "stack" not in path:
        return None
    at = path.index("stack")
    if len(path) < at + 5 or path[at + 3] != "attn":
        return None
    key = (path[at + 1], path[at + 2])
    if key not in groups:
        return None
    name = path[at + 4]
    stat = path[at + 5] if len(path) > at + 5 else None
    if stat is None:
        dim = _Q_LEAVES.get(name, _KV_LEAVES.get(name))
    elif (name, stat) in _STAT_AXES:
        dim = -1
    else:
        return None
    if dim is None:
        return None
    q_order, kv_order = groups[key]
    return nd + dim, (q_order if name in _Q_LEAVES else kv_order)


def _permute(t: torch.Tensor, dim: int, heads: list, inverse: bool):
    n = len(heads)
    dh = t.shape[dim] // n
    order = torch.as_tensor(heads, device=t.device)
    if inverse:
        order = torch.argsort(order)
    cols = (order[:, None] * dh + torch.arange(dh, device=t.device)
            ).reshape(-1)
    return t.index_select(dim, cols)


def shard_tree(tree, placements, mesh, groups=None):
    """This rank's shards of a full tree: each dim placed over "model" cut
    into M contiguous blocks, block ``mesh.coord("model")`` kept (a copy),
    after the head-grouped leaves (`head_groups`) are permuted. Axes other
    than "model" are not cut: a data axis is each rank's rows (batches,
    residuals), held by its caller."""
    M, m = mesh.size("model"), mesh.coord("model")
    out = []
    for path, leaf in tree_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        perm = _head_perm(path, leaf.dim(), groups)
        if perm is not None:
            leaf = _permute(leaf, perm[0], perm[1], inverse=False)
        for d, ax in enumerate(placement_at(placements, path)):
            if _on_model(ax):
                n = leaf.shape[d] // M
                leaf = leaf.narrow(d, m * n, n)
        out.append(leaf.clone())
    return tree_unflatten(tree, out)


def gather_tree(tree, placements, mesh, groups=None):
    """The full tree from every model rank's shards (collective over the
    model group; every rank gets the whole tree): the inverse of
    `shard_tree`."""
    from repro_torch.dist import tensor_parallel as tpar
    out = []
    for path, leaf in tree_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        for d, ax in enumerate(placement_at(placements, path)):
            if _on_model(ax):
                leaf = tpar.all_gather_dim(leaf, d, mesh)
        perm = _head_perm(path, leaf.dim(), groups)
        if perm is not None:
            leaf = _permute(leaf, perm[0], perm[1], inverse=True)
        out.append(leaf)
    return tree_unflatten(tree, out)


class _Shape:
    """A leaf stand-in with a shape only (the rule table reads shapes)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _full_shapes(mesh, tree, dim_of):
    """Stand-ins of the full leaves of a tree of this rank's shards: the
    dim ``dim_of(path, nd)`` names, times the model axis."""
    M = mesh.size("model")

    def one(path, leaf):
        shape = list(_shape(leaf))
        d = dim_of(path, len(shape))
        if d is not None and M > 1:
            shape[d] *= M
        return _Shape(shape)
    return _map_paths(one, tree)


def _param_dim(path, nd):
    return _model_dim(_rule(_names(path), nd), nd)


def state_placements(mesh, ts):
    """The placements of a TrainState of this rank's shards (what
    `train_state_sharding` gives its full state: the port's tensor
    parallelism cuts every dim the rules name, each checked to divide at
    the cut)."""
    from repro_torch.train.train_step import TrainState
    return train_state_sharding(mesh, TrainState(
        params=_full_shapes(mesh, ts.params, _param_dim),
        kstate=_full_shapes(mesh, ts.kstate,
                            lambda p, nd: 1 if nd >= 3 else None),
        opt_state=_full_shapes(mesh, ts.opt_state, _param_dim),
        step=ts.step, ef_state=ts.ef_state))


def grads_placements(mesh, grads):
    """The placements of a param-shaped tree of this rank's shards."""
    return params_sharding(mesh, _full_shapes(mesh, grads, _param_dim))


def shard_state(ts, cfg, mesh):
    """This rank's TrainState from a full one (`shard_tree` by
    `train_state_sharding`, local+routing heads grouped per rank)."""
    from repro_torch.train.train_step import TrainState
    if mesh.size("model") <= 1:
        return ts
    pl = train_state_sharding(mesh, ts)
    groups = head_groups(cfg, mesh.size("model"))
    for path, leaf in tree_paths(ts.params):
        md = _param_dim(path, leaf.dim())
        if md is not None and placement_at(pl.params, path)[md] != "model":
            # the rule table would leave the dim whole, which explicit
            # tensor parallelism cannot mix with its cut neighbours
            raise ValueError(f"{'/'.join(map(str, path))}: dim {md} of "
                             f"{tuple(leaf.shape)} does not divide over a "
                             f"{mesh.size('model')}-way model axis")
    return TrainState(
        params=shard_tree(ts.params, pl.params, mesh, groups),
        kstate=shard_tree(ts.kstate, pl.kstate, mesh),
        opt_state=shard_tree(ts.opt_state, pl.opt_state, mesh, groups),
        step=ts.step, ef_state=ts.ef_state)


def gather_state(ts, cfg, mesh):
    """The full TrainState from every model rank's shards (collective over
    the model group): the inverse of `shard_state`."""
    from repro_torch.train.train_step import TrainState
    if mesh.size("model") <= 1:
        return ts
    pl = state_placements(mesh, ts)
    groups = head_groups(cfg, mesh.size("model"))
    return TrainState(
        params=gather_tree(ts.params, pl.params, mesh, groups),
        kstate=gather_tree(ts.kstate, pl.kstate, mesh),
        opt_state=gather_tree(ts.opt_state, pl.opt_state, mesh, groups),
        step=ts.step, ef_state=ts.ef_state)
