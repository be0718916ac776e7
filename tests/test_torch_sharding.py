"""The port's rule table (`repro_torch.dist.sharding`), segment fold and
model-axis helpers against the JAX package's, on the CPU.

* the rule table: `train_state_sharding` (params, centroids, optimizer
  state; ``fsdp`` off and on), `ef_sharding`, `batch_sharding`,
  `cache_sharding` and `replicated` on reduced rt-enwik8, rt-pg19 (its
  Adafactor state) and qwen2-0.5b trees, leaf for leaf against the JAX
  package's on ``jax.sharding.AbstractMesh`` meshes of (2, 4) and
  (2, 16, 16) with a "pod" axis: the same shape tree (``jax.eval_shape`` of
  the JAX init) goes through both;
* `make_constrain_fn`: JAX's `ValueError` for a routing spec that is not
  `seq_shardable`, the seq-parallel epilogue, `fsdp_prefetch` refused;
  `seq_shardable`, `specs_for_model` and `cache_head_axes` against JAX's;
* the segment fold: `routed_attention` at ``segments`` 2 and 4, with a pad
  mask and with the stats, shared-QK causal and separate-QK non-causal,
  against JAX's under ``jax.jit`` (out, centroids and the stats within
  1e-5 relative, occupancy and dead counts exactly), and its fall-through
  cases (N % ns != 0, N / ns < k) equal to the unsegmented output; the
  fused kernels' glue on the folded batch;
* `routing_for_seq` and `with_routing` against JAX's;
* the head grouping of local+routing layers: rank m's shard of ``wq``,
  ``wo`` and the centroids, `head_shard`'s counts, and the refusal of a
  head count or a width that does not divide.

The model axis itself (2 and 4 gloo ranks) is held in `test_torch_tp.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import attn as jax_attn
from repro import configs as jax_configs
from repro.configs.base import RoutingConfig as JaxRoutingConfig
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import routing as jax_routing
from repro.core.kmeans import KMeansState as JaxKMeansState
from repro.dist import sharding as jax_shd
from repro.serve import serving as jax_serving
from repro.train import train_step as jax_train_step
from repro_torch import attn, configs
from repro_torch.configs.base import RoutingConfig, with_overrides
from repro_torch.core import routing
from repro_torch.core.kmeans import KMeansState
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import init_model
from repro_torch.tree import tree_paths

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = {"rt-enwik8": "adam", "rt-pg19": "adafactor", "qwen2-0.5b": "adam"}
TOL = 1e-5
ARCH_R = "rt-enwik8"


def _meshes(name):
    shape, names = MESHES[name]
    return Mesh(dict(zip(names, shape))), AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    """``jax.eval_shape`` of the JAX package's TrainState of the reduced
    arch under its optimizer."""
    run = JaxRunConfig(model=jax_configs.reduced_config(arch),
                       train=JaxTrainConfig(global_batch=4, seq_len=64,
                                            optimizer=ARCHS[arch]))
    return jax.eval_shape(
        lambda k: jax_train_step.init_train_state(run, k),
        jax.random.PRNGKey(0))


def _key(path):
    out = []
    for e in path:
        if isinstance(e, jax.tree_util.DictKey):
            out.append(e.key)
        elif isinstance(e, jax.tree_util.SequenceKey):
            out.append(e.idx)
        else:
            out.append(e.name)
    return tuple(out)


def _jax_specs(tree, shardings):
    """path -> per-dim spec tuple of each leaf of ``tree``."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: hasattr(x, "spec"))
    assert len(flat) == len(shs)
    out = {}
    for (path, leaf), sh in zip(flat, shs):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        out[_key(path)] = spec
    return out


def _port_specs(tree, placements):
    """path -> per-dim placement (a shorter one padded with None, as a
    ``PartitionSpec`` pads)."""
    out = {}
    for p, leaf in tree_paths(tree):
        pl = tuple(shd.placement_at(placements, p))
        out[p] = pl + (None,) * (len(leaf.shape) - len(pl))
    return out


def _shapes(tree):
    """The JAX shape tree as the port's leaves (containers kept)."""
    return jax.tree.map(lambda x: shd._Shape(x.shape), tree)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_state_rules_match_jax(arch, mesh, fsdp):
    pm, jm = _meshes(mesh)
    jts = _jax_state(arch)
    want = jax_shd.train_state_sharding(jm, jts, fsdp=fsdp)
    got = shd.train_state_sharding(pm, _shapes(jts), fsdp=fsdp)
    for field in ("params", "kstate", "opt_state"):
        w = _jax_specs(getattr(jts, field), getattr(want, field))
        g = _port_specs(_shapes(getattr(jts, field)), getattr(got, field))
        assert g == w, field
    assert got.step == () and got.ef_state is None
    # the rules cut over "model", and over the data axes only with fsdp
    specs = _port_specs(_shapes(jts.params), got.params)
    assert any("model" in s for s in specs.values())
    dp = "data" if mesh == "2x4" else ("pod", "data")
    assert any(dp in s for s in specs.values()) == fsdp


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_ef_and_kstate_rules_match_jax(arch, mesh):
    pm, jm = _meshes(mesh)
    jts = _jax_state(arch)
    D = pm.size(shd.dp_axes(pm))
    ef = jax.tree.map(lambda p: jax.ShapeDtypeStruct((D, *p.shape),
                                                     jnp.float32), jts.params)
    assert (_port_specs(_shapes(ef), shd.ef_sharding(pm, _shapes(ef)))
            == _jax_specs(ef, jax_shd.ef_sharding(jm, ef)))
    assert (_port_specs(_shapes(jts.kstate),
                        shd.kstate_sharding(pm, _shapes(jts.kstate)))
            == _jax_specs(jts.kstate, jax_shd.kstate_sharding(jm,
                                                              jts.kstate)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_cache_and_replicated_rules_match_jax(arch, mesh):
    pm, jm = _meshes(mesh)
    cfg = jax_configs.reduced_config(arch)
    for B in (4, 3, 32):
        batch = {"tokens": jax.ShapeDtypeStruct((B, 65), jnp.int32),
                 "pad_mask": jax.ShapeDtypeStruct((B, 64), jnp.bool_)}
        assert (_port_specs(_shapes(batch),
                            shd.batch_sharding(pm, _shapes(batch)))
                == _jax_specs(batch, jax_shd.batch_sharding(jm, batch)))
        cache = jax.eval_shape(lambda: jax_serving.init_cache(cfg, B, 128))
        assert (_port_specs(_shapes(cache),
                            shd.cache_sharding(pm, _shapes(cache), B))
                == _jax_specs(cache, jax_shd.cache_sharding(jm, cache, B)))
        assert (_port_specs(_shapes(cache), shd.replicated(pm, _shapes(cache)))
                == _jax_specs(cache, jax_shd.replicated(jm, cache)))


def test_cache_head_axes_and_seq_shardable_match_jax():
    assert attn.cache_head_axes() == jax_attn.cache_head_axes()
    for arch in ("rt-enwik8", "qwen2-0.5b", "rt-cifar10"):
        for segments in (1, 2, 4):
            cfg = configs.reduced_config(arch)
            cfg = with_overrides(cfg, routing=with_overrides(
                cfg.routing, segments=segments))
            jcfg = jax_configs.reduced_config(arch)
            jcfg = jax_configs.with_overrides(jcfg, routing=(
                jax_configs.with_overrides(jcfg.routing, segments=segments)))
            specs = attn.specs_for_model(cfg)
            jspecs = jax_attn.specs_for_model(jcfg)
            assert [s.variant for s in specs] == [s.variant for s in jspecs]
            for tp in (1, 2, 4):
                assert ([attn.seq_shardable(s, tp) for s in specs]
                        == [jax_attn.seq_shardable(s, tp) for s in jspecs])


def test_constrain_fn_refuses_global_routing_under_seq_parallel():
    pm = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0})
    cfg = configs.reduced_config("rt-enwik8")
    with pytest.raises(ValueError, match="route globally"):
        shd.make_constrain_fn(pm, True, attn_specs=attn.specs_for_model(cfg))
    seg = with_overrides(cfg, routing=with_overrides(cfg.routing,
                                                     segments=2))
    fn = shd.make_constrain_fn(pm, True, attn_specs=attn.specs_for_model(seg))
    assert fn.seq_parallel and hasattr(fn, "epilogue")
    x = torch.zeros(1, 4, 8)
    assert fn(x) is x
    # without seq_parallel, or on one model rank, nothing is checked
    off = shd.make_constrain_fn(pm, False,
                                attn_specs=attn.specs_for_model(cfg))
    assert not off.seq_parallel and not hasattr(off, "epilogue")
    one = shd.make_constrain_fn(Mesh({"data": 1, "model": 1}), True,
                                attn_specs=attn.specs_for_model(cfg))
    assert not one.seq_parallel
    with pytest.raises(NotImplementedError, match="item 10"):
        shd.make_constrain_fn(pm, fsdp_prefetch=True)
    # JAX refuses the same specs
    jm = AbstractMesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="route globally"):
        jax_shd.make_constrain_fn(jm, True, attn_specs=(
            jax_attn.specs_for_model(jax_configs.reduced_config(ARCH_R))))


# ---------------------------------------------------------------------------
# the segment fold
# ---------------------------------------------------------------------------
def _fold_inputs(B=2, H=2, N=128, dh=16, kc=4, seed=0, pad=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, N, dh).astype(np.float32)
    k = rng.randn(B, H, N, dh).astype(np.float32)
    v = rng.randn(B, H, N, dh).astype(np.float32)
    mu = rng.randn(H, kc, dh).astype(np.float32)
    mu = mu / np.linalg.norm(mu, axis=-1, keepdims=True) * np.sqrt(dh)
    mask = None
    if pad:
        lens = np.array([N, N - N // 3])[:B]
        mask = np.arange(N)[None, :] < lens[:, None]
    return q, k, v, mu, mask


def _close(got, want, rel=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _both(segments, causal, pad, stats=False, N=128, kc=4, impl="torch"):
    q, k, v, mu, mask = _fold_inputs(N=N, kc=kc, pad=pad)
    kw = dict(num_clusters=kc, segments=segments, causal=causal,
              share_qk=causal, stats=stats)
    got = routing.routed_attention(
        torch.tensor(q), None if causal else torch.tensor(k),
        torch.tensor(v), KMeansState(torch.tensor(mu)), RoutingConfig(**kw),
        pad_mask=None if mask is None else torch.tensor(mask), impl=impl)
    want = jax.jit(lambda q, k, v, mu: jax_routing.routed_attention(
        q, k, v, JaxKMeansState(mu), JaxRoutingConfig(**kw),
        pad_mask=mask))(q, None if causal else k, v, mu)
    return got, want


@pytest.mark.parametrize("pad", [False, True], ids=["dense", "padded"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("segments", [2, 4])
def test_segment_fold_matches_jax(segments, causal, pad):
    got, want = _both(segments, causal, pad, stats=True)
    _close(got.out.numpy(), want.out)
    _close(got.state.mu.numpy(), want.state.mu)
    for f in got.stats._fields:
        g, w = getattr(got.stats, f).numpy(), np.asarray(getattr(want.stats,
                                                                 f))
        assert g.shape == w.shape, f
        if f in ("occupancy", "dead"):
            np.testing.assert_array_equal(g, w, err_msg=f)
        elif f == "drift":
            np.testing.assert_allclose(g, w, rtol=TOL, atol=1e-6)
        else:
            _close(g, w)
    # the fold is not the unsegmented routing
    one, _ = _both(1, causal, pad)
    assert not torch.allclose(got.out, one.out)


def test_segment_fold_on_the_fused_kernels_glue():
    got, want = _both(2, True, True, impl="cuda_fused")
    _close(got.out.detach().numpy(), want.out)
    _close(got.state.mu.numpy(), want.state.mu)


@pytest.mark.parametrize("segments,N,kc", [(3, 128, 4), (4, 128, 64)],
                         ids=["N%ns", "N/ns<k"])
def test_segment_fold_falls_through(segments, N, kc):
    got, want = _both(segments, True, False, N=N, kc=kc)
    one, _ = _both(1, True, False, N=N, kc=kc)
    assert torch.equal(got.out, one.out)
    _close(got.out.numpy(), want.out)


@pytest.mark.parametrize("arch", ["rt-enwik8", "qwen2-0.5b", "rt-pg19"])
def test_routing_for_seq_and_with_routing_match_jax(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    for seq in (1024, 8192, 32768, 65536):
        for segments in (0, 1, 2, 16):
            got = configs.routing_for_seq(cfg, seq, segments).routing
            want = jax_configs.routing_for_seq(jcfg, seq, segments).routing
            assert (got.num_clusters, got.window, got.segments) == (
                want.num_clusters, want.window, want.segments)
    assert (configs.with_routing(cfg).attention
            == jax_configs.with_routing(jcfg).attention == "local+routing")


# ---------------------------------------------------------------------------
# the head grouping of local+routing layers
# ---------------------------------------------------------------------------
def test_head_groups_give_each_rank_local_and_routing_heads():
    cfg = configs.get_config("rt-enwik8")
    q_order, kv_order = shd.head_groups(cfg, 2)[(0, 0)]
    assert q_order == kv_order == [0, 1, 4, 5, 2, 3, 6, 7]
    spec = attn.head_shard(attn.spec_for_layer(cfg, cfg.attention), 2)
    assert attn.head_split(spec) == (2, 2, 2, 2)
    assert attn.head_shard(attn.spec_for_layer(
        configs.get_config("qwen2-0.5b"), "full"), 2).num_kv_heads == 1
    # a rank's shard of the reduced model: its heads' columns of wq and
    # rows of wo, its block of the routing heads' centroids
    red = configs.reduced_config("rt-enwik8")          # Hl = Hr = 2, dh 16
    params, kstate = init_model(red, seed=0, device="cpu")
    from repro_torch.train.train_step import TrainState
    ts = TrainState(params, kstate, {"count": 0}, 0, None)
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 1})
    got = shd.shard_state(ts, red, mesh)
    attn_p = params["stack"][0][0]["attn"]
    wq, wo = attn_p["wq"], attn_p["wo"]
    heads = [1, 3]                       # rank 1: local head 1, routing 3
    cols = torch.cat([torch.arange(h * 16, (h + 1) * 16) for h in heads])
    assert torch.equal(got.params["stack"][0][0]["attn"]["wq"], wq[..., cols])
    assert torch.equal(got.params["stack"][0][0]["attn"]["wo"], wo[:, cols])
    assert torch.equal(got.kstate[0]["0"], kstate[0]["0"][:, 1:2])
    assert torch.equal(got.params["embed"]["tok"],
                       params["embed"]["tok"][128:])
    assert torch.equal(got.params["stack"][0][0]["ln1"]["scale"],
                       params["stack"][0][0]["ln1"]["scale"])


def test_uneven_model_axis_raises():
    with pytest.raises(ValueError, match="do not divide"):
        shd.head_groups(configs.get_config("rt-enwik8"), 3)
    with pytest.raises(ValueError, match="num_kv_heads"):
        shd.head_groups(configs.reduced_config("qwen2-0.5b"), 2)
    red = with_overrides(configs.reduced_config("rt-enwik8"), d_ff=129)
    params, kstate = init_model(red, seed=0, device="cpu")
    from repro_torch.train.train_step import TrainState
    with pytest.raises(ValueError, match="does not divide"):
        shd.shard_state(TrainState(params, kstate, {"count": 0}, 0, None),
                        red, Mesh({"data": 1, "model": 2},
                                  {"data": 0, "model": 0}))
