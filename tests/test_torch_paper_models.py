"""Slice parity: the paper's other three models (rt-pg19, rt-imagenet64,
rt-wikitext103) train in the port as in the JAX package.

The same inputs (numpy, from seeds; JAX parameters and train states carried
across with `repro_torch.interop`) go through the JAX package and the port
on the CPU:

* Adafactor (rt-pg19's optimizer) against ``repro.optim.adafactor`` over 5
  steps on a tree with a 1-D leaf, a 2-D leaf, a stacked (G, d_in, d_out)
  leaf, a stacked (G, d) bias and a bf16 leaf: parameters and statistics
  within 1e-6 of their largest value;
* the head-dim padding of the local-window and fused routing wrappers
  (`common.pad_heads`: dh 17 runs at 64, dh 129 at 192, the kernels'
  widths), their plain versions called through it against the same plain
  versions unpadded: out, lse, dq, dk and dv within 1e-6 relative in fp32,
  the scale that of the true head dim;
* one fp32 step's loss, gradients and centroids of reduced forms of the
  three models against ``jax.value_and_grad`` of `make_loss_fn` (the JAX
  side on its Pallas kernels in interpret mode), the port on its plain
  backend and forced onto its kernel backend (impl="cuda", whose wrappers
  take their padded plain versions for CPU tensors): rt-pg19 with an odd
  head dim and its routing suffix kept (2 routing heads in the last
  layer; without rope, which the JAX package applies to even head dims
  only, while the port rotates the leading dh - 1 columns and passes the
  last through, held to JAX's rope on those columns), rt-imagenet64
  with local and routing windows wider than N / k (overlapping
  clusters), rt-wikitext103 with a vocab that is not 256-aligned; `reduced_config` drops the routing suffix and the head
  dims, so the tests set them through `with_overrides` on both packages'
  configs;
* a 5-step rt-pg19 Adafactor trajectory against JAX `make_train_step`, and
  a port run continuing a JAX Adafactor run mid-trajectory (serving the
  three models: tests/test_torch_serving_models.py).

Tolerances (fp32): loss and gradients 1e-5 relative to each leaf's largest
entry for one step (two frameworks summing the same fp32 products in other
orders), 1e-5 absolute over the trajectories, as tests/test_torch_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.base import with_overrides as jax_with_overrides
from repro.data import synthetic as jax_synthetic
from repro.models.model import init_model as jax_init_model
from repro.optim.adafactor import adafactor as jax_adafactor
from repro.train import train_step as jax_train_step
from repro_torch import attn
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.core import local as local_ref
from repro_torch.core import routing as routing_ref
from repro_torch.core import row_dot
from repro_torch.interop import (kstate_from_jax, opt_state_from_jax,
                                 params_from_jax, train_state_from_jax,
                                 tree_to_numpy)
from repro_torch.kernels import common
from repro_torch.kernels import local_attention as local_k
from repro_torch.kernels import routing_attention as routing_k
from repro_torch.optim import make_optimizer
from repro_torch.optim.adafactor import adafactor
from repro_torch.train import train_step
from repro_torch.tree import tree_leaves

B, S = 2, 64
STEP_TOL = 1e-5
TRAJ_TOL = 1e-5
PAD_TOL = 1e-6
# the three reduced models, each with what its full config exercises kept:
# (arch, overrides of both packages' configs, overrides of their routing)
MODELS = {
    # head dim 17 (odd; the kernels run it at 64) and the routing suffix:
    # 2 routing heads in the last layer only, the others local. No rope:
    # the JAX package's `apply_rope` takes even head dims only
    # (`test_rope_at_an_odd_head_dim` holds the port's extension)
    "rt-pg19": (dict(head_dim=17, position="none"),
                dict(routing_heads=2, routing_layers=(1,))),
    # local and routing windows of 32 over N / k = 16: clusters overlap
    "rt-imagenet64": (dict(), dict(window=32, local_window=32)),
    # vocab 300, padded to 512 rows
    "rt-wikitext103": (dict(vocab_size=300), dict()),
}
ADAFACTOR = dict(optimizer="adafactor", lr=1e-2, schedule="const",
                 warmup_steps=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _runs(arch, **train):
    over, rover = MODELS[arch]
    kw = dict(global_batch=B, seq_len=S, **train)
    jcfg = jax_reduced_config(arch)
    jcfg = jax_with_overrides(jcfg, **over, routing=jax_with_overrides(
        jcfg.routing, **rover))
    cfg = reduced_config(arch)
    cfg = with_overrides(cfg, **over, routing=with_overrides(cfg.routing,
                                                             **rover))
    return (JaxRunConfig(model=jcfg, train=JaxTrainConfig(**kw)),
            RunConfig(model=cfg, train=TrainConfig(**kw)))


def _batches(n, start=0):
    loader = jax_synthetic.SyntheticLoader("markov", 128, B, S, seed=3,
                                           start_step=start)
    return [next(loader) for _ in range(n)]


def _leaf_close(got, want, rel):
    for g, w in zip(tree_leaves(tree_to_numpy(got)), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, atol=rel * max(np.abs(w).max(),
                                                        1e-30))


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------
def _adafactor_tree(rng):
    """Keys in sorted order, so that the port's leaf order (insertion)
    is JAX's (sorted)."""
    return {"bf16": rng.standard_normal((4, 6)),
            "bias": rng.standard_normal((7,)),
            "stack": {"b": rng.standard_normal((3, 8)),
                      "w": rng.standard_normal((3, 4, 5))},
            "w": rng.standard_normal((5, 6))}


def _as_jax(tree):
    out = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    out["bf16"] = out["bf16"].astype(jnp.bfloat16)
    return out


def _as_port(tree):
    out = {k: (_as_port(v) if isinstance(v, dict)
               else torch.from_numpy(v.astype(np.float32)))
           for k, v in tree.items()}
    if "bf16" in out:
        out["bf16"] = out["bf16"].to(torch.bfloat16)
    return out


def test_make_optimizer_returns_the_ported_adafactor():
    init, update = make_optimizer(TrainConfig(optimizer="adafactor"))
    state = init({"w": torch.zeros(3, 4), "b": torch.zeros(4)})
    assert set(state) == {"stats", "count"} and state["count"] == 0
    assert set(state["stats"]["w"]) == {"vr", "vc"}
    assert set(state["stats"]["b"]) == {"v"}


def test_adafactor_matches_jax():
    """Five steps on every leaf kind: factored second moments over the
    last two axes (so a stacked (G, d) bias is factored over G x d, as in
    JAX), full ones for the 1-D leaf, fp32 arithmetic cast back to bf16."""
    rng = np.random.default_rng(31)
    params = _adafactor_tree(rng)
    j_init, j_upd = jax_adafactor()
    p_init, p_upd = adafactor()
    jp, pp = _as_jax(params), _as_port(params)
    js, ps = j_init(jp), p_init(pp)
    for _ in range(5):
        g = _adafactor_tree(rng)
        jp, js = j_upd(_as_jax(g), js, jp, 1e-2)
        pp, ps = p_upd(_as_port(g), ps, pp, 1e-2)
    assert ps["count"] == int(js["count"]) == 5
    assert pp["bf16"].dtype == torch.bfloat16
    assert set(ps["stats"]["stack"]["b"]) == {"vr", "vc"}
    assert tuple(ps["stats"]["stack"]["b"]["vr"].shape) == (3,)
    _leaf_close(pp, _np(jp), PAD_TOL)
    _leaf_close(ps["stats"], _np(js["stats"]), PAD_TOL)


# ---------------------------------------------------------------------------
# rope at rt-pg19's odd head dim
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh", [16, 17, 129])
def test_rope_at_an_odd_head_dim(dh):
    """At an even head dim the port's rope is JAX's; at an odd one (which
    JAX's does not take) its leading dh - 1 columns are JAX's rope of a
    head of dh - 1 and the last column passes through."""
    from repro.models.layers import apply_rope as jax_rope
    from repro_torch.models.layers import apply_rope
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 3, 40, dh)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 40)).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy()
    even = dh - dh % 2
    want = np.asarray(jax_rope(jnp.asarray(x[..., :even]), jnp.asarray(pos),
                               1e4))
    np.testing.assert_allclose(got[..., :even], want, atol=1e-5)
    np.testing.assert_array_equal(got[..., even:], x[..., even:])


# ---------------------------------------------------------------------------
# the head-dim padding of the kernel wrappers
# ---------------------------------------------------------------------------
def test_padded_head_dims():
    assert [common.padded_head_dim("t", d) for d in (1, 17, 64, 65, 128,
                                                     129, 192)] == \
        [64, 64, 64, 128, 128, 192, 192]
    with pytest.raises(ValueError, match="wider"):
        common.padded_head_dim("t", 193)
    assert common.head_scale(64) == 0.125
    x = torch.ones(2, 3, 129)
    (p,) = common.pad_heads("t", 129, x)
    assert p.shape == (2, 3, 192) and float(p[..., 129:].abs().max()) == 0
    assert common.pad_heads("t", 128, x[..., :128])[0] is not None


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=PAD_TOL * float(w.abs().max()))


@pytest.mark.parametrize("dh", [17, 129])
def test_local_padded_matches_unpadded(dh):
    rng = np.random.default_rng(dh)
    Bq, H, Hkv, N, w = 2, 4, 2, 80, 24
    q, do = (torch.from_numpy(rng.standard_normal((Bq, H, N, dh)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((Bq, Hkv, N, dh)).astype(
        np.float32)) for _ in range(2))
    pad = torch.from_numpy(rng.random((Bq, N)) > 0.2)
    out, lse = local_k.local_attention(q, k, v, w, True, pad)
    ref_out, ref_lse = local_ref.local_attention(q, k, v, w, True, pad,
                                                 return_lse=True)
    dsum = row_dot(do, out)
    got = (local_k.local_attention_bwd_dq(q, k, v, do, lse, dsum, w, True,
                                          pad),
           *local_k.local_attention_bwd_dkv(q, k, v, do, lse, dsum, w, True,
                                            pad))
    want = (local_ref.local_attention_bwd_dq(q, k, v, do, lse, dsum, w, True,
                                             pad),
            *local_ref.local_attention_bwd_dkv(q, k, v, do, lse, dsum, w,
                                               True, pad))
    _close((out, lse, *got), (ref_out, ref_lse, *want))


@pytest.mark.parametrize("dh", [17, 129])
@pytest.mark.parametrize("shared", [True, False])
def test_fused_padded_matches_unpadded(dh, shared):
    rng = np.random.default_rng(dh + shared)
    Bq, H, N, kc, w = 2, 2, 96, 4, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((Bq, H, N, dh)).astype(
        np.float32)) for _ in range(3))
    k = None if shared else k
    idx = np.sort(np.stack([rng.choice(N, w, replace=False)
                            for _ in range(Bq * H * kc)]), -1)
    q_idx = torch.from_numpy(idx.reshape(Bq, H, kc, w).astype(np.int32))
    k_idx = q_idx if shared else torch.from_numpy(np.sort(np.stack(
        [rng.choice(N, w, replace=False) for _ in range(Bq * H * kc)]),
        -1).reshape(Bq, H, kc, w).astype(np.int32))
    pos = torch.arange(N, dtype=torch.int32).expand(Bq, N).contiguous()
    kvalid = None if shared else torch.from_numpy(rng.random((Bq, N)) > 0.2)
    out, lse = routing_k.routed_attention_fused(q, k, v, q_idx, k_idx, pos,
                                                True, kvalid)
    li, lk, lp = q_idx.long(), k_idx.long(), pos.long()
    ref_out, ref_lse = routing_ref.gathered_block_attention(
        q, k, v, li, lk, lp, True, kvalid, return_lse=True)
    do = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    dsum = row_dot(do, out)
    args = (q, k, v, q_idx, k_idx, pos, do, lse, dsum, True, kvalid)
    got = (routing_k.routed_attention_fused_bwd_dq(*args),
           *routing_k.routed_attention_fused_bwd_dkv(*args))
    rargs = (q, k, v, li, lk, lp, do, lse, dsum, True, kvalid)
    want = (routing_ref.routed_attention_bwd_dq(*rargs),
            *routing_ref.routed_attention_bwd_dkv(*rargs))
    _close((out, lse, *got), (ref_out, ref_lse, *want))


# ---------------------------------------------------------------------------
# the three models: one step's loss, gradients and centroids
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_step(request):
    """Loss, grads and new kstate of one fp32 step of each reduced model,
    JAX on its Pallas kernels in interpret mode."""
    jrun, _ = _runs(request.param)
    params, kstate = jax.jit(lambda k: jax_init_model(jrun.model, k))(
        jax.random.PRNGKey(0))
    batch = _batches(1)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_ATTN_PLATFORM", "tpu")
        mp.setenv("REPRO_FORCE_INTERPRET", "1")
        vg = jax.jit(jax.value_and_grad(jax_train_step.make_loss_fn(jrun),
                                        has_aux=True))
        (loss, (new_k, _)), grads = vg(params, kstate, batch, None)
    return dict(arch=request.param, params=_np(params), kstate=_np(kstate),
                batch=batch, loss=float(loss), grads=_np(grads),
                new_k=_np(new_k))


def test_reduced_models_keep_what_they_exercise():
    _, pg = _runs("rt-pg19")
    _, im = _runs("rt-imagenet64")
    _, wt = _runs("rt-wikitext103")
    assert pg.model.head_dim_ % 2 == 1
    assert [attn.variant_for_layer(pg.model, i) for i in range(2)] == \
        ["local", "local+routing"]
    assert attn.head_split(attn.spec_for_layer(pg.model, "local+routing")
                           )[1] == 2
    rc = im.model.routing
    assert min(rc.window, rc.local_window) > S // rc.num_clusters
    assert wt.model.vocab_size % 256 and wt.model.padded_vocab == 512


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_one_step_matches_jax(jax_step, impl):
    _, run = _runs(jax_step["arch"])
    vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl=impl))
    batch = {"tokens": torch.from_numpy(jax_step["batch"]["tokens"])}
    (loss, (new_k, metrics)), grads = vg(
        params_from_jax(jax_step["params"]),
        kstate_from_jax(jax_step["kstate"]), batch, None)
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=STEP_TOL)
    assert float(metrics["tokens"]) == B * S
    _leaf_close(grads, jax_step["grads"], STEP_TOL)
    _leaf_close(new_k, jax_step["new_k"], STEP_TOL)


# ---------------------------------------------------------------------------
# rt-pg19 on Adafactor: trajectories
# ---------------------------------------------------------------------------
def _jax_trajectory(jrun, ts, batches):
    step = jax.jit(jax_train_step.make_train_step(jrun))
    losses = []
    for b in batches:
        ts, m = step(ts, b)
        losses.append(float(m["loss"]))
    return ts, losses


def _port_trajectory(run, ts, batches, impl=None):
    step = train_step.make_train_step(run, impl=impl)
    losses = []
    for b in batches:
        ts, m = step(ts, {"tokens": torch.from_numpy(b["tokens"])})
        losses.append(float(m["loss"]))
    return ts, losses


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_pg19_adafactor_trajectory_matches_jax(impl):
    """5 fp32 steps of reduced rt-pg19 on Adafactor (lr 1e-2, a 2-step
    warm-up), clipping and remat "full" from the same JAX initial state:
    losses, parameters, centroids and the Adafactor statistics agree to
    TRAJ_TOL."""
    jrun, run = _runs("rt-pg19", **ADAFACTOR)
    jts = _np(jax_train_step.init_train_state(jrun, jax.random.PRNGKey(1)))
    pts = train_state_from_jax(jts)
    assert set(pts.opt_state) == {"stats", "count"}
    batches = _batches(5)
    jts, jl = _jax_trajectory(jrun, jts, batches)
    pts, pl = _port_trajectory(run, pts, batches, impl)
    np.testing.assert_allclose(pl, jl, atol=TRAJ_TOL)
    assert pl[-1] < pl[0]
    assert pts.step == int(jts.step) == 5
    assert pts.opt_state["count"] == 5
    for g, w in zip(tree_leaves(tree_to_numpy(pts.params)),
                    jax.tree.leaves(_np(jts.params))):
        np.testing.assert_allclose(g, w, atol=TRAJ_TOL)
    _leaf_close(pts.kstate, _np(jts.kstate), TRAJ_TOL)
    _leaf_close(pts.opt_state["stats"], _np(jts.opt_state["stats"]),
                TRAJ_TOL)


def test_port_continues_a_jax_adafactor_run_mid_trajectory():
    """JAX trains 3 steps of reduced rt-pg19 on Adafactor; the port takes
    its state (params, centroids, the factored statistics and count,
    step) and trains 3 more; JAX's own 6-step run agrees."""
    jrun, run = _runs("rt-pg19", **ADAFACTOR)
    batches = _batches(6)
    jts = jax_train_step.init_train_state(jrun, jax.random.PRNGKey(2))
    jts3, _ = _jax_trajectory(jrun, jts, batches[:3])
    jts6, jl6 = _jax_trajectory(jrun, jts3, batches[3:])
    state = opt_state_from_jax(_np(jts3.opt_state))
    assert state["count"] == 3
    pts, pl = _port_trajectory(run, train_state_from_jax(_np(jts3)),
                               batches[3:])
    np.testing.assert_allclose(pl, jl6, atol=TRAJ_TOL)
    assert pts.step == 6 and pts.opt_state["count"] == 6
    for g, w in zip(tree_leaves(tree_to_numpy(pts.params)),
                    jax.tree.leaves(_np(jts6.params))):
        np.testing.assert_allclose(g, w, atol=TRAJ_TOL)
