"""remat "save_dots" in the port against the JAX package's, on the CPU.

The port's "save_dots" is a selective checkpoint of each layer group
(`models.transformer.save_dots_policy`): it keeps the weight products'
outputs and recomputes the rest, as the JAX package's
``jax.checkpoint(policy=checkpoint_dots_with_no_batch_dims)``. Reduced
rt-enwik8 and rt-cifar10 (local+routing) and reduced qwen2-0.5b (full
attention, its qkv biases drawn from a seed), fp32, the JAX state carried
across with `interop`:

* one step of `make_train_step` under ``TrainConfig(remat="save_dots")``
  against the JAX package's: loss within 1e-5, gradients and stepped
  parameters within 1e-5 of each leaf's largest (the tolerances of
  `test_torch_train.py`'s one-step parity). Adam's first step moves an
  element by the learning rate times g / (|g| + eps / 0.14), so where the
  gradient is fp32 cancellation noise near eps (the two packages' values
  differ by more than 1e-3 of it: qwen2's FFN elements with |g| ~ 1e-9)
  the step may differ by up to twice the rate; such elements must stay
  under 0.1% of all, as `test_torch_train.py`'s `_determined_tolerance`
  holds its trajectories;
* "save_dots" equal to "full" to the bit with dropout 0.4 and the
  routing-health stats on: loss, gradients, centroids and metrics;
* the saved set: per layer the policy saves as many tensors as the JAX
  layer's forward has ``dot_general``s with no batch dimensions (its
  ``jax.make_jaxpr``), and the forward kernels' wrappers are called as
  often as under "full" (each twice per layer: forward and recompute);
* the data-parallel step (``int8_ef`` at D = 1) and `Trainer` under
  "save_dots" equal to "full" to the bit.

The tensor-parallel "save_dots" step runs in `test_torch_engine_mesh.py`'s
two-rank spawn.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import synthetic as jax_synthetic
from repro.models import transformer as JT
from repro.train import train_step as jax_train_step
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.interop import (kstate_from_jax, params_from_jax,
                                 train_state_from_jax, tree_to_numpy)
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import local_attention as local_k
from repro_torch.kernels import routing_attention as routing_k
from repro_torch.models import transformer as T
from repro_torch.optim import make_schedule
from repro_torch.train import train_step
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves
from test_torch_full import with_qkv_biases

ARCHS = ["rt-enwik8", "rt-cifar10", "qwen2-0.5b"]
B, S = 2, 64
STEP_TOL = 1e-5
_TRAIN = dict(global_batch=B, seq_len=S, warmup_steps=100)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch():
    loader = jax_synthetic.SyntheticLoader("markov", 128, B, S, seed=3)
    return next(loader)


def _leaf_close(got, want, rel):
    for g, w in zip(tree_leaves(tree_to_numpy(got)), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, atol=rel * max(np.abs(w).max(),
                                                        1e-30))


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def jax_save_dots(request):
    """One JAX step under remat "save_dots": the gradients, the loss and
    the stepped state, from a state whose qkv biases are drawn."""
    arch = request.param
    jrun = JaxRunConfig(model=jax_reduced_config(arch),
                        train=JaxTrainConfig(remat="save_dots", **_TRAIN))
    jts = _np(jax_train_step.init_train_state(jrun, jax.random.PRNGKey(1)))
    jts = jts._replace(params=with_qkv_biases(jts.params, 5))
    batch = _batch()
    grads, _, _ = jax.jit(jax_train_step.make_grad_fn(
        jrun, jax_train_step.make_loss_fn(jrun)))(jts.params, jts.kstate,
                                                  batch, None)
    new, m = jax.jit(jax_train_step.make_train_step(jrun))(jts, batch)
    return dict(arch=arch, ts=jts, batch=batch, grads=_np(grads),
                loss=float(m["loss"]), params=_np(new.params))


def test_save_dots_step_matches_jax(jax_save_dots):
    ref = jax_save_dots
    run = RunConfig(model=reduced_config(ref["arch"]),
                    train=TrainConfig(remat="save_dots", **_TRAIN))
    batch = {"tokens": torch.from_numpy(ref["batch"]["tokens"])}
    ts = train_state_from_jax(ref["ts"])
    grads, _, _ = train_step.make_grad_fn(run, train_step.make_loss_fn(run))(
        ts.params, ts.kstate, batch, None)
    new, m = train_step.make_train_step(run)(ts, batch)
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=STEP_TOL)
    _leaf_close(grads, ref["grads"], STEP_TOL)
    lr = make_schedule(run.train, run.model.d_model)(1)
    noisy = [np.abs(g - j) > 1e-3 * np.abs(j)
             for g, j in zip(tree_leaves(tree_to_numpy(grads)),
                             jax.tree.leaves(ref["grads"]))]
    assert sum(n.sum() for n in noisy) <= 1e-3 * sum(n.size for n in noisy)
    for g, w, n in zip(tree_leaves(tree_to_numpy(new.params)),
                       jax.tree.leaves(ref["params"]), noisy):
        w = np.asarray(w, np.float32)
        tol = np.where(n, 2 * lr, STEP_TOL * max(np.abs(w).max(), 1e-30))
        assert (np.abs(g - w) <= tol).all()


# ---------------------------------------------------------------------------
# against the port's "full"
# ---------------------------------------------------------------------------
def _cfg(arch, dropout=0.4, stats=True):
    cfg = with_overrides(reduced_config(arch), dropout=dropout)
    return with_overrides(cfg, routing=with_overrides(cfg.routing,
                                                      stats=stats))


def _state(arch):
    """JAX-initialized parameters and centroids of reduced ``arch``."""
    from repro.models.model import init_model
    params, kstate = init_model(jax_reduced_config(arch),
                                jax.random.PRNGKey(0))
    return (params_from_jax(with_qkv_biases(_np(params), 4)),
            kstate_from_jax(_np(kstate)))


def _value_and_grad(cfg, remat, params, kstate, impl=None):
    run = RunConfig(model=cfg, train=TrainConfig(remat=remat, **_TRAIN))
    vg = train_step.value_and_grad(train_step.make_loss_fn(run, impl), cfg)
    batch = {"tokens": torch.from_numpy(_batch()["tokens"])}
    (loss, (new_k, metrics)), grads = vg(params, kstate, batch, 7)
    return dict(loss=loss, grads=grads, new_k=new_k, metrics=metrics)


@pytest.mark.parametrize("arch", ARCHS)
def test_save_dots_equals_full_to_the_bit(arch):
    """Dropout 0.4 and the routing-health stats on (the plain path: the
    kernel glue's backward on the CPU is not bit-repeatable)."""
    cfg = _cfg(arch)
    params, kstate = _state(arch)
    full = _value_and_grad(cfg, "full", params, kstate)
    dots = _value_and_grad(cfg, "save_dots", params, kstate)
    assert torch.equal(full["loss"], dots["loss"])
    _equal(full["grads"], dots["grads"])
    _equal(full["new_k"], dots["new_k"])
    assert full["metrics"].keys() == dots["metrics"].keys()
    if arch != "qwen2-0.5b":
        assert any(k.startswith("rt/") for k in dots["metrics"])
    for k in full["metrics"]:
        assert torch.equal(full["metrics"][k], dots["metrics"][k]), k
    # dropout is on: the loss differs from a dropout-free one
    cfg0 = _cfg(arch, dropout=0.0)
    assert not torch.equal(
        _value_and_grad(cfg0, "save_dots", params, kstate)["loss"],
        dots["loss"])


def _jax_products_per_layer(arch) -> int:
    """``dot_general``s with no batch dimensions in ``jax.make_jaxpr`` of
    the JAX package's layer forward (kernel calls not entered: a Pallas
    call is one primitive to the checkpoint policy)."""
    from jax.extend.core import ClosedJaxpr, Jaxpr
    from repro.models.model import init_model
    cfg = jax_reduced_config(arch)
    params, kstate = init_model(cfg, jax.random.PRNGKey(0))
    (pattern, _), = JT.build_segments(cfg)[:1]
    p = jax.tree.map(lambda a: a[0], params["stack"][0])[0]
    kmu = jax.tree.map(lambda a: a[0], kstate[0]).get("0")
    x = jax.numpy.zeros((B, S, cfg.d_model), jax.numpy.float32)

    def count(jaxpr) -> int:
        n = 0
        for e in jaxpr.eqns:
            if e.primitive.name == "dot_general":
                n += not e.params["dimension_numbers"][1][0]
            if e.primitive.name == "pallas_call":
                continue
            for v in e.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, ClosedJaxpr):
                        n += count(sub.jaxpr)
                    elif isinstance(sub, Jaxpr):
                        n += count(sub)
        return n
    jp = jax.make_jaxpr(lambda p, kmu, x: JT.apply_layer(
        pattern[0], p, kmu, x, cfg, update_state=True))(p, kmu, x)
    return count(jp.jaxpr)


@pytest.mark.parametrize("arch", ARCHS)
def test_save_dots_saves_the_products_jax_saves(arch, monkeypatch):
    """Per layer, the tensors the policy saves (its MUST_SAVE decisions in
    the forward) equal the JAX layer's batch-free products; the forward
    kernels' wrappers (impl="cuda": the kernel backend's glue, which on
    CPU tensors takes the plain versions) run as often as under "full"."""
    cfg = _cfg(arch, dropout=0.0, stats=False)
    params, kstate = _state(arch)
    saved, calls = [], {}
    policy = T.save_dots_policy

    def counting_policy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved.append(op)
        return out
    monkeypatch.setattr(T, "save_dots_policy", counting_policy)
    for mod, name in ((local_k, "local_attention"),
                      (routing_k, "routed_attention_fused"),
                      (flash_k, "flash_attention")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    got = {}
    for remat in ("full", "save_dots"):
        saved.clear()
        calls.clear()
        out = _value_and_grad(cfg, remat, params, kstate, impl="cuda")
        got[remat] = dict(saved=len(saved), calls=dict(calls),
                          grads=out["grads"])
    assert got["full"]["saved"] == 0
    assert got["save_dots"]["saved"] == (cfg.num_layers
                                         * _jax_products_per_layer(arch))
    assert got["save_dots"]["calls"] == got["full"]["calls"]
    layers = {"flash_attention": cfg.num_layers} if arch == "qwen2-0.5b" \
        else {"local_attention": cfg.num_layers,
              "routed_attention_fused": cfg.num_layers}
    assert got["full"]["calls"] == {k: 2 * v for k, v in layers.items()}


# ---------------------------------------------------------------------------
# every step maker
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["compressed", "trainer"])
def test_save_dots_runs_through_every_step_maker(entry):
    """The data-parallel step (int8 error feedback, at D = 1 the exchange
    is the identity) and `Trainer.fit` under "save_dots" equal "full" to
    the bit, with dropout 0.4 (reduced rt-enwik8)."""
    cfg = _cfg("rt-enwik8", stats=False)
    out = {}
    for remat in ("full", "save_dots"):
        tc = TrainConfig(remat=remat, global_batch=B, seq_len=S,
                         grad_compression=("int8_ef" if entry == "compressed"
                                           else "none"))
        run = RunConfig(model=cfg, train=tc)
        if entry == "compressed":
            ts = train_step.init_train_state(run, seed=0, device="cpu")
            step = train_step.make_compressed_train_step(run)
            for i in range(2):
                ts, m = step(ts, {"tokens": torch.from_numpy(
                    _batch()["tokens"])})
        else:
            tr = Trainer(run, SyntheticLoader("markov", 128, B, S),
                         device="cpu")
            tr.fit(2)
            ts = tr.state
        out[remat] = ts
    _equal(out["full"].params, out["save_dots"].params)
    _equal(out["full"].kstate, out["save_dots"].kstate)
    if entry == "compressed":
        _equal(out["full"].ef_state, out["save_dots"].ef_state)
