"""Slice parity: the port serves reduced rt-enwik8 as the JAX package does.

The JAX side runs `prefill` and 16 greedy `serve_step`s the way it runs on
a TPU (REPRO_ATTN_PLATFORM=tpu + REPRO_FORCE_INTERPRET=1: the
local+routing/pallas_paged backend with its Pallas kernels in interpret
mode). The port runs the same weights (carried across with
`repro_torch.interop`) and prompt on the CPU, once on its auto-resolved
plain backend (impl=None -> local+routing/torch) and once forced onto the
kernel backend (impl="cuda", whose wrappers take their plain versions for
CPU tensors). The prompt length (64 = 2 local windows, routing window 16)
is one on which the JAX package's own shape rule picks each kernel.

Tolerances (fp32 throughout): logits and float cache leaves 2e-5 absolute
(two layers of fp32 matmuls summed in another order by each framework);
integer cache leaves (rlen, lpos) and greedy tokens exactly equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models.model import init_model as jax_init_model
from repro.serve import serving as jax_serving
from repro_torch.configs import reduced_config
from repro_torch.interop import kstate_from_jax, params_from_jax, tree_to_numpy
from repro_torch.kernels.routing_decode import page_width
from repro_torch.serve import serving

B, N, STEPS = 2, 64, 16
ARCH = "rt-enwik8"
TOL = 2e-5
INT_LEAVES = ("rlen", "lpos")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    cfg = jax_reduced_config(ARCH)
    params, kstate = jax_init_model(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, N)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_ATTN_PLATFORM", "tpu")
        mp.setenv("REPRO_FORCE_INTERPRET", "1")
        prefill = jax.jit(lambda p, k, c, b: jax_serving.prefill(p, k, c, b,
                                                                 cfg))
        step = jax.jit(jax_serving.make_serve_step(cfg))
        cache = jax_serving.init_cache(cfg, B, N + STEPS)
        logits, cache = prefill(params, kstate, cache, {"tokens": prompt})
        out = {"prefill_logits": np.asarray(logits),
               "prefill_cache": _np(cache)}
        tok = np.asarray(logits[:, -1].argmax(-1))
        toks, step_logits = [], []
        for t in range(STEPS):
            lg, cache = step(params, kstate, cache, tok,
                             np.full((B,), N + t, np.int32))
            step_logits.append(np.asarray(lg))
            tok = np.asarray(lg.argmax(-1))
            toks.append(tok)
    out.update(params=_np(params), kstate=_np(kstate), prompt=prompt,
               tokens=np.stack(toks, 1), step_logits=np.stack(step_logits, 1),
               final_cache=_np(cache))
    return out


def _port_run(jr, impl):
    cfg = reduced_config(ARCH)
    params = params_from_jax(jr["params"])
    kstate = kstate_from_jax(jr["kstate"])
    cache = serving.init_cache(cfg, B, N + STEPS, device="cpu")
    logits, cache = serving.prefill(
        params, kstate, cache, {"tokens": torch.from_numpy(jr["prompt"])},
        cfg, impl=impl)
    out = {"prefill_logits": logits.numpy(),
           "prefill_cache": tree_to_numpy(cache)}
    step = serving.make_serve_step(cfg, impl=impl)
    tok = logits[:, -1].argmax(-1)
    toks, step_logits = [], []
    for t in range(STEPS):
        lg, cache = step(params, kstate, cache, tok,
                         torch.full((B,), N + t))
        step_logits.append(lg.numpy())
        tok = lg.argmax(-1)
        toks.append(tok.numpy())
    out.update(tokens=np.stack(toks, 1), step_logits=np.stack(step_logits, 1),
               final_cache=tree_to_numpy(cache))
    return out


@pytest.fixture(scope="module", params=[None, "cuda"],
                ids=["auto-torch", "forced-cuda"])
def port_run(request, jax_run):
    return _port_run(jax_run, request.param)


def _assert_cache_match(jc, pc):
    assert len(jc) == len(pc)
    for js, ps in zip(jc, pc):
        for layer in js:
            for leaf, jv in js[layer].items():
                pv = ps[layer][leaf]
                if leaf in ("rk", "rv"):
                    # the port stores its pages at the decode kernel's
                    # width: the JAX package's columns, then zeros
                    dh = jv.shape[-1]
                    assert pv.shape[-1] == page_width(dh), leaf
                    assert not pv[..., dh:].any(), leaf
                    pv = pv[..., :dh]
                assert pv.shape == jv.shape, (leaf, pv.shape, jv.shape)
                if leaf in INT_LEAVES:
                    np.testing.assert_array_equal(pv, jv, err_msg=leaf)
                else:
                    np.testing.assert_allclose(pv, jv, atol=TOL, rtol=0,
                                               err_msg=leaf)


def test_prefill_logits_match(jax_run, port_run):
    np.testing.assert_allclose(port_run["prefill_logits"],
                               jax_run["prefill_logits"], atol=TOL, rtol=0)


def test_prefill_cache_matches(jax_run, port_run):
    _assert_cache_match(jax_run["prefill_cache"], port_run["prefill_cache"])


def test_greedy_tokens_identical(jax_run, port_run):
    np.testing.assert_array_equal(port_run["tokens"], jax_run["tokens"])


def test_decode_logits_match(jax_run, port_run):
    np.testing.assert_allclose(port_run["step_logits"],
                               jax_run["step_logits"], atol=TOL, rtol=0)


def test_decode_cache_matches(jax_run, port_run):
    _assert_cache_match(jax_run["final_cache"], port_run["final_cache"])


def test_inactive_lanes_untouched(jax_run):
    """serve_step(active=...) leaves an inactive lane's cache exactly as
    it was and still advances the active one."""
    cfg = reduced_config(ARCH)
    params = params_from_jax(jax_run["params"])
    kstate = kstate_from_jax(jax_run["kstate"])
    cache = serving.init_cache(cfg, B, N + STEPS, device="cpu")
    _, cache = serving.prefill(params, kstate, cache,
                               {"tokens": torch.from_numpy(jax_run["prompt"])},
                               cfg)
    step = serving.make_serve_step(cfg)
    active = torch.tensor([True, False])
    _, new = step(params, kstate, cache, torch.zeros(B, dtype=torch.long),
                  torch.full((B,), N), active=active)
    for seg_old, seg_new in zip(cache, new):
        for leaf, old in seg_old["0"].items():
            assert torch.equal(seg_new["0"][leaf][:, 1], old[:, 1]), leaf
    assert not torch.equal(new[0]["0"]["lpos"][:, 0],
                           cache[0]["0"]["lpos"][:, 0])
