"""bf16 against fp32 greedy agreement, in the JAX package and in the port.

On the card, both of the port's rt-enwik8 paths agree with the fp32 path
on 77-86% of greedy prefill tokens at full width (random weights,
``chip_smoke.py``). Whether the reference does the same is the question
here: reduced rt-enwik8, for three seeds, the JAX package's weights
rounded to bf16 once and used by both dtypes, the same tokens; each
framework runs its forward in bf16 and in fp32, and the share of positions
whose argmax agrees between its two dtypes is its agreement rate. The port
also counts its routing calls whose cluster membership differs between the
dtypes. Run with ``-s`` to see the rates.

Held: the fp32 forwards of the two frameworks pick the same token
everywhere, and the port's bf16 agreement rate is the reference's within
one point (6144 positions: a rate lower than the reference's by more
than that would be a port fault, not rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import with_overrides as jax_with_overrides
from repro.models import model as jax_model
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.interop import kstate_from_jax, params_from_jax
from repro_torch.models.model import apply_model

ARCH = "rt-enwik8"
B, N, SEEDS = 4, 512, (0, 1, 2)
MAX_RATE_GAP = 0.01


def _weights(seed):
    """JAX init weights rounded to bf16 (numpy), the same values in fp32,
    and the centroids."""
    cfg = jax_reduced_config(ARCH)
    params, kstate = jax.jit(lambda k: jax_model.init_model(cfg, k))(
        jax.random.PRNGKey(seed))
    pb = jax.tree.map(lambda x: np.asarray(
        x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x), params)
    p32 = jax.tree.map(lambda x: np.asarray(
        x, np.float32 if x.dtype.name == "bfloat16" else x.dtype), pb)
    return pb, p32, jax.tree.map(np.asarray, kstate)


def _jax_argmax(params, kstate, toks, dtype):
    cfg = jax_with_overrides(jax_reduced_config(ARCH), dtype=dtype)
    logits, _, _ = jax_model.apply_model(params, kstate, {"tokens": toks},
                                         cfg)
    return np.asarray(logits, np.float32)[..., :cfg.vocab_size].argmax(-1)


def _port_argmax(params, kstate, toks, dtype, calls):
    cfg = with_overrides(reduced_config(ARCH), dtype=dtype)
    with chip_smoke.membership_recorded(calls):
        logits, _ = apply_model(params_from_jax(params),
                                kstate_from_jax(kstate),
                                {"tokens": torch.from_numpy(toks)}, cfg)
    return logits.float()[..., :cfg.vocab_size].argmax(-1).numpy()


def test_bf16_agreement_matches_the_reference():
    agree = {"jax": [], "port": []}
    fp32_same, calls_differ, calls_all = [], 0, 0
    for seed in SEEDS:
        pb, p32, kstate = _weights(seed)
        toks = np.random.default_rng(seed).integers(0, 128, (B, N)).astype(
            np.int32)
        jb = _jax_argmax(pb, kstate, toks, "bfloat16")
        j32 = _jax_argmax(p32, kstate, toks, "float32")
        cb, c32 = [], []
        tb = _port_argmax(pb, kstate, toks, "bfloat16", cb)
        t32 = _port_argmax(p32, kstate, toks, "float32", c32)
        agree["jax"].append(jb == j32)
        agree["port"].append(tb == t32)
        fp32_same.append(j32 == t32)
        calls_all += len(cb)
        calls_differ += sum(bool((a != b).any()) for a, b in zip(cb, c32))
    rates = {k: float(np.mean(v)) for k, v in agree.items()}
    print(f"bf16 vs fp32 greedy agreement over {len(SEEDS) * B * N} "
          f"positions: JAX {rates['jax']:.4f}, port {rates['port']:.4f}; "
          f"port routing calls whose membership differs between the "
          f"dtypes: {calls_differ} of {calls_all}")
    assert float(np.mean(fp32_same)) == 1.0
    assert rates["port"] >= rates["jax"] - MAX_RATE_GAP
