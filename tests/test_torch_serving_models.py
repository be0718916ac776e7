"""Slice parity: the port serves every model it trains as the JAX package
does: qwen2-0.5b (full attention through the append cache), rt-pg19 (head
dim 129, its cluster pages stored at the decode kernel's width),
rt-imagenet64 and rt-wikitext103.

Each model, reduced as tests/test_torch_paper_models.py reduces it (and
qwen2 at its own GQA 14:2, with its qkv bias and tied embeddings), serves
a 64-token prompt and 16 greedy tokens in the JAX package the way it runs
on a TPU (REPRO_ATTN_PLATFORM=tpu + REPRO_FORCE_INTERPRET=1: the routing
models' local+routing/pallas_paged backend with its Pallas kernels, the
paged decode included, in interpret mode; qwen2's full/xla, the JAX
package's only full backend with positions and decode, as it has no
Pallas decode). The port runs the same weights (`repro_torch.interop`)
and prompt on the CPU, once on its auto-resolved plain backend and once
forced onto its kernel backend (impl="cuda", whose wrappers take their
plain versions for CPU tensors); a full model's forced kernel backend is
refused, as its flash kernel masks by row index and has no decode.

Also: the plain decode over pages padded to the kernel's width equals,
bit for bit, the same over unpadded pages; the decode kernel's split
covers the occupied slots at its dh-192 chunk sizes; a full model's
decode equals its teacher-forced forward; an inactive lane of an append
cache is left as it was; and the resolution of decode on the card.

Tolerances (fp32 throughout): logits and float cache leaves 2e-5 absolute
(two frameworks summing the same fp32 products in other orders), integer
cache leaves and greedy tokens exactly equal.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import with_overrides as jax_with_overrides
from repro.models.model import init_model as jax_init_model
from repro.serve import serving as jax_serving
from repro_torch import attn
from repro_torch.attn import backends
from repro_torch.configs import reduced_config, with_overrides
from repro_torch.interop import kstate_from_jax, params_from_jax, tree_to_numpy
from repro_torch.kernels import common
from repro_torch.kernels import routing_decode as decode_k
from repro_torch.models.model import init_model
from repro_torch.serve import serving
from test_torch_decode_split import _ranges
from test_torch_full import with_qkv_biases

B, N, STEPS = 2, 64, 16
TOL = 2e-5
INT_LEAVES = ("rlen", "lpos")
PAGE_LEAVES = ("rk", "rv")
# (overrides of both packages' configs, overrides of their routing): the
# reductions of tests/test_torch_paper_models.py, and qwen2's heads
MODELS = {
    "qwen2-0.5b": (dict(num_heads=14, num_kv_heads=2), dict()),
    "rt-pg19": (dict(head_dim=17, position="none"),
                dict(routing_heads=2, routing_layers=(1,))),
    "rt-imagenet64": (dict(), dict(window=32, local_window=32)),
    "rt-wikitext103": (dict(vocab_size=300), dict()),
}
# each model on the port's auto-resolved backend and forced onto its kernel
# backend, which a full model refuses
# (`test_full_forced_kernel_backend_is_refused`)
CASES = [(arch, impl) for arch in MODELS for impl in (None, "cuda")
         if not (arch == "qwen2-0.5b" and impl == "cuda")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch):
    over, rover = MODELS[arch]
    jcfg = jax_reduced_config(arch)
    jcfg = jax_with_overrides(jcfg, **over, routing=jax_with_overrides(
        jcfg.routing, **rover))
    cfg = reduced_config(arch)
    cfg = with_overrides(cfg, **over, routing=with_overrides(cfg.routing,
                                                             **rover))
    return jcfg, cfg


def _jax_run(arch):
    jcfg, cfg = _configs(arch)
    params, kstate = jax_init_model(jcfg, jax.random.PRNGKey(0))
    params = _np(params)
    if jcfg.qkv_bias:
        # the JAX init zeros the qkv biases: drawn instead, so they count
        params = with_qkv_biases(params, 5)
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, N)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_ATTN_PLATFORM", "tpu")
        mp.setenv("REPRO_FORCE_INTERPRET", "1")
        prefill = jax.jit(lambda p, k, c, b: jax_serving.prefill(p, k, c, b,
                                                                 jcfg))
        step = jax.jit(jax_serving.make_serve_step(jcfg))
        cache = jax_serving.init_cache(jcfg, B, N + STEPS)
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
    out.update(arch=arch, cfg=cfg, params=params, kstate=_np(kstate),
               prompt=prompt, tokens=np.stack(toks, 1),
               step_logits=np.stack(step_logits, 1), final_cache=_np(cache))
    return out


def _port_run(jr, impl):
    cfg = jr["cfg"]
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


_JAX_RUNS = {}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{i or 'auto'}" for a, i in CASES])
def runs(request):
    """(JAX run, port run) of one (model, impl) case; each model's JAX run
    made once."""
    arch, impl = request.param
    if arch not in _JAX_RUNS:
        _JAX_RUNS[arch] = _jax_run(arch)
    return _JAX_RUNS[arch], _port_run(_JAX_RUNS[arch], impl)


def _assert_cache_match(jc, pc):
    """Leaf by leaf; the port's pages against JAX's on the first dh
    columns, their pad columns exactly zero."""
    assert len(jc) == len(pc)
    for js, ps in zip(jc, pc):
        assert set(js) == set(ps)
        for layer in js:
            assert set(js[layer]) == set(ps[layer])
            for leaf, jv in js[layer].items():
                pv = ps[layer][leaf]
                if leaf in PAGE_LEAVES:
                    dh = jv.shape[-1]
                    assert pv.shape[-1] == decode_k.page_width(dh)
                    assert not pv[..., dh:].any(), leaf
                    pv = pv[..., :dh]
                assert pv.shape == jv.shape, (leaf, pv.shape, jv.shape)
                if leaf in INT_LEAVES:
                    np.testing.assert_array_equal(pv, jv, err_msg=leaf)
                else:
                    np.testing.assert_allclose(pv, jv, atol=TOL, rtol=0,
                                               err_msg=leaf)


def test_prefill_logits_match(runs):
    jax_run, port_run = runs
    np.testing.assert_allclose(port_run["prefill_logits"],
                               jax_run["prefill_logits"], atol=TOL, rtol=0)


def test_prefill_cache_matches(runs):
    jax_run, port_run = runs
    _assert_cache_match(jax_run["prefill_cache"], port_run["prefill_cache"])


def test_greedy_tokens_identical(runs):
    jax_run, port_run = runs
    np.testing.assert_array_equal(port_run["tokens"], jax_run["tokens"])


def test_decode_logits_match(runs):
    jax_run, port_run = runs
    np.testing.assert_allclose(port_run["step_logits"],
                               jax_run["step_logits"], atol=TOL, rtol=0)


def test_decode_cache_matches(runs):
    jax_run, port_run = runs
    _assert_cache_match(jax_run["final_cache"], port_run["final_cache"])


def test_the_reductions_keep_what_serving_exercises(runs):
    """Each reduced model keeps what its full config makes serving do."""
    jax_run = runs[0]
    cfg, cache = jax_run["cfg"], jax_run["final_cache"]
    leaves = {leaf for seg in cache for layer in seg.values()
              for leaf in layer}
    if cfg.attention == "full":
        assert (cfg.num_heads, cfg.num_kv_heads) == (14, 2)
        assert cfg.qkv_bias and cfg.tie_embeddings
        assert leaves == {"k", "v"}
    else:
        assert {"lk", "lv", "lpos", "rk", "rv", "rlen"} <= leaves
    if jax_run["arch"] == "rt-pg19":
        assert cfg.head_dim_ == 17 and "lk" in cache[0]["0"]
        assert cache[0]["0"].keys() != cache[-1]["0"].keys()
    if jax_run["arch"] == "rt-wikitext103":
        assert cfg.vocab_size % 256 != 0


# ---------------------------------------------------------------------------
# full attention: the refused kernel backend, teacher forcing, inactive lanes
# ---------------------------------------------------------------------------
def _full_model():
    cfg = _configs("qwen2-0.5b")[1]
    params, kstate = init_model(cfg, seed=0, device="cpu")
    return cfg, params, kstate


def test_full_forced_kernel_backend_is_refused():
    """impl="cuda" on a full model: its prefill passes positions, which
    the flash kernel (row-index mask) cannot take, and its decode has no
    kernel; both refusals name the backend that serves the call."""
    cfg, params, kstate = _full_model()
    cache = serving.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(attn.BackendResolutionError, match="full/torch"):
        serving.prefill(params, kstate, cache,
                        {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                        cfg, impl="cuda")
    with pytest.raises(attn.BackendResolutionError,
                       match="supports_decode=False"):
        serving.make_serve_step(cfg, impl="cuda")(
            params, kstate, cache, torch.zeros(1, dtype=torch.long),
            torch.zeros(1, dtype=torch.long))


def test_full_decode_equals_teacher_forced_forward():
    """Prefill + 12 greedy steps against one prefill of prompt + tokens:
    every step's logits within TOL of the forward's at its position (the
    JAX package's "decode == teacher-forced forward" property)."""
    cfg, params, kstate = _full_model()
    T = 12
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 40)))
    cache = serving.init_cache(cfg, B, prompt.shape[1] + T, device="cpu")
    logits, cache = serving.prefill(params, kstate, cache,
                                    {"tokens": prompt}, cfg)
    step = serving.make_serve_step(cfg)
    tok, toks, step_logits = logits[:, -1].argmax(-1), [], []
    for t in range(T):
        toks.append(tok)
        lg, cache = step(params, kstate, cache, tok,
                         torch.full((B,), prompt.shape[1] + t))
        step_logits.append(lg)
        tok = lg.argmax(-1)
    full = torch.cat([prompt, torch.stack(toks, 1)], 1)
    forward, _ = serving.prefill(
        params, kstate, serving.init_cache(cfg, B, full.shape[1], "cpu"),
        {"tokens": full}, cfg)
    np.testing.assert_allclose(torch.stack(step_logits, 1).numpy(),
                               forward[:, prompt.shape[1]:].numpy(),
                               atol=TOL, rtol=0)


def test_inactive_lanes_of_an_append_cache_untouched():
    """serve_step(active=...) leaves an inactive lane's k and v exactly as
    they were and still writes the active lane's token at its position."""
    cfg, params, kstate = _full_model()
    cache = serving.init_cache(cfg, B, N + 1, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, N)))
    _, cache = serving.prefill(params, kstate, cache, {"tokens": prompt},
                               cfg)
    _, new = serving.make_serve_step(cfg)(
        params, kstate, cache, torch.zeros(B, dtype=torch.long),
        torch.full((B,), N), active=torch.tensor([True, False]))
    for leaf in ("k", "v"):
        old = cache[0]["0"][leaf]
        assert torch.equal(new[0]["0"][leaf][:, 1], old[:, 1]), leaf
        assert not torch.equal(new[0]["0"][leaf][:, 0, :, N],
                               old[:, 0, :, N]), leaf
        assert torch.equal(new[0]["0"][leaf][:, 0, :, :N],
                           old[:, 0, :, :N]), leaf


# ---------------------------------------------------------------------------
# the plain decode on padded pages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [17, 129])
def test_plain_decode_on_padded_pages_is_bit_for_bit(dh, dtype):
    """The plain decode (and the wrapper, which takes it for CPU tensors)
    over pages stored at `page_width` gives the bits it gives over the
    same pages unpadded: empty, partly filled and wrapped pages."""
    gen = torch.Generator().manual_seed(dh)
    Bq, Hr, kc, cap = 2, 3, 4, 9
    r, v_new = (torch.randn((Bq, Hr, dh), generator=gen).to(dtype)
                for _ in range(2))
    rk, rv = (torch.randn((Bq, Hr, kc, cap, dh), generator=gen).to(dtype)
              for _ in range(2))
    rlen = torch.randint(0, 2 * cap, (Bq, Hr, kc), generator=gen,
                         dtype=torch.int32)
    rlen[0, 0] = 0
    cluster = torch.randint(0, kc, (Bq, Hr), generator=gen,
                            dtype=torch.int32)
    width = decode_k.page_width(dh)
    assert width == common.padded_head_dim("t", dh) > dh
    pad = torch.nn.functional.pad
    rkp, rvp = pad(rk, (0, width - dh)), pad(rv, (0, width - dh))
    want = decode_k.paged_routing_decode_plain(r, v_new, rk, rv, rlen,
                                               cluster)
    got = decode_k.paged_routing_decode_plain(r, v_new, rkp, rvp, rlen,
                                              cluster)
    assert got.shape == want.shape == (Bq, Hr, dh)
    assert torch.equal(got, want)
    for pages in ((rkp, rvp), (rk, rv)):
        assert torch.equal(decode_k.paged_routing_decode(
            r, v_new, *pages, rlen, cluster), want)


# ---------------------------------------------------------------------------
# resolution on the card
# ---------------------------------------------------------------------------
def test_full_torch_declares_decode_with_the_append_layout():
    b = attn.resolve(attn.spec_for_layer(_configs("qwen2-0.5b")[1], "full"),
                     decode=True, platform="cuda")
    assert b.name == "full/torch" and b.caps.supports_decode
    assert b.layout is backends.APPEND_LAYOUT
    assert b.layout.head_axes == {"k": 2, "v": 2}
    assert not attn.backends_for("full")[1].caps.supports_decode


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "starcoder2-3b",
                                  "phi4-mini-3.8b"])
def test_a_full_spec_decode_resolves_to_full_torch_on_the_card(arch):
    """Every full-attention config the port trains: decode and a serving
    prefill (with positions) resolve to full/torch on "cuda", and its
    cache is the append layout at max_len."""
    from repro_torch.configs import get_config
    spec = attn.spec_for_layer(get_config(arch), "full")
    for kw in (dict(decode=True), dict(positioned=True)):
        assert attn.resolve(spec, platform="cuda", **kw).name == "full/torch"
    small = attn.spec_for_layer(reduced_config(arch), "full")
    cache = attn.init_decode_cache(small, 2, 24, torch.float32, "cpu")
    assert {n: tuple(t.shape) for n, t in cache.items()} == {
        n: (2, small.num_kv_heads, 24, small.head_dim) for n in ("k", "v")}


def test_pg19_decode_resolves_to_the_kernel_at_the_pages_width():
    """rt-pg19's routing layers (head dim 129) decode on the card through
    the kernel backend, never the plain one, and their pages are 192
    wide; at dh 64 and 128 the pages keep their width."""
    from repro_torch.configs import get_config
    cfg = get_config("rt-pg19")
    for variant in ("local+routing", "routing"):
        spec = attn.spec_for_layer(cfg, variant)
        assert spec.head_dim == 129
        b = attn.resolve(spec, decode=True, platform="cuda")
        assert b.impl == "cuda" and b.caps.decode_max_head_dim == 192
        cache = attn.init_decode_cache(spec, 1, 64, torch.float32, "cpu")
        assert cache["rk"].shape[-1] == cache["rv"].shape[-1] == 192
    assert [decode_k.page_width(d) for d in (16, 64, 65, 128, 129, 192,
                                             193)] == [64, 64, 128, 128,
                                                       192, 192, 193]


def test_a_decode_cache_above_the_widest_kernel_raises_on_the_card():
    from repro_torch.configs import get_config
    cfg = with_overrides(get_config("rt-pg19"), head_dim=193)
    spec = attn.spec_for_layer(cfg, "local+routing")
    with pytest.raises(ValueError, match="head_dim 193.*widest instance is "
                                         "192"):
        attn.init_decode_cache(spec, 1, 64, torch.float32, "cuda")
    # on the CPU the plain backend serves it, its pages unpadded
    cache = attn.init_decode_cache(spec, 1, 64, torch.float32, "cpu")
    assert cache["rk"].shape[-1] == 193


# ---------------------------------------------------------------------------
# the decode kernel's split at its dh-192 chunk sizes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", sorted({e[-1] for e in
                                        chip_smoke.PG19_DECODE_EDGES}
                                       | {s[-1] for s in
                                          chip_smoke.PAPER_DECODE_SHAPES}))
def test_decode_ranges_cover_occupied_slots_at_dh192_chunks(cap):
    """At the dh-192 instances a chunk (8 KB of K) holds 21 bf16 or 10
    fp32 rows, no power of two: the ranks' ranges and their chunks
    (`test_torch_decode_split._ranges`, the kernel's split) still cover
    [0, nvalid) exactly once, in order, at every cap of rt-pg19's and
    rt-imagenet64's readings."""
    rows = {8192 // (192 * size) for size in (2, 4)}
    assert rows == {21, 10}
    for S in {min(8, -(-cap // 32))} | {1, 8}:
        for C in rows:
            for nvalid in sorted({0, 1, cap // 2, cap - 1, cap}):
                at = 0
                for chunks in _ranges(nvalid, S, C):
                    for lo, hi in chunks:
                        assert lo == at and 0 < hi - lo <= C
                        at = hi
                assert at == nvalid, (cap, S, C, nvalid)
