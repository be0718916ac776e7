#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phases, each of which raises on failure (exit code 1, no result line):

1. print the card's name and power limit (nvidia-smi);
2. build the seven CUDA kernels from src/repro_torch/csrc (one nvcc per
   source, started together) and print each kernel's registers, shared
   memory and spills;
3. for each kernel, at the bf16 shapes its path gives it (serving for the
   forward and decode kernels, training for the four backward kernels):
   compare it with its plain PyTorch version run in fp32 on the same bf16
   inputs, and time the kernel, the plain version (as the plain path runs
   it, in bf16) and, where one PyTorch call computes the same function,
   that call (`library_ms`; the port never calls it);
4. serve the paper's rt-enwik8 at full width (12 layers, d_model 1024,
   bf16, random weights from seed 0) through the port's entry points:
   4 requests with 2048-token prompts + 32 greedy tokens, then 1 request
   with an 8192-token prompt + 16 tokens. Launch counts are set to 0 just
   before and read just after, and must be exactly 12 local and 12 fused
   routing launches per prefill and 12 decode launches per decode step.
   The same requests then run on the plain PyTorch path (impl="torch"),
   teacher-forced with the kernel path's tokens, and the logits of the two
   paths are compared;
5. train the same model: first an fp32 gate, one train step's loss and
   gradients on the kernel path against the plain path (same weights,
   dropout 0, the plain path routing each token into the clusters the
   kernel path chose), with the kernel path's run-to-run floor reported
   and a negative control (the routing backward with the key side of
   shared-QK dropped) that the gate must refuse; then a few bf16 steps
   with dropout
   0.4 through `make_train_step` (Adam, vaswani schedule, clip 1.0, remat
   "full", B 2 x 8192 tokens of the synthetic markov task), launch counts
   set to 0 just before and read just after: with remat "full" each
   forward kernel runs twice per layer and microbatch (forward and
   recompute), each backward kernel once. The loss must be finite and
   fall;
6. print the per-kernel JSON line, then the device JSON line last.

Exits non-zero without a result when no CUDA device is present, or when
run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
ARCH = "rt-enwik8"
DEVICE = "cuda"
REQUESTS = ((4, 2048, 32), (1, 8192, 16))      # (batch, prompt, new tokens)
TRAIN_BATCH, TRAIN_SEQ = 2, 8192               # the paper's context length
TRAIN_STEPS = 6
# kernel vs plain (fp32 on the same bf16 inputs): the kernel rounds its
# output to bf16 (half an ulp: 2^-9 of the value) and sums in another fp32
# order, so outputs may differ by 2^-7 of the largest reference value (two
# bf16 ulps at the top of the range); the fp32 lse by 1e-4 absolute
OUT_REL_TOL = 2.0 ** -7
LSE_TOL = 1e-4
# kernel path vs plain path logits, both in fp32 on the same weights (the
# plain path teacher-forced with the kernel path's tokens): the kernels and
# the plain ops sum in different orders, and index_add_ atomics vary the
# order from run to run. Sound runs read a largest difference of ~1e-5 in
# prefill and <= 5.7e-4 in decode, but now and then a token crosses a
# routing top-w boundary in one path only, and then a few positions read up
# to 0.58 (top-1 still >= 0.9987). So the largest difference is reported,
# and the gate is on top-1 and on the median over positions of each
# position's largest logit difference, which a path that drifts everywhere
# exceeds (sound runs: at most 2.1e-3 even in decode after such a flip)
MIN_TOP1_FP32 = 0.99
MAX_MEDIAN_DIFF_FP32 = 1e-2
# backward kernels vs their plain versions (fp32 outputs of both, on the
# same bf16 inputs and the same lse and D): only the order of fp32 sums
# differs, so a tenth of a percent of the largest reference value
BWD_REL_TOL = 1e-3
# fp32 train step, kernel path vs plain path (same weights, dropout 0, the
# plain path fed the kernel path's cluster membership): the loss, and the
# median over parameter leaves of |g_kernel - g_plain| / |g_plain|. Left to
# route on its own, a path moves a token that sits near a routing top-w
# boundary into another cluster now and then, and with it the token's whole
# gradient contribution (sound runs then read up to 2.5e-3); with the
# membership pinned, only fp32 summation order and index_add_ atomics
# differ: the kernel path against itself reads up to 5.7e-4, a backward
# that drops the key side of shared-QK 1.3e-2 (PERF.md), and the limit
# sits between them
MAX_LOSS_DIFF_FP32 = 1e-3
MAX_GRAD_MEDIAN_FP32 = 2.5e-3
# on one forward graph, backward kernels vs the plain backward: the
# largest per-leaf relative difference. Only fp32 summation order and
# index_add_ atomics differ: sound runs read 7.7e-6..2.6e-5, the broken
# backward 0.159 (PERF.md)
MAX_BWD_GRAD_FP32 = 1e-3

# every kernel of the port: its source, the TPU kernel it replaces (the
# def line), and the paths that launch it
KERNELS = {
    "local_attention": dict(
        route="cuda", source="src/repro_torch/csrc/local_attention.cu",
        replaces="src/repro/kernels/local_attention.py:34",
        paths=("serve", "train")),
    "routing_fused": dict(
        route="cuda", source="src/repro_torch/csrc/routing_fused.cu",
        replaces="src/repro/kernels/routing_attention.py:325",
        paths=("serve", "train")),
    "routing_decode": dict(
        route="cuda", source="src/repro_torch/csrc/routing_decode.cu",
        replaces="src/repro/kernels/routing_decode.py:59",
        paths=("serve",)),
    "local_attention_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/local_attention_bwd.cu",
        replaces="src/repro/kernels/local_attention.py:59",
        paths=("train",)),
    "local_attention_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/local_attention_bwd.cu",
        replaces="src/repro/kernels/local_attention.py:85",
        paths=("train",)),
    "routing_fused_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/routing_fused_bwd.cu",
        replaces="src/repro/kernels/routing_attention.py:372",
        paths=("train",)),
    "routing_fused_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/routing_fused_bwd.cu",
        replaces="src/repro/kernels/routing_attention.py:411",
        paths=("train",)),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def out_ok(out, ref, rel_tol: float = OUT_REL_TOL) -> bool:
    return max_err(out, ref) <= rel_tol * float(ref.abs().max())


def local_pairs(torch, B, H, N, w) -> float:
    """Attended (query, key) pairs of causal local attention."""
    i = torch.arange(N, device=DEVICE)
    lo = ((i // w - 1) * w).clamp_min(0)
    return float((i - lo + 1).sum()) * B * H


def routing_pairs(torch, pos, idx) -> float:
    """Attended (query, key) pairs of causal shared-QK routing on this
    run's membership."""
    B, H, kc, w = idx.shape
    pg = torch.gather(pos[:, None, :].expand(B, H, pos.shape[1]), 2,
                      idx.long().reshape(B, H, -1)).reshape(B, H, kc, w)
    return float((pg[..., :, None] >= pg[..., None, :]).sum())


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version at the serving shapes
# ---------------------------------------------------------------------------
def local_mask(torch, N, w):
    """The dense (N, N) bool mask of causal local attention."""
    i = torch.arange(N, device=DEVICE)
    lo = ((i // w - 1) * w).clamp_min(0)
    return (i[None, :] <= i[:, None]) & (i[None, :] >= lo[:, None])


def check_local(torch, cfg, B, N, gen):
    from repro_torch.kernels import local_attention as K
    dh, w = cfg.head_dim_, cfg.routing.local_window
    H = cfg.num_heads // 2
    q, k, v = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                           dtype=torch.bfloat16) for _ in range(3))
    out, lse = K.local_attention(q, k, v, w)
    torch.cuda.synchronize()
    ref_out, ref_lse = K.local_attention_plain(q.float(), k.float(),
                                               v.float(), w)
    err, lerr = max_err(out, ref_out), max_err(lse, ref_lse)
    if not (out_ok(out, ref_out) and lerr <= LSE_TOL):
        raise AssertionError(f"local_attention disagrees with its plain "
                             f"version: out {err}, lse {lerr}")
    pairs = local_pairs(torch, B, H, N, w)
    mask = local_mask(torch, N, w)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b_ms, b_by = bound_ms(nbytes(q, k, v, out, lse), 4 * dh * pairs)
    return dict(
        max_abs_err=err, lse_err=lerr,
        ms=time_ms(lambda: K.local_attention(q, k, v, w)),
        plain_ms=time_ms(lambda: K.local_attention_plain(q, k, v, w)),
        library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by, shape=f"B{B} H{H} N{N} dh{dh} w{w}")


def check_routing(torch, cfg, B, N, gen):
    from repro_torch.core.kmeans import cluster_scores, normalize_routing
    from repro_torch.core.routing import balanced_topk
    from repro_torch.kernels import routing_attention as K
    dh, kc = cfg.head_dim_, cfg.routing.num_clusters
    H = cfg.num_heads // 2
    w = N // kc
    q, v = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16) for _ in range(2))
    mu = torch.randn((H, kc, dh), generator=gen, device=DEVICE)
    r = normalize_routing(q)
    idx = balanced_topk(cluster_scores(r, mu), w).int().contiguous()
    pos = torch.arange(N, device=DEVICE, dtype=torch.int32).expand(
        B, N).contiguous()
    out, lse = K.routed_attention_fused(r, None, v, idx, idx, pos)
    torch.cuda.synchronize()
    ref_out, ref_lse = K.routed_attention_fused_plain(
        r.float(), None, v.float(), idx, idx, pos)
    err, lerr = max_err(out, ref_out), max_err(lse, ref_lse)
    if not (out_ok(out, ref_out) and lerr <= LSE_TOL):
        raise AssertionError(f"routing_fused disagrees with its plain "
                             f"version: out {err}, lse {lerr}")
    pairs = routing_pairs(torch, pos, idx)
    b_ms, b_by = bound_ms(nbytes(r, v, idx, pos, out, lse), 4 * dh * pairs)
    return dict(
        max_abs_err=err, lse_err=lerr,
        ms=time_ms(lambda: K.routed_attention_fused(r, None, v, idx, idx,
                                                    pos)),
        plain_ms=time_ms(lambda: K.routed_attention_fused_plain(
            r, None, v, idx, idx, pos)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"B{B} H{H} N{N} dh{dh} k{kc} w{w}")


def check_decode(torch, cfg, B, max_len, gen):
    from repro_torch.kernels import routing_decode as K
    dh, kc = cfg.head_dim_, cfg.routing.num_clusters
    Hr = cfg.num_heads // 2
    cap = max_len // kc
    bf = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
    r, v_new = (torch.randn((B, Hr, dh), **bf) for _ in range(2))
    rk, rv = (torch.randn((B, Hr, kc, cap, dh), **bf) for _ in range(2))
    rlen = torch.randint(0, 2 * cap, (B, Hr, kc), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    cluster = torch.randint(0, kc, (B, Hr), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    out = K.paged_routing_decode(r, v_new, rk, rv, rlen, cluster)
    torch.cuda.synchronize()
    ref = K.paged_routing_decode_plain(r.float(), v_new.float(), rk.float(),
                                       rv.float(), rlen, cluster)
    err = max_err(out, ref)
    if not out_ok(out, ref):
        raise AssertionError(f"routing_decode disagrees with its plain "
                             f"version: out {err}")
    nvalid = torch.gather(rlen, 2, cluster.long()[..., None]).clamp_max(cap)
    rows = float(nvalid.sum())
    b_ms, b_by = bound_ms(
        nbytes(r, v_new, out, cluster) + 2 * rows * dh * 2 + 4 * B * Hr,
        4 * dh * (rows + B * Hr))
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: K.paged_routing_decode(r, v_new, rk, rv, rlen,
                                                  cluster)),
        plain_ms=time_ms(lambda: K.paged_routing_decode_plain(
            r, v_new, rk, rv, rlen, cluster)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"B{B} Hr{Hr} dh{dh} k{kc} cap{cap}")


def _bwd_rows(names, got, ref, run_kernel, run_plain, library_ms, nbytes_in,
              flops, shape):
    """Rows of the two backward kernels: each output against its plain
    version, each kernel and plain version timed."""
    rows = {}
    for name, outs, refs, fn, plain, extra in zip(
            names, got, ref, run_kernel, run_plain, flops):
        errs = [max_err(o, r) for o, r in zip(outs, refs)]
        if not all(out_ok(o, r, BWD_REL_TOL) for o, r in zip(outs, refs)):
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"max abs errors {errs}")
        out_bytes, n_flops = extra
        b_ms, b_by = bound_ms(nbytes_in + out_bytes, n_flops)
        rows[name] = dict(max_abs_err=max(errs), ms=time_ms(fn),
                          plain_ms=time_ms(plain), library_ms=library_ms,
                          bound_ms=b_ms, bound_by=b_by, shape=shape)
    return rows


def check_local_bwd(torch, cfg, B, N, gen):
    """The local dq and dk/dv kernels at the train shapes."""
    from repro_torch.core import local as ref
    from repro_torch.kernels import local_attention as K
    dh, w = cfg.head_dim_, cfg.routing.local_window
    H = cfg.num_heads // 2
    q, k, v, do = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                               dtype=torch.bfloat16) for _ in range(4))
    out, lse = K.local_attention(q, k, v, w)
    dsum = K.row_dot(do, out)
    args = (q, k, v, do, lse, dsum, w)
    args32 = (q.float(), k.float(), v.float(), do.float(), lse, dsum, w)
    dq = K.local_attention_bwd_dq(*args)
    dk, dv = K.local_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    ref_dq = ref.local_attention_bwd_dq(*args32)
    ref_dk, ref_dv = ref.local_attention_bwd_dkv(*args32)
    # library: the backward of SDPA with the dense bool mask (all of dq,
    # dk, dv), timed only
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=local_mask(torch, N, w))
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do,
                                                 retain_graph=True))
    del o
    pairs = local_pairs(torch, B, H, N, w)
    return _bwd_rows(
        ("local_attention_bwd_dq", "local_attention_bwd_dkv"),
        ((dq,), (dk, dv)), ((ref_dq,), (ref_dk, ref_dv)),
        (lambda: K.local_attention_bwd_dq(*args),
         lambda: K.local_attention_bwd_dkv(*args)),
        (lambda: ref.local_attention_bwd_dq(*args),
         lambda: ref.local_attention_bwd_dkv(*args)),
        lib_ms, nbytes(q, k, v, do, lse, dsum),
        ((nbytes(dq), 6 * dh * pairs), (nbytes(dk, dv), 8 * dh * pairs)),
        f"B{B} H{H} N{N} dh{dh} w{w}")


def check_routing_bwd(torch, cfg, B, N, gen):
    """The fused routing dq and dk/dv kernels at the train shapes
    (causal shared-QK, as the LM runs them)."""
    from repro_torch.core import routing as ref
    from repro_torch.core.kmeans import cluster_scores, normalize_routing
    from repro_torch.kernels import routing_attention as K
    dh, kc = cfg.head_dim_, cfg.routing.num_clusters
    H = cfg.num_heads // 2
    w = N // kc
    q, v = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16) for _ in range(2))
    mu = torch.randn((H, kc, dh), generator=gen, device=DEVICE)
    r = normalize_routing(q)
    idx = ref.balanced_topk(cluster_scores(r, mu), w).int().contiguous()
    pos = torch.arange(N, device=DEVICE, dtype=torch.int32).expand(
        B, N).contiguous()
    out, lse = K.routed_attention_fused(r, None, v, idx, idx, pos)
    do = torch.randn(out.shape, generator=gen, device=DEVICE,
                     dtype=torch.bfloat16)
    dsum = K.row_dot(do, out)
    args = (r, None, v, idx, idx, pos, do, lse, dsum)
    li, lp = idx.long(), pos.long()
    args32 = (r.float(), None, v.float(), li, li, lp, do.float(), lse, dsum)
    dq = K.routed_attention_fused_bwd_dq(*args)
    dk, dv = K.routed_attention_fused_bwd_dkv(*args)
    torch.cuda.synchronize()
    ref_dq = ref.routed_attention_bwd_dq(*args32)
    ref_dk, ref_dv = ref.routed_attention_bwd_dkv(*args32)
    plain = (r, None, v, li, li, lp, do, lse, dsum)
    pairs = routing_pairs(torch, pos, idx)
    return _bwd_rows(
        ("routing_fused_bwd_dq", "routing_fused_bwd_dkv"),
        ((dq,), (dk, dv)), ((ref_dq,), (ref_dk, ref_dv)),
        (lambda: K.routed_attention_fused_bwd_dq(*args),
         lambda: K.routed_attention_fused_bwd_dkv(*args)),
        (lambda: ref.routed_attention_bwd_dq(*plain),
         lambda: ref.routed_attention_bwd_dkv(*plain)),
        None, nbytes(r, v, idx, pos, do, lse, dsum),
        ((nbytes(dq), 6 * dh * pairs), (nbytes(dk, dv), 8 * dh * pairs)),
        f"B{B} H{H} N{N} dh{dh} k{kc} w{w}")


# ---------------------------------------------------------------------------
# Phase 4: serve full-width rt-enwik8
# ---------------------------------------------------------------------------
def serve(torch, cfg, params, kstate, prompts, new_tokens, impl=None,
          forced=None, counts=None):
    """Prefill ``prompts`` and decode ``new_tokens`` greedy tokens (or feed
    the ``forced`` (B, T) step inputs). With ``counts`` (a callable
    returning the launch counters) assert the exact launches of every
    prefill and step. Returns the logits, the step inputs and timings."""
    from repro_torch.serve import serving
    B, N = prompts.shape
    cache = serving.init_cache(cfg, B, N + new_tokens, device=DEVICE)
    step = serving.make_serve_step(cfg, impl=impl)
    L = cfg.num_layers
    before = counts() if counts else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = serving.prefill(params, kstate, cache,
                                    {"tokens": prompts}, cfg, impl=impl)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if counts:
        got = {n: counts()[n] - before[n] for n in before}
        want = dict.fromkeys(before, 0)
        want.update(local_attention=L, routing_fused=L)
        if got != want:
            raise AssertionError(f"prefill launches {got}, expected {want}")
    tok = logits[:, -1].argmax(-1)
    toks, step_logits = [], []
    t0 = time.perf_counter()
    for t in range(new_tokens):
        inp = tok if forced is None else forced[:, t]
        before = counts() if counts else None
        lg, cache = step(params, kstate, cache, inp,
                         torch.full((B,), N + t, device=DEVICE))
        if counts:
            got = {n: counts()[n] - before[n] for n in before}
            want = dict.fromkeys(before, 0)
            want.update(routing_decode=L)
            if got != want:
                raise AssertionError(f"decode step {t} launches {got}, "
                                     f"expected {want}")
        tok = lg.argmax(-1)
        toks.append(inp)
        step_logits.append(lg)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / new_tokens
    step_logits = torch.stack(step_logits, 1)
    toks = torch.stack(toks, 1)
    for x in (logits, step_logits):
        if not torch.isfinite(x[..., :cfg.vocab_size]).all():
            raise AssertionError("non-finite logits")
    if logits.shape != (B, N, cfg.padded_vocab):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
    return dict(logits=logits, step_logits=step_logits, tokens=toks,
                prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
                prefill_tok_s=B * N / prefill_ms * 1e3,
                decode_tok_s=B / decode_ms * 1e3)


def profiled(torch, fn, top: int = 15) -> dict:
    """Run ``fn`` under torch.profiler: wall ms, device busy ms, device
    launches, host aten calls and the ``top`` device ops by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith("aten::")]
    return dict(
        wall_ms=wall,
        device_busy_ms=sum(e.self_device_time_total for e in dev) / 1e3,
        device_launches=sum(e.count for e in dev),
        host_aten_calls=sum(e.count for e in host),
        device_ops=[dict(name=e.key, calls=e.count,
                         device_ms=e.self_device_time_total / 1e3)
                    for e in dev[:top]])


def profile(torch, cfg, params, kstate, prompts):
    """Device time by operation over one kernel-path prefill of
    ``prompts`` and, separately, one decode step after it."""
    from repro_torch.serve import serving
    B, N = prompts.shape
    cache = serving.init_cache(cfg, B, N + 2, device=DEVICE)
    step = serving.make_serve_step(cfg)
    res = {}

    def prefill():
        res["logits"], res["cache"] = serving.prefill(
            params, kstate, cache, {"tokens": prompts}, cfg)

    def decode():
        step(params, kstate, res["cache"], res["logits"][:, -1].argmax(-1),
             torch.full((B,), N, device=DEVICE))
    return {"prefill": profiled(torch, prefill),
            "decode_step": profiled(torch, decode)}


# ---------------------------------------------------------------------------
# Phase 5: train full-width rt-enwik8
# ---------------------------------------------------------------------------
def train_run_config(cfg):
    """rt-enwik8 under the TrainConfig defaults (Adam 0.9/0.98, eps 1e-9,
    vaswani schedule, clip 1.0, remat "full") at the paper's context."""
    from repro_torch.configs.base import RunConfig, TrainConfig
    return RunConfig(model=cfg, train=TrainConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))


def train_batches(torch, cfg, n):
    from repro_torch.data.synthetic import SyntheticLoader
    loader = SyntheticLoader("markov", cfg.vocab_size, TRAIN_BATCH,
                             TRAIN_SEQ, seed=0)
    return [{k: torch.from_numpy(v).to(DEVICE)
             for k, v in next(loader).items()} for _ in range(n)]


def grad_agreement(grads, ref) -> dict:
    """Per parameter leaf |g - g_ref| / |g_ref| (Frobenius norms): the
    median over leaves (the gate) and the largest (reported)."""
    import torch
    from repro_torch.tree import tree_leaves
    rel = torch.stack([(a - b).norm() / b.norm().clamp_min(1e-30)
                       for a, b in zip(tree_leaves(grads), tree_leaves(ref))])
    return dict(grad_rel_median=float(rel.median()),
                grad_rel_max=float(rel.max()), leaves=len(rel))


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    kept = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kept)


def membership_recorded(calls: list):
    """Inside the block, each routing layer's cluster membership
    (`balanced_topk`) is appended to ``calls``."""
    from repro_torch.core import routing
    topk = routing.balanced_topk

    def record(*args, **kwargs):
        calls.append(topk(*args, **kwargs))
        return calls[-1]
    return swapped(routing, "balanced_topk", record)


def membership_replayed(calls: list, flips: list):
    """Inside the block, the routing layers take the memberships of
    ``calls`` in order instead of their own; for each, ``flips`` gets
    whether the layer's own membership differed. The same model under the
    same remat calls `balanced_topk` in the same order on both paths."""
    from repro_torch.core import routing
    topk = routing.balanced_topk

    def replay(*args, **kwargs):
        own, idx = topk(*args, **kwargs), calls[len(flips)]
        flips.append(bool((own != idx).any()))
        return idx
    return swapped(routing, "balanced_topk", replay)


def key_side_dropped(routing_bwd):
    """``routing_bwd`` (the fused routing backward) with the key side of
    the gradient dropped: with shared-QK, q's gradient loses its dk part.
    The gate's negative control."""
    def broken(*args, **kwargs):
        dq, dk, dv = routing_bwd(*args, **kwargs)
        return dq, dk.new_zeros(dk.shape), dv
    return broken


def train_gate(torch, cfg, params, kstate, batch):
    """fp32 train step (dropout 0, the same weights), two gates:

    * the kernel path against the plain path: loss and gradients, the
      plain path fed the kernel path's cluster membership, so that a token
      near a routing top-w boundary cannot switch clusters in one path
      only (see MAX_GRAD_MEDIAN_FP32);
    * on one forward graph, the gradients through the backward kernels
      against those through the plain backward (the Functions' backward
      pointed at the plain versions): no forward difference at all, so
      this gate is tight.

    Reported beside them: the plain path routing on its own (``unpinned``,
    with the number of routing calls whose membership differed), the
    kernel path against itself run again, and a negative control, the
    backward with the key side of the shared-QK routing gradient dropped,
    which both gates must refuse."""
    from repro_torch.configs import with_overrides
    from repro_torch.kernels import local_attention as KL
    from repro_torch.kernels import routing_attention as KR
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    run = train_run_config(with_overrides(cfg, dtype="float32", dropout=0.0))
    params32 = tree_map(lambda t: t.float(), params)

    def step(impl, membership=contextlib.nullcontext()):
        vg = value_and_grad(make_loss_fn(run, impl=impl))
        with membership:
            (loss, (new_k, _)), grads = vg(params32, kstate, batch, None)
        torch.cuda.synchronize()
        return float(loss), grads, new_k

    calls, flips = [], []
    lk, gk, kk = step(None, membership_recorded(calls))
    lp, gp, kp = step("torch", membership_replayed(calls, flips))
    if len(flips) != len(calls):
        raise AssertionError(f"the plain path routed {len(flips)} times, "
                             f"the kernel path {len(calls)}")
    lu, gu, _ = step("torch")
    _, gr, _ = step(None)

    # one forward graph, three backward passes
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params32)]
    loss, _ = make_loss_fn(run)(tree_unflatten(params32, leaves), kstate,
                                batch, None)

    def grads(retain=True):
        g = torch.autograd.grad(loss, leaves, retain_graph=retain)
        torch.cuda.synchronize()
        return tree_unflatten(params32, list(g))

    g_kernels = grads()
    with swapped(KL, "local_attention_bwd", KL.local_attention_bwd_plain), \
            swapped(KR, "routed_attention_fused_bwd",
                    KR.routed_attention_fused_bwd_plain):
        g_plain_bwd = grads()
    with swapped(KR, "routed_attention_fused_bwd",
                 key_side_dropped(KR.routed_attention_fused_bwd)):
        g_broken = grads(retain=False)

    kdiff = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(kk), tree_leaves(kp)))
    out = dict(loss_kernel=lk, loss_plain=lp, loss_diff=abs(lk - lp),
               kstate_max_diff=kdiff, **grad_agreement(gk, gp),
               unpinned=dict(loss_diff=abs(lk - lu),
                             routing_calls=len(flips),
                             membership_differed=sum(flips),
                             **grad_agreement(gk, gu)),
               backward=grad_agreement(g_kernels, g_plain_bwd),
               repeat=grad_agreement(gr, gk),
               key_side_dropped=grad_agreement(g_broken, gp),
               key_side_dropped_backward=grad_agreement(g_broken,
                                                        g_plain_bwd))
    if (out["loss_diff"] > MAX_LOSS_DIFF_FP32
            or out["grad_rel_median"] > MAX_GRAD_MEDIAN_FP32
            or out["backward"]["grad_rel_max"] > MAX_BWD_GRAD_FP32):
        raise AssertionError(f"fp32 kernel and plain train steps disagree: "
                             f"{out}")
    if (out["key_side_dropped"]["grad_rel_median"] <= MAX_GRAD_MEDIAN_FP32
            or out["key_side_dropped_backward"]["grad_rel_max"]
            <= MAX_BWD_GRAD_FP32):
        raise AssertionError(f"the fp32 gates pass a broken backward: {out}")
    return out


def expected_train_launches(run, steps, L):
    """Per kernel, the launches of ``steps`` train steps of an L-layer
    model: each forward kernel once per layer and microbatch, twice with
    remat "full" (forward and recompute); each backward kernel once."""
    tc = run.train
    fwd = L * tc.grad_accum * (2 if tc.remat == "full" else 1) * steps
    bwd = L * tc.grad_accum * steps
    return {n: (fwd if n in ("local_attention", "routing_fused") else
                bwd if "train" in meta["paths"] else 0)
            for n, meta in KERNELS.items()}


def train(torch, cfg, params, kstate, batches, counts):
    """``len(batches)`` bf16 train steps through `make_train_step`, from
    the schedule's peak (see below). Asserts the exact launches, a finite
    and falling loss; returns losses, timings and peak memory."""
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.optim import make_optimizer
    run = train_run_config(cfg)
    step_fn = make_train_step(run)
    opt_init, _ = make_optimizer(run.train)
    # at step 1 the vaswani rate is 1e-6, below the bf16 resolution of the
    # weights, so a few steps could not move the loss: start the state at
    # the end of warm-up, the schedule's peak (~1e-3), as a run in progress
    ts = TrainState(params, kstate, opt_init(params), run.train.warmup_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        ts, metrics = step_fn(ts, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    got = {n: counts()[n] - before[n] for n in before}
    want = dict.fromkeys(before, 0)
    want.update(expected_train_launches(run, len(batches), cfg.num_layers))
    if got != want:
        raise AssertionError(f"train launches {got}, expected {want}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train loss not finite and falling: {losses}")
    step_ms = statistics.median(times[1:])
    return dict(losses=losses, step_ms=times, median_step_ms=step_ms,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=got, grad_norm=float(metrics["grad_norm"]),
                lr=metrics["lr"]), ts


def profile_train(torch, cfg, ts, batch):
    """Device time by operation over one bf16 train step."""
    from repro_torch.train.train_step import make_train_step
    step_fn = make_train_step(train_run_config(cfg))
    return profiled(torch, lambda: float(step_fn(ts, batch)[1]["loss"]))


def compare_paths(kern, plain, V):
    """Top-1 agreement and, over positions, the largest, median and 99th
    percentile of each position's largest logit difference."""
    out = {}
    for phase, key in (("prefill", "logits"), ("decode", "step_logits")):
        a, b = kern[key][..., :V].float(), plain[key][..., :V].float()
        d = (a - b).abs().amax(-1).flatten()
        out.update({
            f"{phase}_max_diff": float(d.max()),
            f"{phase}_median_diff": float(d.median()),
            f"{phase}_p99_diff": float(d.quantile(0.99)),
            f"{phase}_top1": float((a.argmax(-1) == b.argmax(-1)).float()
                                   .mean())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report here (JSON)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, with_overrides
    from repro_torch.kernels import common
    from repro_torch.models.model import init_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    common.build(sorted({Path(m["source"]).stem for m in KERNELS.values()}))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in common.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    (B1, N1, T1), (B2, N2, T2) = REQUESTS
    kern_rows = {
        "local_attention": check_local(torch, cfg, B1, N1, gen),
        "routing_fused": check_routing(torch, cfg, B1, N1, gen),
        "routing_decode": check_decode(torch, cfg, B1, N1 + T1, gen),
        **check_local_bwd(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, gen),
        **check_routing_bwd(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, gen),
    }
    long_rows = {
        "local_attention": check_local(torch, cfg, B2, N2, gen),
        "routing_fused": check_routing(torch, cfg, B2, N2, gen),
        "routing_decode": check_decode(torch, cfg, B2, N2 + T2, gen),
    }
    for shape_rows in (kern_rows, long_rows):
        for name, row in shape_rows.items():
            print(f"kernel {name} [{row['shape']}]: " + ", ".join(
                f"{k}={v}" for k, v in row.items() if k != "shape"),
                flush=True)

    params, kstate = init_model(cfg, seed=0, device=DEVICE)
    gen_tok = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (B, N), generator=gen_tok,
                             device=DEVICE) for B, N, _ in REQUESTS]
    # warm-up outside the counted run: cuBLAS handles, kernel loading
    serve(torch, cfg, params, kstate, prompts[0][:1, :512], 2)

    common.reset_counters()
    kern_runs = [serve(torch, cfg, params, kstate, p, T,
                       counts=common.counters)
                 for p, (_, _, T) in zip(prompts, REQUESTS)]
    launches = {"serve": common.counters()}

    # the same requests on the plain path, fed the main path's tokens. In
    # bf16 the two paths round differently, and a token whose routing
    # score sits near a cluster's top-w boundary can switch clusters in
    # one path only: reported, not gated, each bf16 path also against the
    # fp32 kernel path. In fp32 (same weights, upcast) the kernel and
    # plain paths must agree: that comparison is the gate.
    cfg32 = with_overrides(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    serving_rows = []
    for p, (B, N, T), kr in zip(prompts, REQUESTS, kern_runs):
        pr = serve(torch, cfg, params, kstate, p, T, impl="torch",
                   forced=kr["tokens"])
        k32 = serve(torch, cfg32, params32, kstate, p, T,
                    forced=kr["tokens"])
        p32 = serve(torch, cfg32, params32, kstate, p, T, impl="torch",
                    forced=kr["tokens"])
        cmp = compare_paths(kr, pr, cfg.vocab_size)
        cmp32 = compare_paths(k32, p32, cfg.vocab_size)
        kernel_vs_fp32 = compare_paths(kr, k32, cfg.vocab_size)
        plain_vs_fp32 = compare_paths(pr, k32, cfg.vocab_size)
        row = dict(batch=B, prompt=N, new_tokens=T,
                   prefill_ms=kr["prefill_ms"],
                   decode_ms_per_token=kr["decode_ms_per_token"],
                   prefill_tok_s=kr["prefill_tok_s"],
                   decode_tok_s=kr["decode_tok_s"],
                   plain_prefill_ms=pr["prefill_ms"],
                   plain_decode_ms_per_token=pr["decode_ms_per_token"],
                   bf16=cmp, fp32=cmp32, bf16_kernel_vs_fp32=kernel_vs_fp32,
                   bf16_plain_vs_fp32=plain_vs_fp32)
        serving_rows.append(row)
        print(f"serve {json.dumps(row)}", flush=True)
        if (min(cmp32["prefill_top1"], cmp32["decode_top1"]) < MIN_TOP1_FP32
                or max(cmp32["prefill_median_diff"],
                       cmp32["decode_median_diff"]) > MAX_MEDIAN_DIFF_FP32):
            raise AssertionError(f"fp32 kernel and plain paths disagree: "
                                 f"{cmp32}")
    del params32

    batches = train_batches(torch, cfg, TRAIN_STEPS)
    gate = train_gate(torch, cfg, params, kstate, batches[0])
    print(f"train fp32 gate {json.dumps(gate)}", flush=True)
    common.reset_counters()
    train_row, trained = train(torch, cfg, params, kstate, batches,
                               common.counters)
    launches["train"] = common.counters()
    print(f"train {json.dumps(train_row)}", flush=True)
    for name, meta in KERNELS.items():
        for path in meta["paths"]:
            if launches[path].get(name, 0) == 0:
                raise AssertionError(f"kernel {name} never ran on the "
                                     f"{path} path")

    kernels = []
    for name, meta in KERNELS.items():
        row = kern_rows[name]
        kernels.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(launches[p][name] for p in meta["paths"]),
            launches_by_path={p: launches[p][name] for p in meta["paths"]},
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"]))
    if args.out:
        prof = profile(torch, cfg, params, kstate, prompts[0])
        prof["train_step"] = profile_train(torch, cfg, trained, batches[-1])
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, kernels=kernels, long_prompt_kernels=long_rows,
            serving=serving_rows, train_gate=gate, train=train_row,
            profile=prof), indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
