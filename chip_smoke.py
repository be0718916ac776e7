#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phases, each of which raises on failure (exit code 1, no result line):

1. print the card's name and power limit (nvidia-smi);
2. build the thirteen CUDA kernels from src/repro_torch/csrc (one nvcc per
   source, started together) and print each kernel's registers, shared
   memory and spills;
3. for each kernel, at the shapes its path gives it (rt-enwik8 serving
   for the local, routing and decode forward kernels, rt-enwik8 training
   for their backward kernels, qwen2-0.5b training for the three flash
   kernels, rt-cifar10 training for the three gathered routing kernels,
   all bf16; the flash kernels also in fp32 at head dim 128, the gathered
   ones also at rt-enwik8's blocks (dh 128) and in fp32, non-causal, with
   separate and padded keys at a ragged w): compare it with its plain
   PyTorch version run in fp32 on the same inputs, and time the kernel,
   the plain version (as the plain path runs it) and, where one PyTorch
   call computes the same function, that call (`library_ms`; the port
   never calls it). The causal flash kernels must take well under the
   time of the same call without the causal mask;
4. serve the paper's rt-enwik8 at full width (12 layers, d_model 1024,
   bf16, random weights from seed 0) through the port's entry points:
   4 requests with 2048-token prompts + 32 greedy tokens, then 1 request
   with an 8192-token prompt + 16 tokens. Launch counts are set to 0 just
   before and read just after, and must be exactly 12 local and 12 fused
   routing launches per prefill and 12 decode launches per decode step.
   The same requests then run on the plain PyTorch path (impl="torch"),
   teacher-forced with the kernel path's tokens, and the logits of the two
   paths are compared;
5. train the same model: first the fp32 gates (`routing_gate`), one train
   step's loss and gradients on the kernel path against the plain path
   (same weights, dropout 0, the plain path routing each token into the
   clusters the kernel path chose), the backward kernels against their
   plain versions on one forward graph, the kernel path against itself
   run again, and a negative control (the routing backward with the key
   side of shared-QK dropped) that the gates must refuse; the same for
   the forced gathered kernels against the fused ones at B 1 x 8192 (dh
   128); then a few bf16 steps with dropout 0.4 through `make_train_step`
   (Adam, vaswani schedule, clip 1.0, remat "full", B 2 x 8192 tokens of
   the synthetic markov task), launch counts set to 0 just before and
   read just after: with remat "full" each forward kernel runs twice per
   layer and microbatch (forward and recompute), each backward kernel
   once. The loss must be finite and fall;
6. train qwen2-0.5b at full width and depth (24 layers, d_model 896, GQA
   14:2, dh 64) on the flash kernels: an fp32 gate at B 1 x 2048 as in 5
   (no routing to pin; its negative control takes each kv head's dk/dv
   from one query head of its group), then 6 bf16 steps of B 2 x 4096
   through `make_train_step` under the JAX launcher's run config, with
   exactly 48 forward, 24 dq and 24 dk/dv flash launches per step and no
   other kernel; then the training launcher `repro_torch.launch.train` at
   its defaults (fp32, B 8 x 256) for 3 steps, in-process, with exact
   launch counts;
7. rt-cifar10 at full width and depth (12 layers, d_model 512, 8 heads of
   dh 64; layers 0-7 local, 8-11 local+routing, k 6, window 512): the fp32
   gates of 5 at B 1 x 3072 for the auto-selected kernels and for the
   forced gathered ones (impl="cuda_gathered"); 6 bf16 steps of B 8 x 3072
   through `make_train_step` on each, with exact launches per step (local
   forward 24, dq 12, dk/dv 12; fused or gathered forward 8, dq 4, dk/dv
   4; nothing else); `Trainer.fit` for 2 steps on the gathered kernels;
   serving 2 x 1536-token prompts + 32 tokens, gated as in 4;
8. the all-routing row (`cifar10(routing_heads=8, routing_layers=12)`, the
   routing variant on every layer): an fp32 gate and 2 x 1536 + 8 tokens
   of serving with exact launches;
9. print the per-kernel JSON line, then the device JSON line last.
   ``--out`` adds torch.profiler breakdowns of one rt-enwik8 prefill,
   decode step and train step, of one qwen2 train step and of one
   rt-cifar10 train step on each of its two kernel paths.

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
FULL_ARCH = "qwen2-0.5b"
# the seq of the JAX package's train_4k cell; the batch cut to one card
FULL_BATCH, FULL_SEQ = 2, 4096
FULL_GATE_BATCH, FULL_GATE_SEQ = 1, 2048        # the fp32 gate's batch
FULL_VOCAB = 512          # markov over min(V, 512) tokens, as the launcher
LAUNCH_ARGV = ["--steps", "3"]                  # the launcher's defaults
# the flash kernels at head dim 128 in fp32, as starcoder2-3b's heads:
# (B, H, Hkv, N, dh)
WIDE_FLASH = (1, 24, 2, 2048, 128)
# rt-cifar10 (the JAX registry's default row of the Table 1 grid: layers
# 0-7 local, 8-11 local+routing with 4 routing heads, k 6, window 512): its
# sequence of 32x32x3 bytes, the batch cut to one card; the fp32 gates at
# B 1; serving at half the sequence
CIFAR_ARCH = "rt-cifar10"
CIFAR_BATCH, CIFAR_SEQ = 8, 3072
CIFAR_GATE_BATCH = 1
CIFAR_FIT_STEPS = 2
CIFAR_REQUESTS = ((2, 1536, 32),)
# the all-routing row of the grid (the routing variant on every layer)
ROUTING_ROW = dict(routing_heads=8, routing_layers=12)
ROUTING_REQUESTS = ((2, 1536, 8),)
# rt-enwik8's gathered path against its fused path: one sequence of 8192
ENWIK8_GATHERED_GATE_BATCH = 1
# the gathered kernels in fp32, non-causal, separate keys, padded keys, w
# not a multiple of the tiles: (B, H, k, w, dh)
GATHERED_RAGGED = (1, 2, 8, 200, 64)
# kernel vs plain (fp32 on the same bf16 inputs): the kernel rounds its
# output to bf16 (half an ulp: 2^-9 of the value) and sums in another fp32
# order, so outputs may differ by 2^-7 of the largest reference value (two
# bf16 ulps at the top of the range); the fp32 lse by 1e-4 absolute
OUT_REL_TOL = 2.0 ** -7
LSE_TOL = 1e-4
# kernel path vs plain path logits, both in fp32 on the same weights (the
# plain path teacher-forced with the kernel path's tokens): the kernels and
# the plain ops sum in different orders. Sound runs read a largest
# difference of ~1e-5 in prefill and <= 5.7e-4 in decode, but now and then
# a token crosses a routing top-w boundary in one path only, and then a few
# positions read up to 0.58 (rt-enwik8; top-1 still >= 0.9987), more in a
# stack whose every head routes (the all-routing row of rt-cifar10 read
# 1.07 over 1.0% of prefill positions and lost one decode token in 16). So
# the plain path's prefill takes the kernel path's cluster membership (the
# number of routing calls that would have differed is reported), the
# largest difference is reported, and the gate is on top-1 and on the
# median over positions of each position's largest logit difference, which
# a path that drifts everywhere exceeds (sound runs: at most 2.1e-3 even
# in decode after such a flip)
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
# membership pinned, only the order of fp32 sums differs: rt-enwik8's sound
# runs read ~1e-4, a backward that drops the key side of shared-QK 1.3e-2
# (PERF.md), and the limit sits between them
MAX_LOSS_DIFF_FP32 = 1e-3
MAX_GRAD_MEDIAN_FP32 = 2.5e-3
# on one forward graph, backward kernels vs the plain backward: the
# largest per-leaf relative difference. Only fp32 summation order differs:
# sound runs read 7.7e-6..2.6e-5, the broken backward 0.159 (PERF.md)
MAX_BWD_GRAD_FP32 = 1e-3
# the kernel path against itself, run again on the same inputs (`repeat`,
# median leaf difference): what changes between runs is only the order in
# which atomics add a token's per-cluster gradients. With index_add_ in the
# fused path's scatter rt-enwik8 read 7.5e-5..4.6e-4, within 5x of any
# limit that also sits 5x under the broken backward's 1.28e-2; the scatter
# is now a sorted segmented sum (the fused path reads 0.0), and the
# gathered path keeps the atomics of its gather's backward (2.5e-7)
MAX_REPEAT_FP32 = 1e-4
ENWIK8_LIMITS = dict(loss=MAX_LOSS_DIFF_FP32, grad_median=MAX_GRAD_MEDIAN_FP32,
                     bwd_max=MAX_BWD_GRAD_FP32, repeat=MAX_REPEAT_FP32)
# rt-cifar10's gates (the auto-selected kernels and the forced gathered
# ones against the plain path): its pinned median reads 1.28e-4, the key
# side dropped 5.6e-3 (one local+routing layer in three has routing
# heads), so the median's limit sits at their geometric mean, 6.6x from
# each; the others as rt-enwik8's (readings in PERF.md)
CIFAR_LIMITS = dict(ENWIK8_LIMITS, grad_median=8.5e-4)
# the all-routing row: pinned median 2.1e-4, key side dropped 3.6e-2
ROUTING_ROW_LIMITS = dict(ENWIK8_LIMITS)
# rt-enwik8's gathered kernels against its fused kernels: both kernel
# paths, so the pinned median reads 2.5e-7 and the loss 0.0; the key side
# dropped 1.4e-2
ENWIK8_GATHERED_LIMITS = dict(ENWIK8_LIMITS, loss=1e-4, grad_median=1e-4)
# a causal flash call does half the pairs of a non-causal one; with the
# tiles above the diagonal skipped it takes ~0.5 of the time, masked ~1
MAX_CAUSAL_OVER_DENSE = 0.85

# fp32 train step of qwen2-0.5b, kernel path vs plain path (same weights,
# dropout 0): no routing, so only the order of fp32 sums differs between
# the flash kernels and the plain ops. Sound and broken readings (the
# negative control below) are in PERF.md; each limit sits at least 5x from
# both
MAX_LOSS_DIFF_FULL = 1e-4
MAX_GRAD_MEDIAN_FULL = 1e-4
MAX_BWD_GRAD_FULL = 1e-3

# every kernel of the port: its source, the TPU kernel it replaces (the
# def line), whether it runs in the forward (twice per layer under remat
# "full": forward and recompute) or the backward, the layers that run it
# (those with local heads, with routing heads, or with full attention) and
# the paths that launch it: serving and training rt-enwik8 ("serve",
# "train"), training qwen2-0.5b through make_train_step ("train_full") and
# through the launcher ("launch"), serving and training rt-cifar10 on the
# auto-selected kernels ("serve_cifar", "train_cifar"), training it on the
# forced gathered kernels through make_train_step and Trainer.fit
# ("train_gathered", "fit_gathered"), and serving the all-routing row
# ("serve_routing")
_LOCAL_FWD = ("serve", "train", "serve_cifar", "train_cifar",
              "train_gathered", "fit_gathered")
_LOCAL_BWD = ("train", "train_cifar", "train_gathered", "fit_gathered")
_FLASH = ("train_full", "launch")
_GATHERED = ("train_gathered", "fit_gathered")
KERNELS = {
    "local_attention": dict(
        route="cuda", source="src/repro_torch/csrc/local_attention.cu",
        replaces="src/repro/kernels/local_attention.py:34",
        kind="forward", layers="local", paths=_LOCAL_FWD),
    "routing_fused": dict(
        route="cuda", source="src/repro_torch/csrc/routing_fused.cu",
        replaces="src/repro/kernels/routing_attention.py:325",
        kind="forward", layers="routing",
        paths=("serve", "train", "serve_cifar", "train_cifar",
               "serve_routing")),
    "routing_decode": dict(
        route="cuda", source="src/repro_torch/csrc/routing_decode.cu",
        replaces="src/repro/kernels/routing_decode.py:59",
        kind="decode", layers="routing",
        paths=("serve", "serve_cifar", "serve_routing")),
    "local_attention_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/local_attention_bwd.cu",
        replaces="src/repro/kernels/local_attention.py:59",
        kind="backward", layers="local", paths=_LOCAL_BWD),
    "local_attention_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/local_attention_bwd.cu",
        replaces="src/repro/kernels/local_attention.py:85",
        kind="backward", layers="local", paths=_LOCAL_BWD),
    "routing_fused_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/routing_fused_bwd.cu",
        replaces="src/repro/kernels/routing_attention.py:372",
        kind="backward", layers="routing", paths=("train", "train_cifar")),
    "routing_fused_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/routing_fused_bwd.cu",
        replaces="src/repro/kernels/routing_attention.py:411",
        kind="backward", layers="routing", paths=("train", "train_cifar")),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:47",
        kind="forward", layers="full", paths=_FLASH),
    "flash_attention_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:90",
        kind="backward", layers="full", paths=_FLASH),
    "flash_attention_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:123",
        kind="backward", layers="full", paths=_FLASH),
    "routing_gathered": dict(
        route="cuda", source="src/repro_torch/csrc/routing_gathered.cu",
        replaces="src/repro/kernels/routing_attention.py:80",
        kind="forward", layers="routing", paths=_GATHERED),
    "routing_gathered_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/routing_gathered_bwd.cu",
        replaces="src/repro/kernels/routing_attention.py:115",
        kind="backward", layers="routing", paths=_GATHERED),
    "routing_gathered_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/routing_gathered_bwd.cu",
        replaces="src/repro/kernels/routing_attention.py:140",
        kind="backward", layers="routing", paths=_GATHERED),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def print_dynamic_smem() -> None:
    """Dynamic shared memory per block, which ptxas does not report: the
    forward tile (local, fused routing and flash forward kernels), the dq
    and dk/dv tiles (their backward kernels); the decode kernel takes
    (cap + 1) fp32 scores."""
    import ctypes
    from repro_torch.kernels import common
    fwd = common.load("flash_attention", "forward_tile_smem_bytes",
                      [ctypes.c_int])
    bwd = common.load("flash_attention_bwd", "backward_tile_smem_bytes",
                      [ctypes.c_int, ctypes.c_int])
    for dh in (64, 128):
        print(f"  dynamic smem per block, dh {dh}: forward tile {fwd(dh)} "
              f"B, dq tile {bwd(dh, 0)} B, dk/dv tile {bwd(dh, 1)} B; "
              f"decode (cap + 1) * 4 B")


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


def causal_pairs(B, H, N) -> float:
    """Attended (query, key) pairs of causal dense attention, N = M."""
    return B * H * N * (N + 1) / 2


def check_flash(torch, B, H, Hkv, N, dh, dtype, gen):
    """The three flash kernels at one causal shape: each against its plain
    version in fp32 on the same inputs, timed beside the plain version (in
    ``dtype``) and SDPA (forward; backward for all of dq, dk/dv). The
    kernels skip the key tiles above the diagonal, so each must take well
    under the time of the same call without the causal mask (twice the
    pairs): ``causal_over_dense`` reads ~0.5 (a kernel that masks those
    tiles instead of skipping them reads ~1)."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.core import row_dot
    mk = dict(generator=gen, device=DEVICE, dtype=dtype)
    q, do = (torch.randn((B, H, N, dh), **mk) for _ in range(2))
    k, v = (torch.randn((B, Hkv, N, dh), **mk) for _ in range(2))
    out, lse = K.flash_attention(q, k, v)
    dsum = row_dot(do, out)
    args = (q, k, v, do, lse, dsum)
    dq = K.flash_attention_bwd_dq(*args)
    dk, dv = K.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, do)]
    ref_out, ref_lse = K.flash_attention_plain(*f32[:3])
    err, lerr = max_err(out, ref_out), max_err(lse, ref_lse)
    if not (out_ok(out, ref_out) and lerr <= LSE_TOL):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: out {err}, lse {lerr}")
    args32 = (*f32, lse, dsum)
    ref_dq = K.flash_attention_bwd_dq_plain(*args32)
    ref_dk, ref_dv = K.flash_attention_bwd_dkv_plain(*args32)
    del ref_out, ref_lse

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do,
                                                  retain_graph=True))
    del o
    pairs = causal_pairs(B, H, N)
    shape = (f"B{B} H{H} Hkv{Hkv} N{N} dh{dh} "
             f"{str(dtype).replace('torch.', '')} causal")
    fwd_ms = time_ms(lambda: K.flash_attention(q, k, v))
    b_ms, b_by = bound_ms(nbytes(q, k, v, out, lse), 4 * dh * pairs)
    rows = {"flash_attention": dict(
        max_abs_err=err, lse_err=lerr, ms=fwd_ms,
        plain_ms=time_ms(lambda: K.flash_attention_plain(q, k, v)),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, shape=shape,
        causal_over_dense=fwd_ms / time_ms(
            lambda: K.flash_attention(q, k, v, False)))}
    rows.update(_bwd_rows(
        ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
        ((dq,), (dk, dv)), ((ref_dq,), (ref_dk, ref_dv)),
        (lambda: K.flash_attention_bwd_dq(*args),
         lambda: K.flash_attention_bwd_dkv(*args)),
        (lambda: K.flash_attention_bwd_dq_plain(*args),
         lambda: K.flash_attention_bwd_dkv_plain(*args)),
        lib_bwd, nbytes(q, k, v, do, lse, dsum),
        ((nbytes(dq), 6 * dh * pairs), (nbytes(dk, dv), 8 * dh * pairs)),
        shape))
    out_d, lse_d = K.flash_attention(q, k, v, False)
    dense = (q, k, v, do, lse_d, row_dot(do, out_d), False)
    for name, fn in (("flash_attention_bwd_dq", K.flash_attention_bwd_dq),
                     ("flash_attention_bwd_dkv", K.flash_attention_bwd_dkv)):
        rows[name]["causal_over_dense"] = rows[name]["ms"] / time_ms(
            lambda: fn(*dense))
    for name, row in rows.items():
        if row["causal_over_dense"] > MAX_CAUSAL_OVER_DENSE:
            raise AssertionError(
                f"{name} takes {row['causal_over_dense']:.2f} of its dense "
                f"time on a causal call: the tiles above the diagonal are "
                f"not skipped")
    return rows


def gathered_inputs(torch, B, H, kc, w, dh, dtype, gen, causal=True,
                    shared=True):
    """Gathered cluster blocks (n = B*H*kc, w, dh) and int32 positions for
    the gathered kernels. Causal shared-QK, as the routing layers make
    them: routing vectors of random q over N = kc*w tokens, their balanced
    top-w membership, the member rows and positions gathered. Otherwise
    random blocks with sorted positions, separate keys, and (non-causal)
    about one padded key in seven at SENTINEL."""
    from repro_torch.core import routing as ref
    from repro_torch.core.kmeans import cluster_scores, normalize_routing
    from repro_torch.kernels import routing_gathered as KG
    mk = dict(generator=gen, device=DEVICE, dtype=dtype)
    n = B * H * kc
    if shared:
        N = kc * w
        q, v = (torch.randn((B, H, N, dh), **mk) for _ in range(2))
        mu = torch.randn((H, kc, dh), generator=gen, device=DEVICE)
        r = normalize_routing(q)
        idx = ref.balanced_topk(cluster_scores(r, mu), w)
        pos = torch.arange(N, device=DEVICE).expand(B, N)
        qg, _, vg, pq, _, _ = ref.gather_blocks(r, None, v, idx, idx, pos)
        qf = qg.reshape(n, w, dh)
        pqf = pq.reshape(n, w).to(torch.int32).contiguous()
        return qf, qf, vg.reshape(n, w, dh), pqf, pqf.clone()
    qf, kf, vf = (torch.randn((n, w, dh), **mk) for _ in range(3))
    pos = lambda: torch.randint(0, 4 * w, (n, w), generator=gen,  # noqa
                                device=DEVICE).sort(-1).values
    pqf, pkf = pos(), pos()
    if not causal:
        pad = torch.rand((n, w), generator=gen, device=DEVICE) < 1 / 7
        pkf = torch.where(pad, KG.SENTINEL, pkf)
    return qf, kf, vf, pqf.to(torch.int32), pkf.to(torch.int32)


def check_gathered(torch, B, H, kc, w, dh, dtype, gen, causal=True,
                   shared=True):
    """The three gathered kernels at one shape: each against its plain
    version in fp32 on the same inputs, timed beside the plain version (in
    ``dtype``) and SDPA over the blocks with the boolean keep mask
    (forward; backward for all of dq, dk/dv)."""
    from repro_torch.core import row_dot
    from repro_torch.kernels import routing_gathered as K
    qf, kf, vf, pqf, pkf = gathered_inputs(torch, B, H, kc, w, dh, dtype,
                                           gen, causal, shared)
    out, lse = K.routed_attention_blocks(qf, kf, vf, pqf, pkf, causal)
    do = torch.randn(out.shape, generator=gen, device=DEVICE, dtype=dtype)
    dsum = row_dot(do, out)
    args = (qf, kf, vf, pqf, pkf, do, lse, dsum, causal)
    dq = K.routed_attention_blocks_bwd_dq(*args)
    dk, dv = K.routed_attention_blocks_bwd_dkv(*args)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (qf, kf, vf)]
    if shared:
        f32[1] = f32[0]
    ref_out, ref_lse = K.routed_attention_blocks_plain(*f32, pqf, pkf,
                                                       causal)
    err, lerr = max_err(out, ref_out), max_err(lse, ref_lse)
    if not (out_ok(out, ref_out) and lerr <= LSE_TOL):
        raise AssertionError(f"routing_gathered disagrees with its plain "
                             f"version: out {err}, lse {lerr}")
    args32 = (*f32, pqf, pkf, do.float(), lse, dsum, causal)
    ref_dq = K.routed_attention_blocks_bwd_dq_plain(*args32)
    ref_dk, ref_dv = K.routed_attention_blocks_bwd_dkv_plain(*args32)
    del ref_out, ref_lse

    keep = pkf[:, None, :] < K.SENTINEL
    if causal:
        keep = keep & (pqf[:, :, None] >= pkf[:, None, :])
    pairs = float(keep.sum())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = keep[:, None]
    qg, kg, vg = (t.detach()[:, None].requires_grad_(True)
                  for t in (qf, kf, vf))
    o = sdpa(qg, kg, vg, attn_mask=mask)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg),
                                                  do[:, None],
                                                  retain_graph=True))
    del o
    shape = (f"B{B} H{H} k{kc} w{w} dh{dh} "
             f"{str(dtype).replace('torch.', '')} "
             f"{'causal' if causal else 'non-causal'} "
             f"{'shared-QK' if shared else 'separate-QK'}")
    ins = (qf, vf, pqf, pkf) if shared else (qf, kf, vf, pqf, pkf)
    b_ms, b_by = bound_ms(nbytes(*ins, out, lse), 4 * dh * pairs)
    rows = {"routing_gathered": dict(
        max_abs_err=err, lse_err=lerr,
        ms=time_ms(lambda: K.routed_attention_blocks(qf, kf, vf, pqf, pkf,
                                                     causal)),
        plain_ms=time_ms(lambda: K.routed_attention_blocks_plain(
            qf, kf, vf, pqf, pkf, causal)),
        library_ms=time_ms(lambda: sdpa(qf[:, None], kf[:, None],
                                        vf[:, None], attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by, shape=shape, pairs=pairs)}
    rows.update(_bwd_rows(
        ("routing_gathered_bwd_dq", "routing_gathered_bwd_dkv"),
        ((dq,), (dk, dv)), ((ref_dq,), (ref_dk, ref_dv)),
        (lambda: K.routed_attention_blocks_bwd_dq(*args),
         lambda: K.routed_attention_blocks_bwd_dkv(*args)),
        (lambda: K.routed_attention_blocks_bwd_dq_plain(*args),
         lambda: K.routed_attention_blocks_bwd_dkv_plain(*args)),
        lib_bwd, nbytes(*ins, do, lse, dsum),
        ((nbytes(dq), 6 * dh * pairs), (nbytes(dk, dv), 8 * dh * pairs)),
        shape))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: serve full-width rt-enwik8
# ---------------------------------------------------------------------------
def serve(torch, cfg, params, kstate, prompts, new_tokens, impl=None,
          forced=None, counts=None):
    """Prefill ``prompts`` and decode ``new_tokens`` greedy tokens (or feed
    the ``forced`` (B, T) step inputs). With ``counts`` (a callable
    returning the launch counters) assert the exact launches of every
    prefill and step: each layer with local heads launches the local
    kernel and each with routing heads the fused kernel once per prefill,
    each with routing heads the decode kernel once per step. Returns the
    logits, the step inputs and timings."""
    from repro_torch.serve import serving
    B, N = prompts.shape
    cache = serving.init_cache(cfg, B, N + new_tokens, device=DEVICE)
    step = serving.make_serve_step(cfg, impl=impl)
    layers = layer_counts(cfg)
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
        want.update(local_attention=layers["local"],
                    routing_fused=layers["routing"])
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
            want.update(routing_decode=layers["routing"])
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
def train_run_config(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """A paper model under the TrainConfig defaults (Adam 0.9/0.98, eps
    1e-9, vaswani schedule, clip 1.0, remat "full"), by default at
    rt-enwik8's train shape."""
    from repro_torch.configs.base import RunConfig, TrainConfig
    return RunConfig(model=cfg, train=TrainConfig(global_batch=batch,
                                                  seq_len=seq))


def train_batches(torch, vocab, batch, seq, n):
    from repro_torch.data.synthetic import SyntheticLoader
    loader = SyntheticLoader("markov", vocab, batch, seq, seed=0)
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


@contextlib.contextmanager
def all_of(*managers):
    """Every context manager of ``managers`` entered, in order."""
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def one_graph_grads(torch, run, params32, kstate, batch, contexts,
                    impl=None):
    """Gradients of one forward graph's loss (on ``impl``), one backward
    pass inside each of ``contexts``: the forward is the same for all of
    them, so they differ only in the backward."""
    from repro_torch.train.train_step import (leaf_grads, make_loss_fn,
                                              unread_leaves)
    from repro_torch.tree import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params32)]
    unread = unread_leaves(params32, run.model)
    loss, _ = make_loss_fn(run, impl)(tree_unflatten(params32, leaves),
                                      kstate, batch, None)
    out = []
    for i, ctx in enumerate(contexts):
        with ctx:
            g = leaf_grads(loss, leaves, unread,
                           retain_graph=i < len(contexts) - 1)
        torch.cuda.synchronize()
        out.append(tree_unflatten(params32, g))
    return out


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


def routing_backward(impl):
    """(module, name) of the routing backward that ``impl`` runs: the
    fused kernels' for the auto-selected path, the gathered kernels'
    for ``cuda_gathered``."""
    from repro_torch.kernels import routing_attention as KR
    from repro_torch.kernels import routing_gathered as KG
    if impl == "cuda_gathered":
        return KG, "routed_attention_blocks_bwd"
    return KR, "routed_attention_fused_bwd"


def plain_backward(impl):
    """Inside the block, the backward of ``impl``'s local and routing
    Functions runs their plain versions."""
    from repro_torch.kernels import local_attention as KL
    module, name = routing_backward(impl)
    return all_of(swapped(KL, "local_attention_bwd",
                          KL.local_attention_bwd_plain),
                  swapped(module, name, getattr(module, f"{name}_plain")))


def broken_backward(impl):
    """Inside the block, ``impl``'s routing backward drops the key side
    of shared-QK (`key_side_dropped`): the negative control."""
    module, name = routing_backward(impl)
    return swapped(module, name, key_side_dropped(getattr(module, name)))


def gate_failures(out, limits) -> list:
    """What a routing gate's readings ``out`` fail of ``limits``: each
    sound reading must stay at or under its limit, and the negative
    control must exceed the limits of the gradient readings."""
    sound = (("loss_diff", out["loss_diff"], "loss"),
             ("grad_rel_median", out["grad_rel_median"], "grad_median"),
             ("backward.grad_rel_max", out["backward"]["grad_rel_max"],
              "bwd_max"),
             ("repeat.grad_rel_median", out["repeat"]["grad_rel_median"],
              "repeat"))
    broken = (("key_side_dropped.grad_rel_median",
               out["key_side_dropped"]["grad_rel_median"], "grad_median"),
              ("key_side_dropped.grad_rel_median",
               out["key_side_dropped"]["grad_rel_median"], "repeat"),
              ("key_side_dropped_backward.grad_rel_max",
               out["key_side_dropped_backward"]["grad_rel_max"], "bwd_max"))
    return ([f"{n} {v} > {limits[k]}" for n, v, k in sound
             if not v <= limits[k]]
            + [f"negative control {n} {v} <= {limits[k]}"
               for n, v, k in broken if not v > limits[k]])


def routing_gate(torch, cfg, params, kstate, batch, limits, impl=None,
                 ref_impl="torch"):
    """fp32 train step of a routing model (dropout 0, the same weights),
    the kernel path ``impl`` against the path ``ref_impl``:

    * loss and gradients, ``ref_impl`` fed ``impl``'s cluster membership,
      so that a token near a routing top-w boundary cannot switch
      clusters in one path only (see MAX_GRAD_MEDIAN_FP32);
    * on one forward graph, the gradients through the backward kernels
      against those through the plain backward (the Functions' backward
      pointed at the plain versions): no forward difference at all, so
      this reading is tight;
    * the kernel path against itself run again (``repeat``);
    * a negative control, the routing backward with the key side of the
      shared-QK gradient dropped, which the gradient readings must refuse.

    Reported beside them: ``ref_impl`` routing on its own (``unpinned``,
    with the number of routing calls whose membership differed). Raises
    on any of `gate_failures`."""
    from repro_torch.configs import with_overrides
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    run = train_run_config(with_overrides(cfg, dtype="float32", dropout=0.0),
                           batch["tokens"].shape[0],
                           batch["tokens"].shape[1] - 1)
    params32 = tree_map(lambda t: t.float(), params)

    def step(impl, membership=contextlib.nullcontext()):
        vg = value_and_grad(make_loss_fn(run, impl=impl), run.model)
        with membership:
            (loss, (new_k, _)), grads = vg(params32, kstate, batch, None)
        torch.cuda.synchronize()
        return float(loss), grads, new_k

    calls, flips = [], []
    lk, gk, kk = step(impl, membership_recorded(calls))
    lp, gp, kp = step(ref_impl, membership_replayed(calls, flips))
    if len(flips) != len(calls):
        raise AssertionError(f"{ref_impl} routed {len(flips)} times, "
                             f"{impl} {len(calls)}")
    lu, gu, _ = step(ref_impl)
    _, gr, _ = step(impl)
    g_kernels, g_plain_bwd, g_broken = one_graph_grads(
        torch, run, params32, kstate, batch,
        [contextlib.nullcontext(), plain_backward(impl),
         broken_backward(impl)], impl)

    kdiff = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(kk), tree_leaves(kp)))
    out = dict(impl=str(impl), ref=str(ref_impl),
               shape=f"B{run.train.global_batch} x {run.train.seq_len}",
               loss_kernel=lk, loss_ref=lp, loss_diff=abs(lk - lp),
               kstate_max_diff=kdiff, **grad_agreement(gk, gp),
               unpinned=dict(loss_diff=abs(lk - lu),
                             routing_calls=len(flips),
                             membership_differed=sum(flips),
                             **grad_agreement(gk, gu)),
               backward=grad_agreement(g_kernels, g_plain_bwd),
               repeat=grad_agreement(gr, gk),
               key_side_dropped=grad_agreement(g_broken, gp),
               key_side_dropped_backward=grad_agreement(g_broken,
                                                        g_plain_bwd),
               limits=limits)
    fails = gate_failures(out, limits)
    if fails:
        raise AssertionError(f"fp32 routing gate ({impl} vs {ref_impl}) "
                             f"fails: {fails}: {out}")
    return out


def first_query_head_only(q, k, v, out, lse, do, causal=True):
    """The flash backward with each kv head's dk/dv taken from the first
    query head of its GQA group instead of the group's sum. The qwen2
    gate's negative control."""
    from repro_torch.core import row_dot
    from repro_torch.kernels import flash_attention as KF
    dsum = row_dot(do, out)
    dq = KF.flash_attention_bwd_dq(q, k, v, do, lse, dsum, causal)
    dk, dv = KF.flash_attention_bwd_dkv(q, k, v, do, lse, dsum, causal)
    B, H, M, dh = dk.shape
    Hkv = k.shape[1]
    return (dq, dk.reshape(B, Hkv, H // Hkv, M, dh)[:, :, 0],
            dv.reshape(B, Hkv, H // Hkv, M, dh)[:, :, 0])


def full_run_config(cfg, batch, seq):
    """The JAX package's training launcher's run config (Adam, clip 1.0,
    remat "full", lr 1e-3 on a linear warm-up of 20 steps then rsqrt)."""
    from repro_torch.configs.base import RunConfig, TrainConfig
    return RunConfig(model=cfg, train=TrainConfig(
        global_batch=batch, seq_len=seq, lr=1e-3,
        schedule="linear_warmup_rsqrt", warmup_steps=20))


def full_train_gate(torch, cfg, params, kstate, batch):
    """qwen2's fp32 train step (dropout 0, the same weights), two gates as
    `routing_gate` has: the kernel path against the plain path (loss and
    the median leaf gradient difference), and on one forward graph the
    backward kernels against the plain backward (the largest leaf
    difference). Full attention routes nothing, so no membership is
    pinned. Reported beside them: the kernel path against itself, and a
    negative control (`first_query_head_only`) both gates must refuse."""
    from repro_torch.configs import with_overrides
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_map
    run = full_run_config(with_overrides(cfg, dtype="float32", dropout=0.0),
                          FULL_GATE_BATCH, FULL_GATE_SEQ)
    params32 = tree_map(lambda t: t.float(), params)

    def step(impl):
        vg = value_and_grad(make_loss_fn(run, impl=impl))
        (loss, _), grads = vg(params32, kstate, batch, None)
        torch.cuda.synchronize()
        return float(loss), grads

    lk, gk = step(None)
    lp, gp = step("torch")
    _, gr = step(None)
    g_kernels, g_plain_bwd, g_broken = one_graph_grads(
        torch, run, params32, kstate, batch, [
            contextlib.nullcontext(),
            swapped(KF, "flash_attention_bwd", KF.flash_attention_bwd_plain),
            swapped(KF, "flash_attention_bwd", first_query_head_only)])
    out = dict(loss_kernel=lk, loss_plain=lp, loss_diff=abs(lk - lp),
               **grad_agreement(gk, gp),
               backward=grad_agreement(g_kernels, g_plain_bwd),
               repeat=grad_agreement(gr, gk),
               first_head_only=grad_agreement(g_broken, gp),
               first_head_only_backward=grad_agreement(g_broken,
                                                       g_plain_bwd),
               shape=f"B{FULL_GATE_BATCH} x {FULL_GATE_SEQ}")
    if (out["loss_diff"] > MAX_LOSS_DIFF_FULL
            or out["grad_rel_median"] > MAX_GRAD_MEDIAN_FULL
            or out["backward"]["grad_rel_max"] > MAX_BWD_GRAD_FULL):
        raise AssertionError(f"fp32 kernel and plain qwen2 train steps "
                             f"disagree: {out}")
    if (out["first_head_only"]["grad_rel_median"] <= MAX_GRAD_MEDIAN_FULL
            or out["first_head_only_backward"]["grad_rel_max"]
            <= MAX_BWD_GRAD_FULL):
        raise AssertionError(f"the qwen2 fp32 gates pass a broken "
                             f"backward: {out}")
    return out


def layer_counts(cfg) -> dict:
    """How many layers of ``cfg`` have local heads, routing heads and full
    attention (a local+routing layer counts in the first two)."""
    from repro_torch.attn.spec import spec_for_layer, variant_for_layer
    variants = [spec_for_layer(cfg, variant_for_layer(cfg, i)).variant
                for i in range(cfg.num_layers)]
    return {"local": sum("local" in v for v in variants),
            "routing": sum("routing" in v for v in variants),
            "full": sum(v == "full" for v in variants)}


def expected_launches(path, run, steps):
    """Per kernel, the launches of ``steps`` train steps of ``run`` on
    ``path``: each forward kernel of the path once per layer that runs it
    and microbatch, twice with remat "full" (forward and recompute); each
    backward kernel once; every other kernel never."""
    tc = run.train
    layers = layer_counts(run.model)
    per = tc.grad_accum * steps
    fwd = per * (2 if tc.remat == "full" else 1)
    return {n: (0 if path not in meta["paths"] else
                layers[meta["layers"]] * (fwd if meta["kind"] == "forward"
                                          else per))
            for n, meta in KERNELS.items()}


def check_launches(path, got, want):
    if got != want:
        raise AssertionError(f"{path} launches {got}, expected {want}")


def train(torch, run, path, params, kstate, batches, counts, impl=None):
    """``len(batches)`` train steps through `make_train_step` on ``impl``,
    from the schedule's peak (see below). Asserts the exact launches of
    ``path``, a finite and falling loss; returns losses, timings and peak
    memory."""
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.optim import make_optimizer
    step_fn = make_train_step(run, impl)
    opt_init, _ = make_optimizer(run.train)
    # at step 1 the rate is far below its peak (rt-enwik8's vaswani
    # schedule: 1e-6, under the bf16 resolution of the weights), so a few
    # steps could not move the loss: start the state at the end of
    # warm-up, the schedule's peak, as a run in progress
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
    check_launches(path, got, expected_launches(path, run, len(batches)))
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{path} loss not finite and falling: "
                             f"{losses}")
    step_ms = statistics.median(times[1:])
    tokens = run.train.global_batch * run.train.seq_len
    return dict(losses=losses, step_ms=times, median_step_ms=step_ms,
                tokens_per_s=tokens / step_ms * 1e3,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=got, grad_norm=float(metrics["grad_norm"]),
                lr=metrics["lr"]), ts


def launch(torch, counts):
    """The training launcher at its defaults (qwen2-0.5b in fp32, B 8 x
    256) for a few steps, in-process, with the exact launches of the
    ``launch`` path and a finite loss."""
    from repro_torch.configs import get_config, with_overrides
    from repro_torch.launch import train as launcher
    args = launcher.parser().parse_args(LAUNCH_ARGV)
    cfg = with_overrides(get_config(args.arch), dtype="float32")
    before = counts()
    t0 = time.perf_counter()
    out = launcher.main(LAUNCH_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: counts()[n] - before[n] for n in before}
    check_launches("launch", got, expected_launches(
        "launch", full_run_config(cfg, args.batch, args.seq), args.steps))
    if out["steps"] != args.steps or not math.isfinite(out["final_loss"]):
        raise AssertionError(f"launcher run: {out}")
    return dict(argv=LAUNCH_ARGV, wall_s=wall, launches=got, **out)


def profile_train(torch, run, ts, batch, impl=None):
    """Device time by operation over one bf16 train step on ``impl``."""
    from repro_torch.train.train_step import make_train_step
    step_fn = make_train_step(run, impl)
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


def phase(name: str, t0: float) -> float:
    """Print the seconds since ``t0`` under ``name``; return now."""
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.1f} s", flush=True)
    return now


def serve_and_compare(torch, cfg, params, kstate, requests, name,
                      pin=False):
    """Serve ``requests`` ((batch, prompt, new tokens), random prompts from
    seed 1) on the kernel path with exact launch counts (set to 0 just
    before, read just after), then the same requests on the plain path,
    fed the kernel path's tokens. In bf16 the two paths round differently,
    and a token whose routing score sits near a cluster's top-w boundary
    can switch clusters in one path only: reported, not gated, each bf16
    path also against the fp32 kernel path. In fp32 (same weights,
    upcast) the kernel and plain paths must agree: that comparison is the
    gate. With ``pin`` the gated plain prefill is fed the kernel path's
    cluster membership, as in `routing_gate`, and its own routing is
    reported beside it (``fp32_unpinned``), with the count of routing
    calls whose own membership differed on the pinned inputs
    (``fp32_membership_flipped``); without, the plain path routes on its
    own. Either way the row counts the prefill routing calls whose
    membership differed between the two unpinned paths, a flip's later
    layers included (``fp32_membership_differed``). To tell routing flips
    from rounding, the bf16 kernel path is also held against the fp32
    kernel path fed its prefill membership
    (``bf16_kernel_vs_fp32_pinned``; the count of routing calls whose
    fp32 membership differed beside it). Returns (rows, launches,
    prompts)."""
    from repro_torch.configs import with_overrides
    from repro_torch.kernels import common
    from repro_torch.tree import tree_map
    gen_tok = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (B, N), generator=gen_tok,
                             device=DEVICE) for B, N, _ in requests]
    # warm-up outside the counted run: cuBLAS handles, kernel loading
    serve(torch, cfg, params, kstate, prompts[0][:1, :512], 2)
    common.reset_counters()
    bf16_calls = [[] for _ in requests]
    kern_runs = []
    for p, (_, _, T), c in zip(prompts, requests, bf16_calls):
        with membership_recorded(c):
            kern_runs.append(serve(torch, cfg, params, kstate, p, T,
                                   counts=common.counters))
    launches = common.counters()
    cfg32 = with_overrides(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    rows = []
    for p, (B, N, T), kr, bc in zip(prompts, requests, kern_runs,
                                    bf16_calls):
        pr = serve(torch, cfg, params, kstate, p, T, impl="torch",
                   forced=kr["tokens"])
        bflips = []
        with membership_replayed(bc, bflips):
            k32b = serve(torch, cfg32, params32, kstate, p, T,
                         forced=kr["tokens"])
        calls, own = [], []
        with membership_recorded(calls):
            k32 = serve(torch, cfg32, params32, kstate, p, T,
                        forced=kr["tokens"])
        with membership_recorded(own):
            p32 = serve(torch, cfg32, params32, kstate, p, T, impl="torch",
                        forced=kr["tokens"])
        differed = sum(bool((a != b).any()) for a, b in zip(calls, own))
        cmp = compare_paths(kr, pr, cfg.vocab_size)
        cmp32 = compare_paths(k32, p32, cfg.vocab_size)
        extra = {}
        if pin:
            flips = []
            with membership_replayed(calls, flips):
                p32 = serve(torch, cfg32, params32, kstate, p, T,
                            impl="torch", forced=kr["tokens"])
            extra = dict(fp32_unpinned=cmp32,
                         fp32_membership_flipped=sum(flips))
            cmp32 = compare_paths(k32, p32, cfg.vocab_size)
        row = dict(model=cfg.name, batch=B, prompt=N, new_tokens=T,
                   fp32_routing_calls=len(calls),
                   fp32_membership_differed=differed,
                   fp32_membership_pinned=pin,
                   prefill_ms=kr["prefill_ms"],
                   decode_ms_per_token=kr["decode_ms_per_token"],
                   prefill_tok_s=kr["prefill_tok_s"],
                   decode_tok_s=kr["decode_tok_s"],
                   plain_prefill_ms=pr["prefill_ms"],
                   plain_decode_ms_per_token=pr["decode_ms_per_token"],
                   bf16=cmp, fp32=cmp32, **extra,
                   bf16_kernel_vs_fp32=compare_paths(kr, k32,
                                                     cfg.vocab_size),
                   bf16_membership_differed=sum(bflips),
                   bf16_kernel_vs_fp32_pinned=compare_paths(
                       kr, k32b, cfg.vocab_size),
                   bf16_plain_vs_fp32=compare_paths(pr, k32,
                                                    cfg.vocab_size))
        rows.append(row)
        print(f"{name} {json.dumps(row)}", flush=True)
        if (min(cmp32["prefill_top1"], cmp32["decode_top1"]) < MIN_TOP1_FP32
                or max(cmp32["prefill_median_diff"],
                       cmp32["decode_median_diff"]) > MAX_MEDIAN_DIFF_FP32):
            raise AssertionError(f"{name}: fp32 kernel and plain paths "
                                 f"disagree: {cmp32}")
    return rows, launches, prompts


def fit(torch, run, impl, steps, counts):
    """`Trainer.fit` for ``steps`` steps of ``run`` on ``impl`` (its step
    function `make_train_step(run, impl)`), from a fresh state, with the
    exact launches of the ``fit_gathered`` path and a finite loss."""
    from repro_torch.data.synthetic import SyntheticLoader
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer
    tc = run.train
    trainer = Trainer(run, SyntheticLoader("markov", run.model.vocab_size,
                                           tc.global_batch, tc.seq_len,
                                           seed=tc.seed),
                      step_fn=make_train_step(run, impl), device=DEVICE)
    trainer.init_or_restore()
    before = counts()
    t0 = time.perf_counter()
    out = trainer.fit(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: counts()[n] - before[n] for n in before}
    check_launches("fit_gathered", got,
                   expected_launches("fit_gathered", run, steps))
    if out["steps"] != steps or not math.isfinite(out["final_loss"]):
        raise AssertionError(f"Trainer.fit on {impl}: {out}")
    return dict(wall_s=wall, launches=got, **out)


def print_rows(rows):
    for name, row in rows.items():
        print(f"kernel {name} [{row['shape']}]: " + ", ".join(
            f"{k}={v}" for k, v in row.items() if k != "shape"), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report here (JSON)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.attn.spec import head_split
    from repro_torch.configs import get_config, paper
    from repro_torch.kernels import common
    from repro_torch.models.model import init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t_start = t = time.perf_counter()
    common.build(sorted({Path(m["source"]).stem for m in KERNELS.values()}))
    t = phase("build", t)
    for name, log in common.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    print_dynamic_smem()

    cfg = get_config(ARCH)
    fcfg = get_config(FULL_ARCH)
    ccfg = get_config(CIFAR_ARCH)
    rcfg = paper.cifar10(**ROUTING_ROW)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    (B1, N1, T1), (B2, N2, T2) = REQUESTS
    cifar_blocks = (CIFAR_BATCH, head_split(ccfg)[1],
                    ccfg.routing.num_clusters, ccfg.routing.window,
                    ccfg.head_dim_)
    kern_rows = {
        "local_attention": check_local(torch, cfg, B1, N1, gen),
        "routing_fused": check_routing(torch, cfg, B1, N1, gen),
        "routing_decode": check_decode(torch, cfg, B1, N1 + T1, gen),
        **check_local_bwd(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, gen),
        **check_routing_bwd(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, gen),
        **check_flash(torch, FULL_BATCH, fcfg.num_heads, fcfg.num_kv_heads,
                      FULL_SEQ, fcfg.head_dim_, torch.bfloat16, gen),
        **check_gathered(torch, *cifar_blocks, torch.bfloat16, gen),
    }
    long_rows = {
        "local_attention": check_local(torch, cfg, B2, N2, gen),
        "routing_fused": check_routing(torch, cfg, B2, N2, gen),
        "routing_decode": check_decode(torch, cfg, B2, N2 + T2, gen),
    }
    wide_rows = check_flash(torch, *WIDE_FLASH, torch.float32, gen)
    gathered_rows = {
        "rt-enwik8": check_gathered(
            torch, 1, head_split(cfg)[1], cfg.routing.num_clusters,
            TRAIN_SEQ // cfg.routing.num_clusters, cfg.head_dim_,
            torch.bfloat16, gen),
        "fp32 ragged": check_gathered(torch, *GATHERED_RAGGED,
                                      torch.float32, gen, causal=False,
                                      shared=False)}
    for shape_rows in (kern_rows, long_rows, wide_rows,
                       *gathered_rows.values()):
        print_rows(shape_rows)
    t = phase("kernels", t)

    # rt-enwik8: serve, then train
    params, kstate = init_model(cfg, seed=0, device=DEVICE)
    serving_rows, serve_launches, prompts = serve_and_compare(
        torch, cfg, params, kstate, REQUESTS, "serve")
    launches = {"serve": serve_launches}
    t = phase("serve", t)

    run = train_run_config(cfg)
    batches = train_batches(torch, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_STEPS)
    gate = routing_gate(torch, cfg, params, kstate, batches[0],
                        ENWIK8_LIMITS)
    print(f"train fp32 gate {json.dumps(gate)}", flush=True)
    gathered_gate = routing_gate(
        torch, cfg, params, kstate,
        {"tokens": batches[0]["tokens"][:ENWIK8_GATHERED_GATE_BATCH]},
        ENWIK8_GATHERED_LIMITS, impl="cuda_gathered", ref_impl=None)
    print(f"train fp32 gathered gate {json.dumps(gathered_gate)}",
          flush=True)
    common.reset_counters()
    train_row, trained = train(torch, run, "train", params, kstate, batches,
                               common.counters)
    launches["train"] = common.counters()
    print(f"train {json.dumps(train_row)}", flush=True)
    t = phase("train", t)
    if args.out:
        prof = profile(torch, cfg, params, kstate, prompts[0])
        prof["train_step"] = profile_train(torch, run, trained, batches[-1])
    del params, kstate, trained, batches, prompts
    torch.cuda.empty_cache()

    # qwen2-0.5b: full attention on the flash kernels
    fparams, fkstate = init_model(fcfg, seed=0, device=DEVICE)
    fvocab = min(fcfg.vocab_size, FULL_VOCAB)
    gate_batch = train_batches(torch, fvocab, FULL_GATE_BATCH,
                               FULL_GATE_SEQ, 1)[0]
    full_gate = full_train_gate(torch, fcfg, fparams, fkstate, gate_batch)
    print(f"train_full fp32 gate {json.dumps(full_gate)}", flush=True)
    t = phase("train_full gate", t)
    frun = full_run_config(fcfg, FULL_BATCH, FULL_SEQ)
    fbatches = train_batches(torch, fvocab, FULL_BATCH, FULL_SEQ,
                             TRAIN_STEPS)
    common.reset_counters()
    full_row, ftrained = train(torch, frun, "train_full", fparams, fkstate,
                               fbatches, common.counters)
    launches["train_full"] = common.counters()
    full_row["shape"] = f"B{FULL_BATCH} x {FULL_SEQ}"
    print(f"train_full {json.dumps(full_row)}", flush=True)
    t = phase("train_full", t)
    if args.out:
        prof["train_full_step"] = profile_train(torch, frun, ftrained,
                                                fbatches[-1])
    del fparams, fkstate, ftrained, fbatches
    torch.cuda.empty_cache()

    common.reset_counters()
    launch_row = launch(torch, common.counters)
    launches["launch"] = common.counters()
    print(f"launch {json.dumps(launch_row)}", flush=True)
    t = phase("launch", t)

    # rt-cifar10: the fp32 gates, bf16 training on the auto-selected and
    # on the gathered kernels, Trainer.fit, serving
    cparams, ckstate = init_model(ccfg, seed=0, device=DEVICE)
    crun = train_run_config(ccfg, CIFAR_BATCH, CIFAR_SEQ)
    cbatches = train_batches(torch, ccfg.vocab_size, CIFAR_BATCH, CIFAR_SEQ,
                             TRAIN_STEPS)
    cgate_batch = {"tokens": cbatches[0]["tokens"][:CIFAR_GATE_BATCH]}
    cifar_gates = {
        str(impl): routing_gate(torch, ccfg, cparams, ckstate, cgate_batch,
                                CIFAR_LIMITS, impl=impl)
        for impl in (None, "cuda_gathered")}
    for impl, g in cifar_gates.items():
        print(f"train_cifar fp32 gate {impl} {json.dumps(g)}", flush=True)
    t = phase("cifar gates", t)
    cifar_rows = {}
    for path, impl in (("train_cifar", None),
                       ("train_gathered", "cuda_gathered")):
        common.reset_counters()
        cifar_rows[path], ctrained = train(torch, crun, path, cparams,
                                           ckstate, cbatches,
                                           common.counters, impl)
        launches[path] = common.counters()
        cifar_rows[path]["shape"] = f"B{CIFAR_BATCH} x {CIFAR_SEQ}"
        print(f"{path} {json.dumps(cifar_rows[path])}", flush=True)
        if args.out:
            prof[f"{path}_step"] = profile_train(torch, crun, ctrained,
                                                 cbatches[-1], impl)
        del ctrained
    common.reset_counters()
    fit_row = fit(torch, crun, "cuda_gathered", CIFAR_FIT_STEPS,
                  common.counters)
    launches["fit_gathered"] = common.counters()
    print(f"fit_gathered {json.dumps(fit_row)}", flush=True)
    t = phase("train_cifar", t)
    cserve_rows, launches["serve_cifar"], _ = serve_and_compare(
        torch, ccfg, cparams, ckstate, CIFAR_REQUESTS, "serve_cifar")
    del cparams, ckstate, cbatches
    torch.cuda.empty_cache()
    t = phase("serve_cifar", t)

    # the all-routing row of the Table 1 grid: the routing variant
    rparams, rkstate = init_model(rcfg, seed=0, device=DEVICE)
    rbatch = train_batches(torch, rcfg.vocab_size, CIFAR_GATE_BATCH,
                           CIFAR_SEQ, 1)[0]
    routing_row_gate = routing_gate(torch, rcfg, rparams, rkstate, rbatch,
                                    ROUTING_ROW_LIMITS)
    print(f"routing row fp32 gate {json.dumps(routing_row_gate)}",
          flush=True)
    # pinned: unpinned, a routing flip in one fp32 path costs this row one
    # decode token in 16 (its own reading, fp32_unpinned, stays reported)
    rserve_rows, launches["serve_routing"], _ = serve_and_compare(
        torch, rcfg, rparams, rkstate, ROUTING_REQUESTS, "serve_routing",
        pin=True)
    del rparams, rkstate
    t = phase("routing row", t)

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
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, kernels=kernels, long_prompt_kernels=long_rows,
            wide_head_kernels=wide_rows, gathered_kernels=gathered_rows,
            serving=serving_rows, train_gate=gate,
            train_gathered_gate=gathered_gate, train=train_row,
            train_full_gate=full_gate, train_full=full_row,
            launch=launch_row, cifar_gates=cifar_gates, cifar=cifar_rows,
            fit_gathered=fit_row, serve_cifar=cserve_rows,
            routing_row_gate=routing_row_gate, serve_routing=rserve_rows,
            profile=prof), indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
