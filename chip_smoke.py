#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]
    python3 chip_smoke.py --decode-only [--src OTHER/src] [--out FILE]

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
   the flash kernels also in bf16 at head dim 128, and all three in bf16
   at the shapes their 128-row tiles make ragged (`FLASH_EDGES`), each
   bf16 row reporting SDPA's own error (forward, and dq, dk and dv)
   against the same fp32 plain version beside its own; the gathered
   kernels' dq, dk and dv also row by row under their position mask, each
   row of dq and dk allowed twice its probabilistic fp32 rounding floor
   (`gathered_grad_row_errs`), and all three in bf16 at the w their tiles
   make ragged (`GATHERED_EDGES`: causal shared-QK, causal separate-QK
   with queries that see no key, non-causal with a cluster all padding),
   SDPA's backward errors beside each bf16 row, the bf16 gathered
   backward also against fp64 and timed in a CUDA graph (`graph_ms`); the
   local and gathered forwards also row by row within ROW_REL_TOL, the
   local forward also at rt-cifar10's local layers (B 8 x 3072, 8 heads,
   w 512) and in bf16 at the N and w its tiles and window make ragged
   (`LOCAL_EDGES`, with a pad mask whose last rows keep no key), each bf16
   forward row with SDPA's and fp64 readings and `graph_ms`; a digest of
   the flash forward's outputs (`flash_forward_digest`); the ptxas lines
   of the bf16 kernels on the tensor cores (flash forward, dq, dk/dv;
   local forward; gathered forward, dq, dk/dv) must show no spills;
   the local dq and dk/dv also row by row under the window mask
   (`local_grad_row_errs`) with SDPA's and fp64 readings and `graph_ms`,
   also at rt-cifar10's local layers and in bf16 at every `LOCAL_EDGES`
   shape (`check_local_bwd_edges`: GQA 2:1 through `group_sum`, dq of a
   row that keeps no key and dk, dv of a padded key exactly zero); a
   digest of the flash and gathered backwards' outputs
   (`backward_digest`); the bf16 local dq and dk/dv on the tensor cores
   must show no spills either; the fused routing dq and dk/dv (since
   slice 10 bf16 on the tensor cores, no spill) also row by row under
   their position mask (`fused_grad_row_errs`: the gathered row check on
   the members' blocks, no-key dq rows and unkept keys' dk, dv exactly
   zero) and run twice, equal bit for bit, with `graph_ms`, at
   rt-enwik8's train shape, at rt-cifar10's routing heads (B 8 x 3072, 4
   heads, k 6, w 512) and in bf16 at the 48 `FUSED_EDGES`; a digest of
   the local backward's outputs (`local_backward_digest`); the fused
   routing forward (since slice 11 bf16 on the tensor cores, no spill)
   against its plain version in fp32, row by row (`fused_fwd_row_errs`:
   rows that keep no key exactly zero with the plain lse) and run twice,
   equal bit for bit, with `graph_ms`, the fp64 and SDPA readings and the
   gathered forward's `graph_ms` on the same members' blocks beside it,
   at rt-enwik8's train shape, at rt-cifar10's routing heads and at
   rt-enwik8's 4 x 2048 prefill (`check_routing_fwd`), and at the 48
   `FUSED_EDGES` (`check_routing_fwd_edges`); a digest of the local and
   gathered forwards' outputs (`forward_digest`); the paged decode (since
   slice 12 a thread-block cluster per (batch, head), no spill) in bf16
   and fp32 at the four shapes the serving paths give it and at the 12
   `DECODE_EDGES` (`check_decode_shapes`): every (b, h) row within
   ROW_REL_TOL of its own largest value (`decode_row_errs`), a page with
   no occupied slot giving v_new bit for bit, slots past the occupied
   ones poisoned and a second run leaving the bits as they were, each
   with `graph_ms` and an L2-cold reading (`cold_ms`); since slice 14 the
   same at rt-pg19's and rt-imagenet64's serving shapes
   (`PAPER_DECODE_SHAPES`: dh 129 through the dh-192 instance over pages
   stored 192 wide, the bound also at 192; cap 2048) and at
   `PG19_DECODE_EDGES` (`check_decode_paper`), and a digest of the dh-64
   and dh-128 decode (`decode_digest`); since slice 13 the
   local and fused routing kernels (forward, dq, dk/dv) at the paper's
   other models' train shapes through the same checks
   (`check_paper_kernels`, seed 9): rt-pg19's head dim 129, which the
   wrappers run zero-padded to the kernels' dh-192 instances (local B 1 x
   8192, 8 heads, w 512; fused Hr 2, k 16, w 512; bound counted at dh
   129), in bf16 and in fp32, and rt-imagenet64's windows of 2048 (local B
   1 x 12288, 8 heads, dh 64; fused Hr 8, k 8, w 2048) in bf16; then the
   four edge checks at dh-129 ragged shapes (`PG19_LOCAL_EDGES`,
   `PG19_FUSED_EDGES`); the dh-192 instances on `wgmma` are under the
   spill check too;
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
   between the fp32 gate and the bf16 steps, a bf16 gate at the gate's
   shape (`full_train_gate_bf16`): the kernel path and, as the yardstick,
   the plain path with SDPA in place of the flash kernels, each against
   the plain path (`BF16_GATE_FACTOR`), the kernel path against itself,
   and the fp32 gate's negative control;
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
   of serving with exact launches; then (slice 13) the paper's other three
   models at full width and depth, random weights from seed 0, each with
   exact launches per path (`train_paper`), its busy ms per step (one
   more step under the profiler), tokens/s and peak memory:
   ``train_pg19``: rt-pg19 (22 layers, d_model 1032, 8 heads of dh 129,
   2 routing heads in layers 20-21), its fp32 gate at B 1 x 8192 as in 5
   (`PG19_LIMITS`: rt-enwik8's, the median's at 2.5e-4, so that the
   dropped key side, which touches 2 of 22 layers, is refused), then 3
   bf16 steps of B 1 x 8192 on Adafactor (lr 0.01, the default schedule)
   with local 44 / 22 / 22 and fused 4 / 2 / 2 launches per step;
   ``train_imagenet64``: rt-imagenet64 (24 layers, windows 2048), its fp32
   gate at B 1 x 12288 (rt-enwik8's limits), then 3 bf16 steps of B 1 x
   12288 on Adam (lr 2e-4, linear warm-up then constant), 48 / 24 / 24
   each;
   ``train_wikitext103``: rt-wikitext103 (10 layers, vocab 267735), 3
   bf16 steps of B 2 x 4096 on Adam, 20 / 10 / 10 each;
   then (slice 14) every model the port trains served at full width and
   depth in bf16 (`serve_model`: exact launches per prefill and per step,
   prefill ms and tokens/s, decode ms per token, the busy ms of one
   profiled prefill and decode step), each with an fp32 gate on the same
   weights: ``serve_pg19`` (1 x 8192 + 16: local 22 and fused 2 launches
   per prefill, decode 2 per step, through its dh-192 instance),
   ``serve_imagenet64`` (1 x 6144 + 16, pages of cap 2048: 24, 24, 24),
   ``serve_wikitext103`` (2 x 2048 + 16: 10, 10, 10), their kernel path
   against the plain path under the serving gates of 4; ``serve_full``
   (qwen2-0.5b, 2 x 2048 + 32: no kernel, full/torch prefill and
   append-cache decode, as the JAX package's full/xla), each decode step
   against the prefill logits of prompt + tokens
   (MAX_MEDIAN_DIFF_FULL_FP32);
   then (slice 15) ``serve_engine``: full-width rt-enwik8 in bf16 through
   the continuous-batching engine (`repro_torch.serve.engine`), a pool of
   8 lanes of 4096 tokens, 24 requests (prompts of 512 to 3072 tokens,
   16 to 64 new tokens, half sampled, an interactive-class arrival while
   every slot is busy, 4 repeated prompts): run A with chunked prefill
   (2 stages a step), time slices of 8 tokens and a prefix cache, run B
   with none of them and its free slots in reverse order. Every request's
   tokens and recorded logits rows must be equal in A and B bit for bit;
   a lane poisoned in the KV store before its resume must break that
   parity; each prefill, chunked stage, decode step, park, resume and
   activation launches exactly its kernels, adding up to the counters;
   the fp32 engine on the kernels against the engine on the plain path
   under the serving gates; the card's PRNG keys, bits and sampled tokens
   against the CPU's; a lane's KV store round trip bit for bit, below
   the uncompacted lane's bytes; run A parks through the engine's own
   store, which copies off the card on a side stream and finishes the
   park on a background thread (slice 16);
   then (slice 16) ``serve_disagg``: the same model, pool and requests cut
   to the first 16, disaggregated: a prefill pool (``prefill_only``, the
   local and fused kernels) exports every session through a TCP blob
   server on 127.0.0.1 started in the process, and a decode pool imports
   them into a store with a disk tier and a remote tier on that server
   (limits set so about 4 sessions stay on the host, 4 spill to disk and
   8 go to the remote tier), async transfers and time slices of 8
   tokens, and decodes them on the paged decode kernel. Gates: every
   request's tokens and logits rows equal run B's bit for bit; spills,
   remote parks and resumes, async parks, exports and imports each ran;
   each prefill, decode step, park, resume, export and import launches
   exactly its kernels (none for the last four); a blob with one payload
   byte flipped is refused with BlobChecksumError at import. Reports park
   p50 as the caller sees it, the background transfer p50, resume p50 by
   tier, bytes per tier and the phase's wall time;
   then (slice 17) ``obs``: the routing-health stats and the obs layer on
   the card. (a) One full-width rt-enwik8 bf16 train step (B 2 x 8192,
   the TrainConfig defaults, remat "full", dropout 0.4) from one state
   and batch with ``RoutingConfig.stats`` off, on and off again: loss,
   every parameter, optimizer moment and centroid of the stats-on step
   equal the stats-off step's bit for bit (held to the control's own
   difference if the two stats-off steps differ), each step launches
   exactly the train path's kernels, the ``routing/*`` scalars lie in
   their ranges and ``rt/{seg}/{layer}/*`` covers all 12 layers; busy ms
   of a profiled step and the step's peak memory, on against off. (b) The
   collapse control: a stats-on forward with every layer's centroids
   equal reads entropy < 0.05 and 31 dead of 32. (c) The engine: 8 of
   `engine_requests`' requests over 8 lanes, chunked prefill, with
   ``obs_jsonl`` and ``routing_stats=True``: tokens and logits rows equal
   a stats-off engine's bit for bit, every line passes
   ``repro_torch.obs.schema``, ``engine_tick`` carries the pages' health,
   launches exact per event. (d) The launcher with ``--obs-jsonl
   --routing-stats --profile-dir`` (rt-enwik8, 3 steps of 2 x 1024): valid
   lines, exact launches, and a Chrome trace naming ``train/grad``,
   ``train/optimizer``, ``kernels/local_attention`` and
   ``kernels/routed_attention_fused``;
   then (slice 18) ``ckpt_dist``: checkpoints, the int8 error-feedback
   gradient exchange and the data-parallel step, on full-width rt-enwik8
   (bf16, B 2 x 8192, the TrainConfig defaults, checkpoints of 1.5 GB in a
   temporary directory, removed afterwards). (a) `Trainer.fit` of 4 steps
   checkpointed every 2 against fit(2) and a fresh Trainer's fit(4) on
   the same directory; (b) a SIGTERM at the end of step 2 from a
   step-function wrapper: the fit returns preempted with a synchronous
   checkpoint at step 2 only, and a fresh Trainer finishes; both equal the
   uninterrupted run bit for bit (a digest of every parameter, optimizer
   and centroid leaf; the step, the loader's cursor, the losses of steps
   3-4), with exact launches per fit; (c) ``int8_ef`` at D = 1 with no
   process group: 2 steps equal the uncompressed Trainer's to the bit,
   every residual zero; (d) ``int8_ef`` over 2 spawned processes on the
   card (gloo, CUDA tensors staged through the host, B 1 x 8192 each, 2
   steps): both ranks' digests equal after each step, on step 1 every
   compressed leaf's applied mean within 0.02 of the exact fp32 mean
   (over its largest value; an extra all-reduce after the step) and every
   residual within half a hop-1 plus n halves of a hop-2 quantization
   step, exact launches in each process, the wire bytes per rank; (e) the
   launcher (``ckpt_launch``, qwen2-0.5b as in 6) with ``--ckpt-dir`` for 2
   steps, then 4: steps 3-4's losses equal an uninterrupted 4-step run's,
   and ``--grad-compression int8_ef`` at D = 1 equals the uncompressed
   run's losses; (d)'s processes run while (e) runs;
   then (slice 19) ``tp``: the model axis, TP_RANKS processes of `tp_rank`
   on the one card (gloo) on a 1 x 2 mesh against 1 x 1 runs in this
   process (`tp_references`). (a) Full-width rt-enwik8 in fp32, B 1 x
   8192, the same state and batch: the gradients (after the model axis's
   reductions, gathered) and one step (the parameters gathered), the
   1 x 1 cluster membership replayed on each rank's routing heads
   (`membership_replayed_heads`): the loss within 1e-5 relative, the
   gradients' median and largest and the parameters' median leaf
   difference within the routing gate's limits. (b) The same model in
   bf16 for TP_STEPS steps: finite losses, equal on the ranks, every
   replicated leaf equal to the bit on both ranks after each step
   (`replicated_digest`), the wall and the bytes through the model group
   per step. (c) (a) with ``RoutingConfig.segments=2`` under
   seq_parallel against segments 2 at 1 x 1 (the fold on the fused
   kernels). (d) qwen2-0.5b in fp32 at the fp32 gate's shape, TP_STEPS
   steps with and without seq_parallel: losses within 1e-4 relative of
   1 x 1. Each rank's launches are exact per part (a step's worth per
   layer as 1 x 1), and every attention call runs half the heads (7 query
   and 1 KV head for qwen2);
9. print the per-kernel JSON line, then the device JSON line last.
   ``--out`` adds torch.profiler breakdowns of one rt-enwik8 prefill,
   decode step and train step, of one qwen2 train step, of one
   rt-cifar10 train step on each of its two kernel paths and of one
   rt-cifar10 prefill and decode step.

``--decode-only`` builds only the decode kernel and runs only
`check_decode_shapes`, `decode_digest` and (without ``--src``)
`check_decode_paper`; with ``--src`` it imports repro_torch from another
checkout, so that tree's decode kernel reads the same inputs.

Exits non-zero without a result when no CUDA device is present, or when
run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
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
# (and in bf16: the tensor-core forward's dh 128 instance)
#
# the three flash kernels in bf16 at the shapes their 128-row tiles make
# ragged, (B, H, Hkv, N, M, dh, causal): N and M of 1, 127, 129 and 200,
# M != N with the causal mask on row indices, causal and not, GQA 2:1 and
# 7:1, dh 64 and 128. With N 127 < M 200 causal, the keys past row 126 are
# seen by no query (their dk and dv are zero)
FLASH_EDGES = tuple(
    (1, H, Hkv, N, M, dh, causal) for dh in (64, 128)
    for H, Hkv, N, M, causal in ((2, 1, 1, 1, True), (14, 2, 127, 129, True),
                                 (7, 1, 200, 127, False),
                                 (4, 2, 129, 200, False),
                                 (2, 1, 127, 200, True),
                                 (14, 2, 200, 1, True)))
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
# the paper's other three models (slice 13), each at full width and depth
# on one sequence or two: rt-pg19 (22 layers, d_model 1032 over 8 heads of
# dh 129, which the local and fused kernels run zero-padded to their dh-192
# instances; 2 routing heads in layers 20-21, k 16, windows 512; Adafactor
# at TrainConfig's "PG19: adafactor 0.01", the other settings at their
# defaults, whose vaswani schedule reads no lr), rt-imagenet64 (24 layers,
# 16 heads of dh 64, windows 2048 over N 12288, k 8, so each routing
# cluster takes 2048 of 12288 tokens: they overlap; Adam at TrainConfig's
# "paper: 2e-4" under the schedule that reads it, linear warm-up then
# constant: at vaswani's peak, 9.9e-4, the first steps from fresh Adam
# moments move every weight by the rate, and its loss only falls from the
# fourth step, PERF.md) and rt-wikitext103 (10 layers, vocab 267735, fp32
# logits of ~4.4 GB a sequence; the defaults); markov batches over min(V,
# 512) tokens, as qwen2's
PG19_ARCH, PG19_BATCH, PG19_SEQ = "rt-pg19", 1, 8192
PG19_TRAIN = dict(optimizer="adafactor", lr=0.01)
IMAGENET_ARCH, IMAGENET_BATCH, IMAGENET_SEQ = "rt-imagenet64", 1, 12288
IMAGENET_TRAIN = dict(schedule="const", lr=2e-4)
WIKITEXT_ARCH, WIKITEXT_BATCH, WIKITEXT_SEQ = "rt-wikitext103", 2, 4096
PAPER_STEPS = 3
# the local and fused kernels in bf16 at the ragged shapes of LOCAL_EDGES
# and FUSED_EDGES, at rt-pg19's head dim (129, run as 192)
PG19_LOCAL_EDGES = ((1, 2, 1, 200, 128, 129, False, False),
                    (1, 2, 2, 129, 63, 129, True, False),
                    (1, 2, 1, 3072, 200, 129, True, True))
PG19_FUSED_EDGES = tuple(
    (1, 2, 3, w, 3 * w + w // 2 + 3, 129, mode) for w in (63, 200)
    for mode in ("shared", "separate", "padded"))
# the gathered kernels in fp32, non-causal, separate keys, padded keys, w
# not a multiple of the tiles: (B, H, k, w, dh)
GATHERED_RAGGED = (1, 2, 8, 200, 64)
# the gathered kernels in bf16 at the w their 128-row blocks and 64- (32-)
# row tiles make ragged, (B, H, k, w, dh, causal, shared): each w and dh
# causal shared-QK (positions from balanced_topk, as the routing layers
# make them), causal separate-QK (cluster 0's keys all after its queries,
# so its queries see no key) and non-causal with padded keys (cluster 0
# all padding). At w 1 every query keeps at most one key, so dq and dk are
# zero in exact arithmetic (`gathered_grad_scales`)
GATHERED_EDGES = tuple(
    (1, 2, 3, w, dh, causal, shared) for w in (1, 63, 129, 200)
    for dh in (64, 128)
    for causal, shared in ((True, True), (True, False), (False, False)))
# the local forward in bf16 at the shapes its 128-row tiles and its window
# make ragged, (B, H, Hkv, N, w, dh, causal, padded): N of 1, 127, 129, 200
# and 3072, w of 63, 128, 200, 256 and 512 (w > N at N 1, 127 and 200),
# causal and not, GQA 2:1, dh 64 and 128. A padded case (`local_pad_mask`)
# ends in a run of padding longer than two windows, so its last rows keep
# no key (out 0, lse NEG + log(1e-30))
LOCAL_EDGES = tuple(
    (1, H, Hkv, N, w, dh, causal, padded) for dh in (64, 128)
    for H, Hkv, N, w, causal, padded in ((2, 1, 1, 63, True, False),
                                         (2, 1, 127, 128, False, False),
                                         (2, 2, 129, 63, True, False),
                                         (4, 2, 200, 256, True, False),
                                         (2, 1, 200, 128, False, False),
                                         (2, 1, 3072, 512, True, False),
                                         (2, 1, 3072, 200, False, False),
                                         (2, 1, 3072, 200, True, True)))
# the fused routing dq and dk/dv in bf16 at the w their 128-row blocks and
# 64- (32-) row tiles make ragged, (B, H, k, w, N, dh, mode): w of 1, 63,
# 129 and 200, with N = k w (every token in one cluster) and N > k w
# (tokens in no cluster, and in several), dh 64 and 128; "shared": causal
# shared-QK, the membership from balanced_topk, as the routing layers make
# it; "separate": causal separate-QK, the keys' own balanced_topk
# membership; "padded": non-causal separate-QK with kvalid, one key in
# seven padding and cluster 0's keys the last w tokens, all padding, so
# its queries keep no key (dq 0) and those keys no query (dk, dv 0)
FUSED_EDGES = tuple(
    (1, 2, 3, w, N, dh, mode) for w in (1, 63, 129, 200)
    for N in (3 * w, 3 * w + w // 2 + 3) for dh in (64, 128)
    for mode in ("shared", "separate", "padded"))
# the paged decode at the shapes the serving paths give it, (name, B, Hr,
# dh, k, cap): rt-enwik8's 4 x (2048 + 32) and 1 x (8192 + 16) (cap =
# max_len / k), rt-cifar10's and the all-routing row's 2 x (1536 + 32 or
# 8) (cap = the window, 512)
DECODE_SHAPES = (("rt-enwik8 4x2048", 4, 4, 128, 32, 65),
                 ("rt-enwik8 1x8192", 1, 4, 128, 32, 256),
                 ("rt-cifar10 2x1536", 2, 4, 64, 6, 512),
                 ("all-routing 2x1536", 2, 8, 64, 6, 512))
# and at caps its split over a cluster's CTAs and its chunks make ragged,
# (B, Hr, dh, k, cap): caps of 1, 31, 33, 65, 512 and 1000, none a
# multiple of the ranks times the chunk rows, dh 64 and 128; head h reads
# a page of kind h (`decode_pages`: empty, one slot, partly full, exactly
# full, wrapped), batch row 0 page 0 and batch row 1 page k - 1
DECODE_EDGES = tuple((2, 5, dh, 3, cap) for cap in (1, 31, 33, 65, 512, 1000)
                     for dh in (64, 128))
# since slice 14 the paged decode also at the shapes the paper's other
# models' serving paths give it: rt-pg19's 1 x (8192 + 16) (2 routing heads
# of dh 129, which the wrapper runs at the dh-192 instance over pages
# stored 192 wide; cap = max_len / k) and rt-imagenet64's 1 x (6144 + 16)
# (8 routing heads, cap = the window, 2048); and at the DECODE_EDGES caps
# at dh 129, with the page kinds of `decode_pages`
PAPER_DECODE_SHAPES = (("rt-pg19 1x8192", 1, 2, 129, 16, 513),
                       ("rt-imagenet64 1x6144", 1, 8, 64, 8, 2048))
PG19_DECODE_EDGES = tuple((2, 5, 129, 3, cap)
                          for cap in (1, 31, 33, 65, 512, 1000))
# since slice 14 the paper's other three models and qwen2-0.5b served at
# full width and depth (random weights from seed 0, bf16; their fp32 gates
# at the same size), path -> (arch, (batch, prompt, new tokens)): rt-pg19
# at its 8192-token context, rt-imagenet64 at half an image (6144 of its
# 12288 bytes), rt-wikitext103 and qwen2 at two 2048-token prompts
SERVE_PAPER = {
    "serve_pg19": (PG19_ARCH, (1, 8192, 16)),
    "serve_imagenet64": (IMAGENET_ARCH, (1, 6144, 16)),
    "serve_wikitext103": (WIKITEXT_ARCH, (2, 2048, 16)),
}
SERVE_FULL = ("serve_full", FULL_ARCH, (2, 2048, 32))
# since slice 15: the continuous-batching engine (`serve_engine`) serves
# full-width rt-enwik8 in bf16 from a pool of 8 lanes of 4096 tokens (cluster
# pages of cap 4096 / k = 128): 24 requests from seed 12, prompts of 512 to
# 3072 tokens, 16 to 64 new tokens, two arrivals per engine step, odd uids
# sampled, one interactive-class arrival while every slot is busy, the last
# four repeating the first four prompts; run A with chunked prefill, time
# slices and a prefix cache, run B with none of them and its free slots
# taken in reverse order
ENGINE_SLOTS = 8
ENGINE_MAX_LEN = 4096
ENGINE_PROMPTS = (512, 1024, 2048, 3072)
ENGINE_REQUESTS = 24
ENGINE_NEW_TOKENS = (16, 64)
ENGINE_REPEATS = 4
ENGINE_INTERACTIVE = 17            # its uid: arrives at step 8
ENGINE_SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95, seed=12)
ENGINE_RUN_A = dict(chunked_prefill=2, time_slice=8)
ENGINE_PROFILE_STEP = 40           # the engine step profiled in run A
# the poisoned-lane control: a greedy 2048-token request of the workload,
# parked after this many tokens and cut at ENGINE_CONTROL_TOKENS
ENGINE_CONTROL_UID = 2
ENGINE_CONTROL_PARK_AT = 4
ENGINE_CONTROL_TOKENS = 8
# the fp32 engine gate: requests, prompt, greedy tokens
ENGINE_GATE = (4, 1024, 8)
# since slice 16: the disaggregated pools (`serve_disagg`) take the first
# DISAGG_REQUESTS of the `serve_engine` workload; at import the decode
# pool's host tier holds the last DISAGG_HOST sessions, its disk tier the
# DISAGG_DISK before them and the remote tier the rest
DISAGG_REQUESTS = 16
DISAGG_HOST = 4
DISAGG_DISK = 4
DISAGG_TIME_SLICE = 8
# since slice 17: the `obs` phase serves the first OBS_REQUESTS of the
# `serve_engine` workload with chunked prefill, and runs the launcher with
# the observability flags for OBS_LAUNCH_ARGV
OBS_REQUESTS = 8
OBS_ENGINE = dict(chunked_prefill=2)
OBS_LAUNCH_ARGV = ["--arch", "rt-enwik8", "--steps", "3", "--batch", "2",
                   "--seq", "1024", "--routing-stats"]
OBS_TRACE_SPANS = ("train/grad", "train/optimizer", "kernels/local_attention",
                   "kernels/routed_attention_fused")
# the collapse control: every centroid of a layer equal sends each token to
# centroid 0 (argmax takes the first of equal scores)
OBS_COLLAPSE_ENTROPY = 0.05
# the spans the train step and the kernel wrappers open (slice 17): the
# profiler lists each as a device event holding the device time beneath it
PORT_SPANS = ("train/", "kernels/")
# slice 18: checkpoints and the data-parallel step on rt-enwik8's train
# shape. (a) an uninterrupted Trainer.fit of CKPT_STEPS checkpointed every
# CKPT_EVERY steps against one stopped at CKPT_STOP and resumed; (b) a
# SIGTERM at the end of step CKPT_STOP; (c) int8_ef at D = 1 for CKPT_STOP
# steps; (d) int8_ef over DIST_RANKS processes on the one card (gloo,
# DIST_ROWS rows each) for DIST_STEPS steps; (e) the launcher with
# --ckpt-dir for CKPT_STOP, then CKPT_STEPS steps
CKPT_STEPS, CKPT_STOP, CKPT_EVERY = 4, 2, 2
DIST_RANKS, DIST_ROWS, DIST_STEPS = 2, 1, 2
DIST_TIMEOUT_S = 600
# slice 19: the model axis. TP_RANKS processes on the one card (gloo, CUDA
# tensors staged through the host: NCCL refuses two ranks on one card) on
# a 1 x TP_RANKS mesh: (a) full-width rt-enwik8 in fp32, B 1 x TRAIN_SEQ,
# the gradients and one step against the 1 x 1 step in this process, the
# 1 x 1 cluster membership replayed on each rank's routing heads; (b) the
# same model in bf16 for TP_STEPS steps; (c) RoutingConfig.segments =
# TP_RANKS under seq_parallel against segments = TP_RANKS at 1 x 1; (d)
# qwen2-0.5b in fp32, B FULL_GATE_BATCH x FULL_GATE_SEQ, TP_STEPS steps
# with and without seq_parallel against 1 x 1
TP_RANKS, TP_STEPS = 2, 2
TP_TIMEOUT_S = 900
# (a), (c): the loss within this relative difference of the 1 x 1 step's
# (only the order of fp32 sums differs); the gradients' median and largest
# leaf difference and the parameters' median within the routing gate's
# limits (ENWIK8_LIMITS: grad_median, bwd_max). The membership is pinned,
# but a relu whose input sits at zero within rounding can still take the
# other side in one of the two runs: the gradients then differ by ~1e-4
# (PERF.md), as the routing gate's do. A parameter's largest difference is
# reported, not gated: Adam's first step moves an element by lr times the
# sign of its gradient, so a zero-initialised bias whose gradient element
# changes sign differs by 2 lr
TP_LOSS_REL_TOL = 1e-5
# (d): each step's loss within this relative difference of 1 x 1's
TP_FULL_LOSS_REL_TOL = 1e-4
# the JAX package's bound on the int8 mean (tests/test_dist.py): largest
# difference from the exact fp32 mean over the exact mean's largest value
DIST_MEAN_REL_TOL = 0.02
# fp32 rounding of q * scale beside the half-step bound on a residual
DIST_RESIDUAL_SLACK = 1e-4
# kernel vs plain (fp32 on the same bf16 inputs): the kernel rounds its
# output to bf16 (half an ulp: 2^-9 of the value) and sums in another fp32
# order, so outputs may differ by 2^-7 of the largest reference value (two
# bf16 ulps at the top of the range); the fp32 lse by 1e-4 absolute
OUT_REL_TOL = 2.0 ** -7
LSE_TOL = 1e-4
# the flash, local and gathered forwards also row by row: |out - ref| /
# |ref| over each query row's head dim (2-norms) in every row (a row that
# keeps no key is zero in the reference, so it must be zero in the kernel:
# the denominator is clamped at 1e-30). OUT_REL_TOL is set by the largest
# output, which an early row (few keys) holds; a late row averages
# thousands of keys, its values are far smaller, and a fault in its P V (a
# value tile left out or misplaced) can stay under that limit while it
# moves the row by ~10%. Rounding P and the output to bf16 costs ~2^-9 of
# a row; SDPA, which rounds the same, is read beside each bf16 row
ROW_REL_TOL = 2.0 ** -7
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
# a full-attention model served in fp32 (qwen2-0.5b, since slice 14): each
# decode step's logits against the prefill logits of prompt + tokens
# (teacher forcing), as the JAX package's tests hold decode to the forward.
# Both run full/torch (no routing to flip); only the order of fp32 sums
# differs between a one-token query over the cache and the prompt's
# chunked prefill, so the median's limit is a tenth of the routing paths'
MAX_MEDIAN_DIFF_FULL_FP32 = 1e-3
# backward kernels vs their plain versions (fp32 outputs of both, on the
# same bf16 inputs and the same lse and D): only the order of fp32 sums
# differs, so a tenth of a percent of the largest reference value
BWD_REL_TOL = 1e-3
# the flash backward also row by row (`grad_row_errs`): |d - ref| / |ref|
# over each query row of dq and each key row of dk and dv (2-norms over the
# head dim). BWD_REL_TOL is set by the largest value, which an early row
# holds; under causality a late key row's dk and dv sum a few P ~ 1/N terms
# and read ~1e-4..1e-5 of it, so a fault there (the last key row left
# unwritten, a wrong diagonal mask, a stale query tile) can stay under that
# limit while it moves the row by ~100%. P and dS as hi + lo bf16 pairs
# read ~6e-6 a row in fp32 sums (tests/test_torch_flash_bwd_split.py) and
# up to ~2.5e-5 with the tensor cores' own accumulation on the card; one
# bf16 value each, as SDPA rounds them, 3-4.5e-3 (SDPA is read beside each
# bf16 row)
BWD_ROW_REL_TOL = 1e-3
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
# rt-pg19's gate (B 1 x 8192, fp32, dh 129 through the dh-192 kernels): its
# pinned median reads 5.0e-5, the key side dropped 1.24e-3 (only layers
# 20-21 route, 2 heads of 8), under rt-enwik8's 2.5e-3; so the median's
# limit sits at their geometric mean, ~5x from each, as rt-cifar10's does;
# the others as rt-enwik8's (readings in PERF.md; H100 80GB HBM3, 700 W)
PG19_LIMITS = dict(ENWIK8_LIMITS, grad_median=2.5e-4)
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
# bf16 train step of qwen2-0.5b (dropout 0, the same bf16 weights): the
# kernel path and, as the yardstick, the plain path with SDPA in place of
# the flash kernels, each against the plain path. The three round
# differently in bf16 (the plain path rounds the logits too, the
# tensor-core forward and SDPA round P), so the kernel path's median leaf
# gradient difference may be at most this factor times SDPA's, the
# negative control must exceed that limit, and the kernel path must repeat
# itself exactly (no atomics on it)
BF16_GATE_FACTOR = 1.25

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
# since slice 13 the local and fused kernels also train the paper's other
# three models ("train_pg19", "train_imagenet64", "train_wikitext103")
_PAPER = ("train_pg19", "train_imagenet64", "train_wikitext103")
# and since slice 14 the local and fused kernels prefill, and the decode
# kernel decodes, those three models' serving paths (qwen2-0.5b's,
# "serve_full", runs no kernel: full/torch, as the JAX package's full/xla);
# since slice 15 the three also run under the continuous-batching engine
# ("serve_engine"), and since slice 16 under its disaggregated prefill and
# decode pools ("serve_disagg"); since slice 17 rt-enwik8's train step,
# a forward, the engine and the launcher run them with the routing-health
# stats and the obs layer on ("obs"); since slice 18 its Trainer resumes
# from checkpoints and its steps exchange int8 gradients, in this process
# and in DIST_RANKS spawned ones ("ckpt_dist"), and the launcher resumes
# qwen2-0.5b from its checkpoints ("ckpt_launch"); since slice 19 the
# local, fused and flash kernels run on each tensor-parallel rank's heads
# ("tp")
_SERVE_PAPER = tuple(SERVE_PAPER)
_ENGINE = ("serve_engine", "serve_disagg", "obs")
_LOCAL_FWD = ("serve", "train", "serve_cifar", "train_cifar",
              "train_gathered", "fit_gathered", *_PAPER, *_SERVE_PAPER,
              *_ENGINE, "ckpt_dist", "tp")
_LOCAL_BWD = ("train", "train_cifar", "train_gathered", "fit_gathered",
              *_PAPER, "obs", "ckpt_dist", "tp")
_FLASH = ("train_full", "launch", "ckpt_launch", "tp")
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
               "serve_routing", *_PAPER, *_SERVE_PAPER, *_ENGINE,
               "ckpt_dist", "tp")),
    "routing_decode": dict(
        route="cuda", source="src/repro_torch/csrc/routing_decode.cu",
        replaces="src/repro/kernels/routing_decode.py:59",
        kind="decode", layers="routing",
        paths=("serve", "serve_cifar", "serve_routing", *_SERVE_PAPER,
               *_ENGINE)),
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
        kind="backward", layers="routing",
        paths=("train", "train_cifar", *_PAPER, "obs", "ckpt_dist", "tp")),
    "routing_fused_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/routing_fused_bwd.cu",
        replaces="src/repro/kernels/routing_attention.py:411",
        kind="backward", layers="routing",
        paths=("train", "train_cifar", *_PAPER, "obs", "ckpt_dist", "tp")),
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
    and dk/dv tiles (their backward kernels); the decode kernel takes none
    since slice 12 (its ring of chunks is static: its ptxas line)."""
    import ctypes
    from repro_torch.kernels import common
    fwd = common.load("flash_attention", "forward_tile_smem_bytes",
                      [ctypes.c_int])
    bwd = common.load("flash_attention_bwd", "backward_tile_smem_bytes",
                      [ctypes.c_int, ctypes.c_int])
    for dh in (64, 128):
        print(f"  dynamic smem per block, dh {dh}: forward tile {fwd(dh)} "
              f"B, dq tile {bwd(dh, 0)} B, dk/dv tile {bwd(dh, 1)} B; "
              f"decode none")
    # the bf16 flash kernels run on the tensor cores with tiles of their own
    fwd_tc = common.load("flash_attention", "flash_fwd_wgmma_smem_bytes",
                         [ctypes.c_int])
    bwd_tc = common.load("flash_attention_bwd", "flash_bwd_wgmma_smem_bytes",
                         [ctypes.c_int, ctypes.c_int])
    for dh in (64, 128):
        print(f"  dynamic smem per block, dh {dh}: bf16 flash (wgmma + TMA) "
              f"forward {fwd_tc(dh)} B, dq {bwd_tc(dh, 0)} B, dk/dv "
              f"{bwd_tc(dh, 1)} B")
    # the bf16 local and gathered forwards run the flash forward's body: the
    # same dynamic tiles; their static shared memory (the staged pad mask or
    # positions) is in their ptxas lines
    for dh in (64, 128):
        print(f"  dynamic smem per block, dh {dh}: bf16 local and gathered "
              f"forward (wgmma + TMA) {fwd_tc(dh)} B")
    # the bf16 gathered backward runs the flash backward's bodies: the same
    # dynamic tiles; its static shared memory (the staged positions) is in
    # its ptxas line
    for dh in (64, 128):
        print(f"  dynamic smem per block, dh {dh}: bf16 gathered backward "
              f"(wgmma + TMA) dq {bwd_tc(dh, 0)} B, dk/dv {bwd_tc(dh, 1)} B")
    # the bf16 fused routing backward gathers its rows by cp.async into the
    # same tiles (its mbarriers unused)
    for dh in (64, 128):
        print(f"  dynamic smem per block, dh {dh}: bf16 fused routing "
              f"backward (wgmma, cp.async) dq {bwd_tc(dh, 0)} B, dk/dv "
              f"{bwd_tc(dh, 1)} B")


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


def graph_ms(torch, fn, iters: int = 20) -> float:
    """The time of one call of ``fn`` without the host between launches:
    ``iters`` calls captured in a CUDA graph, replayed. A kernel whose
    wrapper takes longer on the host than the kernel on the card reads
    the host's time in `time_ms`; context, never a limit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5) / iters


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
def local_mask(torch, N, w, causal=True, pad=None):
    """The dense bool mask of local attention, (N, N), or (B, 1, N, N) with
    a (B, N) key pad mask: key j of query i's block or the one before (also
    the one after when not causal; w cut to N, as the wrapper cuts it),
    j <= i when causal, j not padding."""
    w = min(w, N)
    i = torch.arange(N, device=DEVICE)
    lo = ((i // w - 1) * w).clamp_min(0)
    hi = i if causal else ((i // w + 2) * w).clamp_max(N) - 1
    mask = (i[None, :] <= hi[:, None]) & (i[None, :] >= lo[:, None])
    return mask if pad is None else mask & pad[:, None, None, :]


def local_pad_mask(torch, B, N, gen):
    """A (B, N) key pad mask: about one key in seven padding, and the last
    sixth of the sequence all padding (at N 3072 and w 200 the rows from
    2800 on keep no key)."""
    pad = torch.rand((B, N), generator=gen, device=DEVICE) >= 1 / 7
    pad[:, N - N // 6:] = False
    return pad


def err64(a, ref64) -> dict:
    """|a - ref64| over the largest |ref64|, and row by row (2-norms over
    the last dim; a reference row of zeros must be zeros), in fp64."""
    d = a.double() - ref64
    return dict(rel=float(d.abs().max() / ref64.abs().max()),
                rows=float((d.norm(dim=-1)
                            / ref64.norm(dim=-1).clamp_min(1e-30)).max()))


def fwd_fp64_errs(out, ref_out, ref64) -> dict:
    """The kernel's output and the fp32 plain version's against the plain
    version run in fp64 on the same inputs, over the largest fp64 value and
    row by row: whether the kernel's distance from the fp32 plain version
    is its own; context, never a limit."""
    k, p = err64(out, ref64), err64(ref_out, ref64)
    return dict(kernel_vs_fp64=k["rel"], kernel_vs_fp64_rows=k["rows"],
                plain_vs_fp64=p["rel"], plain_vs_fp64_rows=p["rows"])


def check_local(torch, cfg, B, N, gen, heads=None, dtype=None):
    """The local forward at one causal shape (``heads``, default half the
    model's heads, as rt-enwik8's local+routing layers run it): against
    its plain version in fp32 on the same inputs, the largest value
    (OUT_REL_TOL), every row (ROW_REL_TOL) and lse (LSE_TOL); timed beside
    the plain version, SDPA with the dense bool mask and, in a CUDA graph,
    itself (`graph_ms`). Batch 0 is also read against fp64, and SDPA's own
    errors against the fp32 reference (bf16; context). ``dtype`` of the
    inputs: bf16 unless given."""
    from repro_torch.kernels import local_attention as K
    dh, w = cfg.head_dim_, cfg.routing.local_window
    H = heads or cfg.num_heads // 2
    q, k, v = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                           dtype=dtype or torch.bfloat16) for _ in range(3))
    out, lse = K.local_attention(q, k, v, w)
    torch.cuda.synchronize()
    ref_out, ref_lse = K.local_attention_plain(q.float(), k.float(),
                                               v.float(), w)
    err, lerr = max_err(out, ref_out), max_err(lse, ref_lse)
    row_err = row_rel_err(out, ref_out)
    if not (out_ok(out, ref_out) and lerr <= LSE_TOL
            and row_err <= ROW_REL_TOL):
        raise AssertionError(f"local_attention disagrees with its plain "
                             f"version: out {err}, lse {lerr}, row "
                             f"{row_err}")
    mask = local_mask(torch, N, w)
    ref64, _ = K.local_attention_plain(q[:1].double(), k[:1].double(),
                                       v[:1].double(), w)
    readings = dict(out_rel_err=rel_err(out, ref_out), row_rel_err=row_err,
                    **fwd_fp64_errs(out[:1], ref_out[:1], ref64),
                    **sdpa_out_errs(torch, q, k, v, ref_out, mask=mask))
    del ref_out, ref_lse, ref64
    pairs = local_pairs(torch, B, H, N, w)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b_ms, b_by = bound_ms(nbytes(q, k, v, out, lse), 4 * dh * pairs)
    ms = time_ms(lambda: K.local_attention(q, k, v, w))
    return dict(
        max_abs_err=err, lse_err=lerr, ms=ms,
        plain_ms=time_ms(lambda: K.local_attention_plain(q, k, v, w)),
        library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
        graph_ms=graph_ms(torch, lambda: K.local_attention(q, k, v, w)),
        shape=f"B{B} H{H} N{N} dh{dh} w{w}", **readings)


def check_local_edges(torch, gen, edges=None) -> list:
    """The local forward in bf16 at LOCAL_EDGES, each against its plain
    version in fp32 on the same inputs: out within OUT_REL_TOL of its
    largest reference value and within ROW_REL_TOL in every row (rows that
    keep no key zero), lse within LSE_TOL. SDPA's own errors and the fp64
    readings are reported beside each row."""
    from repro_torch.kernels import local_attention as K
    rows = []
    for B, H, Hkv, N, w, dh, causal, padded in edges or LOCAL_EDGES:
        mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
        q = torch.randn((B, H, N, dh), **mk)
        k, v = (torch.randn((B, Hkv, N, dh), **mk) for _ in range(2))
        pad = local_pad_mask(torch, B, N, gen) if padded else None
        out, lse = K.local_attention(q, k, v, w, causal, pad)
        torch.cuda.synchronize()
        ref_out, ref_lse = K.local_attention_plain(
            q.float(), k.float(), v.float(), w, causal, pad)
        ref64, _ = K.local_attention_plain(q.double(), k.double(),
                                           v.double(), w, causal, pad)
        mask = local_mask(torch, N, w, causal, pad)
        row = dict(shape=(f"B{B} H{H} Hkv{Hkv} N{N} w{w} dh{dh} "
                          f"{'causal' if causal else 'full'}"
                          f"{' padded' if padded else ''}"),
                   out_rel_err=rel_err(out, ref_out),
                   row_rel_err=row_rel_err(out, ref_out),
                   lse_err=max_err(lse, ref_lse),
                   no_key_rows=int((~mask.any(-1)).sum()) * H,
                   **fwd_fp64_errs(out, ref_out, ref64),
                   **sdpa_out_errs(torch, q, k, v, ref_out, mask=mask))
        rows.append(row)
        if not (row["out_rel_err"] <= OUT_REL_TOL
                and row["row_rel_err"] <= ROW_REL_TOL
                and row["lse_err"] <= LSE_TOL):
            raise AssertionError(f"local_attention disagrees with its plain "
                                 f"version at a ragged shape: {row}")
    return rows


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


def decode_pages(cap) -> tuple:
    """rlen of the page kinds a `DECODE_EDGES` reading's heads read: empty,
    one slot, partly full, exactly full, wrapped (rlen past cap)."""
    return (0, 1, max(1, cap // 2), cap, 3 * cap + 2)


def decode_inputs(torch, B, Hr, dh, kc, cap, dtype, gen, pages=None):
    """One decode call's inputs in ``dtype``. r and the page keys are
    routing vectors (norm sqrt(dh), as `normalize_routing` makes them),
    each key r's own direction plus noise of a size drawn per slot, so the
    page's logits spread below the self logit and every slot counts (a
    cluster's members resemble its token); values N(0, 1). rlen from [0,
    2 cap) and cluster ids at random; with ``pages`` (`decode_pages`), head
    h reads a page of kind h, batch row 0 page 0 and the others page
    k - 1."""
    from repro_torch.core.kmeans import normalize_routing
    f = dict(generator=gen, device=DEVICE)
    r = normalize_routing(torch.randn((B, Hr, dh), **f))
    spread = torch.rand((B, Hr, kc, cap, 1), **f) * 2.5 + 0.5
    rk = normalize_routing(r[:, :, None, None] + spread * torch.randn(
        (B, Hr, kc, cap, dh), **f))
    v_new = torch.randn((B, Hr, dh), **f)
    rv = torch.randn((B, Hr, kc, cap, dh), **f)
    rlen = torch.randint(0, 2 * cap, (B, Hr, kc), dtype=torch.int32, **f)
    cluster = torch.randint(0, kc, (B, Hr), dtype=torch.int32, **f)
    if pages is not None:
        cluster[0], cluster[1:] = 0, kc - 1
        kinds = torch.tensor(pages, dtype=torch.int32, device=DEVICE)
        rlen.scatter_(2, cluster.long()[..., None], kinds[
            torch.arange(Hr, device=DEVICE) % len(pages)].expand(B, Hr)[
                ..., None])
    return (*(t.to(dtype) for t in (r, v_new, rk, rv)), rlen, cluster)


def decode_row_errs(out, ref) -> list:
    """The decode's output (B, Hr, dh) against its plain version's, each
    (b, h) row held to its own largest value: max |out - ref| / max |ref|
    over the row's dh values, row by row. The largest value of the whole
    output (`out_ok`) lets a row whose values are small go wrong by far
    more than its own size."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    return (err / ref.abs().amax(-1).clamp_min(1e-30)).flatten().tolist()


def cold_ms(torch, fn, iters: int = 20) -> float:
    """The median time of one call of ``fn`` after a 64 MB write has
    flushed the 50 MB L2, as a serving step may find its page cold: CUDA
    events around each call, the card held busy (`torch.cuda._sleep`)
    while the host enqueues it, so the events bracket the kernel and not
    the wrapper's host time."""
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    events = []
    for _ in range(iters + 2):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events[2:])


def _decode_reading(torch, K, shape, B, Hr, dh, kc, cap, dtype, gen,
                    pages=None, width=None, plain=False):
    """One `check_decode_shapes` reading: the kernel against its plain
    version in fp32 on the same inputs, row by row, and its exact cases.
    With a ``width`` past dh (rt-pg19's 129 at the kernel's 192,
    `page_width`) the pages are stored that wide, their pad columns zero,
    as the cache stores them; the bound is counted at dh, and at the
    stored width beside it. With ``plain`` also the plain version's time
    on the same inputs (`time_ms`)."""
    args = decode_inputs(torch, B, Hr, dh, kc, cap, dtype, gen, pages)
    width = width or dh
    if width != dh:
        pad = lambda t: torch.nn.functional.pad(t, (0, width - dh))  # noqa
        args = (*args[:2], pad(args[2]), pad(args[3]), *args[4:])
    r, v_new, rk, rv, rlen, cluster = args
    out = K.paged_routing_decode(*args)
    torch.cuda.synchronize()
    ref = K.paged_routing_decode_plain(*(t.float() for t in args[:4]), rlen,
                                       cluster)
    nvalid = torch.gather(rlen, 2, cluster.long()[..., None])[..., 0].clamp(
        0, cap)
    empty = nvalid == 0
    # the selected pages' slots at or past nvalid, poisoned
    past = (torch.arange(kc, device=DEVICE) == cluster[..., None])[..., None] \
        & (torch.arange(cap, device=DEVICE) >= nvalid[..., None, None])
    poisoned = K.paged_routing_decode(
        r, v_new, rk.masked_fill(past[..., None], 1e4),
        rv.masked_fill(past[..., None], 1e4), rlen, cluster)
    again = K.paged_routing_decode(*args)
    slots = float(nvalid.sum())
    b_ms, b_by = bound_ms(
        nbytes(r, v_new, out, cluster) + 2 * slots * dh * r.element_size()
        + 4 * B * Hr, 4 * dh * (slots + B * Hr))
    call = lambda: K.paged_routing_decode(*args)  # noqa: E731
    g_ms = graph_ms(torch, call)
    spare = torch.empty_like(v_new)
    stored = {}
    if width != dh:
        s_ms, s_by = bound_ms(
            nbytes(r, v_new, out, cluster) + 2 * slots * width
            * r.element_size() + 4 * B * Hr, 4 * width * (slots + B * Hr))
        stored = dict(stored_width=width, stored_bound_ms=s_ms,
                      stored_bound_by=s_by, stored_bound_share=s_ms / g_ms)
    if plain:
        stored["plain_ms"] = time_ms(
            lambda: K.paged_routing_decode_plain(*args))
    return dict(
        shape=f"{shape} B{B} Hr{Hr} dh{dh} k{kc} cap{cap} "
              f"{str(dtype).split('.')[-1]}",
        max_abs_err=max_err(out, ref), out_rel_err=rel_err(out, ref),
        row_err=max(decode_row_errs(out, ref)), slots=slots,
        empty_rows=int(empty.sum()),
        empty_exact=bool(out[empty].equal(v_new[empty])),
        poison_exact=bool(poisoned.equal(out)),
        repeat_exact=bool(again.equal(out)),
        graph_ms=g_ms, cold_ms=cold_ms(torch, call), bound_ms=b_ms,
        bound_by=b_by, bound_share=b_ms / g_ms,
        copy_graph_ms=graph_ms(torch, lambda: spare.copy_(v_new)), **stored)


def check_decode_shapes(torch, gen) -> dict:
    """The paged decode in bf16 and fp32 at `DECODE_SHAPES` and
    `DECODE_EDGES` (inputs from ``gen``, `decode_inputs`), against its
    plain version in fp32 on the same inputs: every (b, h) row within
    ROW_REL_TOL of its own largest value (`decode_row_errs`), a page with
    no occupied slot giving v_new bit for bit, the same bits with the
    selected pages' slots at or past nvalid poisoned (1e4) and in a second
    run. Each reading's `graph_ms` (L2 warm) and `cold_ms` (L2 flushed
    before each call) beside its bound (each input byte that the call
    needs read once, the output written once) and, as the floor a launch
    sets in a graph, the `graph_ms` of one copy of v_new (`copy_graph_ms`;
    a yardstick, never a limit). Prints the readings."""
    from repro_torch.kernels import routing_decode as K
    res = dict(shapes=[], edges=[])
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, Hr, dh, kc, cap in DECODE_SHAPES:
            res["shapes"].append(_decode_reading(torch, K, name, B, Hr, dh,
                                                 kc, cap, dtype, gen))
        for B, Hr, dh, kc, cap in DECODE_EDGES:
            res["edges"].append(_decode_reading(
                torch, K, "edge", B, Hr, dh, kc, cap, dtype, gen,
                decode_pages(cap)))
    _decode_gates(res)
    for key in ("shapes", "edges"):
        print(f"decode {key} {json.dumps(res[key])}", flush=True)
    return res


def _decode_gates(res):
    """`check_decode_shapes`' gates on the readings ``res`` (shapes,
    edges)."""
    for row in res["shapes"] + res["edges"]:
        if not (row["row_err"] <= ROW_REL_TOL and row["empty_exact"]
                and row["poison_exact"] and row["repeat_exact"]):
            raise AssertionError(f"routing_decode disagrees with its plain "
                                 f"version or with itself: {row}")
    if not all(row["empty_rows"] for row in res["edges"]):
        raise AssertionError("a DECODE_EDGES reading has no empty page")


def check_decode_paper(torch, gen) -> dict:
    """The paged decode in bf16 and fp32 at `PAPER_DECODE_SHAPES` (rt-pg19's
    dh 129 through the dh-192 instance, rt-imagenet64's cap 2048) and
    `PG19_DECODE_EDGES`, through `check_decode_shapes`' readings and gates
    (inputs from ``gen``), at the two shapes also the plain version's time.
    Prints the readings."""
    from repro_torch.kernels import routing_decode as K
    res = dict(shapes=[], edges=[])
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, Hr, dh, kc, cap in PAPER_DECODE_SHAPES:
            res["shapes"].append(_decode_reading(
                torch, K, name, B, Hr, dh, kc, cap, dtype, gen,
                width=K.page_width(dh), plain=True))
        for B, Hr, dh, kc, cap in PG19_DECODE_EDGES:
            res["edges"].append(_decode_reading(
                torch, K, "edge", B, Hr, dh, kc, cap, dtype, gen,
                decode_pages(cap), K.page_width(dh)))
    _decode_gates(res)
    for key in ("shapes", "edges"):
        print(f"paper decode {key} {json.dumps(res[key])}", flush=True)
    return res


def decode_digest(torch) -> str:
    """A sha256 of the paged decode's outputs in bf16 and fp32 at
    `DECODE_SHAPES` and `DECODE_EDGES` (head dims 64 and 128), on inputs
    from a generator of its own (seed 11, `decode_inputs`): two builds of
    the kernel that compute the same bits there give the same digest."""
    import hashlib
    from repro_torch.kernels import routing_decode as K
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    h = hashlib.sha256()
    for dtype in (torch.bfloat16, torch.float32):
        for (_, B, Hr, dh, kc, cap), pages in (
                *((s, None) for s in DECODE_SHAPES),
                *((("edge", *e), decode_pages(e[-1])) for e in DECODE_EDGES)):
            args = decode_inputs(torch, B, Hr, dh, kc, cap, dtype, gen, pages)
            out = K.paged_routing_decode(*args)
            h.update(out.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()


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


def check_local_bwd(torch, cfg, B, N, gen, heads=None, dtype=None):
    """The local dq and dk/dv kernels at one causal train shape
    (``heads``, default half the model's heads, as rt-enwik8's
    local+routing layers run them), each against its plain
    version in fp32 on the same inputs: the largest value (BWD_REL_TOL) and
    every row under the window mask (`local_grad_row_errs`,
    BWD_ROW_REL_TOL); timed beside the plain versions, SDPA's backward with
    the dense bool mask (dq, dk and dv in one call) and, in a CUDA graph,
    themselves (`graph_ms`). SDPA's own errors and batch 0's readings
    against fp64 are reported beside them (context). ``dtype`` of the
    inputs: bf16 unless given."""
    from repro_torch.core import local as ref
    from repro_torch.kernels import local_attention as K
    dh, w = cfg.head_dim_, cfg.routing.local_window
    H = heads or cfg.num_heads // 2
    q, k, v, do = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                               dtype=dtype or torch.bfloat16)
                   for _ in range(4))
    out, lse = K.local_attention(q, k, v, w)
    dsum = K.row_dot(do, out)
    args = (q, k, v, do, lse, dsum, w)
    args32 = (q.float(), k.float(), v.float(), do.float(), lse, dsum, w)
    dq = K.local_attention_bwd_dq(*args)
    dk, dv = K.local_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    ref_dq = ref.local_attention_bwd_dq(*args32)
    ref_dk, ref_dv = ref.local_attention_bwd_dkv(*args32)
    mask = local_mask(torch, N, w)
    grads, refs = (dq, dk, dv), (ref_dq, ref_dk, ref_dv)
    grad_row = local_grad_row_errs(grads, refs, mask)
    if max(grad_row) > BWD_ROW_REL_TOL:
        raise AssertionError(f"a local backward kernel disagrees with its "
                             f"plain version in a row: {grad_row}")
    report = dict(
        grad_rel_err=[rel_err(g, r) for g, r in zip(grads, refs)],
        grad_row_rel_err=grad_row,
        **local_sdpa_grad_errs(torch, q, k, v, do, refs, mask),
        **local_fp64_grad_errs(
            lambda *a: (ref.local_attention_bwd_dq(*a),
                        *ref.local_attention_bwd_dkv(*a)),
            args, grads, refs, mask))
    # library: the backward of SDPA with the dense bool mask (all of dq,
    # dk, dv), timed only
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do,
                                                 retain_graph=True))
    del o
    pairs = local_pairs(torch, B, H, N, w)
    rows = _bwd_rows(
        ("local_attention_bwd_dq", "local_attention_bwd_dkv"),
        ((dq,), (dk, dv)), ((ref_dq,), (ref_dk, ref_dv)),
        (lambda: K.local_attention_bwd_dq(*args),
         lambda: K.local_attention_bwd_dkv(*args)),
        (lambda: ref.local_attention_bwd_dq(*args),
         lambda: ref.local_attention_bwd_dkv(*args)),
        lib_ms, nbytes(q, k, v, do, lse, dsum),
        ((nbytes(dq), 6 * dh * pairs), (nbytes(dk, dv), 8 * dh * pairs)),
        f"B{B} H{H} N{N} dh{dh} w{w}")
    for name, part, fn in (
            ("local_attention_bwd_dq", slice(0, 1),
             lambda: K.local_attention_bwd_dq(*args)),
            ("local_attention_bwd_dkv", slice(1, 3),
             lambda: K.local_attention_bwd_dkv(*args))):
        rows[name].update({key: val[part] for key, val in report.items()})
        rows[name]["graph_ms"] = graph_ms(torch, fn)
        rows[name]["bound_share"] = rows[name]["bound_ms"] / rows[name][
            "graph_ms"]
    return rows


def local_zero_rows(mask):
    """The rows of the local backward whose gradient is zero in exact
    arithmetic but not by construction: dq of a query row that keeps one
    key (a softmax over one key has no gradient), dk of a key row that some
    query keeps and whose every keeping query keeps only it; each (N,) or
    (B, 1, N) bool over the (N, N) or (B, 1, N, N) ``mask`` of
    `local_mask`. The rows that are zero by construction are not among
    them: dq of a row that keeps no key, dk and dv of a key that no query
    keeps (a padded key), which the kernels write as zeros (p is dropped
    by a select, never multiplied)."""
    count = mask.sum(-1)
    return count == 1, mask.any(-2) & ~(mask & (count[..., None] > 1)).any(-2)


def local_grad_row_errs(got, refs, mask) -> list:
    """`grad_row_errs` under the local window ``mask`` (`local_mask`): the
    largest |g - ref| / |ref| over each query row of dq and each key row of
    dk and dv (2-norms over the head dim). A row zero in exact arithmetic
    but not by construction (`local_zero_rows`) reads fp32 rounding over
    itself, so it is scaled by dv's largest row instead, as `grad_scales`
    scales one key; a row zero by construction (dq of a query that keeps
    no key, dk and dv of a padded key) is zero in the plain version and
    must be exactly zero: any other value reads inf. No rounding floor:
    the checks' queries and keys are independent random rows, so no
    query's own score dominates its softmax and cancels dP - D, as a
    routing vector's score with itself does in shared-QK
    (`gathered_row_floors`)."""
    dv_row = float(refs[2].float().norm(dim=-1).max())
    errs = []
    for g, r, z in zip(got, refs, (*local_zero_rows(mask), None)):
        r = r.float()
        den = r.norm(dim=-1)
        if z is not None:
            den = den.masked_fill(z, dv_row)
        # 0 / 0 (both zero) reads 0, x / 0 reads inf
        err = ((g.float() - r).norm(dim=-1) / den).nan_to_num(
            nan=0.0, posinf=math.inf)
        errs.append(float(err.max()))
    return errs


def local_sdpa_grad_errs(torch, q, k, v, do, refs, mask) -> dict:
    """SDPA's own dq, dk and dv with the local bool ``mask`` (GQA) on the
    same bf16 inputs against the fp32 plain gradients ``refs`` (dk and dv
    per query head, group-summed here), each relative to its largest
    reference value (`grad_scales`) and row by row (`local_grad_row_errs`):
    context for a bf16 backward row, never a limit. Only where every query
    keeps a key (SDPA's softmax over no key is not zero). SDPA rounds P and
    dS to bf16 as its products' operands."""
    from repro_torch.kernels import common
    if not bool(mask.any(-1).all()):
        return {}
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=mask, enable_gqa=True)
    grads = torch.autograd.grad(out, leaves, do)
    Hkv = k.shape[1]
    refs = (refs[0], *(common.group_sum(r, Hkv) for r in refs[1:]))
    return dict(
        sdpa_grad_rel_err=[max_err(g, r) / sc for g, r, sc in zip(
            grads, refs, grad_scales(refs, k.shape[2]))],
        sdpa_grad_row_rel_err=local_grad_row_errs(grads, refs, mask))


def local_fp64_grad_errs(plain, args, got, refs, mask) -> dict:
    """The kernels' dq, dk and dv (``got``) and the fp32 plain version's
    (``refs``) on batch 0 against ``plain`` (returning dq, dk, dv) run in
    fp64 on the same inputs, each over the largest fp64 value and row by
    row (`local_grad_row_errs`): whether the kernels' distance from the
    fp32 plain version is their own or the fp32 plain version's order of
    sums; context, never a limit."""
    def first(t):
        if not hasattr(t, "double"):
            return t
        t = t[:1]
        return t.double() if t.is_floating_point() else t
    r64 = plain(*(first(t) for t in args))
    m0 = mask if mask.dim() == 2 else mask[:1]

    def errs(xs):
        xs = [x[:1].double() for x in xs]
        return ([float((x - r).abs().max() / r.abs().max())
                 for x, r in zip(xs, r64)],
                local_grad_row_errs(xs, r64, m0))
    (k_rel, k_rows), (p_rel, p_rows) = errs(got), errs(refs)
    return dict(kernel_vs_fp64=k_rel, kernel_vs_fp64_rows=k_rows,
                plain_vs_fp64=p_rel, plain_vs_fp64_rows=p_rows)


def check_local_bwd_edges(torch, gen, edges=None) -> list:
    """The local dq and dk/dv kernels in bf16 at LOCAL_EDGES, through
    `local_attention_bwd` (dk and dv group-summed onto the kv heads, GQA
    2:1 among them), each against the plain backward in fp32 on the same
    inputs, lse and D: within BWD_REL_TOL of their largest reference values
    (`grad_scales`; at N 1 dq and dk are zero in exact arithmetic) and
    within BWD_ROW_REL_TOL in every row under the window mask
    (`local_grad_row_errs`); dq of a row that keeps no key and dk, dv of a
    padded key exactly zero. q, k, v and the pad mask are drawn from
    ``gen`` after `check_local_edges` has drawn its own, the output
    gradients from a generator of their own (seed 2). SDPA's own errors
    (without no-key rows) and the fp64 readings are reported beside each
    row."""
    from repro_torch.kernels import local_attention as K
    dgen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = []
    for B, H, Hkv, N, w, dh, causal, padded in edges or LOCAL_EDGES:
        mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
        q = torch.randn((B, H, N, dh), **mk)
        k, v = (torch.randn((B, Hkv, N, dh), **mk) for _ in range(2))
        pad = local_pad_mask(torch, B, N, gen) if padded else None
        out, lse = K.local_attention(q, k, v, w, causal, pad)
        do = torch.randn((B, H, N, dh), generator=dgen, device=DEVICE,
                         dtype=torch.bfloat16)
        args = (q, k, v, out, lse, do, w, causal, pad)
        got = K.local_attention_bwd(*args)
        torch.cuda.synchronize()
        refs = K.local_attention_bwd_plain(q.float(), k.float(), v.float(),
                                           out, lse, do.float(), w, causal,
                                           pad)
        mask = local_mask(torch, N, w, causal, pad)
        no_key = ~mask.any(-1)                  # (N,) or (B, 1, N)
        unseen = ~mask.any(-2)                  # keys no query keeps
        zero = [float(got[0].abs().amax(-1).masked_select(no_key).max())
                if bool(no_key.any()) else 0.0]
        zero += [float(g.abs().amax(-1).masked_select(unseen).max())
                 if bool(unseen.any()) else 0.0 for g in got[1:]]
        row = dict(shape=(f"B{B} H{H} Hkv{Hkv} N{N} w{w} dh{dh} "
                          f"{'causal' if causal else 'full'}"
                          f"{' padded' if padded else ''}"),
                   grad_rel_err=[max_err(a, r) / sc for a, r, sc in zip(
                       got, refs, grad_scales(refs, N))],
                   grad_row_rel_err=local_grad_row_errs(got, refs, mask),
                   no_key_rows=int(no_key.sum()) * H,
                   unseen_keys=int(unseen.sum()) * Hkv,
                   zero_rows_max=zero,
                   **local_sdpa_grad_errs(torch, q, k, v, do, refs, mask),
                   **local_fp64_grad_errs(K.local_attention_bwd_plain,
                                          args, got, refs, mask))
        rows.append(row)
        if not (all(e <= BWD_REL_TOL for e in row["grad_rel_err"])
                and max(row["grad_row_rel_err"]) <= BWD_ROW_REL_TOL
                and max(zero) == 0.0):
            raise AssertionError(f"a local backward kernel disagrees with "
                                 f"its plain version at a ragged shape: "
                                 f"{row}")
    return rows


def check_routing_bwd(torch, cfg, B, N, gen, heads=None, window=None,
                      dtype=None):
    """The fused routing dq and dk/dv kernels at the train shapes
    (causal shared-QK, as the LM runs them; ``heads`` default half the
    model's heads, ``window`` default N / k, ``dtype`` bf16)."""
    from repro_torch.core import routing as ref
    from repro_torch.core.kmeans import cluster_scores, normalize_routing
    from repro_torch.kernels import routing_attention as K
    dh, kc = cfg.head_dim_, cfg.routing.num_clusters
    H = heads or cfg.num_heads // 2
    w = window or N // kc
    q, v = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                        dtype=dtype or torch.bfloat16) for _ in range(2))
    mu = torch.randn((H, kc, dh), generator=gen, device=DEVICE)
    r = normalize_routing(q)
    idx = ref.balanced_topk(cluster_scores(r, mu), w).int().contiguous()
    pos = torch.arange(N, device=DEVICE, dtype=torch.int32).expand(
        B, N).contiguous()
    out, lse = K.routed_attention_fused(r, None, v, idx, idx, pos)
    do = torch.randn(out.shape, generator=gen, device=DEVICE,
                     dtype=dtype or torch.bfloat16)
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
    rows = _bwd_rows(
        ("routing_fused_bwd_dq", "routing_fused_bwd_dkv"),
        ((dq,), (dk, dv)), ((ref_dq,), (ref_dk, ref_dv)),
        (lambda: K.routed_attention_fused_bwd_dq(*args),
         lambda: K.routed_attention_fused_bwd_dkv(*args)),
        (lambda: ref.routed_attention_bwd_dq(*plain),
         lambda: ref.routed_attention_bwd_dkv(*plain)),
        None, nbytes(r, v, idx, pos, do, lse, dsum),
        ((nbytes(dq), 6 * dh * pairs), (nbytes(dk, dv), 8 * dh * pairs)),
        f"B{B} H{H} N{N} dh{dh} k{kc} w{w}")
    # since slice 10 also row by row under the position mask, and run
    # again: each kernel writes each output once, with no atomics, so the
    # second run must equal the first bit for bit
    grads, refs = (dq, dk, dv), (ref_dq, ref_dk, ref_dv)
    grad_row = fused_grad_row_errs(torch, r, None, v, idx, idx, pos, do,
                                   lse, grads, refs)
    repeat = fused_repeat(K, args, grads)
    if max(grad_row) > BWD_ROW_REL_TOL or any(repeat):
        raise AssertionError(f"a fused routing backward kernel disagrees "
                             f"with its plain version in a row or with "
                             f"itself: rows {grad_row}, repeat {repeat}")
    for name, part, fn in (
            ("routing_fused_bwd_dq", slice(0, 1),
             lambda: K.routed_attention_fused_bwd_dq(*args)),
            ("routing_fused_bwd_dkv", slice(1, 3),
             lambda: K.routed_attention_fused_bwd_dkv(*args))):
        rows[name]["grad_rel_err"] = [rel_err(g, r) for g, r in zip(
            grads[part], refs[part])]
        rows[name]["grad_row_rel_err"] = grad_row[part]
        rows[name]["repeat"] = repeat[part]
        rows[name]["graph_ms"] = graph_ms(torch, fn)
        rows[name]["bound_share"] = rows[name]["bound_ms"] / rows[name][
            "graph_ms"]
    return rows


def fused_keep(torch, q_idx, k_idx, positions, kvalid=None, causal=True):
    """The (B, H, k, w, w) bool mask of the fused routing kernels on each
    cluster's members: `gathered_keep` on the members' positions, a padded
    key's at SENTINEL, as the kernels read them."""
    from repro_torch.kernels import routing_attention as K
    B, N = positions.shape
    H, kc, w = q_idx.shape[1:]

    def member_pos(idx, pos):
        return torch.gather(pos[:, None, :].expand(B, H, N).long(), 2,
                            idx.reshape(B, H, -1).long()).reshape(B, H,
                                                                 kc, w)
    pk = positions if kvalid is None else torch.where(kvalid, positions,
                                                      K.SENTINEL)
    return gathered_keep(member_pos(q_idx, positions), member_pos(k_idx, pk),
                         causal)


def fused_grad_row_errs(torch, q, k, v, q_idx, k_idx, positions, do, lse,
                        got, refs, causal=True, kvalid=None) -> list:
    """The fused routing kernels' per-cluster dq, dk and dv (``got``)
    against their plain versions' (``refs``), row by row: the blocks'
    inputs gathered through the membership (`core.routing.gather_blocks`),
    then `gathered_grad_row_errs` under the position mask (`fused_keep`)
    with each row's rounding floor (`gathered_row_floors`), as the
    gathered kernels are held. Rows zero by construction, dq of a query
    that keeps no key and dk, dv of a key that no query keeps, are held to
    exact zero (any other value reads inf): the kernels drop their p by a
    select, and the gathered check scales a no-key dq row by dv's largest
    row."""
    from repro_torch.core import routing as ref
    qg, kg, vg, _, _, _ = ref.gather_blocks(q, k, v, q_idx.long(),
                                            k_idx.long(), positions.long())
    keep = fused_keep(torch, q_idx, k_idx, positions, kvalid, causal)
    floors = gathered_row_floors(torch, qg, kg, vg, do, lse, keep)
    errs = gathered_grad_row_errs(got, refs, keep, floors)
    no_key, unkept = ~keep.any(-1), ~keep.any(-2)
    for i, (g, z) in enumerate(zip(got, (no_key, unkept, unkept))):
        if bool(z.any()) and float(
                g.abs().amax(-1).masked_select(z).max()) != 0.0:
            errs[i] = math.inf
    return errs


def fused_repeat(K, args, got) -> list:
    """The fused dq, dk and dv kernels run again on ``args``: 0.0 where
    the second run equals ``got`` bit for bit, else the largest
    difference."""
    again = (K.routed_attention_fused_bwd_dq(*args),
             *K.routed_attention_fused_bwd_dkv(*args))
    return [0.0 if bool(a.equal(g)) else max(max_err(a, g), 1e-30)
            for a, g in zip(again, got)]


def fused_inputs(torch, B, H, kc, w, N, dh, mode, gen):
    """bf16 sequence-layout q, k (None with shared-QK), v, int32
    membership q_idx, k_idx (B, H, k, w), positions (B, N), kvalid and
    causal for the fused kernels, one `FUSED_EDGES` mode: "shared", the
    routing vectors of random q and their balanced top-w membership;
    "separate", random q and k with the keys' own membership; "padded",
    non-causal, one key in seven padding and cluster 0's keys the last w
    tokens, all padding."""
    from repro_torch.core import routing as ref
    from repro_torch.core.kmeans import cluster_scores, normalize_routing
    mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
    q, k, v = (torch.randn((B, H, N, dh), **mk) for _ in range(3))
    mu = torch.randn((H, kc, dh), generator=gen, device=DEVICE)
    r = normalize_routing(q)
    q_idx = ref.balanced_topk(cluster_scores(r, mu), w)
    kvalid = None
    if mode == "shared":
        q, k, k_idx = r, None, q_idx
    else:
        if mode == "padded":
            kvalid = torch.rand((B, N), generator=gen,
                                device=DEVICE) >= 1 / 7
            kvalid[:, N - w:] = False
        k_idx = ref.balanced_topk(cluster_scores(normalize_routing(k), mu),
                                  w, kvalid)
        if mode == "padded":
            k_idx[:, :, 0] = torch.arange(N - w, N, device=DEVICE)
    pos = torch.arange(N, device=DEVICE, dtype=torch.int32).expand(
        B, N).contiguous()
    return (q, k, v, q_idx.int().contiguous(), k_idx.int().contiguous(),
            pos, kvalid, mode != "padded")


def check_routing_bwd_edges(torch, gen, edges=None) -> list:
    """The fused routing dq and dk/dv kernels in bf16 at FUSED_EDGES,
    each against its plain version in fp32 on the same inputs, lse and D:
    within BWD_REL_TOL of their largest reference values
    (`gathered_grad_scales`: at w 1 dq and dk are zero in exact
    arithmetic), within BWD_ROW_REL_TOL in every row
    (`fused_grad_row_errs`, no-key dq rows and unkept keys' dk, dv exactly
    zero), and equal to themselves run again. Inputs from ``gen``."""
    from repro_torch.core import routing as ref
    from repro_torch.kernels import routing_attention as K
    rows = []
    for B, H, kc, w, N, dh, mode in edges or FUSED_EDGES:
        q, k, v, q_idx, k_idx, pos, kvalid, causal = fused_inputs(
            torch, B, H, kc, w, N, dh, mode, gen)
        out, lse = K.routed_attention_fused(q, k, v, q_idx, k_idx, pos,
                                            causal, kvalid)
        do = torch.randn(out.shape, generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
        args = (q, k, v, q_idx, k_idx, pos, do, lse, K.row_dot(do, out),
                causal, kvalid)
        got = (K.routed_attention_fused_bwd_dq(*args),
               *K.routed_attention_fused_bwd_dkv(*args))
        torch.cuda.synchronize()
        a32 = (q.float(), None if k is None else k.float(), v.float(),
               q_idx.long(), k_idx.long(), pos.long(), do.float(),
               *args[7:])
        refs = (ref.routed_attention_bwd_dq(*a32),
                *ref.routed_attention_bwd_dkv(*a32))
        keep = fused_keep(torch, q_idx, k_idx, pos, kvalid, causal)
        row = dict(shape=(f"B{B} H{H} k{kc} w{w} N{N} dh{dh} {mode}"),
                   grad_rel_err=[max_err(a, r) / sc for a, r, sc in zip(
                       got, refs, gathered_grad_scales(refs, keep))],
                   grad_row_rel_err=fused_grad_row_errs(
                       torch, q, k, v, q_idx, k_idx, pos, do, lse, got,
                       refs, causal, kvalid),
                   repeat=fused_repeat(K, args, got),
                   no_key_rows=int((~keep.any(-1)).sum()),
                   unkept_keys=int((~keep.any(-2)).sum()))
        rows.append(row)
        if not (all(e <= BWD_REL_TOL for e in row["grad_rel_err"])
                and max(row["grad_row_rel_err"]) <= BWD_ROW_REL_TOL
                and not any(row["repeat"])):
            raise AssertionError(f"a fused routing backward kernel "
                                 f"disagrees with its plain version at a "
                                 f"ragged shape: {row}")
    return rows


def fused_fwd_row_errs(torch, out, lse, ref_out, ref_lse, q_idx, k_idx,
                       positions, causal=True, kvalid=None) -> float:
    """The fused routing forward's per-cluster output (``out``, (B, H, k,
    w, dh)) against its plain version's (``ref_out``), row by row: the
    largest `row_rel_err` over the members' blocks, as the gathered
    forward's rows are held. A row that keeps no key (under `fused_keep`)
    is zero in the plain version, so any other value already reads over
    the limit; such a row must also be exactly zero with the plain
    version's lse, else this reads inf."""
    err = row_rel_err(out, ref_out)
    no_key = ~fused_keep(torch, q_idx, k_idx, positions, kvalid,
                         causal).any(-1)
    if bool(no_key.any()) and not (
            float(out.float().abs().amax(-1).masked_select(no_key).max())
            == 0.0 and bool(lse.masked_select(no_key).equal(
                ref_lse.masked_select(no_key)))):
        return math.inf
    return err


def fused_fwd_repeat(K, args, got) -> list:
    """The fused forward run again on ``args``: 0.0 where the second run's
    out and lse equal ``got`` bit for bit, else the largest difference."""
    again = K.routed_attention_fused(*args)
    return [0.0 if bool(a.equal(g)) else max(max_err(a, g), 1e-30)
            for a, g in zip(again, got)]


def _fused_fwd_gates(row):
    return (row["out_rel_err"] <= OUT_REL_TOL
            and row["row_rel_err"] <= ROW_REL_TOL
            and row["lse_err"] <= LSE_TOL and not any(row["repeat"]))


def check_routing_fwd(torch, cfg, B, N, gen, heads=None, window=None,
                      dtype=None):
    """The fused routing forward in bf16 at a train shape (causal
    shared-QK, as the LM runs it; ``heads`` default half the model's
    heads, ``window`` default w = N / k), against its plain version in
    fp32 on the same inputs: the largest value (OUT_REL_TOL), every row
    (ROW_REL_TOL, `fused_fwd_row_errs`: no-key rows exactly zero with the
    plain lse), lse (LSE_TOL), and a
    second run equal to the first bit for bit. Timed by the host clock,
    in a CUDA graph (`graph_ms`) and beside the plain version; the fp64
    and SDPA readings over the members' blocks (keep mask), and the
    gathered forward's `graph_ms` on the same blocks (gathered through
    `core.routing.gather_blocks`), are yardsticks, never limits."""
    from repro_torch.core import routing as ref
    from repro_torch.core.kmeans import cluster_scores, normalize_routing
    from repro_torch.kernels import routing_attention as K
    from repro_torch.kernels import routing_gathered as KG
    dh, kc = cfg.head_dim_, cfg.routing.num_clusters
    H = heads or cfg.num_heads // 2
    w = window or N // kc
    dt = dtype or torch.bfloat16
    q, v = (torch.randn((B, H, N, dh), generator=gen, device=DEVICE,
                        dtype=dt) for _ in range(2))
    mu = torch.randn((H, kc, dh), generator=gen, device=DEVICE)
    r = normalize_routing(q)
    idx = ref.balanced_topk(cluster_scores(r, mu), w).int().contiguous()
    pos = torch.arange(N, device=DEVICE, dtype=torch.int32).expand(
        B, N).contiguous()
    args = (r, None, v, idx, idx, pos)
    out, lse = K.routed_attention_fused(*args)
    torch.cuda.synchronize()
    ref_out, ref_lse = K.routed_attention_fused_plain(
        r.float(), None, v.float(), idx, idx, pos)
    row = dict(max_abs_err=max_err(out, ref_out),
               out_rel_err=rel_err(out, ref_out),
               row_rel_err=fused_fwd_row_errs(torch, out, lse, ref_out,
                                              ref_lse, idx, idx, pos),
               lse_err=max_err(lse, ref_lse),
               repeat=fused_fwd_repeat(K, args, (out, lse)))
    if not _fused_fwd_gates(row):
        raise AssertionError(f"the bf16 routing_fused disagrees with its "
                             f"plain version or with itself: {row}")
    li, lp = idx.long(), pos.long()
    qg, _, vg, pq, _, _ = ref.gather_blocks(r, None, v, li, li, lp)
    n = B * H * kc
    keep = fused_keep(torch, idx, idx, pos)
    ref64 = ref.block_attention(qg.double(), qg.double(), vg.double(), pq,
                                pq, True)
    row.update(**fwd_fp64_errs(out, ref_out, ref64),
               **sdpa_out_errs(torch, qg.reshape(n, 1, w, dh),
                               qg.reshape(n, 1, w, dh),
                               vg.reshape(n, 1, w, dh),
                               ref_out.reshape(n, 1, w, dh),
                               mask=keep.reshape(n, 1, w, w)))
    del ref_out, ref_lse, ref64
    pairs = float(keep.sum())
    b_ms, b_by = bound_ms(nbytes(r, v, idx, pos, out, lse), 4 * dh * pairs)
    fwd = lambda: K.routed_attention_fused(*args)  # noqa: E731
    ms = time_ms(fwd)
    g_ms = graph_ms(torch, fwd)
    qf, vf = qg.reshape(n, w, dh), vg.reshape(n, w, dh)
    pqf = pq.reshape(n, w).to(torch.int32).contiguous()
    row.update(
        ms=ms, graph_ms=g_ms,
        plain_ms=time_ms(lambda: K.routed_attention_fused_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / g_ms, pairs=pairs,
        # (the gathered kernels take dh 64 and 128 only)
        gathered_graph_ms=graph_ms(torch, lambda: KG.routed_attention_blocks(
            qf, qf, vf, pqf, pqf, True))
        if dh in KG.C.SUPPORTED_HEAD_DIMS else None,
        shape=f"B{B} H{H} N{N} dh{dh} k{kc} w{w} "
              f"{'bf16' if dt == torch.bfloat16 else 'fp32'} causal "
              f"shared-QK")
    return {"routing_fused": row}


def check_routing_fwd_edges(torch, gen, edges=None) -> list:
    """The fused routing forward in bf16 at FUSED_EDGES, against its plain
    version in fp32 on the same inputs: the gates of `check_routing_fwd`
    (out within OUT_REL_TOL of its largest value and within ROW_REL_TOL in
    every row, rows that keep no key exactly zero with the plain lse, lse
    within LSE_TOL, a second run equal to the first bit for bit). Inputs
    from ``gen`` (`fused_inputs`)."""
    from repro_torch.kernels import routing_attention as K
    rows = []
    for B, H, kc, w, N, dh, mode in edges or FUSED_EDGES:
        q, k, v, q_idx, k_idx, pos, kvalid, causal = fused_inputs(
            torch, B, H, kc, w, N, dh, mode, gen)
        args = (q, k, v, q_idx, k_idx, pos, causal, kvalid)
        out, lse = K.routed_attention_fused(*args)
        torch.cuda.synchronize()
        ref_out, ref_lse = K.routed_attention_fused_plain(
            q.float(), None if k is None else k.float(), v.float(), q_idx,
            k_idx, pos, causal, kvalid)
        keep = fused_keep(torch, q_idx, k_idx, pos, kvalid, causal)
        row = dict(shape=f"B{B} H{H} k{kc} w{w} N{N} dh{dh} {mode}",
                   out_rel_err=rel_err(out, ref_out),
                   row_rel_err=fused_fwd_row_errs(
                       torch, out, lse, ref_out, ref_lse, q_idx, k_idx, pos,
                       causal, kvalid),
                   lse_err=max_err(lse, ref_lse),
                   repeat=fused_fwd_repeat(K, args, (out, lse)),
                   no_key_rows=int((~keep.any(-1)).sum()))
        rows.append(row)
        if not _fused_fwd_gates(row):
            raise AssertionError(f"the bf16 routing_fused disagrees with "
                                 f"its plain version at a ragged shape: "
                                 f"{row}")
        if mode == "padded" and not row["no_key_rows"]:
            raise AssertionError(f"no query keeps no key at {row['shape']}: "
                                 f"the padded cluster is not empty")
    return rows


def check_paper_kernels(torch, gen) -> dict:
    """The local and fused routing kernels (forward, dq, dk/dv) at the
    paper's other models' train shapes, each through the check of its
    main shape (row by row, fused no-key rows exactly zero and a second
    run bit for bit, `graph_ms`): rt-pg19's (B 1 x 8192, 8 local heads,
    2 routing heads, k 16, w 512) at head dim 129, which the wrappers run
    zero-padded to the kernels' dh-192 instances (the bound counts the
    work of dh 129, so its share shows what the padding costs), in bf16
    and in fp32; rt-imagenet64's (B 1 x 12288, 8 local and 8 routing
    heads of dh 64, k 8, windows 2048) in bf16. Inputs from ``gen``."""
    from repro_torch.attn.spec import head_split, spec_for_layer
    from repro_torch.configs import get_config
    rows = {}
    for tag, arch, N, dtype in (
            ("rt-pg19", PG19_ARCH, PG19_SEQ, torch.bfloat16),
            ("rt-imagenet64", IMAGENET_ARCH, IMAGENET_SEQ, torch.bfloat16),
            ("rt-pg19 fp32", PG19_ARCH, PG19_SEQ, torch.float32)):
        cfg = get_config(arch)
        # local heads: all of a layer without routing (rt-pg19's 0-19),
        # else the local half of the head split
        Hr = head_split(spec_for_layer(cfg, "local+routing"))[1]
        Hl = (cfg.num_heads if cfg.routing.routing_layers
              else cfg.num_heads - Hr)
        w = cfg.routing.window or N // cfg.routing.num_clusters
        rows[tag] = {
            "local_attention": check_local(torch, cfg, 1, N, gen, Hl, dtype),
            **check_local_bwd(torch, cfg, 1, N, gen, Hl, dtype),
            **check_routing_fwd(torch, cfg, 1, N, gen, Hr, w, dtype),
            **check_routing_bwd(torch, cfg, 1, N, gen, Hr, w, dtype)}
    return rows


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
    row_err = row_rel_err(out, ref_out)
    if row_err > ROW_REL_TOL:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version in a row: {row_err}")
    args32 = (*f32, lse, dsum)
    ref_dq = K.flash_attention_bwd_dq_plain(*args32)
    ref_dk, ref_dv = K.flash_attention_bwd_dkv_plain(*args32)
    grad_row = grad_row_errs((dq, dk, dv), (ref_dq, ref_dk, ref_dv), True)
    if max(grad_row) > BWD_ROW_REL_TOL:
        raise AssertionError(f"a flash backward kernel disagrees with its "
                             f"plain version in a row: {grad_row}")
    bf16 = dtype == torch.bfloat16
    sdpa_out = sdpa_out_errs(torch, q, k, v, ref_out, True) if bf16 else {}
    sdpa_grad = (sdpa_grad_errs(torch, q, k, v, do, (ref_dq, ref_dk, ref_dv),
                                True) if bf16 else None)
    fp64 = (fp64_grad_errs(K, args, (dq, dk, dv), (ref_dq, ref_dk, ref_dv))
            if bf16 else None)
    out_rel = rel_err(out, ref_out)
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
    rows["flash_attention"]["row_rel_err"] = row_err
    if sdpa_out:
        rows["flash_attention"].update(out_rel_err=out_rel, **sdpa_out)
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
    rows["flash_attention_bwd_dq"]["grad_row_rel_err"] = grad_row[:1]
    rows["flash_attention_bwd_dkv"]["grad_row_rel_err"] = grad_row[1:]
    if sdpa_grad:
        for name, part in (("flash_attention_bwd_dq", slice(0, 1)),
                           ("flash_attention_bwd_dkv", slice(1, 3))):
            rows[name].update(
                {key: val[part] for key, val in sdpa_grad.items()},
                **{key: val[part] for key, val in fp64.items()})
        rows["flash_attention_bwd_dq"]["grad_rel_err"] = [
            rel_err(dq, ref_dq)]
        rows["flash_attention_bwd_dkv"]["grad_rel_err"] = [
            rel_err(dk, ref_dk), rel_err(dv, ref_dv)]
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


def rel_err(a, ref) -> float:
    """Largest |a - ref| over the largest |ref|."""
    return max_err(a, ref) / float(ref.abs().max())


def row_rel_err(a, ref) -> float:
    """Largest over rows of |a - ref| / |ref|, 2-norms over the last dim."""
    ref = ref.float()
    return float(((a.float() - ref).norm(dim=-1)
                  / ref.norm(dim=-1).clamp_min(1e-30)).max())


def grad_row_errs(got, refs, causal) -> list:
    """The largest |g - ref| / |ref| over each query row of dq and each key
    row of dk and dv (2-norms over the head dim). A row whose gradient is
    zero in exact arithmetic reads fp32 rounding over itself, so it is
    scaled by dv's largest row instead, as `grad_scales` scales M = 1: dq
    of a query row that sees a single key (row 0 under causality; every
    row when M = 1) and every row of dk when M = 1. Rows that no query sees
    are zero in both and read 0."""
    M = refs[1].shape[-2]
    dv_row = float(refs[2].float().norm(dim=-1).max())
    zero = (slice(None) if M == 1 else slice(0, int(causal)),
            slice(None) if M == 1 else slice(0, 0), slice(0, 0))
    errs = []
    for g, r, z in zip(got, refs, zero):
        r = r.float()
        den = r.norm(dim=-1)
        den[..., z] = dv_row
        errs.append(float(((g.float() - r).norm(dim=-1)
                           / den.clamp_min(1e-30)).max()))
    return errs


def sdpa_out_errs(torch, q, k, v, ref_out, causal=False, mask=None) -> dict:
    """SDPA's own error on the same bf16 inputs (causal on row indices, or
    with the bool ``mask``; GQA) against the fp32 plain output ``ref_out``,
    relative to its largest value and row by row: context for a bf16
    forward row, never a limit. With a mask, the rows that keep no key are
    taken as zeros (SDPA's softmax over no key is not zero)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)
    if mask is not None:
        out = torch.where(mask.any(-1, keepdim=True), out, 0.0)
    return dict(sdpa_out_rel_err=rel_err(out, ref_out),
                sdpa_row_rel_err=row_rel_err(out, ref_out))


def grad_scales(refs, M) -> list:
    """The largest |value| of each of dq, dk, dv; with a single key (M = 1)
    dq and dk are zero in exact arithmetic (a softmax over one key has no
    gradient) and read as fp32 rounding, so dv's is taken for them."""
    scales = [float(r.abs().max()) for r in refs]
    if M == 1:
        scales[:2] = [scales[2]] * 2
    return scales


def fp64_grad_errs(K, args, got, refs) -> dict:
    """The kernel's dq, dk and dv (``got``) and the fp32 plain version's
    (``refs``) on batch 0 against the plain version run in fp64 on the same
    inputs, lse and D, each over the largest fp64 value: whether the
    kernel's distance from the fp32 plain version is its own or the fp32
    plain version's order of sums. Causal; context, never a limit."""
    a64 = [t[:1].double() for t in args]
    r64 = (K.flash_attention_bwd_dq_plain(*a64),
           *K.flash_attention_bwd_dkv_plain(*a64))

    def errs(xs):
        return [float((x[:1].double() - r).abs().max() / r.abs().max())
                for x, r in zip(xs, r64)]
    return dict(kernel_vs_fp64=errs(got), plain_vs_fp64=errs(refs))


def sdpa_grad_errs(torch, q, k, v, do, refs, causal) -> dict:
    """SDPA's own dq, dk and dv on the same bf16 inputs (causal on row
    indices, GQA) against the fp32 plain gradients ``refs`` (dk and dv per
    query head, group-summed here), each relative to its largest reference
    value (`grad_scales`) and row by row (`grad_row_errs`): context for a
    bf16 backward row, never a limit. SDPA rounds P and dS to bf16 as its
    products' operands."""
    from repro_torch.kernels import common
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal, enable_gqa=True)
    grads = torch.autograd.grad(out, leaves, do)
    Hkv = k.shape[1]
    refs = (refs[0], *(common.group_sum(r, Hkv) for r in refs[1:]))
    return dict(
        sdpa_grad_rel_err=[max_err(g, r) / sc for g, r, sc in zip(
            grads, refs, grad_scales(refs, k.shape[2]))],
        sdpa_grad_row_rel_err=grad_row_errs(grads, refs, causal))


def check_flash_edges(torch, gen) -> list:
    """The three flash kernels in bf16 at FLASH_EDGES, each against its
    plain version in fp32 on the same inputs: out within OUT_REL_TOL of its
    largest reference value and within ROW_REL_TOL in every row, lse within
    LSE_TOL; dq, dk and dv within BWD_REL_TOL of their largest reference
    values and within BWD_ROW_REL_TOL in every row. With a single key
    (M = 1) dq and dk are zero in exact arithmetic (a softmax over one key
    has no gradient) and both read as fp32 rounding, so they are scaled by
    dv's largest reference value instead (row by row, by dv's largest row:
    `grad_row_errs`). SDPA's own errors (forward, dq, dk, dv) are reported
    beside each row."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.core import row_dot
    rows = []
    for B, H, Hkv, N, M, dh, causal in FLASH_EDGES:
        mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
        q, do = (torch.randn((B, H, N, dh), **mk) for _ in range(2))
        k, v = (torch.randn((B, Hkv, M, dh), **mk) for _ in range(2))
        out, lse = K.flash_attention(q, k, v, causal)
        args = (q, k, v, do, lse, row_dot(do, out), causal)
        got = (K.flash_attention_bwd_dq(*args),
               *K.flash_attention_bwd_dkv(*args))
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, do)]
        ref_out, ref_lse = K.flash_attention_plain(*f32[:3], causal)
        args32 = (*f32, *args[4:])
        refs = (K.flash_attention_bwd_dq_plain(*args32),
                *K.flash_attention_bwd_dkv_plain(*args32))
        scales = grad_scales(refs, M)
        row = dict(shape=(f"B{B} H{H} Hkv{Hkv} N{N} M{M} dh{dh} "
                          f"{'causal' if causal else 'full'}"),
                   out_rel_err=rel_err(out, ref_out),
                   row_rel_err=row_rel_err(out, ref_out),
                   lse_err=max_err(lse, ref_lse),
                   grad_rel_err=[max_err(a, r) / sc
                                 for a, r, sc in zip(got, refs, scales)],
                   grad_row_rel_err=grad_row_errs(got, refs, causal),
                   **sdpa_out_errs(torch, q, k, v, ref_out, causal),
                   **sdpa_grad_errs(torch, q, k, v, do, refs, causal))
        rows.append(row)
        if not (row["out_rel_err"] <= OUT_REL_TOL
                and row["row_rel_err"] <= ROW_REL_TOL
                and row["lse_err"] <= LSE_TOL
                and all(e <= BWD_REL_TOL for e in row["grad_rel_err"])
                and max(row["grad_row_rel_err"]) <= BWD_ROW_REL_TOL):
            raise AssertionError(f"a flash kernel disagrees with its plain "
                                 f"version at a ragged shape: {row}")
    return rows


def flash_forward_digest(torch) -> str:
    """A sha256 of the flash forward's bf16 outputs and lse at qwen2's train
    shape, WIDE_FLASH and every FLASH_EDGES shape, on inputs from a
    generator of its own (seed 1): two builds of the kernel that compute
    the same bits give the same digest."""
    import hashlib
    from repro_torch.kernels import flash_attention as K
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
    shapes = [(FULL_BATCH, 14, 2, FULL_SEQ, FULL_SEQ, 64, True),
              (*WIDE_FLASH[:4], WIDE_FLASH[3], WIDE_FLASH[4], True),
              *FLASH_EDGES]
    h = hashlib.sha256()
    for B, H, Hkv, N, M, dh, causal in shapes:
        q = torch.randn((B, H, N, dh), **mk)
        k, v = (torch.randn((B, Hkv, M, dh), **mk) for _ in range(2))
        for t in K.flash_attention(q, k, v, causal):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def backward_digest(torch) -> str:
    """A sha256 of the bf16 flash and gathered backward kernels' dq, dk and
    dv at qwen2's train shape and every FLASH_EDGES shape (flash), at
    rt-cifar10's gathered blocks and every GATHERED_EDGES shape (gathered),
    on inputs from a generator of their own (seed 3): two builds of the
    backward bodies they share with the local backward
    (csrc/attn_bwd_sm90.cuh) that compute the same bits for these two
    kernels give the same digest."""
    import hashlib
    from repro_torch.core import row_dot
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import routing_gathered as KG
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
    h = hashlib.sha256()

    def take(*ts):
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    for B, H, Hkv, N, M, dh, causal in (
            (FULL_BATCH, 14, 2, FULL_SEQ, FULL_SEQ, 64, True), *FLASH_EDGES):
        q, do = (torch.randn((B, H, N, dh), **mk) for _ in range(2))
        k, v = (torch.randn((B, Hkv, M, dh), **mk) for _ in range(2))
        out, lse = KF.flash_attention(q, k, v, causal)
        args = (q, k, v, do, lse, row_dot(do, out), causal)
        take(KF.flash_attention_bwd_dq(*args),
             *KF.flash_attention_bwd_dkv(*args))
    for B, H, kc, w, dh, causal, shared, empty in (
            (CIFAR_BATCH, 4, 6, 512, 64, True, True, False),
            *((*e, True) for e in GATHERED_EDGES)):
        qf, kf, vf, pqf, pkf = gathered_inputs(
            torch, B, H, kc, w, dh, torch.bfloat16, gen, causal, shared,
            empty_cluster=empty)
        out, lse = KG.routed_attention_blocks(qf, kf, vf, pqf, pkf, causal)
        do = torch.randn(out.shape, **mk)
        args = (qf, kf, vf, pqf, pkf, do, lse, row_dot(do, out), causal)
        take(KG.routed_attention_blocks_bwd_dq(*args),
             *KG.routed_attention_blocks_bwd_dkv(*args))
    return h.hexdigest()


def local_backward_digest(torch) -> str:
    """A sha256 of the bf16 local backward kernels' dq, dk and dv at
    rt-enwik8's train shape (its local heads: B 2 x 8192, 4 heads, dh 128,
    w 256), at rt-cifar10's local layers (B 8 x 3072, 8 heads, dh 64, w
    512) and at every LOCAL_EDGES shape (through `local_attention_bwd`, dk
    and dv group-summed), on inputs from a generator of their own (seed
    4): two builds of the backward bodies they share
    (csrc/attn_bwd_sm90.cuh) that compute the same bits for the local
    kernels give the same digest."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.core import row_dot
    from repro_torch.kernels import local_attention as K
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
    h = hashlib.sha256()

    def take(*ts):
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    cfg, ccfg = get_config(ARCH), get_config(CIFAR_ARCH)
    for B, H, N, c in ((TRAIN_BATCH, cfg.num_heads // 2, TRAIN_SEQ, cfg),
                       (CIFAR_BATCH, ccfg.num_heads, CIFAR_SEQ, ccfg)):
        dh, w = c.head_dim_, c.routing.local_window
        q, k, v, do = (torch.randn((B, H, N, dh), **mk) for _ in range(4))
        out, lse = K.local_attention(q, k, v, w)
        args = (q, k, v, do, lse, row_dot(do, out), w)
        take(K.local_attention_bwd_dq(*args), *K.local_attention_bwd_dkv(*args))
    for B, H, Hkv, N, w, dh, causal, padded in LOCAL_EDGES:
        q, do = (torch.randn((B, H, N, dh), **mk) for _ in range(2))
        k, v = (torch.randn((B, Hkv, N, dh), **mk) for _ in range(2))
        pad = local_pad_mask(torch, B, N, gen) if padded else None
        out, lse = K.local_attention(q, k, v, w, causal, pad)
        take(*K.local_attention_bwd(q, k, v, out, lse, do, w, causal, pad))
    return h.hexdigest()


def forward_digest(torch) -> str:
    """A sha256 of the bf16 local and gathered forwards' outputs and lse:
    the local forward at rt-enwik8's serving shapes (B 4 x 2048 and B 1 x
    8192, 4 heads, dh 128, w 256), at rt-cifar10's local layers (B 8 x
    3072, 8 heads, dh 64, w 512) and at every LOCAL_EDGES shape; the
    gathered forward at rt-cifar10's blocks (B 8, 4 heads, k 6, w 512, dh
    64), rt-enwik8's (B 1, 4 heads, k 32, w 256, dh 128) and every
    GATHERED_EDGES shape; on inputs from a generator of their own (seed
    7): two builds of the forward body they share with the flash and the
    fused routing forwards (csrc/attn_fwd_sm90.cuh) that compute the same
    bits for these two kernels give the same digest."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.kernels import local_attention as KL
    from repro_torch.kernels import routing_gathered as KG
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    mk = dict(generator=gen, device=DEVICE, dtype=torch.bfloat16)
    h = hashlib.sha256()

    def take(*ts):
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    cfg, ccfg = get_config(ARCH), get_config(CIFAR_ARCH)
    (B1, N1, _), (B2, N2, _) = REQUESTS
    for B, H, N, c in ((B1, cfg.num_heads // 2, N1, cfg),
                       (B2, cfg.num_heads // 2, N2, cfg),
                       (CIFAR_BATCH, ccfg.num_heads, CIFAR_SEQ, ccfg)):
        dh, w = c.head_dim_, c.routing.local_window
        q, k, v = (torch.randn((B, H, N, dh), **mk) for _ in range(3))
        take(*KL.local_attention(q, k, v, w))
    for B, H, Hkv, N, w, dh, causal, padded in LOCAL_EDGES:
        q = torch.randn((B, H, N, dh), **mk)
        k, v = (torch.randn((B, Hkv, N, dh), **mk) for _ in range(2))
        pad = local_pad_mask(torch, B, N, gen) if padded else None
        take(*KL.local_attention(q, k, v, w, causal, pad))
    for B, H, kc, w, dh, causal, shared, empty in (
            (CIFAR_BATCH, 4, 6, 512, 64, True, True, False),
            (1, cfg.num_heads // 2, cfg.routing.num_clusters,
             TRAIN_SEQ // cfg.routing.num_clusters, cfg.head_dim_, True,
             True, False),
            *((*e, True) for e in GATHERED_EDGES)):
        qf, kf, vf, pqf, pkf = gathered_inputs(
            torch, B, H, kc, w, dh, torch.bfloat16, gen, causal, shared,
            empty_cluster=empty)
        take(*KG.routed_attention_blocks(qf, kf, vf, pqf, pkf, causal))
    return h.hexdigest()


def gathered_inputs(torch, B, H, kc, w, dh, dtype, gen, causal=True,
                    shared=True, empty_cluster=False):
    """Gathered cluster blocks (n = B*H*kc, w, dh) and int32 positions for
    the gathered kernels. Causal shared-QK, as the routing layers make
    them: routing vectors of random q over N = kc*w tokens, their balanced
    top-w membership, the member rows and positions gathered. Otherwise
    random blocks with sorted positions, separate keys, and (non-causal)
    about one padded key in seven at SENTINEL. With ``empty_cluster``,
    cluster 0 keeps no key: its keys all come after its queries (causal) or
    are all padding (non-causal)."""
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
    if empty_cluster and causal:
        pkf[0] += 4 * w
    if not causal:
        pad = torch.rand((n, w), generator=gen, device=DEVICE) < 1 / 7
        if empty_cluster:
            pad[0] = True
        pkf = torch.where(pad, KG.SENTINEL, pkf)
    return qf, kf, vf, pqf.to(torch.int32), pkf.to(torch.int32)


def gathered_keep(pqf, pkf, causal):
    """The (n, w, w) bool mask of the gathered kernels (`_keep_mask`), as
    their plain versions build it."""
    from repro_torch.core.routing import block_keep
    from repro_torch.kernels import routing_gathered as K
    return block_keep(pqf, pkf, causal, pkf < K.SENTINEL)


def gathered_zero_rows(keep):
    """The rows whose gradient is zero in exact arithmetic: dq of a query
    row that keeps at most one key (a softmax over one key has no
    gradient), dk of a key row whose every keeping query keeps only it;
    each (n, w) bool. dv has none (a row no query keeps is zero in both
    the kernel and the plain version)."""
    count = keep.sum(-1)
    return count <= 1, ~(keep & (count[..., None] > 1)).any(-2)


def gathered_grad_scales(refs, keep) -> list:
    """The largest |value| of each of dq, dk, dv; dq or dk whose every row
    is zero in exact arithmetic (`gathered_zero_rows`: at w 1, say) reads
    fp32 rounding, so dv's largest value is taken for it, as
    `grad_scales` does for one key."""
    scales = [float(r.abs().max()) for r in refs]
    for i, zero in enumerate(gathered_zero_rows(keep)):
        if bool(zero.all()):
            scales[i] = scales[2]
    return scales


def gathered_row_floors(torch, qf, kf, vf, do, lse, keep):
    """The rounding floor of each query row of dq and each key row of dk
    ((n, w) each): what fp32 sums of dh products move dP = dO V^T by
    (|err| <~ sqrt(dh) u sum_d |do_d| |v_d|, u = 2^-24: Higham and Mary's
    probabilistic bound of a dot product, with lambda = 1; the worst-case
    bound has dh u in place of sqrt(dh) u and lets a row be off by as much
    as a bf16 rounding of dS), carried through dS = P (dP - D) scale into
    dq = dS K and dk = dS^T Q (2-norms over the head dim). Where a query
    keeps little besides itself (shared-QK: a routing vector's score with
    itself dominates its softmax), dP - D cancels, and dS and its rows of
    dq and dk sit near this floor in exact arithmetic, so no fp32
    computation, the plain version's included, resolves them."""
    dh = qf.shape[-1]
    q, k, v, g = (t.float() for t in (qf, kf, vf, do))
    s = q @ k.transpose(-1, -2) / dh ** 0.5
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    # sqrt(dh) u for the dot product, times the softmax scale 1 / sqrt(dh)
    a = p * (g.abs() @ v.abs().transpose(-1, -2)) * 2.0 ** -24
    return ((a @ k.abs()).norm(dim=-1),
            (a.transpose(-1, -2) @ q.abs()).norm(dim=-1))


def gathered_grad_row_errs(got, refs, keep, floors=None) -> list:
    """`grad_row_errs` under the gathered kernels' position mask ``keep``
    (n, w, w): the largest |g - ref| / |ref| over each query row of dq and
    each key row of dk and dv (2-norms over the head dim). A row whose
    gradient is zero in exact arithmetic (`gathered_zero_rows`) reads fp32
    rounding over itself, so it is scaled by dv's largest row instead; a
    key row that no query keeps is zero in both and reads 0. With
    ``floors`` (`gathered_row_floors`), a row of dq or dk is scaled by no
    less than twice its rounding floor over BWD_ROW_REL_TOL: a row below
    that is held to twice its floor (the kernel and the plain version each
    within the floor of the exact value), since fp32 does not resolve it
    (`gathered_fp64_grad_errs` reads the plain version against fp64 row by
    row without floors)."""
    dv_row = float(refs[2].float().norm(dim=-1).max())
    zero = (*gathered_zero_rows(keep), None)
    errs = []
    for g, r, z, f in zip(got, refs, zero, (*(floors or (None,) * 2),
                                            None)):
        r = r.float()
        den = r.norm(dim=-1)
        if z is not None:
            den = den.masked_fill(z, dv_row)
        if f is not None:
            den = den.maximum(2 * f / BWD_ROW_REL_TOL)
        errs.append(float(((g.float() - r).norm(dim=-1)
                           / den.clamp_min(1e-30)).max()))
    return errs


def gathered_sdpa_grad_errs(torch, qf, kf, vf, do, refs, keep,
                            floors) -> dict:
    """SDPA's own dq, dk and dv over the blocks with the bool ``keep`` mask,
    on the same bf16 inputs, against the fp32 plain gradients ``refs``,
    relative to their largest values (`gathered_grad_scales`) and row by
    row (`gathered_grad_row_errs`): context for a bf16 backward row, never
    a limit. Only clusters whose every query keeps a key (SDPA's softmax
    over no key is not zero); with shared-QK dk and dv as the kernels
    return them (dk of the blocks taken as keys)."""
    full = keep.any(-1).all(-1)
    if not bool(full.any()):
        return {}
    sel = [t[full] for t in (qf, kf, vf, do)]
    leaves = [t.detach()[:, None].requires_grad_(True) for t in sel[:3]]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=keep[full][:, None])
    grads = [g[:, 0] for g in torch.autograd.grad(out, leaves,
                                                  sel[3][:, None])]
    refs = [r[full] for r in refs]
    k = keep[full]
    return dict(
        sdpa_grad_rel_err=[max_err(g, r) / sc for g, r, sc in zip(
            grads, refs, gathered_grad_scales(refs, k))],
        sdpa_grad_row_rel_err=gathered_grad_row_errs(
            grads, refs, k, [f[full] for f in floors]))


def gathered_fp64_grad_errs(K, args, got, refs, keep) -> dict:
    """The kernel's dq, dk and dv (``got``) and the fp32 plain version's
    (``refs``) against the plain version run in fp64 on the same inputs,
    lse and D, each over the largest fp64 value and row by row without
    rounding floors (`gathered_grad_row_errs`): whether the kernel's
    distance from the fp32 plain version is its own or fp32's, and which
    rows fp32 does not resolve at all; context, never a limit."""
    a64 = [t.double() if t.is_floating_point() else t for t in args[:-1]]
    r64 = (K.routed_attention_blocks_bwd_dq_plain(*a64, args[-1]),
           *K.routed_attention_blocks_bwd_dkv_plain(*a64, args[-1]))

    def errs(xs):
        return [float((x.double() - r).abs().max() / r.abs().max())
                for x, r in zip(xs, r64)]
    return dict(kernel_vs_fp64=errs(got), plain_vs_fp64=errs(refs),
                kernel_vs_fp64_rows=gathered_grad_row_errs(got, r64, keep),
                plain_vs_fp64_rows=gathered_grad_row_errs(refs, r64, keep))


def check_gathered(torch, B, H, kc, w, dh, dtype, gen, causal=True,
                   shared=True):
    """The three gathered kernels at one shape: each against its plain
    version in fp32 on the same inputs, timed beside the plain version (in
    ``dtype``) and SDPA over the blocks with the boolean keep mask
    (forward; backward for all of dq, dk/dv); the output also row by row
    within ROW_REL_TOL, dq, dk and dv row by row under the position mask
    (`gathered_grad_row_errs`) within BWD_ROW_REL_TOL. A bf16 row also
    reports SDPA's own forward and backward errors, the kernel's and the
    plain version's against fp64, and CUDA-graph times (`graph_ms`)."""
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
    row_err = row_rel_err(out, ref_out)
    if not (out_ok(out, ref_out) and lerr <= LSE_TOL
            and row_err <= ROW_REL_TOL):
        raise AssertionError(f"routing_gathered disagrees with its plain "
                             f"version: out {err}, lse {lerr}, row "
                             f"{row_err}")
    args32 = (*f32, pqf, pkf, do.float(), lse, dsum, causal)
    ref_dq = K.routed_attention_blocks_bwd_dq_plain(*args32)
    ref_dk, ref_dv = K.routed_attention_blocks_bwd_dkv_plain(*args32)
    keep = gathered_keep(pqf, pkf, causal)
    fwd_report = dict(out_rel_err=rel_err(out, ref_out), row_rel_err=row_err)
    if dtype == torch.bfloat16:
        f64 = [t.double() for t in (qf, kf, vf)]
        ref64, _ = K.routed_attention_blocks_plain(
            f64[0], f64[0] if shared else f64[1], f64[2], pqf, pkf, causal)
        fwd_report.update(**fwd_fp64_errs(out, ref_out, ref64),
                          **sdpa_out_errs(
                              torch, qf[:, None], kf[:, None], vf[:, None],
                              ref_out[:, None], mask=keep[:, None]))
        del ref64
    del ref_out, ref_lse

    grads, refs = (dq, dk, dv), (ref_dq, ref_dk, ref_dv)
    floors = gathered_row_floors(torch, qf, kf, vf, do, lse, keep)
    grad_row = gathered_grad_row_errs(grads, refs, keep, floors)
    if max(grad_row) > BWD_ROW_REL_TOL:
        raise AssertionError(f"a gathered backward kernel disagrees with "
                             f"its plain version in a row: {grad_row}")
    bf16 = dtype == torch.bfloat16
    report = {}
    if bf16:
        report = dict(
            grad_rel_err=[rel_err(g, r) for g, r in zip(grads, refs)],
            **gathered_sdpa_grad_errs(torch, qf, kf, vf, do, refs, keep,
                                      floors),
            **gathered_fp64_grad_errs(K, args, grads, refs, keep))
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
    fwd = lambda: K.routed_attention_blocks(qf, kf, vf, pqf, pkf,  # noqa
                                            causal)
    ms = time_ms(fwd)
    rows = {"routing_gathered": dict(
        max_abs_err=err, lse_err=lerr, ms=ms,
        plain_ms=time_ms(lambda: K.routed_attention_blocks_plain(
            qf, kf, vf, pqf, pkf, causal)),
        library_ms=time_ms(lambda: sdpa(qf[:, None], kf[:, None],
                                        vf[:, None], attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms, shape=shape,
        pairs=pairs, **fwd_report)}
    if bf16:
        rows["routing_gathered"]["graph_ms"] = graph_ms(torch, fwd)
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
    for name, part, fn in (
            ("routing_gathered_bwd_dq", slice(0, 1),
             K.routed_attention_blocks_bwd_dq),
            ("routing_gathered_bwd_dkv", slice(1, 3),
             K.routed_attention_blocks_bwd_dkv)):
        rows[name]["grad_row_rel_err"] = grad_row[part]
        rows[name].update({key: val[part] for key, val in report.items()})
        if bf16:
            rows[name]["graph_ms"] = graph_ms(torch, lambda: fn(*args))
    return rows


def check_gathered_edges(torch, gen) -> list:
    """The three gathered kernels in bf16 at GATHERED_EDGES, each against
    its plain version in fp32 on the same inputs: out within OUT_REL_TOL of
    its largest reference value and within ROW_REL_TOL in every row (rows
    that keep no key zero), lse within LSE_TOL (as the forward is held at
    every gathered row); dq, dk and dv within BWD_REL_TOL of their
    largest reference values (`gathered_grad_scales`) and within
    BWD_ROW_REL_TOL in every row (`gathered_grad_row_errs`). SDPA's own
    backward errors are reported beside each row."""
    from repro_torch.core import row_dot
    from repro_torch.kernels import routing_gathered as K
    rows = []
    for B, H, kc, w, dh, causal, shared in GATHERED_EDGES:
        qf, kf, vf, pqf, pkf = gathered_inputs(
            torch, B, H, kc, w, dh, torch.bfloat16, gen, causal, shared,
            empty_cluster=True)
        out, lse = K.routed_attention_blocks(qf, kf, vf, pqf, pkf, causal)
        do = torch.randn(out.shape, generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
        args = (qf, kf, vf, pqf, pkf, do, lse, row_dot(do, out), causal)
        got = (K.routed_attention_blocks_bwd_dq(*args),
               *K.routed_attention_blocks_bwd_dkv(*args))
        torch.cuda.synchronize()
        f32 = [t.float() for t in (qf, kf, vf)]
        if shared:
            f32[1] = f32[0]
        ref_out, ref_lse = K.routed_attention_blocks_plain(*f32, pqf, pkf,
                                                           causal)
        args32 = (*f32, pqf, pkf, do.float(), *args[6:])
        refs = (K.routed_attention_blocks_bwd_dq_plain(*args32),
                *K.routed_attention_blocks_bwd_dkv_plain(*args32))
        keep = gathered_keep(pqf, pkf, causal)
        scales = gathered_grad_scales(refs, keep)
        floors = gathered_row_floors(torch, qf, kf, vf, do, lse, keep)
        row = dict(shape=(f"B{B} H{H} k{kc} w{w} dh{dh} "
                          f"{'causal' if causal else 'non-causal'} "
                          f"{'shared-QK' if shared else 'separate-QK'}"),
                   out_rel_err=rel_err(out, ref_out),
                   row_rel_err=row_rel_err(out, ref_out),
                   lse_err=max_err(lse, ref_lse),
                   no_key_rows=int((~keep.any(-1)).sum()),
                   grad_rel_err=[max_err(a, r) / sc
                                 for a, r, sc in zip(got, refs, scales)],
                   grad_row_rel_err=gathered_grad_row_errs(got, refs, keep,
                                                           floors),
                   **gathered_sdpa_grad_errs(torch, qf, kf, vf, do, refs,
                                             keep, floors))
        rows.append(row)
        if not (row["out_rel_err"] <= OUT_REL_TOL
                and row["row_rel_err"] <= ROW_REL_TOL
                and row["lse_err"] <= LSE_TOL
                and all(e <= BWD_REL_TOL for e in row["grad_rel_err"])
                and max(row["grad_row_rel_err"]) <= BWD_ROW_REL_TOL):
            raise AssertionError(f"a gathered kernel disagrees with its "
                                 f"plain version at a ragged shape: {row}")
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


def profiled(torch, fn, top: int = 15, spans: str = None) -> dict:
    """Run ``fn`` under torch.profiler: wall ms, device busy ms, device
    launches, host aten calls and the ``top`` device ops by time. Device
    events named with the ``spans`` prefix are `record_function` spans
    (the engine's ``engine/...``), which the profiler lists with the
    device time beneath them: left out of the sums, as are, since slice
    17, the train and kernel spans (`PORT_SPANS`) every path now runs."""
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
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not (spans and e.key.startswith(spans))
                  and not e.key.startswith(PORT_SPANS)),
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


def sdpa_attention(torch):
    """A stand-in for `FlashAttention` that calls SDPA (causal on row
    indices, GQA): the bf16 gate's yardstick, swapped in here only; the
    port never calls SDPA."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return types.SimpleNamespace(apply=lambda q, k, v, causal: sdpa(
        q, k, v, is_causal=causal, enable_gqa=True))


def full_train_gate_bf16(torch, cfg, params, kstate, batch):
    """qwen2's bf16 train step (dropout 0, the same bf16 weights) on three
    paths, each against the plain path (loss and median leaf gradient
    difference): the kernel path; as the yardstick, the plain path with
    SDPA in place of the flash kernels (`sdpa_attention`); and the negative
    control `first_query_head_only`. The kernel path's median must stay
    within BF16_GATE_FACTOR times SDPA's, the control must exceed that
    limit, and the kernel path run again must give the same gradients
    (``repeat`` 0.0)."""
    from repro_torch.configs import with_overrides
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_map
    run = full_run_config(with_overrides(cfg, dropout=0.0), FULL_GATE_BATCH,
                          FULL_GATE_SEQ)

    def step(ctx=contextlib.nullcontext(), impl=None):
        with ctx:
            vg = value_and_grad(make_loss_fn(run, impl=impl))
            (loss, _), grads = vg(params, kstate, batch, None)
            torch.cuda.synchronize()
        return float(loss), tree_map(lambda t: t.float(), grads)

    lk, gk = step()
    lp, gp = step(impl="torch")
    ls, gs = step(swapped(KF, "FlashAttention", sdpa_attention(torch)))
    _, gr = step()
    _, gb = step(swapped(KF, "flash_attention_bwd", first_query_head_only))
    limit = BF16_GATE_FACTOR * grad_agreement(gs, gp)["grad_rel_median"]
    out = dict(loss_kernel=lk, loss_plain=lp, loss_sdpa=ls,
               loss_diff=abs(lk - lp), sdpa_loss_diff=abs(ls - lp),
               kernel=grad_agreement(gk, gp), sdpa=grad_agreement(gs, gp),
               grad_median_limit=limit, repeat=grad_agreement(gr, gk),
               first_head_only=grad_agreement(gb, gp),
               shape=f"B{FULL_GATE_BATCH} x {FULL_GATE_SEQ}")
    if out["kernel"]["grad_rel_median"] > limit:
        raise AssertionError(f"bf16 kernel and plain qwen2 train steps "
                             f"disagree by more than {BF16_GATE_FACTOR}x "
                             f"SDPA's difference: {out}")
    if out["repeat"]["grad_rel_max"] != 0.0:
        raise AssertionError(f"the bf16 qwen2 kernel path differs from "
                             f"itself on the same inputs: {out}")
    if out["first_head_only"]["grad_rel_median"] <= limit:
        raise AssertionError(f"the qwen2 bf16 gate passes a broken "
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


def train_losses(torch, run, params, kstate, batches) -> list:
    """The losses of ``batches`` through `make_train_step(run)` from the
    state `train` starts at (the end of warm-up); no launch is held."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_step import TrainState, make_train_step
    step_fn = make_train_step(run)
    ts = TrainState(params, kstate, make_optimizer(run.train)[0](params),
                    run.train.warmup_steps)
    losses = []
    for batch in batches:
        ts, metrics = step_fn(ts, batch)
        losses.append(float(metrics["loss"]))
    return losses


def train_paper(torch, run, path, counts, gate_limits=None):
    """One of the paper's other models at full width and depth (random
    weights from seed 0, `PAPER_STEPS` markov batches over min(V, 512)
    tokens): with ``gate_limits`` first its fp32 `routing_gate` on one
    sequence; then bf16 steps through `make_train_step` (`train`: launch
    counts set to 0 just before and read just after, exact for ``path``,
    the loss finite and falling), and one more step under the profiler for
    its busy time. Where ``run`` leaves the default schedule, the same
    steps under the default one are reported beside it (not gated).
    Returns (row, launches)."""
    from dataclasses import replace
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model import init_model
    cfg = run.model
    params, kstate = init_model(cfg, seed=0, device=DEVICE)
    batches = train_batches(torch, min(cfg.vocab_size, FULL_VOCAB),
                            run.train.global_batch, run.train.seq_len,
                            PAPER_STEPS + 1)
    gate = None
    if gate_limits is not None:
        gate = routing_gate(torch, cfg, params, kstate,
                            {"tokens": batches[0]["tokens"][:1]},
                            gate_limits)
        print(f"{path} fp32 gate {json.dumps(gate)}", flush=True)
    from repro_torch.kernels import common
    common.reset_counters()
    row, trained = train(torch, run, path, params, kstate,
                         batches[:PAPER_STEPS], counts)
    launches = common.counters()
    prof = profile_train(torch, run, trained, batches[-1])
    del trained
    default = TrainConfig().schedule
    if run.train.schedule != default:
        drun = replace(run, train=replace(run.train, schedule=default))
        row["default_schedule_losses"] = train_losses(
            torch, drun, params, kstate, batches[:PAPER_STEPS])
    row.update(shape=f"B{run.train.global_batch} x {run.train.seq_len}",
               busy_ms=prof["device_busy_ms"],
               busy_launches=prof["device_launches"],
               busy_top_ops=prof["device_ops"][:5], fp32_gate=gate)
    print(f"{path} {json.dumps(row)}", flush=True)
    return row, launches


def serve_model(torch, path, cfg, request, counts):
    """Serve ``cfg`` at full width and depth (random weights from seed 0,
    bf16; a prompt of random tokens from seed 1): `request` through `serve`
    on the kernel path, launch counts set to 0 just before and read just
    after, exact per prefill and per step; then one prefill and one decode
    step under the profiler (`profile`: device busy ms). Then the fp32 gate
    on the same prompt and weights: a
    routing model's kernel path against its plain path (impl="torch")
    teacher-forced with the kernel path's tokens, under the serving gates
    (MIN_TOP1_FP32, MAX_MEDIAN_DIFF_FP32; each routes on its own, the
    routing calls whose membership differed are counted); a full model's
    decode steps against the prefill logits of prompt + tokens
    (MAX_MEDIAN_DIFF_FULL_FP32). Returns (row, launches)."""
    from repro_torch.configs import with_overrides
    from repro_torch.kernels import common
    from repro_torch.models.model import init_model
    from repro_torch.serve import serving
    from repro_torch.tree import tree_map
    B, N, T = request
    torch.cuda.reset_peak_memory_stats()
    params, kstate = init_model(cfg, seed=0, device=DEVICE)
    gen_tok = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, N), generator=gen_tok,
                            device=DEVICE)
    # warm-up outside the counted run: cuBLAS handles, kernel loading
    serve(torch, cfg, params, kstate, prompts[:1, :512], 2)
    common.reset_counters()
    kr = serve(torch, cfg, params, kstate, prompts, T, counts=counts)
    launches = common.counters()
    prof = profile(torch, cfg, params, kstate, prompts)
    row = dict(model=cfg.name, batch=B, prompt=N, new_tokens=T,
               prefill_ms=kr["prefill_ms"], prefill_tok_s=kr["prefill_tok_s"],
               decode_ms_per_token=kr["decode_ms_per_token"],
               decode_tok_s=kr["decode_tok_s"],
               prefill_busy_ms=prof["prefill"]["device_busy_ms"],
               decode_busy_ms=prof["decode_step"]["device_busy_ms"],
               prefill_top_ops=prof["prefill"]["device_ops"][:5],
               decode_top_ops=prof["decode_step"]["device_ops"][:5],
               peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    del kr, prof
    cfg32 = with_overrides(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    calls = []
    with membership_recorded(calls):
        k32 = serve(torch, cfg32, params32, kstate, prompts, T)
    if layer_counts(cfg)["full"] == cfg.num_layers:
        tokens = torch.cat([prompts, k32["tokens"]], 1)
        cache = serving.init_cache(cfg32, B, N + T, device=DEVICE)
        logits, _ = serving.prefill(params32, kstate, cache,
                                    {"tokens": tokens}, cfg32)
        ref = dict(logits=logits[:, :N], step_logits=logits[:, N:])
        limit, what = MAX_MEDIAN_DIFF_FULL_FP32, "teacher-forced forward"
        extra = {}
    else:
        own = []
        with membership_recorded(own):
            ref = serve(torch, cfg32, params32, kstate, prompts, T,
                        impl="torch", forced=k32["tokens"])
        limit, what = MAX_MEDIAN_DIFF_FP32, "plain path"
        extra = dict(fp32_routing_calls=len(calls),
                     fp32_membership_differed=sum(
                         bool((a != b).any()) for a, b in zip(calls, own)))
    cmp32 = compare_paths(k32, ref, cfg.vocab_size)
    del k32, ref, params32
    torch.cuda.empty_cache()
    row.update(gate=f"fp32 against the {what}", fp32=cmp32, **extra)
    print(f"{path} {json.dumps(row)}", flush=True)
    if (min(cmp32["prefill_top1"], cmp32["decode_top1"]) < MIN_TOP1_FP32
            or max(cmp32["prefill_median_diff"],
                   cmp32["decode_median_diff"]) > limit):
        raise AssertionError(f"{path}: the fp32 kernel path disagrees with "
                             f"the {what}: {cmp32}")
    return row, launches


# ---------------------------------------------------------------------------
# Since slice 15: the continuous-batching engine on full-width rt-enwik8
# ---------------------------------------------------------------------------
def engine_requests(torch, cfg):
    """The `serve_engine` workload (seed 12): ENGINE_REQUESTS requests,
    prompts cycling through ENGINE_PROMPTS, ENGINE_NEW_TOKENS new tokens,
    two arrivals per step, odd uids sampled (ENGINE_SAMPLING), uid
    ENGINE_INTERACTIVE of the interactive class, the last ENGINE_REPEATS
    repeating the first prompts."""
    from repro_torch.serve.engine import (PRIORITY_INTERACTIVE, Request,
                                          SamplingParams)
    gen = torch.Generator().manual_seed(12)
    fresh = ENGINE_REQUESTS - ENGINE_REPEATS
    lo, hi = ENGINE_NEW_TOKENS
    reqs = []
    for uid in range(ENGINE_REQUESTS):
        n = ENGINE_PROMPTS[uid % len(ENGINE_PROMPTS)]
        prompt = (torch.randint(0, cfg.vocab_size, (n,), generator=gen)
                  .tolist() if uid < fresh else reqs[uid - fresh].prompt)
        reqs.append(Request(
            uid=uid, prompt=prompt, arrival_step=uid // 2,
            max_new_tokens=int(torch.randint(lo, hi + 1, (1,),
                                             generator=gen)),
            sampling=(SamplingParams(**ENGINE_SAMPLING) if uid % 2
                      else SamplingParams()),
            priority=(PRIORITY_INTERACTIVE if uid == ENGINE_INTERACTIVE
                      else 0)))
    return reqs


def fresh_requests(reqs):
    from dataclasses import replace
    return [replace(r, output=[], state="WAITING") for r in reqs]


def engine_launch_checks(eng, counts):
    """Wrap ``eng``'s prefill, prefill stages, decode step, park, resume,
    activation, session export and import so that each call holds its own
    launches: a model prefill 1 local and 1 fused launch per layer with
    those heads, a chunked stage those of its layers, a decode step 1
    decode launch per routing layer, a park, a resume, an activation (all
    of an exact prefix hit's admission), an export and an import none.
    Returns the per-event call counts and the launches they add up to."""
    from repro_torch.attn.spec import spec_for_layer
    from repro_torch.models.transformer import build_segments
    cfg = eng.cfg
    segments = build_segments(cfg)
    events, total = {}, {}

    def of(si, n_groups):
        variants = [spec_for_layer(cfg, s.attn).variant
                    for s in segments[si][0]]
        return {"local_attention": n_groups * sum("local" in v
                                                  for v in variants),
                "routing_fused": n_groups * sum("routing" in v
                                                for v in variants)}

    prefill_want = {"local_attention": 0, "routing_fused": 0}
    for si, (_, G) in enumerate(segments):
        for k, v in of(si, G).items():
            prefill_want[k] += v
    decode_want = {"routing_decode": prefill_want["routing_fused"]}

    def wrap(name, fn, want):
        def call(*args, **kwargs):
            before, steps = counts(), eng.metrics.decode_steps
            out = fn(*args, **kwargs)
            after = counts()
            got = {n: after[n] - before.get(n, 0) for n in after
                   if after[n] != before.get(n, 0)}
            w = ({} if name == "decode_step"
                 and eng.metrics.decode_steps == steps else want)
            if got != {k: v for k, v in w.items() if v}:
                raise AssertionError(f"serve_engine {name} launches {got}, "
                                     f"expected {w}")
            events[name] = events.get(name, 0) + 1
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            return out
        return call

    eng._prefill = wrap("prefill", eng._prefill, prefill_want)
    eng._decode_once = wrap("decode_step", eng._decode_once, decode_want)
    for name in ("_park_slot", "_resume_into", "_activate",
                 "export_session", "import_session"):
        setattr(eng, name, wrap(name.lstrip("_"), getattr(eng, name), {}))
    if eng.chunked_prefill is not None:
        eng._pf_stages = [(st, wrap("prefill_stage", fn,
                                    of(st.si, st.g1 - st.g0)))
                          for st, fn in eng._pf_stages]
    return events, total


def drive_engine(torch, eng, reqs, profile_step=None):
    """``eng.run(reqs)`` step by step: returns whether every slot was busy
    when each interactive-class request arrived and, at ``profile_step``,
    one engine step under the profiler (`profiled`)."""
    pending = sorted(reqs, key=lambda r: (r.arrival_step, r.uid))
    busy, prof = [], None
    while pending or eng.has_work():
        while pending and pending[0].arrival_step <= eng.step_count:
            r = pending.pop(0)
            if r.priority > 0:
                busy.append(not eng.free_slot_ids())
            eng.submit(r)
        if eng.step_count == profile_step:
            prof = profiled(torch, eng.step, spans="engine/")
        else:
            eng.step()
        if eng.step_count > 100_000:
            raise AssertionError("serve_engine: the engine did not drain")
    torch.cuda.synchronize()
    return busy, prof


def engine_mismatches(out_a, trace_a, out_b, trace_b, uids):
    """The uids whose tokens or recorded logits rows differ in any bit."""
    bad = []
    for uid in uids:
        rows_a, rows_b = trace_a.get(uid, []), trace_b.get(uid, [])
        if (out_a.get(uid) != out_b.get(uid) or len(rows_a) != len(rows_b)
                or any(a.shape != b.shape or a.tobytes() != b.tobytes()
                       for a, b in zip(rows_a, rows_b))):
            bad.append(uid)
    return bad


def engine_control(torch, cfg, params, kstate, req, ref_out, ref_trace,
                   poison):
    """One workload request alone in a same-size pool, parked by its
    handle after ENGINE_CONTROL_PARK_AT tokens and resumed, cut at
    ENGINE_CONTROL_TOKENS; with ``poison`` its parked pages' values are
    shifted by 1 in the store first. Returns the parity mismatches
    against the same tokens of run B and, taken before the park, the KV
    store round trip of its lane through a store of its own: the lane
    read back with read_slot after a resume into another slot against
    the lane before the park, and the store's bytes against the
    uncompacted lane's."""
    from repro_torch.serve.engine import (InferenceEngine, read_slot,
                                          reset_slot, write_slot)
    from repro_torch.serve.kvstore import KVStore
    from repro_torch.tree import tree_leaves
    eng = InferenceEngine(cfg, params, kstate, max_slots=ENGINE_SLOTS,
                          max_len=ENGINE_MAX_LEN, record_logits=True,
                          device=DEVICE)
    (r,) = fresh_requests([req])
    r.max_new_tokens = ENGINE_CONTROL_TOKENS
    h = eng.submit(r)
    while len(h.output) < ENGINE_CONTROL_PARK_AT:
        eng.step()
    slot = eng.metrics.requests[r.uid].slot
    lane = read_slot(eng.pool, slot)
    store = KVStore()
    parked = store.park(r.uid, lane).nbytes
    other = (slot + 1) % ENGINE_SLOTS
    write_slot(eng.pool, other, store.resume(r.uid))
    back = read_slot(eng.pool, other)
    reset_slot(eng.pool, other)
    round_trip = dict(
        bitwise=all(torch.equal(a, b) for a, b in zip(tree_leaves(lane),
                                                      tree_leaves(back))),
        parked_bytes=parked, lane_bytes=nbytes(*tree_leaves(lane)))
    h.park()
    # the engine's own store finishes a park on its background thread
    eng.kvstore.flush()
    if poison:
        for key, rec in eng.kvstore._sessions[r.uid].leaves.items():
            if key[-1] == "rv" and rec.page_len_key is not None:
                rec.data += 1
    h.resume()
    while eng.has_work():
        eng.step()
    eng.close()
    n = ENGINE_CONTROL_TOKENS
    bad = engine_mismatches({r.uid: h.output}, eng.logits_trace,
                            {r.uid: ref_out[r.uid][:n]},
                            {r.uid: ref_trace[r.uid][:n]}, [r.uid])
    del eng
    torch.cuda.empty_cache()
    return bad, round_trip


def engine_fp32_gate(torch, cfg, params, kstate):
    """The engine in fp32 on the kernels (impl=None) against the engine on
    the plain path (impl="torch"), same weights upcast: ENGINE_GATE's
    requests (random prompts from seed 13, greedy), every recorded logits
    row (the prefill's last and each decode step's) under the serving
    gates (MIN_TOP1_FP32, MAX_MEDIAN_DIFF_FP32)."""
    from repro_torch.configs import with_overrides
    from repro_torch.serve.engine import InferenceEngine, Request
    from repro_torch.tree import tree_map
    n, N, T = ENGINE_GATE
    cfg32 = with_overrides(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    gen = torch.Generator().manual_seed(13)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (N,),
                                                generator=gen).tolist(),
                    max_new_tokens=T) for i in range(n)]
    runs = {}
    for impl in (None, "torch"):
        eng = InferenceEngine(cfg32, params32, kstate, max_slots=n,
                              max_len=N + T, record_logits=True, impl=impl,
                              device=DEVICE)
        out = eng.run(fresh_requests(reqs))
        eng.close()
        runs[impl] = (out, torch.stack([torch.from_numpy(row)
                                        for i in range(n)
                                        for row in eng.logits_trace[i]]))
        del eng
    del params32
    torch.cuda.empty_cache()
    (k_out, k_rows), (p_out, p_rows) = runs[None], runs["torch"]
    V = cfg.vocab_size
    a, b = k_rows[:, :V].double(), p_rows[:, :V].double()
    d = (a - b).abs().amax(-1)
    cmp = dict(requests=n, prompt=N, new_tokens=T, rows=int(d.numel()),
               tokens_equal=k_out == p_out, max_diff=float(d.max()),
               median_diff=float(d.median()),
               top1=float((a.argmax(-1) == b.argmax(-1)).double().mean()))
    if (cmp["top1"] < MIN_TOP1_FP32
            or cmp["median_diff"] > MAX_MEDIAN_DIFF_FP32):
        raise AssertionError(f"serve_engine: the fp32 engine on the kernels "
                             f"disagrees with the plain path: {cmp}")
    return cmp


def engine_sampling_bits(torch):
    """`repro_torch.prng` keys, random bits and uniform floats, and
    `sample_tokens` tokens, on the card against the CPU for a fixed set of
    keys (seeds x uids x token indices up to 2^32 - 1) and logits (seed
    14, one filter setting per row). Keys, bits and floats come from
    integer arithmetic; the tokens depend on floats only through ties
    within an ulp. The gumbel noise (torch's log on each device) is
    reported. Raises on a difference."""
    from repro_torch import prng
    from repro_torch.serve.engine import sample_tokens
    grid = torch.meshgrid(torch.tensor([0, 1, 12, 2 ** 31, 2 ** 32 - 1]),
                          torch.tensor([0, 7, 17, 2 ** 32 - 1]),
                          torch.tensor([0, 1, 63, 2 ** 32 - 1]),
                          indexing="ij")
    seeds, uids, idx = (g.flatten() for g in grid)
    n = seeds.numel()
    gen = torch.Generator().manual_seed(14)
    logits = 3.0 * torch.randn((n, 256), generator=gen)
    settings = ((0.0, 0, 1.0), (1.0, 40, 1.0), (0.9, 0, 0.9),
                (0.8, 40, 0.95), (1.3, 1, 1.0), (1.3, 0, 1e-6))
    rows = [settings[i % len(settings)] for i in range(n)]
    temps = torch.tensor([r[0] for r in rows])
    top_ks = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    top_ps = torch.tensor([r[2] for r in rows])
    got = {}
    for dev in ("cpu", DEVICE):
        keys = prng.fold_in(prng.fold_in(prng.key(seeds.to(dev)),
                                         uids.to(dev)), idx.to(dev))
        got[dev] = dict(
            keys=keys.cpu(), bits=prng.random_bits(keys, (257,)).cpu(),
            uniform=prng.uniform(keys, (257,)).cpu(),
            gumbel=prng.gumbel(keys, (257,)).cpu(),
            tokens=sample_tokens(keys, logits.to(dev), temps.to(dev),
                                 top_ks.to(dev), top_ps.to(dev)).cpu())
    cpu, card = got["cpu"], got[DEVICE]
    g, h = cpu["gumbel"], card["gumbel"]
    one = torch.maximum(g.abs(), torch.ones_like(g))
    ulp = torch.nextafter(one, torch.full_like(one, math.inf)) - one
    out = {k: bool(torch.equal(cpu[k], card[k]))
           for k in ("keys", "bits", "uniform", "tokens")}
    out.update(keys_checked=n,
               gumbel_equal=float((g == h).double().mean()),
               gumbel_max_ulps=float(((g - h).abs() / ulp).max()))
    if not all(out[k] for k in ("keys", "bits", "uniform", "tokens")):
        raise AssertionError(f"serve_engine: the card's sampling bits differ "
                             f"from the CPU's: {out}")
    return out


def serve_engine(torch, card, counts):
    """The `serve_engine` path: full-width rt-enwik8 (random bf16 weights
    from seed 0) through `InferenceEngine` on the kernels, run A
    (ENGINE_RUN_A: chunked prefill, time slices, a prefix cache) then run
    B (none of them, free slots taken in reverse order), launch counts set
    to 0 just before run A and read just after run B. Gates: (1) every
    request's tokens and recorded logits rows equal in A and B bit for
    bit, and a lane poisoned in the store before its resume breaks that
    parity (a clean park and resume keeps it); (2) each prefill, chunked
    stage, decode step, park, resume and activation launches exactly its
    kernels (`engine_launch_checks`), and the launches add up to the
    counters; (3) the fp32 engine gate; (4) the card's sampling bits; (5)
    the KV store round trip. Run A parks through the engine's own store
    (async transfers since slice 16). Returns (row, launches, run B's
    tokens and logits rows, for `serve_disagg`)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import InferenceEngine
    from repro_torch.serve.kvstore import PrefixCache
    cfg = get_config(ARCH)
    params, kstate = init_model(cfg, seed=0, device=DEVICE)
    reqs = engine_requests(torch, cfg)
    # warm-up outside the counted runs: cuBLAS handles, kernel loading
    InferenceEngine(cfg, params, kstate, max_slots=ENGINE_SLOTS,
                    max_len=ENGINE_MAX_LEN, device=DEVICE).run(
                        [replace(reqs[0], output=[], max_new_tokens=2)])
    torch.cuda.empty_cache()
    common.reset_counters()
    runs = {}
    for name, kw in (("A", dict(ENGINE_RUN_A, prefix_cache=PrefixCache())),
                     ("B", {})):
        eng = InferenceEngine(cfg, params, kstate, max_slots=ENGINE_SLOTS,
                              max_len=ENGINE_MAX_LEN, record_logits=True,
                              device=DEVICE, **kw)
        if name == "B":
            eng.free_slot_ids = (lambda e=eng: list(reversed(
                InferenceEngine.free_slot_ids(e))))
        events, total = engine_launch_checks(eng, counts)
        run_reqs = fresh_requests(reqs)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        busy, prof = drive_engine(torch, eng, run_reqs,
                                  ENGINE_PROFILE_STEP if name == "A"
                                  else None)
        wall = time.perf_counter() - t0
        eng.close()                 # raises a failed background park
        after = counts()
        got = {n: after[n] - before[n] for n in after
               if after[n] != before[n]}
        if got != total:
            raise AssertionError(f"serve_engine run {name}: launches {got}, "
                                 f"the engine's events add up to {total}")
        if not (busy and all(busy)):
            raise AssertionError(f"serve_engine run {name}: the interactive "
                                 f"request found a free slot: {busy}")
        if not all(r.state == "FINISHED" for r in run_reqs):
            raise AssertionError(f"serve_engine run {name}: not all "
                                 f"requests finished")
        row = dict(eng.metrics.summary(), wall_s=wall, events=events,
                   launches=got, kvstore=eng.kvstore.stats())
        if eng.prefix_cache is not None:
            row["prefix"] = eng.prefix_cache.stats()
        if prof is not None:
            row["profiled_step"] = dict(
                step=ENGINE_PROFILE_STEP, wall_ms=prof["wall_ms"],
                busy_ms=prof["device_busy_ms"],
                device_launches=prof["device_launches"],
                top_ops=prof["device_ops"][:6])
        runs[name] = (eng, {r.uid: list(r.output) for r in run_reqs}, row)
        print(f"serve_engine run {name} [{card}] {json.dumps(row)}",
              flush=True)
    launches = common.counters()
    (eng_a, out_a, row_a), (eng_b, out_b, row_b) = runs["A"], runs["B"]
    bad = engine_mismatches(out_a, eng_a.logits_trace, out_b,
                            eng_b.logits_trace, [r.uid for r in reqs])
    ran = dict(prefix_hits=row_a["prefix"]["kvstore/prefix_hits"] >= 1,
               parks_a=row_a["parks"] >= 1 and row_a["resumes"] >= 1,
               stages_a=row_a["events"].get("prefill_stage", 0) > 0,
               parks_b=row_b["parks"] >= 1)
    trace_b = eng_b.logits_trace
    park_a = {k: row_a["kvstore"].get(f"kvstore/{k}_p50_s")
              for k in ("park", "park_transfer", "resume")}
    del runs, eng_a, eng_b
    torch.cuda.empty_cache()
    if bad or not all(ran.values()):
        raise AssertionError(f"serve_engine: runs A and B differ on uids "
                             f"{bad}, or a feature never ran: {ran}")
    control = {}
    for poison in (False, True):
        mism, rt = engine_control(torch, cfg, params, kstate,
                                  reqs[ENGINE_CONTROL_UID], out_b, trace_b,
                                  poison)
        control["poisoned" if poison else "clean"] = dict(
            mismatches=mism, store_round_trip=rt)
        if bool(mism) != poison:
            raise AssertionError(f"serve_engine control (poisoned "
                                 f"{poison}): parity mismatches {mism}")
        if not rt["bitwise"] or rt["parked_bytes"] >= rt["lane_bytes"]:
            raise AssertionError(f"serve_engine KV store round trip: {rt}")
    gate = engine_fp32_gate(torch, cfg, params, kstate)
    bits = engine_sampling_bits(torch)
    row = dict(card=card, model=cfg.name, slots=ENGINE_SLOTS,
               max_len=ENGINE_MAX_LEN, requests=len(reqs), run_a=row_a,
               run_b=row_b, parity_mismatches=bad, features_ran=ran,
               control=control, fp32_gate=gate, sampling_bits=bits,
               run_a_p50_s=park_a)
    print(f"serve_engine [{card}] control {json.dumps(control)} fp32 gate "
          f"{json.dumps(gate)} sampling bits {json.dumps(bits)} run A p50 s "
          f"(park as the caller sees it, its background transfer, resume) "
          f"{json.dumps(park_a)}", flush=True)
    del params, kstate
    torch.cuda.empty_cache()
    return row, launches, (out_b, trace_b)


# ---------------------------------------------------------------------------
# Since slice 16: disaggregated prefill and decode pools through the KV
# store's tiers
# ---------------------------------------------------------------------------
def flipped_payload_byte(blob: bytes) -> bytes:
    """``blob`` with one byte of its leaf payload (the middle one, past the
    JSON header) flipped: its CRC no longer matches."""
    hdr_len = int.from_bytes(blob[5:9], "big")
    start, end = 9 + hdr_len, len(blob) - 4
    i = (start + end) // 2
    return blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1:]


def serve_disagg(torch, card, counts, ref_out, ref_trace):
    """The `serve_disagg` path: full-width rt-enwik8 (random bf16 weights
    from seed 0), the first DISAGG_REQUESTS requests of the `serve_engine`
    workload in two engines of ENGINE_SLOTS lanes of ENGINE_MAX_LEN. A
    prefill pool (``prefill_only``) prefills them on the local and fused
    kernels and exports every session to a `TCPStoreServer` on 127.0.0.1
    (port 0, in this process), then closes. A decode pool imports them
    into a store with a TCP remote tier, a disk tier in a temporary
    directory and host and disk limits that keep the last DISAGG_HOST
    sessions on the host and the DISAGG_DISK before them on disk, async
    transfers and time slices of DISAGG_TIME_SLICE tokens, and decodes
    them on the paged decode kernel. Launch counts are set to 0 just
    before the prefill pool and read just after the decode pool. Gates:
    (1) every request's tokens and recorded logits rows (the prefill
    pool's first, the decode pool's after it) equal run B's of
    `serve_engine` bit for bit; (2) spills, remote parks, remote resumes,
    async parks, exports and imports each ran; (3) each prefill, decode
    step, park, resume, activation, export and import launches exactly
    its kernels (`engine_launch_checks`), adding up to the counters; (4) a
    blob with one payload byte flipped raises BlobChecksumError at the
    decode pool's import and leaves its store empty. Returns (row,
    launches)."""
    import tempfile
    from collections import Counter
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import InferenceEngine
    from repro_torch.serve.kvstore import KVStore, StoreConfig
    from repro_torch.serve.kvstore.remote import (BlobChecksumError,
                                                  TCPStoreServer,
                                                  TCPTransport)
    cfg = get_config(ARCH)
    params, kstate = init_model(cfg, seed=0, device=DEVICE)
    reqs = fresh_requests(engine_requests(torch, cfg)[:DISAGG_REQUESTS])
    uids = [r.uid for r in reqs]
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with TCPStoreServer("127.0.0.1", 0) as server, \
            tempfile.TemporaryDirectory() as spill:
        def tcp():
            return TCPTransport(server.host, server.port,
                                connect_timeout_s=10.0, io_timeout_s=120.0)

        common.reset_counters()
        pre = InferenceEngine(
            cfg, params, kstate, max_slots=ENGINE_SLOTS,
            max_len=ENGINE_MAX_LEN, record_logits=True, prefill_only=True,
            kvstore=KVStore(StoreConfig(remote=tcp(), async_transfers=True)),
            device=DEVICE)
        pre_events, pre_total = engine_launch_checks(pre, counts)
        for r in reqs:
            pre.submit(r)
        while pre.has_work():
            pre.step()
        pre.kvstore.flush()
        sizes = {u: pre.kvstore._sessions[u].nbytes for u in uids}
        t0 = time.perf_counter()
        names = [pre.export_session(u) for u in uids]
        export_s = time.perf_counter() - t0
        pre_trace, pre_stats = pre.logits_trace, pre.kvstore.stats()
        pre.close()
        del pre
        torch.cuda.empty_cache()
        tcp().put("corrupt/0", flipped_payload_byte(tcp().get(names[0])))

        host_limit = sum(sizes[u] for u in uids[-DISAGG_HOST:])
        disk_limit = sum(sizes[u] for u in
                         uids[-DISAGG_HOST - DISAGG_DISK:-DISAGG_HOST])
        dec = InferenceEngine(
            cfg, params, kstate, max_slots=ENGINE_SLOTS,
            max_len=ENGINE_MAX_LEN, record_logits=True,
            time_slice=DISAGG_TIME_SLICE,
            kvstore=KVStore(StoreConfig(
                remote=tcp(), async_transfers=True, spill_dir=spill,
                host_bytes_limit=host_limit, disk_bytes_limit=disk_limit)),
            device=DEVICE)
        dec_events, dec_total = engine_launch_checks(dec, counts)
        try:
            dec.import_session("corrupt/0")
            refused = False
        except BlobChecksumError:
            refused = len(dec.kvstore) == 0 and not dec.has_work()
        tcp().delete("corrupt/0")
        t0 = time.perf_counter()
        handles = [dec.import_session(n) for n in names]
        import_s = time.perf_counter() - t0
        at_import = Counter(s.tier for s in dec.kvstore._sessions.values())
        t0 = time.perf_counter()
        while dec.has_work():
            dec.step()
            if dec.step_count > 100_000:
                raise AssertionError("serve_disagg: the decode pool did not "
                                     "drain")
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec.close()                 # raises a failed background park
        got = counts()
        left_on_server = len(server)
    wall = time.perf_counter() - t_start
    out = {h.uid: h.output for h in handles}
    trace = {u: pre_trace[u] + dec.logits_trace.get(u, []) for u in uids}
    bad = engine_mismatches(out, trace, ref_out, ref_trace, uids)
    total = Counter(pre_total) + Counter(dec_total)
    launches = {n: v for n, v in got.items() if v}
    st = dec.kvstore.stats()
    ran = {k: v >= 1 for k, v in (
        ("spills", st["kvstore/spills"]),
        ("remote_parks", st["kvstore/remote_parks"]),
        ("remote_resumes", st["kvstore/remote_resumes"]),
        ("async_parks", st["kvstore/parks"]
         if dec.kvstore.config.async_transfers else 0),
        ("exports", pre_stats["kvstore/exports"]),
        ("imports", st["kvstore/imports"]))}
    p50 = {k: st.get(f"kvstore/{k}_p50_s") for k in (
        "park", "park_transfer", "resume", "resume_host", "resume_disk",
        "resume_remote")}
    row = dict(
        card=card, model=cfg.name, slots=ENGINE_SLOTS,
        max_len=ENGINE_MAX_LEN, requests=len(reqs), wall_s=wall,
        export_s=export_s, import_s=import_s, decode_s=decode_s,
        parity_mismatches=bad, ran=ran, corrupt_blob_refused=refused,
        tiers_at_import=dict(at_import), host_bytes_limit=host_limit,
        disk_bytes_limit=disk_limit, session_bytes=sizes,
        p50_s=p50, prefill_pool_park_p50_s=pre_stats.get(
            "kvstore/park_p50_s"),
        bytes=dict(to_host=st["kvstore/bytes_to_host"],
                   spilled=st["kvstore/bytes_spilled"],
                   to_remote=st["kvstore/bytes_to_remote"],
                   from_remote=st["kvstore/bytes_from_remote"],
                   exported=pre_stats["kvstore/bytes_to_remote"]),
        decode_steps=dec.metrics.decode_steps,
        events=dict(prefill_pool=pre_events, decode_pool=dec_events),
        launches=launches, kvstore=st, blobs_left_on_server=left_on_server)
    print(f"serve_disagg [{card}] {json.dumps(row)}", flush=True)
    del dec, params, kstate
    torch.cuda.empty_cache()
    if bad or not all(ran.values()) or not refused:
        raise AssertionError(f"serve_disagg: tokens or logits differ from "
                             f"run B's on uids {bad}, a tier or transfer "
                             f"never ran ({ran}), or the corrupted blob was "
                             f"not refused ({refused})")
    if launches != dict(total):
        raise AssertionError(f"serve_disagg: launches {launches}, the "
                             f"pools' events add up to {dict(total)}")
    return row, launches


# ---------------------------------------------------------------------------
# Since slice 17: the routing-health stats and the obs layer on the card
# ---------------------------------------------------------------------------
def with_stats(cfg, on=True):
    """``cfg`` with ``RoutingConfig.stats`` set to ``on``."""
    from repro_torch.configs import with_overrides
    return with_overrides(cfg, routing=with_overrides(cfg.routing, stats=on))


def state_diff(torch, a, b) -> dict:
    """How two train states differ: leaves (parameters, centroids,
    optimizer state) not equal bit for bit and the largest difference."""
    from repro_torch.tree import tree_leaves
    la = tree_leaves((a.params, a.kstate, a.opt_state))
    lb = tree_leaves((b.params, b.kstate, b.opt_state))
    differ, worst = 0, 0.0
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                differ += 1
                worst = max(worst, float((x.float() - y.float()).abs().max()))
        elif x != y:
            differ += 1
    return dict(leaves=len(la), differ=differ, max_abs=worst)


def stats_gate(cfg, metrics) -> list:
    """Failures of a stats-on step's metrics: the ``routing/*`` scalars
    out of their ranges, or an ``rt/{seg}/{layer}/{field}`` missing for a
    routing layer (each segment's leaves carry its G layers)."""
    from repro_torch.attn.spec import spec_for_layer
    from repro_torch.models.transformer import build_segments
    from repro_torch.obs.routing_stats import SCALAR_FIELDS
    kc = cfg.routing.num_clusters
    ranges = {"entropy": (0.0, math.log(kc) + 1e-4), "dead": (0.0, kc),
              "mismatch": (0.0, 1.0), "recall": (0.0, 1.0 + 1e-4),
              "drift": (0.0, math.inf)}
    bad = [f"routing/{f} = {float(metrics[f'routing/{f}'])}"
           for f, (lo, hi) in ranges.items()
           if not lo <= float(metrics[f"routing/{f}"]) <= hi]
    layers = 0
    for si, (pattern, G) in enumerate(build_segments(cfg)):
        for i, s in enumerate(pattern):
            if "routing" not in spec_for_layer(cfg, s.attn).variant:
                continue
            for f in SCALAR_FIELDS:
                t = metrics.get(f"rt/{si}/{i}/{f}")
                if t is None or t.shape[0] != G or not bool(
                        t.isfinite().all()):
                    bad.append(f"rt/{si}/{i}/{f}")
            layers += G
    if layers != layer_counts(cfg)["routing"]:
        bad.append(f"rt/* covers {layers} layers")
    return bad


def obs_train(torch, cfg, params, kstate, batch, counts) -> dict:
    """(a) One rt-enwik8 train step from one state and batch with the
    stats off, on, and off again (the control): the stats-on step's loss
    and state equal the stats-off step's bit for bit (or, when the
    control itself differs, within the control's own difference), each
    step launches exactly the train path's kernels, the stats lie in
    their ranges; then one profiled step each way for busy ms and the
    step's peak memory above the state it starts from."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_step import TrainState, make_train_step
    runs = {on: train_run_config(with_stats(cfg, on)) for on in (False, True)}
    opt_init, _ = make_optimizer(runs[False].train)
    ts0 = TrainState(params, kstate, opt_init(params),
                     runs[False].train.warmup_steps)
    want = expected_launches("train", runs[False], 1)
    fns = {on: make_train_step(run) for on, run in runs.items()}
    steps, row = {}, {}
    for name, on in (("off", False), ("on", True), ("control", False)):
        torch.cuda.synchronize()
        before = counts()
        t0 = time.perf_counter()
        ts, metrics = fns[on](ts0, batch)
        loss = float(metrics["loss"])               # waits for the step
        wall = (time.perf_counter() - t0) * 1e3
        got = {n: counts()[n] - before[n] for n in before}
        check_launches(f"obs train {name}", got, want)
        steps[name] = (ts, metrics, loss)
        row[name] = dict(loss=loss, wall_ms=wall)
    (ts_off, m_off, l_off), (ts_on, m_on, l_on), (ts_ctl, _, l_ctl) = (
        steps["off"], steps["on"], steps["control"])
    on_diff, ctl_diff = state_diff(torch, ts_on, ts_off), state_diff(
        torch, ts_ctl, ts_off)
    row.update(on_vs_off=dict(on_diff, loss_diff=abs(l_on - l_off)),
               control_vs_off=dict(ctl_diff, loss_diff=abs(l_ctl - l_off)))
    if ctl_diff["differ"] or l_ctl != l_off:
        # the step itself is not bit-exact from run to run: hold the
        # stats-on step to the control's own difference
        ok = (on_diff["max_abs"] <= ctl_diff["max_abs"]
              and abs(l_on - l_off) <= abs(l_ctl - l_off))
        row["held_to"] = "control"
    else:
        ok = not on_diff["differ"] and l_on == l_off
        row["held_to"] = "bit for bit"
    if not ok:
        raise AssertionError(f"obs train: stats on moved the step: {row}")
    if set(m_off) != {"nll", "tokens", "loss", "grad_norm", "lr"}:
        raise AssertionError(f"obs train: stats-off metrics {sorted(m_off)}")
    bad = stats_gate(cfg, m_on)
    if bad:
        raise AssertionError(f"obs train: stats out of range: {bad}")
    row["routing"] = {k: float(v) for k, v in m_on.items()
                      if k.startswith("routing/")}
    del steps, ts, ts_off, ts_on, ts_ctl, metrics
    torch.cuda.empty_cache()
    for name, on in (("off", False), ("on", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        before = counts()
        prof = profiled(torch, lambda on=on: float(
            fns[on](ts0, batch)[1]["loss"]))
        got = {n: counts()[n] - before[n] for n in before}
        check_launches(f"obs train profiled {name}", got, want)
        peak = torch.cuda.max_memory_allocated()
        row[name].update(busy_ms=prof["device_busy_ms"],
                         busy_launches=prof["device_launches"],
                         profiled_wall_ms=prof["wall_ms"],
                         resident_gib=start / 2 ** 30,
                         step_peak_gib=(peak - start) / 2 ** 30)
    return row


def obs_collapse(torch, cfg, params, kstate, batch, counts) -> dict:
    """(b) One stats-on forward with every layer's centroids equal: all
    tokens take centroid 0, so entropy ~0 and k - 1 dead."""
    from repro_torch.models.model import apply_model, next_token_batch
    from repro_torch.obs.routing_stats import summarize
    flat = [{k: mu[:, :, :1].expand_as(mu).clone() for k, mu in seg.items()}
            for seg in kstate]
    inputs, _ = next_token_batch(batch)
    before = counts()
    with torch.no_grad():
        logits, _, stats = apply_model(params, flat, inputs,
                                       with_stats(cfg), return_stats=True)
        summ = {k: float(v) for k, v in summarize(stats).items()}
    got = {n: counts()[n] - before[n] for n in before
           if counts()[n] != before[n]}
    layers = layer_counts(cfg)
    want = {"local_attention": layers["local"],
            "routing_fused": layers["routing"]}
    check_launches("obs collapse", got, want)
    kc = cfg.routing.num_clusters
    if not (summ["routing/entropy"] < OBS_COLLAPSE_ENTROPY
            and summ["routing/dead"] == kc - 1
            and bool(logits.isfinite().all())):
        raise AssertionError(f"obs collapse control: {summ}")
    return summ


def timed(fn, into: list):
    """``fn`` that appends each call's host seconds to ``into``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            into.append(time.perf_counter() - t0)
    return call


def obs_engine(torch, cfg, params, kstate, counts, tmp) -> dict:
    """(c) The first OBS_REQUESTS of the `serve_engine` workload through
    the engine with chunked prefill, stats off, then with ``obs_jsonl``
    and ``routing_stats``: tokens and logits rows equal bit for bit,
    launches exact per event, every line valid, the ticks carrying the
    pages' health."""
    from repro_torch.obs.schema import validate_jsonl
    from repro_torch.serve.engine import InferenceEngine
    reqs = engine_requests(torch, cfg)[:OBS_REQUESTS]
    path = str(Path(tmp) / "engine.jsonl")
    runs, row = {}, {}
    for name, kw in (("off", {}),
                     ("on", dict(obs_jsonl=path, routing_stats=True))):
        eng = InferenceEngine(cfg, params, kstate, max_slots=ENGINE_SLOTS,
                              max_len=ENGINE_MAX_LEN, record_logits=True,
                              device=DEVICE, **OBS_ENGINE, **kw)
        events, total = engine_launch_checks(eng, counts)
        host_s = {"tick": [], "prefill_stats": []}
        for what, attr in (("tick", "_emit_tick"),
                           ("prefill_stats", "_emit_prefill_stats")):
            setattr(eng, attr, timed(getattr(eng, attr), host_s[what]))
        run_reqs = fresh_requests(reqs)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drive_engine(torch, eng, run_reqs)
        wall = time.perf_counter() - t0
        eng.close()
        got = {n: counts()[n] - before[n] for n in before
               if counts()[n] != before[n]}
        if got != total:
            raise AssertionError(f"obs engine {name}: launches {got}, the "
                                 f"engine's events add up to {total}")
        runs[name] = ({r.uid: list(r.output) for r in run_reqs},
                      eng.logits_trace)
        summ = eng.metrics.summary()
        row[name] = dict(wall_s=wall, events=events, launches=got,
                         decode_steps=summ["decode_steps"],
                         decode_step_p50_s=summ.get("decode_step_p50_s"),
                         **{f"{k}_calls": len(v) for k, v in host_s.items()},
                         **{f"{k}_p50_ms": (statistics.median(v) * 1e3
                                            if v else None)
                            for k, v in host_s.items()})
    bad = engine_mismatches(*runs["off"], *runs["on"],
                            [r.uid for r in reqs])
    lines = validate_jsonl(path)
    recs = [json.loads(ln) for ln in open(path)]
    kinds = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    health = [r["metrics"] for r in recs if r["kind"] == "engine_tick"
              and "routing/entropy" in r["metrics"]]
    prefill = [r["metrics"] for r in recs if r["kind"] == "engine_prefill"]
    row.update(parity_mismatches=bad, lines=lines, kinds=kinds,
               first_prefill=prefill[0] if prefill else None,
               last_health=health[-1] if health else None)
    if (bad or kinds.get("engine_prefill") != len(reqs)
            or recs[-1]["kind"] != "engine_summary" or not health
            or any(h["routing/drift"] != 0.0 for h in health)):
        raise AssertionError(f"obs engine: {row}")
    return row


def obs_launch(torch, counts, tmp) -> dict:
    """(d) The launcher with the observability flags: exact launches,
    valid lines with the stats, and a Chrome trace naming the train and
    kernel spans."""
    from repro_torch.configs import get_config, with_overrides
    from repro_torch.launch import train as launcher
    from repro_torch.obs.schema import validate_jsonl
    from repro_torch.obs.trace import TRACE_FILE
    path, prof = str(Path(tmp) / "launch.jsonl"), str(Path(tmp) / "prof")
    argv = OBS_LAUNCH_ARGV + ["--obs-jsonl", path, "--profile-dir", prof]
    args = launcher.parser().parse_args(argv)
    cfg = with_overrides(get_config(args.arch), dtype="float32")
    before = counts()
    t0 = time.perf_counter()
    out = launcher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: counts()[n] - before[n] for n in before}
    check_launches("obs launch", got, expected_launches(
        "train", train_run_config(cfg, args.batch, args.seq), args.steps))
    lines = validate_jsonl(path)
    recs = [json.loads(ln) for ln in open(path)]
    trace = (Path(prof) / TRACE_FILE).read_text()
    missing = [s for s in OBS_TRACE_SPANS if s not in trace]
    row = dict(argv=argv[:len(OBS_LAUNCH_ARGV)] + ["--obs-jsonl", "...",
                                                   "--profile-dir", "..."],
               wall_s=wall, lines=lines, trace_bytes=len(trace),
               missing_spans=missing,
               routing=recs[-1]["metrics"].get("routing/entropy"), **out)
    if (lines != args.steps or missing or out["steps"] != args.steps
            or not all("routing/recall" in r["metrics"] for r in recs)):
        raise AssertionError(f"obs launch: {row}")
    return row


def obs_phase(torch, card, counts) -> dict:
    """The `obs` path: (a) `obs_train`, (b) `obs_collapse`, (c)
    `obs_engine`, (d) `obs_launch`, on full-width rt-enwik8 (random bf16
    weights from seed 0) and the launcher's fp32 one."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    # every wrapper's counter exists before the first count is read
    from repro_torch.kernels import (flash_attention, local_attention,  # noqa: F401
                                     routing_attention, routing_decode,
                                     routing_gathered)
    from repro_torch.models.model import init_model
    cfg = get_config(ARCH)
    params, kstate = init_model(cfg, seed=0, device=DEVICE)
    batch = train_batches(torch, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 1)[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        row = dict(card=card, train=obs_train(torch, cfg, params, kstate,
                                              batch, counts))
        print(f"obs train [{card}] {json.dumps(row['train'])}", flush=True)
        row["collapse"] = obs_collapse(torch, cfg, params, kstate, batch,
                                       counts)
        print(f"obs collapse {json.dumps(row['collapse'])}", flush=True)
        del batch
        torch.cuda.empty_cache()
        row["engine"] = obs_engine(torch, cfg, params, kstate, counts, tmp)
        print(f"obs engine [{card}] {json.dumps(row['engine'])}", flush=True)
        del params, kstate
        torch.cuda.empty_cache()
        row["launch"] = obs_launch(torch, counts, tmp)
        print(f"obs launch {json.dumps(row['launch'])}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return row


# ---------------------------------------------------------------------------
# Since slice 18: checkpoints, the int8 error-feedback exchange and the
# data-parallel step on the card
# ---------------------------------------------------------------------------
def state_digest(ts) -> str:
    """sha256 over the bytes of every parameter, optimizer and centroid
    leaf, in checkpoint-key order."""
    import hashlib
    from repro_torch.ckpt.checkpoint import _flatten, to_host
    h = hashlib.sha256()
    for key, leaf in _flatten((ts.params, ts.opt_state, ts.kstate)):
        h.update(key.encode())
        h.update(to_host(leaf).tobytes())
    return h.hexdigest()


def timed_manager(mgr, log: list):
    """Record each ``save`` (blocking or not; the seconds waiting for the
    writer still in flight, then the save's own; whether it committed a
    new step) and ``restore`` of ``mgr`` into ``log``."""
    save, restore = mgr.save, mgr.restore

    def timed_save(step, state, extra=None, blocking=True):
        t0 = time.perf_counter()
        mgr.wait()
        t1 = time.perf_counter()
        new = int(step) not in mgr.all_steps()
        save(step, state, extra, blocking)
        log.append(dict(op="save" if blocking else "save_async", step=step,
                        new=new, wait_s=t1 - t0,
                        s=time.perf_counter() - t1))

    def timed_restore(state_like, step=None):
        t0 = time.perf_counter()
        out = restore(state_like, step)
        log.append(dict(op="restore", s=time.perf_counter() - t0))
        return out
    mgr.save, mgr.restore = timed_save, timed_restore
    return mgr


def ckpt_trainer(torch, run, ckpt_dir, log, **kw):
    """A Trainer of ``run`` on the markov task (min(V, 512) tokens, as the
    launcher) over ``ckpt_dir``, its manager timed into ``log``."""
    from repro_torch.data.synthetic import SyntheticLoader
    from repro_torch.train.trainer import Trainer
    tc = run.train
    tr = Trainer(run, SyntheticLoader("markov", min(run.model.vocab_size,
                                                    FULL_VOCAB),
                                      tc.global_batch, tc.seq_len,
                                      seed=tc.seed),
                 ckpt_dir=str(ckpt_dir), device=DEVICE, **kw)
    timed_manager(tr.mgr, log)
    return tr


def fit_counted(torch, tr, steps, counts, path, what):
    """``tr.fit(steps)`` with the exact launches of the steps it ran."""
    ran = len(tr.metrics_history)
    before = counts()
    out = tr.fit(steps)
    torch.cuda.synchronize()
    got = {n: counts()[n] - before[n] for n in before}
    check_launches(f"{path} {what}", got, expected_launches(
        path, tr.run, len(tr.metrics_history) - ran))
    return out


def losses_of(tr) -> list:
    return [m["loss"] for m in tr.metrics_history]


def ckpt_restart(torch, run, tmp, counts, log) -> tuple:
    """(a) Trainer.fit(CKPT_STEPS) checkpointed every CKPT_EVERY steps,
    against fit(CKPT_STOP) and a fresh Trainer's fit(CKPT_STEPS) on the
    same directory; (b) a SIGTERM at the end of step CKPT_STOP, then a
    fresh Trainer finishing. Every parameter, optimizer and centroid leaf,
    the step, the loader's cursor and the losses after the stop equal the
    uninterrupted run's bit for bit."""
    import os
    import signal
    from repro_torch.ckpt.checkpoint import CheckpointManager
    full = ckpt_trainer(torch, run, tmp / "full", log, ckpt_every=CKPT_EVERY)
    fit_counted(torch, full, CKPT_STEPS, counts, "ckpt_dist", "full")
    stop = ckpt_trainer(torch, run, tmp / "stop", log, ckpt_every=CKPT_EVERY)
    fit_counted(torch, stop, CKPT_STOP, counts, "ckpt_dist", "stop")
    stopped = stop.state
    del stop
    torch.cuda.empty_cache()
    res = ckpt_trainer(torch, run, tmp / "stop", log, ckpt_every=CKPT_EVERY)
    fit_counted(torch, res, CKPT_STEPS, counts, "ckpt_dist", "resume")
    want = (state_digest(full.state), full.state.step, full.loader.step,
            losses_of(full)[CKPT_STOP:])
    row = dict(losses=losses_of(full), resumed_losses=losses_of(res),
               digest=want[0], steps=full.state.step,
               checkpoints=CheckpointManager(str(tmp / "full")).all_steps())
    got = (state_digest(res.state), res.state.step, res.loader.step,
           losses_of(res))
    if got != want:
        raise AssertionError(f"ckpt_dist restart: {got} != {want}")
    step_dir = tmp / "full" / f"step_{CKPT_STEPS:08d}"
    row["ckpt_bytes"] = (step_dir / "arrays.npz").stat().st_size
    del res
    torch.cuda.empty_cache()

    pre = ckpt_trainer(torch, run, tmp / "pre", log, ckpt_every=10 ** 9)
    inner, calls = pre.step_fn, []

    def step_then_sigterm(state, batch):
        out = inner(state, batch)
        calls.append(1)
        if len(calls) == CKPT_STOP:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    pre.step_fn = step_then_sigterm
    out = fit_counted(torch, pre, CKPT_STEPS, counts, "ckpt_dist",
                      "preempted")
    steps = pre.mgr.all_steps()
    del pre
    torch.cuda.empty_cache()
    fin = ckpt_trainer(torch, run, tmp / "pre", log, ckpt_every=10 ** 9)
    fit_counted(torch, fin, CKPT_STEPS, counts, "ckpt_dist", "finished")
    got = (state_digest(fin.state), fin.state.step, fin.loader.step,
           losses_of(fin))
    row["preempted"] = dict(preempted=out["preempted"], steps=out["steps"],
                            checkpoints=steps, resumed_losses=losses_of(fin))
    if (not out["preempted"] or out["steps"] != CKPT_STOP
            or steps != [CKPT_STOP] or got != want):
        raise AssertionError(f"ckpt_dist preemption: {row['preempted']}, "
                             f"{got} != {want}")
    del fin, full
    torch.cuda.empty_cache()
    return row, stopped


def ckpt_d1(torch, run, stopped, counts) -> dict:
    """(c) int8_ef at D = 1 with no process group: CKPT_STOP steps from
    the fresh state equal the uncompressed Trainer's first CKPT_STOP
    (``stopped``) bit for bit, every residual zero."""
    from dataclasses import replace
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    run_c = replace(run, train=replace(run.train, grad_compression="int8_ef"))
    tc = run.train
    ts = init_train_state(run_c, seed=tc.seed, device=DEVICE)
    step = make_train_step(run_c)
    batches = train_batches(torch, min(run.model.vocab_size, FULL_VOCAB),
                            tc.global_batch, tc.seq_len, CKPT_STOP)
    before = counts()
    losses = []
    for b in batches:
        ts, m = step(ts, b)
        losses.append(float(m["loss"]))
    got = {n: counts()[n] - before[n] for n in before}
    check_launches("ckpt_dist int8_ef D=1", got,
                   expected_launches("ckpt_dist", run_c, CKPT_STOP))
    nonzero = sum(int(e.count_nonzero()) for e in tree_leaves(ts.ef_state))
    row = dict(losses=losses, residual_nonzero=nonzero,
               equal=state_digest(ts) == state_digest(stopped))
    if not row["equal"] or nonzero:
        raise AssertionError(f"ckpt_dist int8_ef at D = 1: {row}")
    return row


def dist_rank(rank: int, world: int, coordinator: str, out: str) -> None:
    """(d), one rank: full-width rt-enwik8 in bf16, DIST_ROWS rows of the
    global batch, int8_ef over a gloo group on the one card, DIST_STEPS
    steps. Writes to ``out``: each step's loss, wall and state digest, the
    launches, the wire bytes of each step and, for step 1, each compressed
    leaf's applied mean against the exact fp32 mean (one extra all-reduce,
    after the step) and its residual against half a hop-1 step plus n
    halves of a hop-2 step, from the scales that step used."""
    import torch
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.dist import compression as comp
    # every wrapper's counter exists before the counts are read
    from repro_torch.kernels import (common, flash_attention,  # noqa: F401
                                     local_attention, routing_attention,
                                     routing_decode, routing_gathered)
    from repro_torch.launch import distributed
    from repro_torch.train.train_step import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(distributed.LaunchSpec(coordinator, world, rank),
                           device=DEVICE, backend="gloo")
    cfg = get_config(ARCH)
    run = train_run_config(cfg, batch=world * DIST_ROWS)
    run = replace(run, train=replace(run.train, grad_compression="int8_ef"))
    ts = init_train_state(run, seed=run.train.seed, device=DEVICE)
    step = make_train_step(run)
    batches = train_batches(torch, cfg.vocab_size, run.train.global_batch,
                            run.train.seq_len, DIST_STEPS)
    records, scales = [], []
    quantize, ef_mean = comp._quantize, comp.int8_ef_psum_mean

    def recording_quantize(x, group=comp.QUANT_GROUP):
        q, s = quantize(x, group)
        scales.append(s)
        return q, s

    def recording_ef_mean(x, err, group=None):
        scales.clear()
        mean, new_err = ef_mean(x, err, group)
        records.append(dict(x=x.float().clone(), mean=mean,
                            new_err=new_err, s1=scales[0], s2=scales[1]))
        return mean, new_err

    res = dict(rank=rank, losses=[], wall_ms=[], digests=[], wire=[])
    common.reset_counters()
    for i, b in enumerate(batches):
        if i == 0:
            comp._quantize, comp.int8_ef_psum_mean = (recording_quantize,
                                                      recording_ef_mean)
        comp.reset_wire_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts, b)
        res["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        res["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        res["wire"].append(comp.wire_bytes())
        comp._quantize, comp.int8_ef_psum_mean = quantize, ef_mean
        res["digests"].append(state_digest(ts))
        if i == 0:
            res.update(dist_exchange_check(torch, comp, records, world,
                                           rank))
            records.clear()
    res["launches"] = common.counters()
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.distributed.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def dist_exchange_check(torch, comp, records, n, j) -> dict:
    """Step 1's compressed leaves: the applied mean against the exact fp32
    mean of the ranks' gradients (largest difference over the exact
    mean's largest value), and every residual element against half a
    hop-1 quantization step plus n halves of a hop-2 step."""
    g = comp.QUANT_GROUP
    worst, over, elements = 0.0, 0, 0
    for r in records:
        exact = comp.all_mean(r["x"]).flatten()
        worst = max(worst, float((r["mean"].float().flatten() - exact)
                                 .abs().max() / exact.abs().max()))
        bound = (r["s1"] / 2).repeat_interleave(g, dim=1)
        bound[j] += n * (r["s2"] / 2).repeat_interleave(g)
        bound = bound.flatten()[:exact.numel()] * (1 + DIST_RESIDUAL_SLACK)
        over += int((r["new_err"].flatten().abs() > bound).sum())
        elements += exact.numel()
    return dict(compressed_leaves=len(records), compressed_elements=elements,
                mean_rel_err=worst, residual_over_bound=over)


def start_dist_ranks(tmp) -> list:
    """Start DIST_RANKS processes of `dist_rank` on the one card, each
    logging to ``tmp/rank{r}.log``."""
    import os
    import socket
    import subprocess
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    procs = []
    for r in range(DIST_RANKS):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.dist_rank({r}, "
                 f"{DIST_RANKS}, {coordinator!r}, "
                 f"{str(tmp / f'rank{r}.json')!r})"],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ)))
    return procs


def stop_dist_ranks(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)


def finish_dist_ranks(procs, run, tmp, t0) -> dict:
    """(d) Wait for the ranks: every rank's state digest equal after each
    step, the applied mean within DIST_MEAN_REL_TOL of the exact one and
    no residual over its bound on step 1, exact launches in each
    process."""
    codes = [p.wait(timeout=max(1.0, DIST_TIMEOUT_S
                                - (time.perf_counter() - t0)))
             for p in procs]
    wall = time.perf_counter() - t0
    if codes != [0] * DIST_RANKS:
        tails = "\n".join((tmp / f"rank{r}.log").read_text()[-4000:]
                          for r in range(DIST_RANKS))
        raise AssertionError(f"ckpt_dist ranks exited with {codes}:\n{tails}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    want = expected_launches("ckpt_dist", run, DIST_STEPS)
    for r in ranks:
        check_launches(f"ckpt_dist rank {r['rank']}", r["launches"], want)
    row = dict(ranks=ranks, wall_s=wall,
               digests_equal=all(r["digests"] == ranks[0]["digests"]
                                 for r in ranks))
    bad = [r["rank"] for r in ranks
           if not (r["mean_rel_err"] < DIST_MEAN_REL_TOL
                   and r["residual_over_bound"] == 0
                   and all(map(math.isfinite, r["losses"])))]
    if not row["digests_equal"] or bad:
        raise AssertionError(f"ckpt_dist D = {DIST_RANKS}: {row}")
    return row


def ckpt_launch(torch, counts, tmp) -> dict:
    """(e) The launcher (LAUNCH_ARGV: qwen2-0.5b in fp32, B 8 x 256) with
    --ckpt-dir for CKPT_STOP steps, then again for CKPT_STEPS: the resumed
    steps' losses equal an uninterrupted CKPT_STEPS-step run's; then
    --grad-compression int8_ef at D = 1, whose losses equal the
    uncompressed run's. Losses are read from --obs-jsonl records."""
    from repro_torch.configs import get_config, with_overrides
    from repro_torch.launch import train as launcher
    args = launcher.parser().parse_args(LAUNCH_ARGV)
    run = full_run_config(with_overrides(get_config(args.arch),
                                         dtype="float32"),
                          args.batch, args.seq)

    def run_launcher(name, steps, *extra):
        path = tmp / f"{name}.jsonl"
        argv = LAUNCH_ARGV + ["--steps", str(steps), "--obs-jsonl",
                              str(path), *extra]
        before = counts()
        t0 = time.perf_counter()
        out = launcher.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: counts()[n] - before[n] for n in before}
        losses = [json.loads(ln)["metrics"]["loss"] for ln in open(path)]
        check_launches(f"ckpt_launch {name}", got, expected_launches(
            "ckpt_launch", run, len(losses)))
        return dict(argv=argv[:len(LAUNCH_ARGV) + 2] + list(extra[:1]),
                    wall_s=wall, losses=losses, steps=out["steps"])

    ckpt = str(tmp / "launch_ckpt")
    rows = dict(stop=run_launcher("stop", CKPT_STOP, "--ckpt-dir", ckpt),
                resume=run_launcher("resume", CKPT_STEPS, "--ckpt-dir", ckpt),
                full=run_launcher("full", CKPT_STEPS),
                int8_ef=run_launcher("int8_ef", args.steps,
                                     "--grad-compression", "int8_ef"))
    full = rows["full"]["losses"]
    ok = (rows["resume"]["losses"] == full[CKPT_STOP:]
          and rows["stop"]["losses"] == full[:CKPT_STOP]
          and rows["int8_ef"]["losses"] == full[:args.steps]
          and rows["resume"]["steps"] == CKPT_STEPS)
    if not ok:
        raise AssertionError(f"ckpt_launch: {rows}")
    return rows


def ckpt_dist_phase(torch, card, counts) -> tuple:
    """The `ckpt_dist` path: (a) restart and (b) preemption
    (`ckpt_restart`), (c) int8_ef at D = 1 (`ckpt_d1`) on full-width
    rt-enwik8 (bf16, B 2 x 8192, the TrainConfig defaults, random weights
    from seed 0), (d) int8_ef at D = DIST_RANKS (`start_dist_ranks`,
    `finish_dist_ranks`), then
    the `ckpt_launch` path: (e) the launcher (`ckpt_launch`), run while
    (d)'s processes run. Checkpoints go to a temporary directory, removed
    afterwards. Returns the row and the launches of both paths."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels import (flash_attention, local_attention,  # noqa: F401
                                     routing_attention, routing_decode,
                                     routing_gathered)
    cfg = get_config(ARCH)
    run = train_run_config(cfg)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    log = []
    try:
        t0 = time.perf_counter()
        free = shutil.disk_usage(tmp).free
        before = counts()
        row, stopped = ckpt_restart(torch, run, tmp, counts, log)
        print(f"ckpt_dist restart [{card}] {json.dumps(row)}", flush=True)
        shutil.rmtree(tmp / "full")
        shutil.rmtree(tmp / "stop")
        shutil.rmtree(tmp / "pre")
        row["d1"] = ckpt_d1(torch, run, stopped, counts)
        del stopped
        torch.cuda.empty_cache()
        print(f"ckpt_dist int8_ef D=1 {json.dumps(row['d1'])}", flush=True)
        launches = {n: counts()[n] - before[n] for n in before}
        # (d)'s ranks run while (e), mostly the host writing and reading
        # qwen2's checkpoints, runs here
        t_dist = time.perf_counter()
        procs = start_dist_ranks(tmp)
        try:
            before = counts()
            row["launch"] = ckpt_launch(torch, counts, tmp)
            launch_launches = {n: counts()[n] - before[n] for n in before}
            row["dist"] = finish_dist_ranks(procs, run, tmp, t_dist)
        finally:
            stop_dist_ranks(procs)
        for r in row["dist"]["ranks"]:
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
        print(f"ckpt_dist D={DIST_RANKS} [{card}] "
              f"{json.dumps(row['dist'])}", flush=True)
        print(f"ckpt_launch {json.dumps(row['launch'])}", flush=True)
        row.update(card=card, seconds=time.perf_counter() - t0,
                   disk_free_gib=free / 2 ** 30, manager=log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    saves = [e["s"] for e in log if e["op"] == "save" and e["new"]]
    asyncs = [e["s"] for e in log if e["op"] == "save_async" and e["new"]]
    waits = [e["wait_s"] for e in log if e["op"] == "save_async"]
    restores = [e["s"] for e in log if e["op"] == "restore"]
    summary = dict(
        seconds=row["seconds"], ckpt_bytes=row["ckpt_bytes"],
        blocking_save_s=saves, async_save_caller_s=asyncs,
        async_wait_for_previous_writer_s=waits, restore_s=restores,
        dist_wall_ms_per_step=[r["wall_ms"] for r in row["dist"]["ranks"]],
        dist_wire_bytes=[r["wire"] for r in row["dist"]["ranks"]],
        dist_mean_rel_err=[r["mean_rel_err"] for r in row["dist"]["ranks"]])
    print(f"ckpt_dist summary [{card}] {json.dumps(summary)}", flush=True)
    row["summary"] = summary
    return row, launches, launch_launches


# ---------------------------------------------------------------------------
# slice 19: the model axis (tensor and sequence parallelism) on one card
# ---------------------------------------------------------------------------
def membership_replayed_heads(calls: list, flips: list, rank: int):
    """`membership_replayed` on a tensor-parallel rank: each routing call
    takes this rank's block of the heads of the 1 x 1 run's membership
    (the rank's routing heads are the routing heads' block ``rank``)."""
    from repro_torch.core import routing
    topk = routing.balanced_topk

    def replay(*args, **kwargs):
        own = topk(*args, **kwargs)
        h = own.shape[1]
        idx = calls[len(flips)][:, rank * h:(rank + 1) * h].to(own.device)
        flips.append(bool((own != idx).any()))
        return idx
    return swapped(routing, "balanced_topk", replay)


def tp_configs():
    """The tp phase's configs: (a) rt-enwik8 fp32 at dropout 0, (b) the
    same in bf16 with its own dropout, (c) (a) with TP_RANKS segments,
    (d) qwen2-0.5b fp32."""
    from repro_torch.configs import get_config, with_overrides
    cfg = get_config(ARCH)
    a = with_overrides(cfg, dtype="float32", dropout=0.0)
    c = with_overrides(a, routing=with_overrides(a.routing,
                                                 segments=TP_RANKS))
    d = with_overrides(get_config(FULL_ARCH), dtype="float32")
    return dict(a=a, b=cfg, c=c, d=d)


def tp_runs():
    """(a)-(c) at B 1 x TRAIN_SEQ under the TrainConfig defaults, (d) at
    the qwen2 gate's shape under the launcher's config."""
    cfgs = tp_configs()
    runs = {k: train_run_config(cfgs[k], batch=1) for k in "abc"}
    runs["d"] = full_run_config(cfgs["d"], FULL_GATE_BATCH, FULL_GATE_SEQ)
    return runs


def tp_batch(torch, run):
    vocab = min(run.model.vocab_size, FULL_VOCAB)
    return train_batches(torch, vocab, run.train.global_batch,
                         run.train.seq_len, 1)[0]


def tp_grads_and_step(torch, run, ts, batch, constrain_fn=None, mesh=None,
                      membership=contextlib.nullcontext):
    """The gradients of the loss (on a mesh: of this rank's shards, after
    the model axis's reductions, `make_tp_grad_fn`) and one train step
    from ``ts`` on ``batch``, each inside a fresh ``membership()``: (loss,
    grads, step loss, new state)."""
    from repro_torch.train.train_step import (make_grad_fn, make_loss_fn,
                                              make_tp_grad_fn,
                                              make_train_step)
    grad_fn = (make_tp_grad_fn(run, None, constrain_fn, mesh)
               if mesh is not None else
               make_grad_fn(run, make_loss_fn(run)))
    with membership():
        grads, _, metrics = grad_fn(ts.params, ts.kstate, batch, None)
    loss = metrics["loss"]
    step = make_train_step(run, None, constrain_fn, mesh)
    with membership():
        new, m = step(ts, batch)
    torch.cuda.synchronize()
    return float(loss), grads, float(m["loss"]), new


def tp_references(torch, tmp) -> dict:
    """The 1 x 1 runs in this process: (a) and (c) record their cluster
    membership and save it with their gradients and stepped parameters;
    (d) its losses over TP_STEPS steps. Returns the readings."""
    from repro_torch.train.train_step import init_train_state, make_train_step
    runs = tp_runs()
    out = {}
    for k in "ac":
        run = runs[k]
        ts = init_train_state(run, seed=0, device=DEVICE)
        ts = ts._replace(step=run.train.warmup_steps)
        batch = tp_batch(torch, run)
        calls = []
        t0 = time.perf_counter()
        # the value_and_grad records; the step's forward, the same
        # computation, routes the same way
        loss, grads, step_loss, new = tp_grads_and_step(
            torch, run, ts, batch,
            membership=lambda: (contextlib.nullcontext() if calls
                                else membership_recorded(calls)))
        out[k] = dict(loss=loss, step_loss=step_loss,
                      s=time.perf_counter() - t0)
        torch.save(dict(calls=[c.cpu() for c in calls],
                        grads=grads, params=new.params, old=ts.params,
                        loss=loss, step_loss=step_loss),
                   tmp / f"ref_{k}.pt")
        del ts, grads, new, calls
        torch.cuda.empty_cache()
    run = runs["d"]
    ts = init_train_state(run, seed=0, device=DEVICE)
    batch = tp_batch(torch, run)
    step = make_train_step(run)
    losses = []
    for _ in range(TP_STEPS):
        ts, m = step(ts, batch)
        losses.append(float(m["loss"]))
    out["d"] = dict(losses=losses)
    del ts
    torch.cuda.empty_cache()
    return out


def replicated_digest(ts, mesh) -> str:
    """sha256 over the bytes of every tensor leaf of ``ts`` the rule table
    replicates (placed over no "model" dim), in tree order."""
    import hashlib
    import torch
    from repro_torch.ckpt.checkpoint import to_host
    from repro_torch.dist import sharding as shd
    from repro_torch.tree import tree_paths
    pl = shd.state_placements(mesh, ts)._asdict()
    h = hashlib.sha256()
    for path, leaf in tree_paths(ts._asdict()):
        if (isinstance(leaf, torch.Tensor)
                and "model" not in shd.placement_at(pl, path)):
            h.update(repr(path).encode())
            h.update(to_host(leaf).tobytes())
    return h.hexdigest()


def attend_heads(log: list):
    """Inside the block, every attention call's (variant, query heads,
    KV heads) is appended to ``log``."""
    import repro_torch.attn as attn_api
    attend = attn_api.attend

    def recording(spec, q, k, v, **kw):
        log.append((spec.variant, q.shape[1], v.shape[1]))
        return attend(spec, q, k, v, **kw)
    return swapped(attn_api, "attend", recording)


def tp_rank(rank: int, world: int, coordinator: str, tmp: str) -> None:
    """One tensor-parallel rank of the tp phase on a 1 x ``world`` mesh
    over gloo on the one card: (a), (b), (c) and (d) of TP_RANKS's comment,
    each rank's launches per part, the attention calls' head counts, and
    on rank 0 the gathered gradients and parameters against the 1 x 1
    references. Writes ``tmp/tp{rank}.json``."""
    import torch
    from repro_torch.attn.spec import specs_for_model
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tpar
    from repro_torch.kernels import (common, flash_attention,  # noqa: F401
                                     local_attention, routing_attention,
                                     routing_decode, routing_gathered)
    from repro_torch.launch import distributed
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    distributed.initialize(distributed.LaunchSpec(coordinator, world, rank),
                           device=DEVICE, backend="gloo")
    mesh = distributed.make_process_mesh(1, world)
    runs = tp_runs()
    res = dict(rank=rank, launches={}, heads={})

    def constrain(run, sp):
        return shd.make_constrain_fn(mesh, sp,
                                     attn_specs=specs_for_model(run.model))

    def part(name, run, fn):
        heads = []
        common.reset_counters()
        tpar.reset_wire_bytes()
        t0 = time.perf_counter()
        with attend_heads(heads):
            row = fn()
        torch.cuda.synchronize()
        row["s"] = time.perf_counter() - t0
        res["launches"][name] = common.counters()
        res["heads"][name] = sorted(set(heads))
        res[name] = row

    for k, sp in (("a", False), ("c", True)):
        run = runs[k]

        def gate(run=run, k=k, sp=sp):
            ref = torch.load(tmp / f"ref_{k}.pt", map_location=DEVICE,
                             weights_only=False)
            ts = init_train_state(run, seed=0, device=DEVICE, mesh=mesh)
            ts = ts._replace(step=run.train.warmup_steps)
            flips = []

            def replay():
                return membership_replayed_heads(ref["calls"], flips, rank)

            def replays():
                flips.clear()
                return replay()
            loss, grads, step_loss, new = tp_grads_and_step(
                torch, run, ts, tp_batch(torch, run), constrain(run, sp),
                mesh, replays)
            full_g = shd.gather_tree(grads, shd.grads_placements(mesh, grads),
                                     mesh, shd.head_groups(run.model, world))
            full = shd.gather_state(new, run.model, mesh)
            row = dict(loss=loss, step_loss=step_loss,
                       loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                       step_loss_rel=abs(step_loss - ref["step_loss"])
                       / abs(ref["step_loss"]),
                       replayed_calls=len(flips),
                       membership_differed=sum(flips),
                       recorded_calls=len(ref["calls"]),
                       grads=grad_agreement(full_g, ref["grads"]),
                       params=grad_agreement(full.params, ref["params"]),
                       updates=grad_agreement(
                           [a - b for a, b in zip(tree_leaves(full.params),
                                                  tree_leaves(ref["old"]))],
                           [a - b for a, b in zip(tree_leaves(ref["params"]),
                                                  tree_leaves(ref["old"]))]))
            return row
        part(k, run, gate)

    run = runs["b"]

    def bf16_steps():
        torch.cuda.reset_peak_memory_stats()
        ts = init_train_state(run, seed=0, device=DEVICE, mesh=mesh)
        ts = ts._replace(step=run.train.warmup_steps)
        step = make_train_step(run, None, constrain(run, False), mesh)
        batches = train_batches(torch, run.model.vocab_size, 1,
                                run.train.seq_len, TP_STEPS)
        row = dict(losses=[], wall_ms=[], model_bytes=[], digests=[],
                   collective_ms=[])
        spent = [0.0]

        def timed_call(fn):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                spent[0] += time.perf_counter() - t
                return out
            return call
        # host clock around each collective (its staging copies wait for
        # the card); a step's wall less this is compute and dispatch
        with all_of(swapped(tpar, "_gather_rows",
                            timed_call(tpar._gather_rows)),
                    swapped(tpar, "_exchange_rows",
                            timed_call(tpar._exchange_rows))):
            for b in batches:
                tpar.reset_wire_bytes()
                spent[0] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ts, m = step(ts, b)
                row["losses"].append(float(m["loss"]))
                torch.cuda.synchronize()
                row["wall_ms"].append((time.perf_counter() - t0) * 1e3)
                row["collective_ms"].append(spent[0] * 1e3)
                row["model_bytes"].append(tpar.wire_bytes())
                row["digests"].append(replicated_digest(ts, mesh))
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return row
    part("b", run, bf16_steps)

    run = runs["d"]

    def full_steps():
        row = {}
        for sp in (False, True):
            ts = init_train_state(run, seed=0, device=DEVICE, mesh=mesh)
            step = make_train_step(run, None, constrain(run, sp), mesh)
            batch = tp_batch(torch, run)
            losses = []
            for _ in range(TP_STEPS):
                ts, m = step(ts, batch)
                losses.append(float(m["loss"]))
            row["seq_parallel" if sp else "tp"] = losses
            del ts
            torch.cuda.empty_cache()
        return row
    part("d", run, full_steps)
    torch.distributed.destroy_process_group()
    (tmp / f"tp{rank}.json").write_text(json.dumps(res))


def tp_expected(runs) -> dict:
    """Per part, one rank's launches: every kernel once per layer per step
    as 1 x 1 (the value_and_grad of (a) and (c) counts as a step)."""
    return dict(a=expected_launches("tp", runs["a"], 2),
                b=expected_launches("tp", runs["b"], TP_STEPS),
                c=expected_launches("tp", runs["c"], 2),
                d=expected_launches("tp", runs["d"], 2 * TP_STEPS))


def tp_gate(ranks, refs, runs) -> list:
    """What the tp phase's readings fail of its gates."""
    from repro_torch.attn.spec import head_split, spec_for_layer
    fails = []
    want = tp_expected(runs)
    for r in ranks:
        for k, w in want.items():
            if r["launches"][k] != w:
                fails.append(f"rank {r['rank']} ({k}) launches "
                             f"{r['launches'][k]}, expected {w}")
        for k in "abcd":
            cfg = runs[k].model
            spec = spec_for_layer(cfg, cfg.attention)
            if spec.variant == "local+routing":
                Hl, Hr, kvl, kvr = head_split(spec)
                heads = [["local+routing", (Hl + Hr) // TP_RANKS,
                          (kvl + kvr) // TP_RANKS]]
            else:
                heads = [[spec.variant, spec.num_heads // TP_RANKS,
                          spec.num_kv_heads // TP_RANKS]]
            if r["heads"][k] != heads:
                fails.append(f"rank {r['rank']} ({k}) attention heads "
                             f"{r['heads'][k]}, expected {heads}")
    lim = ENWIK8_LIMITS
    for k in "ac":
        row = ranks[0][k]
        if not (row["loss_rel"] <= TP_LOSS_REL_TOL
                and row["step_loss_rel"] <= TP_LOSS_REL_TOL
                and row["grads"]["grad_rel_median"] <= lim["grad_median"]
                and row["grads"]["grad_rel_max"] <= lim["bwd_max"]
                and row["params"]["grad_rel_median"] <= lim["grad_median"]
                and row["replayed_calls"] == row["recorded_calls"]):
            fails.append(f"({k}) against 1 x 1: {row}")
    b = [r["b"] for r in ranks]
    if not (all(x["digests"] == b[0]["digests"] for x in b)
            and all(math.isfinite(v) for x in b for v in x["losses"])
            and all(x["losses"] == b[0]["losses"] for x in b)):
        fails.append(f"(b) ranks differ or loss not finite: {b}")
    ref = refs["d"]["losses"]
    for mode in ("tp", "seq_parallel"):
        got = ranks[0]["d"][mode]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, ref)]
        if not max(rel) <= TP_FULL_LOSS_REL_TOL:
            fails.append(f"(d) {mode} losses {got} against 1 x 1 {ref}")
    return fails


def tp_phase(torch, card, counts) -> tuple:
    """The `tp` path: the 1 x 1 references here (`tp_references`), then
    TP_RANKS processes of `tp_rank` on the one card; every gate of
    `tp_gate`. References go to a temporary directory, removed afterwards.
    Returns the row and the launches of all ranks together."""
    import os
    import shutil
    import socket
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    runs = tp_runs()
    try:
        t0 = time.perf_counter()
        before = counts()
        refs = tp_references(torch, tmp)
        launches_1x1 = {n: counts()[n] - before[n] for n in before}
        t_refs = time.perf_counter() - t0
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
        procs = []
        for r in range(TP_RANKS):
            with open(tmp / f"tp{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     f"import chip_smoke; chip_smoke.tp_rank({r}, "
                     f"{TP_RANKS}, {coordinator!r}, {str(tmp)!r})"],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                    env=dict(os.environ)))
        try:
            codes = [p.wait(timeout=TP_TIMEOUT_S) for p in procs]
        finally:
            stop_dist_ranks(procs)
        if codes != [0] * TP_RANKS:
            tails = "\n".join((tmp / f"tp{r}.log").read_text()[-4000:]
                              for r in range(TP_RANKS))
            raise AssertionError(f"tp ranks exited with {codes}:\n{tails}")
        ranks = [json.loads((tmp / f"tp{r}.json").read_text())
                 for r in range(TP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    for r in ranks:
        for part in r["launches"].values():
            for n, c in part.items():
                launches[n] = launches.get(n, 0) + c
    row = dict(card=card, refs=refs, refs_s=t_refs,
               launches_1x1_refs=launches_1x1,
               ranks=ranks, seconds=time.perf_counter() - t0)
    fails = tp_gate(ranks, refs, runs)
    summary = dict(
        seconds=row["seconds"], refs_s=t_refs,
        a=dict(ranks[0]["a"], s=[r["a"]["s"] for r in ranks]),
        c=dict(ranks[0]["c"], s=[r["c"]["s"] for r in ranks]),
        b=[dict(rank=r["rank"], losses=r["b"]["losses"],
                wall_ms=r["b"]["wall_ms"],
                collective_ms=r["b"]["collective_ms"],
                model_bytes=r["b"]["model_bytes"],
                peak_mem_gib=r["b"]["peak_mem_gib"]) for r in ranks],
        d=dict(ranks[0]["d"], ref=refs["d"]["losses"]),
        heads=ranks[0]["heads"])
    print(f"tp summary [{card}] {json.dumps(summary)}", flush=True)
    if fails:
        raise AssertionError(f"tp phase fails: {fails}")
    row["summary"] = summary
    return row, launches


def print_rows(rows):
    for name, row in rows.items():
        print(f"kernel {name} [{row['shape']}]: " + ", ".join(
            f"{k}={v}" for k, v in row.items() if k != "shape"), flush=True)


def decode_only(torch, card, out=None, other=False) -> int:
    """``--decode-only``: build the decode kernel of the repro_torch that
    is imported (``--src`` picks another tree's: ``other``), print its
    ptxas lines and run `check_decode_shapes` on the generator the full run
    gives it, so two trees' kernels read the same inputs, and
    `decode_digest`; on this tree also `check_decode_paper`; with ``out``
    write the readings there too."""
    import repro_torch
    from repro_torch.kernels import common
    where = str(Path(repro_torch.__file__).parent)
    print(f"repro_torch from {where}", flush=True)
    common.build(["routing_decode"])
    for line in common.BUILD_LOGS["routing_decode"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  routing_decode: {line.strip()}")
    rows = check_decode_shapes(torch,
                               torch.Generator(device=DEVICE).manual_seed(8))
    digest = decode_digest(torch)
    print(f"decode digest {digest}", flush=True)
    paper = None
    if not other:
        paper = check_decode_paper(
            torch, torch.Generator(device=DEVICE).manual_seed(10))
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(dict(
            card=card, repro_torch=where, decode_shapes=rows,
            decode_digest=digest, paper_decode=paper), indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report here (JSON)")
    ap.add_argument("--decode-only", action="store_true",
                    help="build the decode kernel and run only its readings "
                         "at DECODE_SHAPES and DECODE_EDGES "
                         "(check_decode_shapes), decode_digest and, without "
                         "--src, check_decode_paper; prints no result line")
    ap.add_argument("--src", help="import repro_torch from this directory "
                    "(another checkout's src), so that an earlier tree's "
                    "kernels run through this script's checks")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))

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
    if args.decode_only:
        return decode_only(torch, card, args.out, bool(args.src))

    t_start = t = time.perf_counter()
    common.build(sorted({Path(m["source"]).stem for m in KERNELS.values()}))
    t = phase("build", t)
    # the bf16 kernels on the tensor cores (flash forward, dq, dk/dv; local
    # forward; gathered forward, dq, dk/dv) keep their accumulators in
    # registers
    no_spill = {"flash_attention": ("flash_fwd_wgmma",),
                "flash_attention_bwd": ("flash_bwd_dq_wgmma",
                                        "flash_bwd_dkv_wgmma"),
                "local_attention": ("local_fwd_wgmma",),
                "routing_gathered": ("routing_gathered_wgmma",),
                "routing_gathered_bwd": ("routing_gathered_dq_wgmma",
                                         "routing_gathered_dkv_wgmma"),
                # and since slice 9 the local dq (both instances) and dk/dv
                "local_attention_bwd": ("local_bwd_dq_wgmma",
                                        "local_bwd_dkv_wgmma"),
                # and since slice 10 the fused routing dq and dk/dv
                "routing_fused_bwd": ("routing_fused_dq_wgmma",
                                      "routing_fused_dkv_wgmma"),
                # and since slice 11 the fused routing forward
                "routing_fused": ("routing_fused_wgmma",),
                # and since slice 12 the paged decode (its partials in
                # registers), since slice 14 its dh-192 instances by name
                "routing_decode": ("routing_decode_cluster",
                                   "routing_decode_clusterI13__nv_bfloat16"
                                   "Li192E",
                                   "routing_decode_clusterIfLi192E")}
    seen = set()
    for name, log in common.BUILD_LOGS.items():
        entry = ""
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
            entry = line if "Compiling entry function" in line else entry
            spills = re.findall(r"(\d+) bytes spill", line)
            for fn in no_spill.get(name, ()):
                if fn in entry and spills:
                    seen.add(fn)
                    if any(int(n) for n in spills):
                        raise AssertionError(f"{fn} spills: {line}")
    missing = {fn for fns in no_spill.values() for fn in fns} - seen
    if missing:
        raise AssertionError(f"no ptxas lines of {sorted(missing)} in the "
                             f"nvcc logs: their spill check cannot run")
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
    wide_bf16_rows = check_flash(torch, *WIDE_FLASH, torch.bfloat16, gen)
    flash_edges = check_flash_edges(torch, gen)
    print(f"flash edges {json.dumps(flash_edges)}", flush=True)
    gathered_rows = {
        "rt-enwik8": check_gathered(
            torch, 1, head_split(cfg)[1], cfg.routing.num_clusters,
            TRAIN_SEQ // cfg.routing.num_clusters, cfg.head_dim_,
            torch.bfloat16, gen),
        "fp32 ragged": check_gathered(torch, *GATHERED_RAGGED,
                                      torch.float32, gen, causal=False,
                                      shared=False)}
    gathered_edges = check_gathered_edges(torch, gen)
    print(f"gathered edges {json.dumps(gathered_edges)}", flush=True)
    # the local forward at rt-cifar10's local layers (B 8 x 3072, all 8
    # heads, w 512), then at its ragged shapes
    cifar_local_rows = {"local_attention": check_local(
        torch, ccfg, CIFAR_BATCH, CIFAR_SEQ, gen, heads=ccfg.num_heads)}
    local_edges = check_local_edges(torch, gen)
    print(f"local edges {json.dumps(local_edges)}", flush=True)
    # the local backward at its ragged shapes, then at rt-cifar10's local
    # layers (B 8 x 3072, all 8 heads, w 512)
    local_bwd_edges = check_local_bwd_edges(torch, gen)
    print(f"local backward edges {json.dumps(local_bwd_edges)}", flush=True)
    cifar_local_bwd_rows = check_local_bwd(
        torch, ccfg, CIFAR_BATCH, CIFAR_SEQ, gen, heads=ccfg.num_heads)
    flash_digest = flash_forward_digest(torch)
    print(f"flash forward digest {flash_digest}", flush=True)
    bwd_digest = backward_digest(torch)
    print(f"backward digest {bwd_digest}", flush=True)
    # since slice 10: the fused routing backward at rt-cifar10's routing
    # heads (B 8 x 3072, 4 heads, dh 64, k 6, w 512) and at its ragged
    # shapes, on a generator of its own, then a digest of the local
    # backward, which shares the bodies the fused backward now runs
    fused_gen = torch.Generator(device=DEVICE).manual_seed(5)
    cifar_fused_bwd_rows = check_routing_bwd(torch, ccfg, CIFAR_BATCH,
                                             CIFAR_SEQ, fused_gen)
    fused_bwd_edges = check_routing_bwd_edges(torch, fused_gen)
    print(f"fused backward edges {json.dumps(fused_bwd_edges)}", flush=True)
    local_digest = local_backward_digest(torch)
    print(f"local backward digest {local_digest}", flush=True)
    # since slice 11: the bf16 fused routing forward at rt-enwik8's train
    # shape (B 2 x 8192, 4 heads, dh 128, k 32, w 256), at rt-cifar10's
    # routing heads (B 8 x 3072, 4 heads, dh 64, k 6, w 512), at
    # rt-enwik8's 4 x 2048 prefill (w 64) and at its ragged shapes, on a
    # generator of its own, then a digest of the local and gathered
    # forwards, which share the body the fused forward now runs
    fused_fwd_gen = torch.Generator(device=DEVICE).manual_seed(6)
    fused_fwd_rows = {
        "rt-enwik8": check_routing_fwd(torch, cfg, TRAIN_BATCH, TRAIN_SEQ,
                                       fused_fwd_gen),
        "rt-cifar10": check_routing_fwd(torch, ccfg, CIFAR_BATCH, CIFAR_SEQ,
                                        fused_fwd_gen),
        "rt-enwik8 prefill": check_routing_fwd(torch, cfg, B1, N1,
                                               fused_fwd_gen)}
    fused_fwd_edges = check_routing_fwd_edges(torch, fused_fwd_gen)
    print(f"fused forward edges {json.dumps(fused_fwd_edges)}", flush=True)
    fwd_digest = forward_digest(torch)
    print(f"forward digest {fwd_digest}", flush=True)
    # since slice 12: the paged decode in bf16 and fp32 at the four shapes
    # the serving paths give it and at its ragged caps and pages, on a
    # generator of its own
    decode_rows = check_decode_shapes(
        torch, torch.Generator(device=DEVICE).manual_seed(8))
    # since slice 14: the decode at rt-pg19's dh 129 (the dh-192 instance
    # over pages stored 192 wide) and rt-imagenet64's cap 2048, then a
    # digest of the dh-64 and dh-128 decode, on generators of their own
    paper_decode_rows = check_decode_paper(
        torch, torch.Generator(device=DEVICE).manual_seed(10))
    dec_digest = decode_digest(torch)
    print(f"decode digest {dec_digest}", flush=True)
    # since slice 13: the local and fused kernels at the paper's other
    # models' shapes (rt-pg19's head dim 129 through the dh-192 instances,
    # bf16 and fp32; rt-imagenet64's windows of 2048), then at
    # LOCAL_EDGES- and FUSED_EDGES-like ragged shapes at dh 129, on
    # generators of their own
    t = phase("kernels", t)
    paper_gen = torch.Generator(device=DEVICE).manual_seed(9)
    paper_kernel_rows = check_paper_kernels(torch, paper_gen)
    pg19_edges = dict(
        local=check_local_edges(torch, paper_gen, PG19_LOCAL_EDGES),
        local_bwd=check_local_bwd_edges(torch, paper_gen, PG19_LOCAL_EDGES),
        fused_fwd=check_routing_fwd_edges(torch, paper_gen,
                                          PG19_FUSED_EDGES),
        fused_bwd=check_routing_bwd_edges(torch, paper_gen,
                                          PG19_FUSED_EDGES))
    print(f"pg19 edges {json.dumps(pg19_edges)}", flush=True)
    for tag, shape_rows in paper_kernel_rows.items():
        print(f"paper kernels: {tag}", flush=True)
        print_rows(shape_rows)
    t = phase("paper kernels", t)
    for shape_rows in (kern_rows, long_rows, cifar_local_rows, wide_rows,
                       *gathered_rows.values()):
        print_rows(shape_rows)
    print_rows(wide_bf16_rows)
    print_rows(cifar_local_bwd_rows)
    print_rows(cifar_fused_bwd_rows)
    for shape_rows in fused_fwd_rows.values():
        print_rows(shape_rows)

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
    full_gate_bf16 = full_train_gate_bf16(torch, fcfg, fparams, fkstate,
                                          gate_batch)
    print(f"train_full bf16 gate {json.dumps(full_gate_bf16)}", flush=True)
    t = phase("train_full bf16 gate", t)
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
    cserve_rows, launches["serve_cifar"], cprompts = serve_and_compare(
        torch, ccfg, cparams, ckstate, CIFAR_REQUESTS, "serve_cifar")
    if args.out:
        prof["serve_cifar"] = profile(torch, ccfg, cparams, ckstate,
                                      cprompts[0])
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

    # since slice 13: the paper's other three models, each at full width
    # and depth with exact launches per path; rt-pg19's and rt-imagenet64's
    # fp32 gates first
    from repro_torch.configs.base import RunConfig, TrainConfig
    paper_rows = {}
    for path, arch, B, N, train_kw, limits in (
            ("train_pg19", PG19_ARCH, PG19_BATCH, PG19_SEQ, PG19_TRAIN,
             PG19_LIMITS),
            ("train_imagenet64", IMAGENET_ARCH, IMAGENET_BATCH,
             IMAGENET_SEQ, IMAGENET_TRAIN, ENWIK8_LIMITS),
            ("train_wikitext103", WIKITEXT_ARCH, WIKITEXT_BATCH,
             WIKITEXT_SEQ, {}, None)):
        prun = RunConfig(model=get_config(arch), train=TrainConfig(
            global_batch=B, seq_len=N, **train_kw))
        paper_rows[path], launches[path] = train_paper(
            torch, prun, path, common.counters, limits)
        torch.cuda.empty_cache()
        t = phase(path, t)

    # since slice 14: every model the port trains served, the paper's
    # other three on the kernels, qwen2-0.5b on full/torch (no counter)
    serve_rows = {}
    for path, (arch, request) in (*SERVE_PAPER.items(),
                                  (SERVE_FULL[0], SERVE_FULL[1:])):
        serve_rows[path], launches[path] = serve_model(
            torch, path, get_config(arch), request, common.counters)
        torch.cuda.empty_cache()
        t = phase(path, t)

    # since slice 15: full-width rt-enwik8 through the continuous-batching
    # engine, runs A and B with exact launches per event, then its gates
    engine_row, launches["serve_engine"], engine_ref = serve_engine(
        torch, card, common.counters)
    t = phase("serve_engine", t)

    # since slice 16: the same engine as disaggregated prefill and decode
    # pools, sessions moved through TCP blobs and the KV store's tiers
    disagg_row, launches["serve_disagg"] = serve_disagg(
        torch, card, common.counters, *engine_ref)
    del engine_ref
    t = phase("serve_disagg", t)

    # since slice 17: the routing-health stats and the obs layer: a train
    # step and a forward with the stats, the engine with its JSONL sink and
    # the launcher with its observability flags
    common.reset_counters()
    obs_row = obs_phase(torch, card, common.counters)
    launches["obs"] = common.counters()
    t = phase("obs", t)

    # since slice 18: checkpoints (restart and preemption bit for bit), the
    # int8 error-feedback exchange at D = 1 and over DIST_RANKS processes on
    # the card, and the launcher resuming from its checkpoints
    common.reset_counters()
    ckpt_row, launches["ckpt_dist"], launches["ckpt_launch"] = \
        ckpt_dist_phase(torch, card, common.counters)
    t = phase("ckpt_dist", t)

    # since slice 19: the model axis, TP_RANKS tensor-parallel ranks on the
    # card against 1 x 1 (rt-enwik8 fp32 and bf16, the segment fold under
    # seq_parallel, qwen2-0.5b with and without seq_parallel)
    common.reset_counters()
    tp_row, launches["tp"] = tp_phase(torch, card, common.counters)
    t = phase("tp", t)

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
            wide_head_bf16_kernels=wide_bf16_rows, flash_edges=flash_edges,
            gathered_edges=gathered_edges, cifar_local=cifar_local_rows,
            local_edges=local_edges, flash_forward_digest=flash_digest,
            local_bwd_edges=local_bwd_edges,
            cifar_local_bwd=cifar_local_bwd_rows, backward_digest=bwd_digest,
            cifar_fused_bwd=cifar_fused_bwd_rows,
            fused_bwd_edges=fused_bwd_edges,
            local_backward_digest=local_digest,
            fused_fwd=fused_fwd_rows, fused_fwd_edges=fused_fwd_edges,
            forward_digest=fwd_digest, decode_shapes=decode_rows,
            train_full_gate_bf16=full_gate_bf16,
            serving=serving_rows, train_gate=gate,
            train_gathered_gate=gathered_gate, train=train_row,
            train_full_gate=full_gate, train_full=full_row,
            launch=launch_row, cifar_gates=cifar_gates, cifar=cifar_rows,
            fit_gathered=fit_row, serve_cifar=cserve_rows,
            routing_row_gate=routing_row_gate, serve_routing=rserve_rows,
            paper_kernels=paper_kernel_rows, pg19_edges=pg19_edges,
            paper=paper_rows, paper_decode=paper_decode_rows,
            decode_digest=dec_digest, serve_paper=serve_rows,
            serve_engine=engine_row, serve_disagg=disagg_row, obs=obs_row,
            ckpt_dist=ckpt_row, tp=tp_row, launches=launches, profile=prof),
            indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
