"""Training launcher of the port (counterpart of the JAX package's
``launch/train.py``, with its flags and defaults).

  PYTHONPATH=src python -m repro_torch.launch.train              # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \
      --device cpu
  # resume from (and checkpoint into) a directory; int8 error-feedback
  # gradient exchange
  PYTHONPATH=src python -m repro_torch.launch.train --ckpt-dir ckpt \
      --grad-compression int8_ef
  # two processes, data-parallel (per process; the coordinator is rank 0's
  # rendezvous; NCCL on the card, gloo with --device cpu)
  REPRO_COORDINATOR=localhost:29500 REPRO_NUM_PROCESSES=2 \
      REPRO_PROCESS_ID=$RANK python -m repro_torch.launch.train
  # the same two processes tensor-parallel, and sequence-parallel too
  ... python -m repro_torch.launch.train --mesh 1x2 [--seq-parallel]

The model is forced to fp32 and trained on the synthetic markov task
(vocabulary min(V, 512)) with ``TrainConfig(lr=1e-3,
schedule="linear_warmup_rsqrt", warmup_steps=20)``, as the JAX launcher
does. It runs on the card unless ``--device cpu`` is given; without a card
it raises. ``--obs-jsonl`` appends a ``train_step`` record per step
(validate with ``python -m repro_torch.obs.schema``), ``--routing-stats``
turns on the routing-health stats (``routing/*`` and ``rt/*`` metrics),
and ``--profile-dir`` captures the whole run as a Chrome trace
(``trace.json``). ``--mesh DxM`` is clamped to the processes as in JAX:
D data ranks, each of M model ranks that train the model tensor-parallel
(`repro_torch.dist.sharding`, `repro_torch.dist.tensor_parallel`), and
``--seq-parallel`` shards the residual stream's sequence over the model
axis too (a routing model needs ``RoutingConfig.segments`` a multiple of
M, else `ValueError`, as in JAX).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import torch

from repro_torch.attn.spec import specs_for_model
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.configs.base import RunConfig, TrainConfig, with_overrides
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.dist import sharding as shd
from repro_torch.launch import distributed
from repro_torch.obs import trace as obs_trace
from repro_torch.train.trainer import Trainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default="", help="DxM, e.g. 2x1 (default: "
                                               "every process as data)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from the latest checkpoint here and save "
                         "into it")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="shard the residual stream's sequence over the "
                         "model axis")
    ap.add_argument("--grad-compression", default="none",
                    help="none or int8_ef: the error-feedback int8 "
                         "gradient exchange (data-parallel)")
    ap.add_argument("--obs-jsonl", default=None,
                    help="append per-step metric records (schema v1 JSONL, "
                         "validated by `python -m repro_torch.obs.schema`)")
    ap.add_argument("--routing-stats", action="store_true",
                    help="compute the routing-health stats (occupancy "
                         "entropy, dead clusters, centroid drift, mismatch, "
                         "sampled attention recall) in every step")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler Chrome trace of the "
                         "whole run into this directory")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (or $REPRO_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="total launched processes (or $REPRO_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (or $REPRO_PROCESS_ID)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv``, (maybe) join the process group, train, print the
    JAX launcher's lines and return `Trainer.fit`'s result."""
    ap = parser()
    args = ap.parse_args(argv)
    multi = distributed.initialize(coordinator=args.coordinator,
                                   num_processes=args.num_processes,
                                   process_id=args.process_id,
                                   device=args.device)
    try:
        return _train(ap, args, multi)
    finally:
        if multi:
            torch.distributed.destroy_process_group()


def _train(ap, args, multi: bool) -> Dict[str, Any]:
    if args.arch not in ARCHS:
        ap.error(f"unknown --arch {args.arch}; choices: {sorted(ARCHS)}")

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = with_overrides(cfg, dtype="float32")
    if args.routing_stats:
        cfg = with_overrides(
            cfg, routing=with_overrides(cfg.routing, stats=True))
    run = RunConfig(model=cfg, train=TrainConfig(
        global_batch=args.batch, seq_len=args.seq, steps=args.steps,
        lr=1e-3, schedule="linear_warmup_rsqrt", warmup_steps=20,
        grad_compression=args.grad_compression))

    info = distributed.process_info()
    n = info["global_devices"]
    d, m = ((int(x) for x in args.mesh.split("x")) if args.mesh
            else (n, 1))
    compressed = run.train.grad_compression == "int8_ef"
    if compressed and m > 1:
        ap.error("--grad-compression int8_ef is data-parallel only; "
                 "use --mesh Dx1")
    if compressed and args.seq_parallel:
        ap.error("--seq-parallel needs the GSPMD path; drop it or use "
                 "--grad-compression none")
    mesh = distributed.make_process_mesh(d, m)   # clamps oversubscription
    d, m = mesh.shape["data"], mesh.shape["model"]
    use_fsdp = cfg.param_count() > 20e9
    constrain = (None if compressed else shd.make_constrain_fn(
        mesh, args.seq_parallel, fsdp_prefetch=use_fsdp,
        attn_specs=specs_for_model(cfg)))
    # every process builds the same global batches; the step takes its rows
    loader = SyntheticLoader("markov", min(cfg.vocab_size, 512),
                             args.batch, args.seq)
    tr = Trainer(run, loader, ckpt_dir=args.ckpt_dir, device=args.device,
                 obs_jsonl=args.obs_jsonl, mesh=mesh, constrain_fn=constrain)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"mesh=({d}x{m}) devices={n} "
          f"process={info['process_index']}/{info['process_count']} "
          f"multi_host={multi} compression={run.train.grad_compression} "
          f"device={tr.device}")
    try:
        with obs_trace.profile(args.profile_dir):
            out = tr.fit(args.steps)
    finally:
        tr.close()
    hist = tr.metrics_history
    if hist:
        print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    print(out)
    return out


if __name__ == "__main__":
    main()
