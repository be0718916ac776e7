"""Single-device training launcher of the port (counterpart of the JAX
package's ``launch/train.py``, with its flags and defaults).

  PYTHONPATH=src python -m repro_torch.launch.train              # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \
      --device cpu

The model is forced to fp32 and trained on the synthetic markov task
(vocabulary min(V, 512)) with ``TrainConfig(lr=1e-3,
schedule="linear_warmup_rsqrt", warmup_steps=20)``, as the JAX launcher
does. It runs on the card unless ``--device cpu`` is given; without a card
it raises. The JAX launcher's flags for meshes, checkpoints, sequence
parallelism, gradient compression, observability and multi-host launch
are accepted but raise `NotImplementedError` when set: their subsystems
are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.configs.base import RunConfig, TrainConfig, with_overrides
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.train.trainer import Trainer

_DIST = "ROADMAP Queue 1 item 10: ckpt, dist and launch"
_OBS = "ROADMAP Queue 1 item 9: obs"
# flags whose subsystem is not ported -> the ROADMAP item it waits for
_UNPORTED = {"mesh": _DIST, "ckpt_dir": _DIST, "seq_parallel": _DIST,
             "grad_compression": _DIST, "obs_jsonl": _OBS,
             "routing_stats": _OBS, "profile_dir": _OBS,
             "coordinator": _DIST, "num_processes": _DIST,
             "process_id": _DIST}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--obs-jsonl", default=None)
    ap.add_argument("--routing-stats", action="store_true")
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv``, train, print the JAX launcher's lines and return
    `Trainer.fit`'s result."""
    ap = parser()
    args = ap.parse_args(argv)
    for dest, item in _UNPORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} is not ported yet ({item})")
    if args.arch not in ARCHS:
        ap.error(f"unknown --arch {args.arch}; choices: {sorted(ARCHS)}")

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = with_overrides(cfg, dtype="float32")
    run = RunConfig(model=cfg, train=TrainConfig(
        global_batch=args.batch, seq_len=args.seq, steps=args.steps,
        lr=1e-3, schedule="linear_warmup_rsqrt", warmup_steps=20))
    loader = SyntheticLoader("markov", min(cfg.vocab_size, 512),
                             args.batch, args.seq)
    tr = Trainer(run, loader, device=args.device)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={tr.device}")
    out = tr.fit(args.steps)
    hist = tr.metrics_history
    if hist:
        print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    print(out)
    return out


if __name__ == "__main__":
    main()
