"""Multi-process launch: ``torch.distributed`` process-group wiring (port of
the JAX package's ``launch/distributed.py``).

One process per rank; process 0 hosts the rendezvous. Discovery is
env/flag-driven (flags override env), with the JAX package's variables:

  REPRO_COORDINATOR    host:port of process 0's rendezvous
  REPRO_NUM_PROCESSES  total number of launched processes
  REPRO_PROCESS_ID     this process's rank in [0, num_processes)

When nothing is configured, `initialize()` is a no-op single-process
fallback, and every collective of the port is the identity there.
`initialize` picks the ``nccl`` backend for CUDA devices (each rank on
card ``rank % device_count``) and ``gloo`` for the CPU; a caller may name
the backend (``gloo`` with CUDA tensors also runs several ranks on one
card, which NCCL refuses).
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from repro_torch.dist import compression as comp
from repro_torch.launch.mesh import make_host_mesh

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
TIMEOUT_S = 300.0


@dataclass(frozen=True)
class LaunchSpec:
    """A validated multi-process launch description."""
    coordinator: str            # "host:port" of process 0
    num_processes: int
    process_id: int

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, "
                             f"got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(f"process_id {self.process_id} outside "
                             f"[0, {self.num_processes})")
        if self.num_processes > 1 and ":" not in self.coordinator:
            raise ValueError("multi-process launch needs a host:port "
                             f"coordinator, got {self.coordinator!r}")


def detect(env: Optional[Mapping[str, str]] = None, *,
           coordinator: Optional[str] = None,
           num_processes: Optional[int] = None,
           process_id: Optional[int] = None) -> Optional[LaunchSpec]:
    """Build a LaunchSpec from explicit flags, falling back to env vars.

    Returns None when nothing is configured (the single-process
    fallback); raises on half-configured launches so a typo'd env never
    silently trains on 1/N of the data.
    """
    env = os.environ if env is None else env
    coordinator = coordinator or env.get(ENV_COORDINATOR, "")
    if num_processes is None:
        num_processes = int(env.get(ENV_NUM_PROCESSES, "0") or 0)
    if process_id is None:
        # "" counts as unset: REPRO_PROCESS_ID=$RANK with $RANK unset
        # must hit the explicit-rank error, not a bare int('') crash
        raw = env.get(ENV_PROCESS_ID, "")
        process_id = int(raw) if raw != "" else None
    if not coordinator and num_processes <= 1:
        return None
    if not coordinator:
        raise ValueError(f"{ENV_NUM_PROCESSES}={num_processes} but no "
                         f"coordinator address ({ENV_COORDINATOR})")
    if num_processes < 1:
        raise ValueError(f"coordinator {coordinator!r} set but "
                         f"{ENV_NUM_PROCESSES} missing")
    if process_id is None:
        # defaulting to rank 0 would make EVERY process claim rank 0 and
        # hang the rendezvous: fail fast instead
        raise ValueError(f"multi-process launch needs an explicit rank "
                         f"({ENV_PROCESS_ID} or --process-id)")
    return LaunchSpec(coordinator, num_processes, process_id)


def initialize(spec: Optional[LaunchSpec] = None,
               env: Optional[Mapping[str, str]] = None, *,
               device="cuda", backend: Optional[str] = None,
               timeout_s: float = TIMEOUT_S, **detect_kw) -> bool:
    """Initialize the default process group when a launch is configured.

    Returns True when multi-process initialization ran, False on the
    single-process fallback (no process group is created). The rendezvous
    is ``tcp://<coordinator>``; every collective times out after
    ``timeout_s`` seconds instead of hanging.
    """
    if spec is None:
        spec = detect(env, **detect_kw)
    if spec is None or spec.num_processes <= 1:
        return False
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(spec.process_id % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{spec.coordinator}",
        world_size=spec.num_processes, rank=spec.process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_info() -> dict:
    """Rank/process-count view after (maybe-)initialization, for logging
    (the JAX package's keys; one device per process)."""
    n = comp.world_size()
    return {"process_index": comp.rank(), "process_count": n,
            "local_devices": 1, "global_devices": n}


def make_process_mesh(data: int = 1, model: int = 1):
    """The (data, model) `Mesh` over every process (call after
    `initialize`; every process calls it, since it creates the axes'
    process groups): `launch/mesh.make_host_mesh`, which clamps the
    request to the largest feasible grid."""
    return make_host_mesh(data, model)
