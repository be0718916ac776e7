"""Build, load and launch plumbing for the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. At first
use it is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared`` into ``src/repro_torch/_build/`` (git-ignored), under a file
name that carries a hash of the source, its headers and the flags, and
loaded with ctypes. Nothing is built when a module is imported: the CPU
tests import every module on a host with no nvcc.

Every C entry point returns ``cudaGetLastError()`` after its launch;
`check` raises on anything but 0, so a refused launch (too much shared
memory, too many threads) never passes silently. Each wrapper counts its
own launches in a `LaunchCounter` (`counters()` / `reset_counters()`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the widths of the flash and gathered kernels: the flash wrappers run a
# head dim up to 128 zero-padded to one of them (`pad_heads`; the bf16
# flash kernels also have a dh-80 instance, `flash_attention.BF16_WIDTHS`);
# the gathered kernels take these two only
SUPPORTED_HEAD_DIMS = (64, 128)
# the widths of the fused routing and paged decode kernels: a head dim up
# to one of them runs zero-padded to it (`pad_heads`)
PADDED_HEAD_DIMS = (64, 128, 192)
# the local-window kernels' widths: those and 256 (recurrentgemma-9b's head
# dim), which the fused routing and decode kernels do not take
LOCAL_HEAD_DIMS = PADDED_HEAD_DIMS + (256,)
# element-type codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Plain integer count of one wrapper's kernel launches."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def bump(self) -> None:
        self.count += 1


_COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return _COUNTERS.setdefault(name, LaunchCounter(name))


def counters() -> Dict[str, int]:
    return {n: c.count for n, c in _COUNTERS.items()}


def reset_counters() -> None:
    for c in _COUNTERS.values():
        c.count = 0


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


BUILD_LOGS: Dict[str, str] = {}


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns name -> library.
    Each library's nvcc log is kept beside it and read into ``BUILD_LOGS``
    also when the library is current."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {n: _lib_path(n) for n in names}
    procs = {}
    for n, lib in libs.items():
        if lib.exists():
            if lib.with_suffix(".log").exists():
                BUILD_LOGS[n] = lib.with_suffix(".log").read_text()
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(_nvcc_cmd(n, tmp), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        libs[n].with_suffix(".log").write_text(log)
        os.replace(tmp, libs[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of kernel source ``name``, built if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    f = getattr(_LIBS[name], fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    """The current device's current stream: the raw handle that
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    Stream object on every launch, a cost a short kernel's wrapper feels
    on the host. This depends on a private PyTorch call,
    ``torch._C._cuda_getCurrentRawStream``; should a PyTorch release drop
    it, the public line above is its replacement."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device()))


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensors(what: str, unaligned: Tuple[str, ...] = (),
                  **tensors: torch.Tensor) -> None:
    """Checks shared by every wrapper, made before it dispatches, so the CPU
    tests hold the call sites to what the kernel takes: contiguity always;
    for CUDA tensors also one device and 16-byte alignment, but for those
    the kernel reads element by element (``unaligned``; dtype and shape
    checks are per kernel)."""
    # each message is built only when its check fails: formatted on every
    # call they were a large part of a short kernel's wrapper time on the
    # host
    dev = next(iter(tensors.values())).device
    cuda = dev.type == "cuda"
    for n, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {n} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{what}: {n} is on {t.device}, not {dev}")
        if cuda and n not in unaligned and t.data_ptr() % 16:
            raise ValueError(f"{what}: {n} must be 16-byte aligned (vector "
                             f"loads)")
    if not cuda and dev.type != "cpu":
        raise ValueError(f"{what}: tensors on {dev}: the kernel runs on "
                         f"CUDA, its plain version on the CPU")


def head_dim_ok(what: str, dh: int,
                widths: Tuple[int, ...] = SUPPORTED_HEAD_DIMS) -> None:
    require(dh in widths,
            f"{what}: head_dim {dh} unsupported by the CUDA kernel "
            f"(supported: {widths})")


def padded_head_dim(what: str, dh: int,
                    widths: Tuple[int, ...] = PADDED_HEAD_DIMS) -> int:
    """The kernel width a head dim ``dh`` runs at: the first of ``widths``
    (the kernel family's instances: SUPPORTED_HEAD_DIMS for the flash
    kernels, PADDED_HEAD_DIMS for the fused routing and decode kernels,
    LOCAL_HEAD_DIMS for the local-window ones) that holds it."""
    for width in widths:
        if dh <= width:
            return width
    raise ValueError(f"{what}: head_dim {dh} is wider than the kernels' "
                     f"widest instance ({widths[-1]})")


@functools.lru_cache(maxsize=None)
def head_scale(dh: int) -> float:
    """The softmax scale 1 / sqrt(dh) in fp32, rounded as ``1.0f /
    sqrtf(dh)`` rounds it (IEEE square root and division), so that the
    value the kernels are passed is the one they once computed."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def pad_heads(what: str, dh: int, *tensors: Optional[torch.Tensor],
              widths: Tuple[int, ...] = PADDED_HEAD_DIMS) -> Tuple:
    """``tensors`` (..., dh) with zero columns up to `padded_head_dim` of
    ``widths`` (None passes through; at a kernel width they are returned
    as they are). Zero columns leave every dot product, so every score and
    every softmax, unchanged, provided the scale stays `head_scale` of the
    true dh; the outputs' extra columns are zero and `unpad_heads` cuts
    them."""
    width = padded_head_dim(what, dh, widths)
    if width == dh:
        return tensors
    return tuple(None if t is None else F.pad(t, (0, width - dh))
                 for t in tensors)


def unpad_heads(dh: int, *tensors: torch.Tensor) -> Tuple:
    """``tensors`` (..., width) cut back to their first ``dh`` columns."""
    return tuple(t if t.shape[-1] == dh else t[..., :dh].contiguous()
                 for t in tensors)


def group_sum(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B,H,N,dh) per query head -> (B,Hkv,N,dh): sum each kv head's
    query group (GQA), as the JAX package does after its dk/dv kernels."""
    B, H, N, dh = x.shape
    return x.reshape(B, Hkv, H // Hkv, N, dh).sum(2)


def dtype_code(what: str, t: torch.Tensor) -> int:
    require(t.dtype in DTYPE_CODES,
            f"{what}: dtype {t.dtype} unsupported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]
