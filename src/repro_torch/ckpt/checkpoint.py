"""Atomic, async checkpoints with elastic restore (port of the JAX
package's ``ckpt/checkpoint.py``; its on-disk format, byte for byte).

Layout:  <dir>/step_<N>/arrays.npz   flattened "path/to/leaf" -> np array
         <dir>/step_<N>/manifest.json  step, sorted keys, extra
Commit protocol: write into `step_<N>.tmp/`, fsync the manifest, then
os.rename — a checkpoint directory either exists completely or not at
all; interrupted saves leave only .tmp garbage that restore ignores and
the next commit removes.

Keys are built as the JAX package builds them over a pytree: dict keys in
sorted order, list and tuple indices, ``.field`` for a NamedTuple (JAX's
``GetAttrKey``), ``None`` writing no key. A Python int leaf (the port's
``step`` and optimizer ``count``) is stored as an int32 0-d array, as JAX
stores its scalars. A bfloat16 leaf is stored as numpy writes an
``ml_dtypes.bfloat16`` array for JAX: the raw little-endian bf16 bits under
the header's ``'<V2'``, which loads as 2-byte void words; restore reads
such words back through a 16-bit integer view by the template's dtype (no
``ml_dtypes`` needed, here or on load).

Async: `save_async` copies every leaf to the host synchronously (a
blocking device-to-host copy, so the snapshot is complete before the
writer starts and before the caller's next step), then writes in a daemon
thread; `wait()` joins before the next save, so at most one writer is in
flight.

Elastic restore: each restored leaf takes its template's dtype and device
(the port's counterpart of the JAX ``shardings`` argument on one data
axis). Error-feedback residuals (``ef_state/*``) missing from a checkpoint
or saved for another data-parallel size re-zero instead of failing: zero is
always a valid restart of the residual.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

BF16_WORD = np.dtype("V2")
BF16_DESCR = "<V2"                   # ml_dtypes.bfloat16's dtype.str


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's flattening order and with its
    key names (``_flatten`` / ``_kname`` of ``repro.ckpt.checkpoint``)."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), t) for i, t in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [kl for name, sub in items
            for kl in _flatten(sub, f"{prefix}/{name}" if prefix else name)]


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    def key(name):
        return f"{prefix}/{name}" if prefix else name
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves, key("." + f))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, key(str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, leaves, key(str(i)))
                          for i, t in enumerate(tree))
    return leaves[prefix]


def to_host(leaf: Any) -> np.ndarray:
    """A leaf as the array the JAX package would write: a copy on the host
    (blocking), bf16 as 2-byte void words, a Python int as int32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_WORD)
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    raise TypeError(f"a checkpoint leaf is a tensor or an int, not "
                    f"{type(leaf).__name__}")


def _write_npz(path: str, host: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **host)``, but a bf16 leaf's header names its dtype
    as numpy does for ``ml_dtypes.bfloat16`` (``'<V2'``, where a plain void
    dtype writes ``'|V2'``), so every array's bytes are the JAX package's."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if arr.dtype == BF16_WORD:
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": BF16_DESCR, "fortran_order": False,
                            "shape": arr.shape})
                    f.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(f, arr)


def _shape(like: Any) -> Tuple[int, ...]:
    return tuple(like.shape) if hasattr(like, "shape") else ()


def _as_like(arr: np.ndarray, like: Any) -> Any:
    """``arr`` with ``like``'s type: a tensor of its dtype on its device,
    or a Python int."""
    if not isinstance(like, torch.Tensor):
        return int(arr)
    if arr.dtype == BF16_WORD:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        if int(step) in self.all_steps():
            return                       # committed: skip the host copy
        host = {k: to_host(v) for k, v in _flatten(state)}
        manifest = {"step": int(step), "keys": sorted(host.keys()),
                    "extra": extra or {}}
        self.wait()                      # at most one writer in flight
        if int(step) in self.all_steps():
            return                       # already committed (final-save dup)
        if blocking:
            self._write(int(step), host, manifest)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(int(step), host, manifest),
                daemon=True)
            self._thread.start()

    def save_async(self, step: int, state: Any,
                   extra: Optional[Dict] = None) -> None:
        self.save(step, state, extra, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray],
               manifest: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _write_npz(os.path.join(tmp, "arrays.npz"), host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name,
                                                "manifest.json")):
                steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> Tuple[int, str]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, os.path.join(self.dir, f"step_{step:08d}")

    def keys(self, step: Optional[int] = None) -> List[str]:
        """The flattened leaf keys a checkpoint holds (from its manifest),
        so a caller can tell the on-disk layout before it picks a restore
        template."""
        _, d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)["keys"]

    def restore(self, state_like: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """Returns (state, extra). ``state_like`` gives the tree structure
        and, per leaf, the shape, dtype and device (tensors) or the type
        (Python ints) to restore into."""
        _, d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for key, like in _flatten(state_like):
                # error-feedback residuals are approximation state: a warm
                # start from an uncompressed checkpoint, or one saved for
                # another data-parallel size, re-zeros them
                is_ef = key.split("/", 1)[0] == "ef_state"
                arr = data[key] if key in data.files else None
                if arr is None or (is_ef and arr.shape != _shape(like)):
                    if not is_ef:
                        raise KeyError(f"checkpoint missing leaf {key}")
                    arr = np.zeros(_shape(like), np.float32)
                if arr.shape != _shape(like):
                    raise ValueError(
                        f"shape mismatch for {key}: ckpt {arr.shape} "
                        f"vs expected {_shape(like)}")
                leaves[key] = _as_like(arr, like)
        return _unflatten(state_like, leaves), manifest.get("extra", {})
