"""Background transfer worker: the thread that makes park/resume async
(the port's copy of the JAX package's ``serve/kvstore/remote/worker.py``).

One daemon thread, one FIFO queue. Every off-device byte movement the
KV store does asynchronously — host materialization of a parking lane,
tier eviction (disk write / transport put), resume prefetch — runs here
in submission order, so tier state changes are serialized without
holding the store lock across IO. The engine's admission path only
*enqueues*: ``park()`` under ``async_transfers`` returns as soon as the
device→host copies are launched on the store's side stream, and the
decode step it would have blocked overlaps with the transfer. The
thread itself launches no kernel: a park's job waits on the copies'
CUDA event, then works on host memory.

``TransferHandle`` is the rendezvous: ``wait()`` blocks until the job
ran and re-raises the job's exception in the waiter (so a failed
background park surfaces at the resume/export/flush that depends on
it, never silently).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class TransferHandle:
    """Completion handle for one background transfer job."""

    def __init__(self, label: str = ""):
        self.label = label
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self._result = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the job finished; re-raise its error, return its
        result. Raises TimeoutError if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"transfer {self.label or '<unnamed>'} did not complete "
                f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class TransferWorker:
    """One daemon thread draining transfer jobs FIFO."""

    def __init__(self, name: str = "kvstore-transfer"):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[], object],
               handle: Optional[TransferHandle] = None) -> TransferHandle:
        """Queue ``fn``; raises RuntimeError once the thread has stopped
        (a job queued to a dead worker would never run, and its waiter
        would block)."""
        if self._closed or not self._thread.is_alive():
            raise RuntimeError("the transfer worker is not running")
        if handle is None:
            handle = TransferHandle(getattr(fn, "__name__", "job"))
        self._q.put((fn, handle))
        return handle

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, handle = item
            try:
                handle._result = fn()
            except BaseException as e:          # surfaced via wait()
                handle._error = e
            finally:
                handle._event.set()
            # a job may hold a lane's tensors: drop them now, not when the
            # next job arrives
            item = fn = handle = None

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait until every job enqueued so far has run (errors in those
        jobs surface at their own handles, not here)."""
        marker = self.submit(lambda: None)
        if not marker._event.wait(timeout):
            raise TimeoutError("transfer worker did not drain in time")

    def close(self, timeout: float = 10.0) -> None:
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout)
