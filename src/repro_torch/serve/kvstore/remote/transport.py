"""Blob transports: named put/get/delete/exists over a remote store (the
port's copy of the JAX package's ``serve/kvstore/remote/transport.py``,
which is pure Python).

``Transport`` is the protocol the KV store's remote tier speaks —
whole blobs under string names, nothing smarter. Three implementations:

  LoopbackTransport  in-process dict. Deterministic, zero IO — what the
                     tests and the single-process disaggregation harness
                     use so every failure is reproducible.
  FileTransport      a shared directory (NFS / fuse-mounted object
                     store): one file per blob, written atomically
                     (tmp + rename) so a concurrent reader never sees a
                     half-written blob.
  TCPTransport       sockets to a peer ``TCPStoreServer`` (remote/tcp.py)
                     with connect/read timeouts and bounded
                     exponential-backoff retries.

All of them extend ``InstrumentedTransport``: every op is counted and
timed into a ``repro_torch.obs`` Registry (`transport/puts`, bytes in/out,
put/get latency histograms, retries, failures) whose ``stats()`` the
KV store folds into the engine's ``engine_tick`` records.

``FaultInjectionTransport`` wraps any of them and injects the failure
menagerie the fault suite needs — dropped puts, truncated/corrupted
gets, transient errors that exercise the retry path — deterministically
(counted, not random).
"""
from __future__ import annotations

import os
import threading
import time
import urllib.parse
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Protocol, Tuple

from repro_torch.obs import Registry


class TransportError(RuntimeError):
    """Transport-level failure (connection, framing, server error)."""


class BlobNotFound(TransportError, KeyError):
    """``get``/``delete`` of a name that holds no blob."""

    def __str__(self) -> str:        # KeyError quotes its arg; keep msg
        return RuntimeError.__str__(self)


class Transport(Protocol):
    """What the KV store's remote tier needs from a peer blob store."""

    def put(self, name: str, data: bytes) -> None: ...
    def get(self, name: str) -> bytes: ...
    def delete(self, name: str) -> None: ...
    def exists(self, name: str) -> bool: ...
    def list_blobs(self, prefix: str = "") -> List[str]: ...


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: ``attempts`` total tries, sleeping
    ``min(base_delay_s * factor**i, max_delay_s)`` between them."""

    attempts: int = 4
    base_delay_s: float = 0.05
    factor: float = 2.0
    max_delay_s: float = 2.0

    def delays(self) -> Iterable[float]:
        d = self.base_delay_s
        for _ in range(max(self.attempts - 1, 0)):
            yield min(d, self.max_delay_s)
            d *= self.factor


def with_retries(fn: Callable[[], object], policy: RetryPolicy, *,
                 retry_on: Tuple[type, ...] = (TransportError, OSError),
                 no_retry: Tuple[type, ...] = (BlobNotFound,),
                 on_retry: Optional[Callable[[int, Exception], None]] = None):
    """Run ``fn`` under ``policy``. ``no_retry`` exceptions (a missing
    blob is a deterministic answer, not a transient fault) propagate
    immediately; the last transient error propagates after the final
    attempt."""
    delays = list(policy.delays()) + [None]
    last: Optional[Exception] = None
    for attempt, delay in enumerate(delays):
        try:
            return fn()
        except no_retry:
            raise
        except retry_on as e:
            last = e
            if delay is None:
                break
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
    raise TransportError(
        f"gave up after {policy.attempts} attempts: {last}") from last


class InstrumentedTransport:
    """Base class: public ops wrap subclass ``_put``/``_get``/... with
    counters + latency histograms; ``stats()`` is engine_tick food."""

    def __init__(self):
        self.obs = Registry()
        self._puts = self.obs.counter("transport/puts")
        self._gets = self.obs.counter("transport/gets")
        self._deletes = self.obs.counter("transport/deletes")
        self._bytes_out = self.obs.counter("transport/bytes_out")
        self._bytes_in = self.obs.counter("transport/bytes_in")
        self._retries = self.obs.counter("transport/retries")
        self._failures = self.obs.counter("transport/failures")
        self._put_s = self.obs.histogram("transport/put_s")
        self._get_s = self.obs.histogram("transport/get_s")

    # subclasses implement these
    def _put(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def _get(self, name: str) -> bytes:
        raise NotImplementedError

    def _delete(self, name: str) -> None:
        raise NotImplementedError

    def _exists(self, name: str) -> bool:
        raise NotImplementedError

    def _list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def put(self, name: str, data: bytes) -> None:
        t0 = time.perf_counter()
        try:
            self._put(name, bytes(data))
        except Exception:
            self._failures.inc()
            raise
        self._put_s.record(time.perf_counter() - t0)
        self._puts.inc()
        self._bytes_out.inc(len(data))

    def get(self, name: str) -> bytes:
        t0 = time.perf_counter()
        try:
            data = self._get(name)
        except BlobNotFound:
            raise
        except Exception:
            self._failures.inc()
            raise
        self._get_s.record(time.perf_counter() - t0)
        self._gets.inc()
        self._bytes_in.inc(len(data))
        return data

    def delete(self, name: str) -> None:
        try:
            self._delete(name)
        except BlobNotFound:
            raise
        except Exception:
            self._failures.inc()
            raise
        self._deletes.inc()

    def exists(self, name: str) -> bool:
        return self._exists(name)

    def list_blobs(self, prefix: str = "") -> List[str]:
        return sorted(self._list(prefix))

    def stats(self) -> dict:
        out = {
            "transport/puts": self._puts.value,
            "transport/gets": self._gets.value,
            "transport/deletes": self._deletes.value,
            "transport/bytes_out": self._bytes_out.value,
            "transport/bytes_in": self._bytes_in.value,
            "transport/retries": self._retries.value,
            "transport/failures": self._failures.value,
        }
        for name, h in (("put", self._put_s), ("get", self._get_s)):
            if h.count:
                out[f"transport/{name}_p50_s"] = h.percentile(50)
                out[f"transport/{name}_p99_s"] = h.percentile(99)
        return out


class LoopbackTransport(InstrumentedTransport):
    """In-process blob store — the deterministic test/bench transport.
    Thread-safe: the KV store's transfer worker and the main thread may
    hit it concurrently."""

    def __init__(self):
        super().__init__()
        self._blobs = {}
        self._lock = threading.RLock()

    def _put(self, name, data):
        with self._lock:
            self._blobs[name] = data

    def _get(self, name):
        with self._lock:
            try:
                return self._blobs[name]
            except KeyError:
                raise BlobNotFound(f"no blob named {name!r}") from None

    def _delete(self, name):
        with self._lock:
            if self._blobs.pop(name, None) is None:
                raise BlobNotFound(f"no blob named {name!r}")

    def _exists(self, name):
        with self._lock:
            return name in self._blobs

    def _list(self, prefix):
        with self._lock:
            return [n for n in self._blobs if n.startswith(prefix)]


class FileTransport(InstrumentedTransport):
    """Shared-directory transport (object-store semantics over a mount).

    Blob names are percent-encoded into flat filenames (no directory
    traversal, arbitrary name characters survive the round trip) and
    writes go through tmp + ``os.replace`` so a concurrent ``get`` on a
    peer host never reads a torn blob.
    """

    _SUFFIX = ".blob"

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root,
                            urllib.parse.quote(name, safe="") + self._SUFFIX)

    def _put(self, name, data):
        path = self._path(name)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def _get(self, name):
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise BlobNotFound(f"no blob named {name!r}") from None

    def _delete(self, name):
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            raise BlobNotFound(f"no blob named {name!r}") from None

    def _exists(self, name):
        return os.path.exists(self._path(name))

    def _list(self, prefix):
        out = []
        for fn in os.listdir(self.root):
            if not fn.endswith(self._SUFFIX):
                continue
            name = urllib.parse.unquote(fn[:-len(self._SUFFIX)])
            if name.startswith(prefix):
                out.append(name)
        return out


class FaultInjectionTransport(InstrumentedTransport):
    """Deterministic failure wrapper for the fault suite and benches.

    Counters, not randomness: the first ``fail_puts`` puts / ``fail_gets``
    gets raise a transient ``TransportError`` (retry fodder); the first
    ``drop_puts`` puts report success without storing (a lost blob —
    later gets see ``BlobNotFound``); the first ``corrupt_gets`` /
    ``truncate_gets`` gets return damaged bytes (the blob CRC must
    catch both); ``duplicate_puts`` puts every blob twice (idempotence).
    Each counter decrements as it fires, so a wrapped transport heals —
    letting one test drive fail → retry → recover end to end.
    """

    def __init__(self, inner, *, fail_puts: int = 0, fail_gets: int = 0,
                 drop_puts: int = 0, corrupt_gets: int = 0,
                 truncate_gets: int = 0, duplicate_puts: bool = False):
        super().__init__()
        self.inner = inner
        self.fail_puts = fail_puts
        self.fail_gets = fail_gets
        self.drop_puts = drop_puts
        self.corrupt_gets = corrupt_gets
        self.truncate_gets = truncate_gets
        self.duplicate_puts = duplicate_puts
        self.injected = {"fail_put": 0, "fail_get": 0, "drop_put": 0,
                         "corrupt_get": 0, "truncate_get": 0}

    def _put(self, name, data):
        if self.fail_puts > 0:
            self.fail_puts -= 1
            self.injected["fail_put"] += 1
            raise TransportError(f"injected put failure for {name!r}")
        if self.drop_puts > 0:
            self.drop_puts -= 1
            self.injected["drop_put"] += 1
            return                      # blob silently lost
        self.inner.put(name, data)
        if self.duplicate_puts:
            self.inner.put(name, data)

    def _get(self, name):
        if self.fail_gets > 0:
            self.fail_gets -= 1
            self.injected["fail_get"] += 1
            raise TransportError(f"injected get failure for {name!r}")
        data = self.inner.get(name)
        if self.truncate_gets > 0:
            self.truncate_gets -= 1
            self.injected["truncate_get"] += 1
            return data[:max(len(data) // 2, 1)]
        if self.corrupt_gets > 0:
            self.corrupt_gets -= 1
            self.injected["corrupt_get"] += 1
            i = len(data) // 2
            return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        return data

    def _delete(self, name):
        self.inner.delete(name)

    def _exists(self, name):
        return self.inner.exists(name)

    def _list(self, prefix):
        return self.inner.list_blobs(prefix)
