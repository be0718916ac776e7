"""TCP blob peer: length-prefixed framing, timeouts, retried client (the
port's copy of the JAX package's ``serve/kvstore/remote/tcp.py``; the two
speak one wire protocol, so either side's client talks to either side's
server).

Wire protocol (all integers big-endian)::

    request   u64 frame_len | u8 op | u32 name_len | name utf-8 | payload
    response  u64 frame_len | u8 status | payload

``frame_len`` counts everything after itself, so both sides read
exactly one length then exactly one frame — no delimiters, no
ambiguity at any blob size. Ops: PUT(payload=blob), GET, DELETE,
EXISTS (payload ``\\x01``/``\\x00`` back), LIST (payload=prefix, JSON
list back), PING (liveness probe for ``wait_until_ready``). Status:
OK / NOT_FOUND / ERROR (payload = utf-8 message).

``TCPStoreServer`` is the peer host's side: an accept loop + one
handler thread per connection (connections are long-lived; each serves
many requests), blobs in an in-memory dict. It is deliberately dumb —
the KV store on the *client* side owns tiering, checksums, and retry
policy; the server just holds named bytes. ``TCPTransport`` is the
client: one connection per op (reconnect == retry unit), connect/read
timeouts, and bounded exponential-backoff retries via ``RetryPolicy``
for transient socket errors (a NOT_FOUND answer is deterministic and
never retried).
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, Tuple

from repro_torch.serve.kvstore.remote.transport import (BlobNotFound,
                                                  InstrumentedTransport,
                                                  RetryPolicy,
                                                  TransportError,
                                                  with_retries)

OP_PUT, OP_GET, OP_DELETE, OP_EXISTS, OP_LIST, OP_PING = 1, 2, 3, 4, 5, 6
OK, NOT_FOUND, ERROR = 0, 1, 2

_LEN = struct.Struct(">Q")
_REQ = struct.Struct(">BI")             # op, name_len
_STATUS = struct.Struct(">B")
MAX_FRAME = 1 << 34                     # 16 GiB: sanity bound on frames
ACCEPT_POLL_S = 0.1                     # server accept loop's wake period
CONN_TIMEOUT_S = 300.0                  # server side of one connection


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise TransportError("peer closed the connection mid-frame")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise TransportError(f"frame length {n} exceeds bound {MAX_FRAME}")
    return _recv_exact(sock, n)


def _send_frame(sock: socket.socket, *parts: bytes) -> None:
    body = b"".join(parts)
    sock.sendall(_LEN.pack(len(body)) + body)


class TCPStoreServer:
    """In-memory blob store serving the wire protocol above.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    Runs its accept loop on a daemon thread; ``close()`` (or the
    context manager) shuts it down and drops every live connection.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        # the accept loop wakes this often to see close(): closing a
        # socket does not interrupt another thread's accept() on Linux
        self._sock.settimeout(ACCEPT_POLL_S)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closing = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="kv-blob-server", daemon=True)
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                  # socket closed by close()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(CONN_TIMEOUT_S)
            while not self._closing:
                try:
                    frame = _recv_frame(conn)
                except (TransportError, OSError):
                    return              # client went away
                try:
                    status, payload = self._handle(frame)
                except Exception as e:  # never kill the connection loop
                    status, payload = ERROR, str(e).encode()
                try:
                    _send_frame(conn, _STATUS.pack(status), payload)
                except OSError:
                    return

    def _handle(self, frame: bytes) -> Tuple[int, bytes]:
        op, name_len = _REQ.unpack_from(frame, 0)
        off = _REQ.size
        name = frame[off:off + name_len].decode()
        payload = frame[off + name_len:]
        if op == OP_PUT:
            with self._lock:
                self._blobs[name] = payload
            return OK, b""
        if op == OP_GET:
            with self._lock:
                data = self._blobs.get(name)
            return (NOT_FOUND, b"") if data is None else (OK, data)
        if op == OP_DELETE:
            with self._lock:
                had = self._blobs.pop(name, None) is not None
            return (OK, b"") if had else (NOT_FOUND, b"")
        if op == OP_EXISTS:
            with self._lock:
                return OK, (b"\x01" if name in self._blobs else b"\x00")
        if op == OP_LIST:
            prefix = payload.decode()
            with self._lock:
                names = [n for n in self._blobs if n.startswith(prefix)]
            return OK, json.dumps(sorted(names)).encode()
        if op == OP_PING:
            return OK, b""
        return ERROR, f"unknown op {op}".encode()

    def close(self) -> None:
        self._closing = True
        self._thread.join(timeout=5 * ACCEPT_POLL_S + 5)
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TCPTransport(InstrumentedTransport):
    """Client to a ``TCPStoreServer`` peer, with timeouts + retries."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout_s: float = 5.0,
                 io_timeout_s: float = 60.0,
                 retry: RetryPolicy = RetryPolicy()):
        super().__init__()
        self.host, self.port = host, int(port)
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.retry = retry

    def __repr__(self) -> str:
        return f"TCPTransport({self.host}:{self.port})"

    def _rpc_once(self, op: int, name: str,
                  payload: bytes = b"") -> Tuple[int, bytes]:
        nb = name.encode()
        with socket.create_connection(
                (self.host, self.port),
                timeout=self.connect_timeout_s) as sock:
            sock.settimeout(self.io_timeout_s)
            _send_frame(sock, _REQ.pack(op, len(nb)), nb, payload)
            resp = _recv_frame(sock)
        (status,) = _STATUS.unpack_from(resp, 0)
        body = resp[_STATUS.size:]
        if status == ERROR:
            raise TransportError(
                f"peer {self.host}:{self.port} errored: {body.decode()}")
        return status, body

    def _rpc(self, op: int, name: str,
             payload: bytes = b"") -> Tuple[int, bytes]:
        return with_retries(
            lambda: self._rpc_once(op, name, payload), self.retry,
            retry_on=(OSError, TransportError),
            on_retry=lambda i, e: self._retries.inc())

    def wait_until_ready(self, timeout_s: float = 30.0) -> None:
        """Block until the peer answers a PING (process rendezvous for
        the two-pool harness); raises TransportError on timeout."""
        policy = RetryPolicy(attempts=max(int(timeout_s / 0.25), 1),
                             base_delay_s=0.25, factor=1.0,
                             max_delay_s=0.25)
        with_retries(lambda: self._rpc_once(OP_PING, ""), policy,
                     retry_on=(OSError, TransportError),
                     on_retry=lambda i, e: self._retries.inc())

    def _put(self, name, data):
        self._rpc(OP_PUT, name, data)

    def _get(self, name):
        status, body = self._rpc(OP_GET, name)
        if status == NOT_FOUND:
            raise BlobNotFound(f"no blob named {name!r} on "
                               f"{self.host}:{self.port}")
        return body

    def _delete(self, name):
        status, _ = self._rpc(OP_DELETE, name)
        if status == NOT_FOUND:
            raise BlobNotFound(f"no blob named {name!r} on "
                               f"{self.host}:{self.port}")

    def _exists(self, name):
        _, body = self._rpc(OP_EXISTS, name)
        return body == b"\x01"

    def _list(self, prefix):
        _, body = self._rpc(OP_LIST, "", prefix.encode())
        return json.loads(body.decode())
