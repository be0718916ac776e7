"""repro_torch.serve.kvstore.remote — the distributed KV plane (the port of
the JAX package's ``repro.serve.kvstore.remote``).

Three layers under one roof:

  blob       the shared codec: versioned header (tree skeleton, leaf
             dtypes/shapes, compacted-page lengths) + CRC32, verified on
             every decode — disk spill and remote transfer speak the
             same format, and it is the JAX package's byte for byte
  transport  named-blob put/get/delete/exists: LoopbackTransport
             (in-process), TCPTransport + TCPStoreServer (peer host,
             framed sockets, timeouts + bounded backoff retries),
             FileTransport (shared directory / object-store mount),
             FaultInjectionTransport (deterministic failure drills)
  worker     the background transfer thread that makes park/resume
             async (device→host copies on a side stream, then host-side
             compaction and transport puts overlap the next decode steps)

``KVStore`` consumes all of this via ``StoreConfig(remote=...,
async_transfers=...)`` — see repro_torch.serve.kvstore.store.
"""
from repro_torch.serve.kvstore.remote.blob import (BLOB_VERSION,
                                                   BlobChecksumError,
                                                   BlobError, decode_session,
                                                   encode_session)
from repro_torch.serve.kvstore.remote.tcp import TCPStoreServer, TCPTransport
from repro_torch.serve.kvstore.remote.transport import (
    BlobNotFound, FaultInjectionTransport, FileTransport,
    InstrumentedTransport, LoopbackTransport, RetryPolicy, Transport,
    TransportError, with_retries)
from repro_torch.serve.kvstore.remote.worker import (TransferHandle,
                                                     TransferWorker)

__all__ = [
    "BLOB_VERSION", "BlobChecksumError", "BlobError", "BlobNotFound",
    "FaultInjectionTransport", "FileTransport", "InstrumentedTransport",
    "LoopbackTransport", "RetryPolicy", "TCPStoreServer", "TCPTransport",
    "Transport", "TransferHandle", "TransferWorker", "TransportError",
    "decode_session", "encode_session", "with_retries",
]
