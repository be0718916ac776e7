"""One codec for every off-device tier: versioned blob header + CRC32 (the
port's side of the JAX package's ``serve/kvstore/remote/blob.py``, byte
for byte the same format, so a blob either package writes is one the
other reads).

A blob is the wire/file form of a ``ParkedSession``: the compacted
cluster-page representation the host tier keeps (only the occupied
``min(rlen, cap)`` prefix of each page travels), so a remote round trip
is bit-exact for the reason the local one is. Layout::

    offset 0   magic  b"RKVB"
           4   u8     version (== BLOB_VERSION)
           5   u32    header length (big-endian)
           9   header JSON (utf-8)
           ..  leaf payload bytes, concatenated in header order
        last 4 u32    CRC32 of everything before it (big-endian)

The header holds ``uid``, the ``skeleton`` (the nested list/dict
structure with leaf indices at the leaves; cache lanes are plain
JSON-able containers, which ``encode_session`` enforces), ``leaves``
(per leaf: key path, logical shape, dtype name, stored shape, byte
length and the page-length sibling key a compacted leaf re-expands
against) and the caller's JSON ``meta``.

Where the two packages differ, this module translates:

* leaves are listed in the JAX package's flatten order (list items by
  index, dict keys sorted), and the skeleton's leaf indices follow it;
  the port's trees keep dicts in insertion order, so a decoded template
  keeps the skeleton's key order (the engine lines a lane up with its
  pool before writing it);
* a key is a path as ``jax.tree_util.keystr`` writes it: ``[0]`` for a
  list index, ``['k']`` for a dict key (`keystr`); decoding rebuilds
  each path from the skeleton and holds the header's key to it;
* dtype names are numpy's (``float32``, ``int32``, ``bfloat16``); a
  bfloat16 payload is its raw 16-bit words, as ``ml_dtypes`` stores it.

The CRC is verified on decode: a truncated or corrupted blob, on disk or
fetched over a transport, raises ``BlobChecksumError`` instead of
resuming silent garbage.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_paths

MAGIC = b"RKVB"
BLOB_VERSION = 1
_HEAD = struct.Struct(">4sBI")          # magic, version, header_len
_CRC = struct.Struct(">I")

# numpy's dtype names, which the JAX package writes, and torch's dtypes
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


class BlobError(ValueError):
    """Malformed blob (bad magic/version/header, truncated payload)."""


class BlobChecksumError(BlobError):
    """CRC32 mismatch — the blob was corrupted in storage or transit."""


def keystr(path: Tuple) -> str:
    """``jax.tree_util.keystr`` of a port path: ``(0, '1', 'rk')`` ->
    ``"[0]['1']['rk']"``."""
    return "".join(f"[{p!r}]" for p in path)


def _dtype_from_name(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise BlobError(f"unknown leaf dtype {name!r}") from None


def _skeleton(template, index: Dict[Tuple, int]):
    """``template``'s containers with each leaf's blob index at its place;
    lists and dicts only (a tuple would not survive JSON)."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, prefix + (i,)) for i, v in enumerate(node)]
        if isinstance(node, tuple):
            raise BlobError(
                "cache tree contains a tuple; the blob codec supports "
                "list/dict trees only")
        return index[prefix]
    skel = walk(template, ())
    try:
        json.dumps(skel)
    except TypeError as e:
        raise BlobError(
            f"cache tree contains non-JSON-able containers ({e}); the "
            f"blob codec supports list/dict trees only") from None
    return skel


def encode_session(sess, meta: Optional[Dict[str, Any]] = None) -> bytes:
    """Serialize a resident ``ParkedSession`` (every leaf in host memory,
    none spilled) plus an optional JSON ``meta`` dict."""
    order = sorted(sess.order)          # the JAX package's flatten order
    leaves_meta, payloads = [], []
    for key in order:
        rec = sess.leaves[key]
        if rec.data is None:
            raise BlobError(
                f"leaf {keystr(key)!r} of session {sess.uid} is not "
                f"resident (spilled?); load it before encoding")
        if rec.data.device.type != "cpu":
            raise BlobError(f"leaf {keystr(key)!r} of session {sess.uid} "
                            f"is not in host memory")
        raw = rec.data.contiguous().reshape(-1).view(torch.uint8).numpy()
        leaves_meta.append({
            "key": keystr(key),
            "shape": list(rec.shape),
            "dtype": _NAMES[rec.dtype],
            "stored_shape": list(rec.data.shape),
            "nbytes": int(raw.nbytes),
            "page_len_key": (None if rec.page_len_key is None
                             else keystr(rec.page_len_key)),
        })
        payloads.append(raw)
    header = {
        "uid": sess.uid,
        "skeleton": _skeleton(sess.template,
                              {k: i for i, k in enumerate(order)}),
        "leaves": leaves_meta,
        "meta": meta if meta is not None else {},
    }
    hdr = json.dumps(header, separators=(",", ":")).encode()
    parts = [_HEAD.pack(MAGIC, BLOB_VERSION, len(hdr)), hdr, *payloads]
    crc = 0
    for part in parts:
        crc = zlib.crc32(part, crc)
    return b"".join([*parts, _CRC.pack(crc & 0xFFFFFFFF)])


def decode_session(data: bytes) -> Tuple[object, Dict[str, Any]]:
    """Rebuild a ``ParkedSession`` (host tier, fully resident) and the
    caller ``meta`` dict from a blob either package wrote. Verifies the
    CRC32 before trusting a byte of the payload."""
    from repro_torch.serve.kvstore.store import ParkedSession, _LeafRec

    if len(data) < _HEAD.size + _CRC.size:
        raise BlobError(f"blob truncated: {len(data)} bytes")
    (crc_stored,) = _CRC.unpack_from(data, len(data) - _CRC.size)
    view = memoryview(data)
    if zlib.crc32(view[:-_CRC.size]) & 0xFFFFFFFF != crc_stored:
        raise BlobChecksumError(
            "blob CRC32 mismatch — corrupted in storage or transit")
    magic, version, hdr_len = _HEAD.unpack_from(data, 0)
    if magic != MAGIC:
        raise BlobError(f"bad blob magic {magic!r}")
    if version != BLOB_VERSION:
        raise BlobError(f"unsupported blob version {version} "
                        f"(this codec reads {BLOB_VERSION})")
    off = _HEAD.size
    try:
        header = json.loads(bytes(view[off:off + hdr_len]))
    except ValueError as e:
        raise BlobError(f"unreadable blob header ({e})")
    off += hdr_len
    # each leaf's path comes from the skeleton; the header's key must be
    # that path's keystr
    by_index = {idx: path for path, idx in tree_paths(header["skeleton"])}
    if sorted(by_index) != list(range(len(header["leaves"]))):
        raise BlobError("blob skeleton does not index every leaf once")
    paths = [by_index[i] for i in range(len(by_index))]
    if paths != sorted(paths):
        raise BlobError("blob skeleton leaf order disagrees with "
                        "flatten order")
    by_key = {keystr(p): p for p in paths}
    recs: Dict[Tuple, _LeafRec] = {}
    for path, lm in zip(paths, header["leaves"]):
        if lm["key"] != keystr(path):
            raise BlobError(f"blob leaf key {lm['key']!r} is not its "
                            f"skeleton path {keystr(path)!r}")
        n = int(lm["nbytes"])
        if off + n > len(data) - _CRC.size:
            raise BlobError(f"blob payload truncated at leaf {lm['key']!r}")
        dt = _dtype_from_name(lm["dtype"])
        raw = np.frombuffer(data, np.uint8, count=n, offset=off).copy()
        t = torch.from_numpy(raw).view(dt).reshape(lm["stored_shape"])
        off += n
        rlen = lm["page_len_key"]
        if rlen is not None and rlen not in by_key:
            raise BlobError(f"blob leaf {lm['key']!r} pages against "
                            f"{rlen!r}, which the blob does not hold")
        recs[path] = _LeafRec(tuple(lm["shape"]), dt, t,
                              page_len_key=(None if rlen is None
                                            else by_key[rlen]))
    template = header["skeleton"]
    sess = ParkedSession(uid=int(header["uid"]), template=template,
                         order=[p for p, _ in tree_paths(template)],
                         leaves=recs)
    sess.nbytes = sum(r.data.numel() * r.data.element_size()
                      for r in recs.values())
    return sess, header.get("meta", {})
