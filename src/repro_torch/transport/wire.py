"""Versioned, codec-aware wire schema for the serving ingress (§12): a
copy of the JAX package's ``transport/wire.py`` (numpy only), so frames,
int8 payloads and both digests are byte-identical between the packages.

One frame format for every RPC of the ``AggregatorService`` protocol
(offer / pull / snapshot), over raw TCP and as HTTP bodies alike:

    +--------+----------------+------------+--------------+-----------+
    | b"FW"  | u16 schema_ver | u32 hd_len | header JSON  | blobs ... |
    +--------+----------------+------------+--------------+-----------+

(big-endian integers; on TCP the frame is preceded by a u32 total
length so the reader can recv exactly one frame). The header is UTF-8
JSON — msgpack would shave a few bytes but the container is stdlib-only,
and the tensor payloads dominate anyway:

    {"kind": "offer" | "admission" | "pull" | "model" | "metrics"
             | "error",
     "meta": {...},                      # message-specific JSON
     "tensors": [{"name": ..., "dtype": "float32", "shape": [...],
                  "codec": "f32" | "int8", "nbytes": ...,
                  "qblock": 256}, ...]}  # blob manifest, in blob order

``schema_version`` is stamped on encode and CHECKED on decode — a
mismatched peer fails loudly with ``WireError`` instead of folding
garbage into the aggregate.

Payload codecs (per tensor; non-float32 leaves — labels — always ship
raw):

* ``f32`` — raw little-endian float32 bytes. Bit-exact round-trip: the
  loopback parity gate (served params byte-identical between the
  in-process twin and the socket path) rides on this.
* ``int8`` — per-block affine quantization, ``qblock`` params per block
  (the compressed version store's scheme, DESIGN.md §11, applied to the
  client->server upload direction): blob = int8 codes + per-block f32
  scale + per-block f32 min, ~3.9x fewer bytes than f32 at qblock=256.
  Lossy — used for bandwidth, never under the parity gate.
"""
from __future__ import annotations

import hashlib
import json
import struct
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

SCHEMA_VERSION = 1
MAGIC = b"FW"
WIRE_CODECS = ("f32", "int8")
_HDR = struct.Struct(">2sHI")  # magic, schema_version, header_len
_LEN = struct.Struct(">I")  # TCP frame-length prefix
MAX_FRAME_BYTES = 1 << 30  # refuse absurd lengths before allocating


class WireError(ValueError):
    """Malformed / truncated / wrong-schema frame."""


# -- tensor payload codecs ----------------------------------------------

def _encode_tensor(name: str, arr: np.ndarray, codec: str,
                   qblock: int) -> Tuple[Dict[str, Any], bytes]:
    """(manifest entry, blob bytes) for one tensor."""
    arr = np.ascontiguousarray(arr)
    entry: Dict[str, Any] = {"name": name, "dtype": str(arr.dtype),
                             "shape": list(arr.shape)}
    if codec == "int8" and arr.dtype == np.float32:
        x = arr.ravel()
        n = x.size
        nb = max(1, -(-n // qblock))
        padded = np.zeros(nb * qblock, np.float32)
        padded[:n] = x
        blocks = padded.reshape(nb, qblock)
        mn = blocks.min(axis=1)
        scale = (blocks.max(axis=1) - mn) / 255.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.rint((blocks - mn[:, None]) / scale[:, None]) - 128
        blob = (q.astype(np.int8).tobytes() +
                scale.astype("<f4").tobytes() + mn.astype("<f4").tobytes())
        entry.update(codec="int8", qblock=qblock, nbytes=len(blob))
        return entry, blob
    if codec not in WIRE_CODECS:
        raise WireError(f"unknown wire codec {codec!r} (have {WIRE_CODECS})")
    blob = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    entry.update(codec="f32", nbytes=len(blob))
    return entry, blob


def _decode_tensor(entry: Dict[str, Any], blob: bytes) -> np.ndarray:
    dtype = np.dtype(entry["dtype"])
    shape = tuple(entry["shape"])
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if entry["codec"] == "int8":
        qblock = int(entry["qblock"])
        nb = max(1, -(-n // qblock))
        off = nb * qblock
        if len(blob) != off + 8 * nb:
            raise WireError(f"int8 blob for {entry['name']!r}: "
                            f"{len(blob)} bytes, expected {off + 8 * nb}")
        q = np.frombuffer(blob, np.int8, count=off).astype(np.float32)
        scale = np.frombuffer(blob, "<f4", count=nb, offset=off)
        mn = np.frombuffer(blob, "<f4", count=nb, offset=off + 4 * nb)
        x = (q.reshape(nb, qblock) + 128.0) * scale[:, None] + mn[:, None]
        return x.ravel()[:n].astype(np.float32).reshape(shape)
    if entry["codec"] != "f32":
        raise WireError(f"unknown tensor codec {entry['codec']!r}")
    expect = n * dtype.itemsize
    if len(blob) != expect:
        raise WireError(f"raw blob for {entry['name']!r}: {len(blob)} "
                        f"bytes, expected {expect}")
    return np.frombuffer(blob, dtype.newbyteorder("<")).astype(
        dtype, copy=False).reshape(shape)


# -- frame encode / decode ----------------------------------------------

def encode_message(kind: str, meta: Dict[str, Any],
                   tensors: Optional[Dict[str, np.ndarray]] = None,
                   codec: str = "f32", qblock: int = 256) -> bytes:
    """One complete frame (schema-stamped header + tensor blobs)."""
    manifest: List[Dict[str, Any]] = []
    blobs: List[bytes] = []
    for name in sorted(tensors or ()):
        entry, blob = _encode_tensor(name, tensors[name], codec, qblock)
        manifest.append(entry)
        blobs.append(blob)
    header = json.dumps({"kind": kind, "meta": meta, "tensors": manifest},
                        separators=(",", ":")).encode()
    return b"".join([_HDR.pack(MAGIC, SCHEMA_VERSION, len(header)), header,
                     *blobs])


def decode_message(data: bytes
                   ) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    """Parse one complete frame -> (kind, meta, tensors).

    Raises ``WireError`` on a bad magic, a schema_version mismatch, or a
    truncated / oversized payload."""
    if len(data) < _HDR.size:
        raise WireError(f"frame truncated: {len(data)} bytes")
    magic, version, hd_len = _HDR.unpack_from(data)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (not a wire frame)")
    if version != SCHEMA_VERSION:
        raise WireError(f"schema_version mismatch: peer speaks {version}, "
                        f"this build speaks {SCHEMA_VERSION}")
    off = _HDR.size + hd_len
    if len(data) < off:
        raise WireError("frame truncated inside the header")
    try:
        header = json.loads(data[_HDR.size:off].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"unparseable frame header: {e}") from e
    tensors: Dict[str, np.ndarray] = {}
    for entry in header.get("tensors", ()):
        nbytes = int(entry["nbytes"])
        if len(data) < off + nbytes:
            raise WireError(f"frame truncated inside tensor "
                            f"{entry['name']!r}")
        tensors[entry["name"]] = _decode_tensor(entry,
                                                data[off:off + nbytes])
        off += nbytes
    return header["kind"], header.get("meta", {}), tensors


def write_frame(stream: BinaryIO, frame: bytes) -> None:
    """TCP framing: u32 length prefix + the frame."""
    stream.write(_LEN.pack(len(frame)) + frame)
    stream.flush()


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame"
                                  if buf else "peer closed")
        buf += chunk
    return buf


def read_message(stream: BinaryIO
                 ) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    """Read one length-prefixed frame off a TCP stream and decode it."""
    (total,) = _LEN.unpack(_read_exact(stream, _LEN.size))
    if total > MAX_FRAME_BYTES:
        raise WireError(f"frame length {total} exceeds the "
                        f"{MAX_FRAME_BYTES}-byte cap")
    return decode_message(_read_exact(stream, total))


# -- content digests (the loopback parity gate) -------------------------

def payload_sha256(upload) -> str:
    """Digest of an Upload's tensor content (batch + probe), byte-exact.

    Used by the fold journal: the parity replay reconstructs each folded
    upload from the seeded client datasets and checks the digest before
    folding, so a desynced reconstruction fails loudly instead of
    producing a silently-different aggregate."""
    _, tensors = upload.to_wire()
    h = hashlib.sha256()
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    h.update(str(int(upload.base_version)).encode())
    return h.hexdigest()


def params_sha256(version: int, params: Any) -> str:
    """Digest of a served model: the byte-identity the loopback parity
    acceptance gate compares between the in-process twin and the socket
    path."""
    from repro_torch.core.serving import tree_to_wire

    tensors: Dict[str, np.ndarray] = {}
    tree_to_wire("params", params, tensors)
    h = hashlib.sha256()
    h.update(str(int(version)).encode())
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        h.update(name.encode())
        h.update(arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return h.hexdigest()
