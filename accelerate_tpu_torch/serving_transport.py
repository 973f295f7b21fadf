"""Framed socket transport for the multi-process serving fleet.

Counterpart of :mod:`accelerate_tpu.serving_transport`, the frame kept
byte for byte. The process supervisor
(:mod:`accelerate_tpu_torch.serving_proc`) talks to its engine workers
over one localhost TCP connection per worker. Every message is ONE
length-prefixed frame: a fixed 16-byte header (``>2sBBIII``: magic,
version, reserved flags, JSON bytes, blob bytes, crc32 of JSON + blob), a
compact JSON control part, and an optional raw binary part. The binary
part is a :class:`~accelerate_tpu_torch.serving_fleet.HandoffCodec` blob
(prefill handoffs) or the failover-snapshot bundle of
:func:`encode_snapshots`: each row leaf as raw bytes with its shape and
dtype name (bf16 included: numpy has no bfloat16, so a leaf never passes
through a numpy dtype), the request's sampling state (``gen_state``, a
``torch.Generator``'s state as bytes) and its trace id.

Failure is structured, never a hang: a short read at EOF (the worker died
mid-frame) raises :class:`PeerClosedError` with the byte position; a bad
magic, version or crc32, or an oversized declared length raises
:class:`FrameError` BEFORE any allocation for the body; socket timeouts
propagate as ``socket.timeout`` for the supervisor's degraded /
quarantined escalation. ``recv_exact`` loops over partial reads, so TCP
segmentation is invisible to the protocol layer.

Concurrency: every function here is a plain blocking socket call, so a
caller must never hold a lock across one. The worker is single-threaded;
the supervisor confines all transport IO to its pump loop.
"""

from __future__ import annotations

import io
import json
import socket
import struct
import zlib

import numpy as np
import torch

#: frame header: magic, version, reserved flags, json bytes, blob bytes,
#: crc32(json + blob)
_HEADER = struct.Struct(">2sBBIII")
MAGIC = b"AT"
VERSION = 1

#: refuse frames larger than this before reading the body (a corrupt
#: length field must not allocate gigabytes or desync into a hang)
MAX_FRAME_BYTES = 256 << 20

#: a snapshot's row leaves, in wire order (the handoff codec's)
ROW_LEAVES = ("key", "value", "index")


class TransportError(RuntimeError):
    """Base class for structured transport failures."""


class FrameError(TransportError):
    """The byte stream is not a valid frame (bad magic/version, crc32
    mismatch, oversized declared length, or undecodable JSON). The
    connection is unrecoverable: close it and treat the peer as dead."""


class PeerClosedError(TransportError):
    """EOF before a complete frame: the peer process died (or closed)
    mid-message. Carries how far the read got."""

    def __init__(self, msg: str, got: int = 0, want: int = 0):
        super().__init__(msg)
        self.got = int(got)
        self.want = int(want)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes, looping over partial reads. EOF
    mid-read raises :class:`PeerClosedError` (worker death mid-frame);
    a socket timeout propagates unchanged."""
    if n == 0:
        return b""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise PeerClosedError(f"peer closed after {got}/{n} bytes of a frame", got=got, want=n)
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock: socket.socket, obj: dict, blob: bytes = b"", *, max_frame: int = MAX_FRAME_BYTES) -> int:
    """Send one frame (``obj`` as compact JSON + optional binary
    ``blob``). Returns the total bytes written; ``sendall`` loops over
    short writes."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) + len(blob) > max_frame:
        raise FrameError(f"frame of {len(payload) + len(blob)} bytes exceeds the {max_frame}-byte transport cap")
    crc = zlib.crc32(blob, zlib.crc32(payload))
    header = _HEADER.pack(MAGIC, VERSION, 0, len(payload), len(blob), crc)
    sock.sendall(header + payload + blob)
    return len(header) + len(payload) + len(blob)


def recv_msg(sock: socket.socket, *, max_frame: int = MAX_FRAME_BYTES):
    """Receive one frame; ``(obj, blob)``. Raises :class:`FrameError`
    on a corrupt/oversized frame, :class:`PeerClosedError` on EOF
    mid-frame, and lets ``socket.timeout`` propagate."""
    header = recv_exact(sock, _HEADER.size)
    magic, version, _flags, jlen, blen, crc = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    if version != VERSION:
        raise FrameError(f"unsupported transport version {version} (speak {VERSION})")
    if jlen + blen > max_frame:
        raise FrameError(f"declared frame of {jlen + blen} bytes exceeds the {max_frame}-byte transport cap")
    payload = recv_exact(sock, jlen)
    blob = recv_exact(sock, blen)
    if zlib.crc32(blob, zlib.crc32(payload)) != crc:
        raise FrameError("frame crc32 mismatch: payload corrupt in transit")
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"frame JSON undecodable: {e}") from None
    return obj, blob


def request(sock: socket.socket, obj: dict, blob: bytes = b"", *, timeout=None, max_frame: int = MAX_FRAME_BYTES):
    """One strict request/response round trip (the supervisor side).
    ``timeout`` covers both legs; a reply carrying ``{"err": ...}``
    raises :class:`WorkerError` with the worker's structured detail."""
    sock.settimeout(timeout)
    send_msg(sock, obj, blob, max_frame=max_frame)
    reply, rblob = recv_msg(sock, max_frame=max_frame)
    if isinstance(reply, dict) and reply.get("err") is not None:
        raise WorkerError(reply["err"])
    return reply, rblob


class WorkerError(TransportError):
    """The worker replied with a structured error (``{"err": {...}}``):
    the request failed application-side (bad uid, import rejected, a
    poison trip) but the worker and the connection are still alive."""

    def __init__(self, err):
        detail = err if isinstance(err, dict) else {"detail": str(err)}
        super().__init__(detail.get("detail") or str(detail))
        self.kind = detail.get("kind", "error")
        self.detail = detail


# --------------------------------------------------------------------- #
# failover-snapshot bundle codec
# --------------------------------------------------------------------- #
# ``ServingEngine.export_inflight`` snapshots cross the process boundary
# in one npz bundle: per-snapshot namespaced arrays, each row leaf as raw
# uint8 bytes with its shape and dtype name, as HandoffCodec carries them.
# The importing engine's row template (``row_template``) is checked
# against what arrives. The JSON half of the frame carries
# ``snapshot_meta``, so the supervisor routes, prices and accounts each
# snapshot without decoding the blob.


def _rows_nbytes(rows: dict) -> int:
    return int(sum(t.numel() * t.element_size() for t in rows.values()))


def snapshot_meta(snaps: list) -> list:
    """Supervisor-visible metadata for each snapshot: identity, progress,
    and the KV payload size actually serialized (``kv_bytes``, the sum of
    the row tensors' bytes, is what the priced failover pins against the
    ``rows * bytes_per_token + fixed`` prediction)."""
    meta = []
    for s in snaps:
        kv_bytes = _rows_nbytes(s["cache"]) if s.get("cache") is not None else 0
        meta.append(
            {
                "uid": int(s["uid"]),
                "prompt_len": int(np.asarray(s["prompt"]).size),
                "generated": len(s.get("out_tokens") or []),
                "max_new_tokens": int(s["max_new_tokens"]),
                "priority": int(s.get("priority", 0)),
                "rows": int(s.get("rows") or 0),
                "has_kv": s.get("cache") is not None,
                "kv_bytes": int(kv_bytes),
                "trace": s.get("trace"),
            }
        )
    return meta


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def row_template(engine) -> tuple:
    """``((leaf name, dtype name), ...)`` of the rows ``engine`` exports
    and imports: K and V in the model's dtype, the per-layer write index
    int32 (``KVCache.host_rows``)."""
    kv = _dtype_name(engine.model.dtype)
    return tuple(zip(ROW_LEAVES, (kv, kv, "int32")))


def encode_snapshots(snaps: list) -> tuple:
    """``(meta, blob)`` for a list of ``export_inflight`` snapshots. Row
    tensors leave the card before their bytes are taken."""
    arrays = {}
    for i, s in enumerate(snaps):
        p = f"s{i}_"
        arrays[p + "prompt"] = np.asarray(s["prompt"], np.int32)
        arrays[p + "gen_state"] = np.asarray(s.get("gen_state", np.zeros((0,), np.uint8)), np.uint8)
        arrays[p + "out"] = np.asarray(s.get("out_tokens") or [], np.int64)
        arrays[p + "lps"] = np.asarray(s.get("out_lps") or [], np.float64)
        stops = s.get("stop_sequences") or ()
        arrays[p + "stop_flat"] = np.asarray([t for seq in stops for t in seq], np.int64)
        arrays[p + "stop_lens"] = np.asarray([len(seq) for seq in stops], np.int64)
        rows = s.get("cache")
        leaves = [rows[name] for name in ROW_LEAVES] if rows is not None else []
        arrays[p + "imeta"] = np.asarray(
            [
                int(s["uid"]),
                int(s["max_new_tokens"]),
                int(s.get("priority", 0)),
                int(s.get("rows") or 0),
                len(leaves),
                -1 if s.get("trace") is None else int(s["trace"]),
            ],
            np.int64,
        )
        for j, leaf in enumerate(leaves):
            leaf = leaf.detach().cpu().contiguous()
            arrays[p + f"leaf_{j}"] = leaf.reshape(-1).view(torch.uint8).numpy()
            arrays[p + f"shape_{j}"] = np.asarray(leaf.shape, np.int64)
            arrays[p + f"dtype_{j}"] = np.asarray(_dtype_name(leaf.dtype))
    arrays["count"] = np.asarray([len(snaps)], np.int64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return snapshot_meta(snaps), buf.getvalue()


def decode_snapshots(blob: bytes, engine) -> list:
    """Rebuild the snapshot dicts (rows as host tensors) against
    ``engine``'s row template; each result feeds
    ``engine.import_inflight`` unchanged."""
    template = row_template(engine)
    snaps = []
    with np.load(io.BytesIO(blob)) as z:
        count = int(z["count"][0])
        for i in range(count):
            p = f"s{i}_"
            uid, max_new, priority, rows, n_leaves, trace = (int(v) for v in z[p + "imeta"])
            stops, flat = [], [int(t) for t in z[p + "stop_flat"]]
            for ln in z[p + "stop_lens"]:
                stops.append(tuple(flat[: int(ln)]))
                flat = flat[int(ln):]
            snap = {
                "uid": uid,
                "prompt": np.asarray(z[p + "prompt"], np.int32),
                "max_new_tokens": max_new,
                "out_tokens": [int(t) for t in z[p + "out"]],
                "out_lps": [float(v) for v in z[p + "lps"]],
                "stop_sequences": tuple(stops),
                "priority": priority,
                "trace": None if trace < 0 else trace,
                "gen_state": np.asarray(z[p + "gen_state"], np.uint8),
            }
            if n_leaves:
                if n_leaves != len(template):
                    raise ValueError(
                        f"snapshot has {n_leaves} KV leaves; this engine's row template has {len(template)}: "
                        "engines disagree on the row cache"
                    )
                cache = {}
                for j, (name, dtype) in enumerate(template):
                    got = str(z[p + f"dtype_{j}"])
                    if got != dtype:
                        raise ValueError(f"snapshot {name} rows are {got}; this engine's row template holds {dtype}")
                    shape = tuple(int(d) for d in z[p + f"shape_{j}"])
                    raw = bytearray(z[p + f"leaf_{j}"].tobytes())
                    tdtype = getattr(torch, dtype)
                    cache[name] = (torch.frombuffer(raw, dtype=tdtype).reshape(shape) if raw
                                   else torch.zeros(shape, dtype=tdtype))
                snap["cache"] = cache
                snap["rows"] = rows
            snaps.append(snap)
    return snaps
