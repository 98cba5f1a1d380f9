"""Length-prefixed framing for the router <-> replica-worker RPC pipe.

Copy of ``repro/serving/fleet/protocol.py`` (framework-free).

A frame is a 4-byte big-endian length followed by a pickled payload. The
router sends request frames ``{"id": n, "ops": [op, ...]}`` (each op a dict
with an ``"op"`` kind plus operands); the worker answers with one response
frame ``{"id": n, "results": [r, ...]}`` aligned 1:1 with the ops, each
result ``{"ok": True, "value": ...}`` or ``{"ok": False, "error": str,
"cls": str}``. Batching many ops per frame is the wire-level analogue of
the server's deadline batching: a burst the router coalesced crosses the
pipe in one syscall and lands in the worker's scheduler together.

Pickle is safe here because both endpoints are the same codebase talking
over a private pipe the router itself spawned — this is an intra-fleet
protocol, not a public network surface.
"""
from __future__ import annotations

import pickle
import struct
from typing import Any, BinaryIO

_HEADER = struct.Struct(">I")
# A frame carries at most a batched op list with a few numpy token arrays —
# anything bigger is a framing bug (e.g. a stray print corrupting the pipe),
# better surfaced as a protocol error than as an absurd allocation.
MAX_FRAME = 256 * 1024 * 1024


class ProtocolError(RuntimeError):
    """The pipe closed mid-frame or carried a malformed frame."""


def send_msg(fp: BinaryIO, payload: Any) -> None:
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    if len(blob) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(blob)} bytes exceeds MAX_FRAME")
    fp.write(_HEADER.pack(len(blob)) + blob)
    fp.flush()


def _read_exact(fp: BinaryIO, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = fp.read(n - got)
        if not chunk:
            raise EOFError(f"pipe closed after {got}/{n} frame bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(fp: BinaryIO) -> Any:
    """Read one frame; raises ``EOFError`` on a closed pipe (the router's
    replica-death signal) and ``ProtocolError`` on garbage."""
    header = fp.read(_HEADER.size)
    if not header:
        raise EOFError("pipe closed")
    if len(header) < _HEADER.size:
        raise EOFError("pipe closed mid-header")
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME:
        raise ProtocolError(f"frame header claims {length} bytes")
    try:
        return pickle.loads(_read_exact(fp, length))
    except EOFError:
        raise
    except Exception as exc:  # corrupt pickle = corrupt pipe
        raise ProtocolError(f"undecodable frame: {exc}") from exc
