"""Framed binary wire protocol for the cache daemon.

Frames are length-prefixed pickles over a stream socket — the network
promotion of the process driver's worker-pipe protocol, message shapes included:

* request:  ``(op, frees, payload)`` — ``frees`` is the piggybacked
  list of ``(offset, length)`` arena slots the client has finished
  reading (same slot-recycling trick as the process driver: a free
  never needs its own round trip);
* reply:    ``("ok", result)`` or ``("err", exc)``.

Read replies carry outcomes in the shared compact codec
(``core.wire.encode_outcome`` / ``WireOutcome``) plus one payload
descriptor per request: ``("shm", offset, length)`` when the bytes sit
in the daemon's shared-memory arena (same-node clients), or
``("raw", bytes)`` streamed inline (remote clients / arena spills).

The framing itself is deliberately dumb: a 4-byte big-endian length
then the pickle.  Protocol agreement is checked once at ``hello`` time
(``PROTO_VERSION``), and a frame larger than ``MAX_FRAME`` is treated
as a protocol violation rather than an allocation request.
"""
from __future__ import annotations

import pickle
import struct

__all__ = ["ConnectionClosed", "MAX_FRAME", "PROTO_VERSION",
           "ProtocolError", "recv_msg", "send_msg"]

PROTO_VERSION = 1
_HEADER = struct.Struct("!I")
MAX_FRAME = 512 * 1024 * 1024


class ConnectionClosed(ConnectionError):
    """Peer went away (EOF mid-frame or before one started)."""


class ProtocolError(RuntimeError):
    """Frame that cannot be ours (oversized length prefix)."""


def send_msg(sock, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    # one sendall: header+payload coalesced so small commands are one
    # segment on the wire
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_msg(sock):
    (n,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if n > MAX_FRAME:
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME")
    return pickle.loads(_recv_exact(sock, n))
