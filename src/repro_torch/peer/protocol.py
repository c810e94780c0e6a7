"""Length-prefixed peer wire protocol.

One frame = an 8-byte big-endian prefix (header length, payload length),
a JSON header, and a raw payload::

    >II | {"op": "fetch", "key": ..., "start": ..., "end": ...} | <bytes>

JSON headers keep the protocol debuggable and versionable; block payloads
ride outside the JSON so a block transfer is one memcpy, not a base64
round-trip. Requests and responses share the framing; a response header
carries ``ok`` plus a ``status`` ("hit" / "fetched" / "miss" / "stored"
/ "rejected") and the payload when there is one.

Block identity on the wire is (key, start, end) — the same triple
`repro_torch.core.plan.Block.block_id` content-addresses blocks with — so any
two hosts running the same blocksize policy name the same stored bytes
identically with no coordination.
"""

from __future__ import annotations

import json
import socket
import struct

from repro_torch.store.base import TransientStoreError

# Header-length, payload-length prefix.
_PREFIX = struct.Struct(">II")

# A frame a sibling could not possibly send: cap both lengths so a
# corrupt / non-protocol peer cannot make us allocate unbounded buffers.
MAX_HEADER = 1 << 20
MAX_PAYLOAD = 1 << 31

#: FaultSchedule operation names for the peer transport, the analogue of
#: `repro_torch.store.faults.READ_OPS` for peer RPCs — route a schedule's
#: stall/transient/cut/throttle rules through these to chaos-test the
#: peer path.
PEER_OPS = ("peer_fetch", "peer_put", "peer_has", "peer_ping")


class PeerError(TransientStoreError):
    """A peer RPC failed (connection refused/reset, timeout, protocol
    violation, remote error). Transient by construction: the peer layer
    is a cache, so every `PeerError` degrades to a cache miss — the
    caller falls back to the backing store, never surfaces the error."""


def span_block_id(key: str, start: int, end: int) -> str:
    """The content-addressed block id for bytes [start, end) of `key` —
    must match `repro_torch.core.plan.Block.block_id` byte for byte."""
    return f"{key}@{start:015d}-{end:015d}"


def parse_block_id(block_id: str) -> tuple[str, int, int]:
    """Inverse of :func:`span_block_id` (keys may contain ``@``; the
    final one delimits the range suffix)."""
    key, _, span = block_id.rpartition("@")
    if not key:
        raise ValueError(f"not a block id: {block_id!r}")
    lo, _, hi = span.partition("-")
    return key, int(lo), int(hi)


def send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    # Every frame with a payload declares its length INSIDE the header
    # too. The binary prefix frames the read; the header's "len" is the
    # sender's claim about the block itself, and `recv_msg` rejects any
    # frame where the two disagree — a short write, a truncating proxy,
    # or a raw-socket peer lying about its payload would otherwise
    # deliver a wrong-sized block that only fails much later (or never).
    if payload:
        header = dict(header, len=len(payload))
    raw = json.dumps(header, separators=(",", ":")).encode()
    # One sendall: the prefix, header, and payload leave as a single
    # buffer so a thread switch cannot interleave frames on a shared
    # socket (callers still serialize per-socket for responses).
    sock.sendall(_PREFIX.pack(len(raw), len(payload)) + raw + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise PeerError("peer connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    hlen, plen = _PREFIX.unpack(recv_exact(sock, _PREFIX.size))
    if hlen > MAX_HEADER or plen > MAX_PAYLOAD:
        raise PeerError(
            f"peer frame too large (header {hlen}, payload {plen})"
        )
    header = json.loads(recv_exact(sock, hlen))
    payload = recv_exact(sock, plen) if plen else b""
    declared = header.get("len")
    if declared is not None and declared != len(payload):
        # The prefix framed `plen` bytes but the header promised
        # `declared`: a protocol violation, not a miss. Refuse the frame
        # — the bytes cannot be trusted to be the block they claim.
        raise PeerError(
            f"peer frame length mismatch: header declares {declared} "
            f"payload bytes, received {len(payload)}"
        )
    return header, payload
