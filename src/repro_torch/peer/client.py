"""PeerClient: one host's RPC endpoint to one sibling's BlockServer.

Pools persistent connections (a socket per concurrent RPC, reused across
requests), retries through the shared `repro_torch.io.retry` machinery
(`PeerError` subclasses `TransientStoreError`, so a flaky LAN hop gets
the same full-jitter backoff as a flaky store), bills every payload to
the peer `LinkModel` — the ONLY place peer bytes are billed, so the LAN
hop is charged exactly once per block — and routes a `FaultSchedule`'s
``peer_*`` ops through the transport for chaos tests (stalls, transient
refusals, mid-transfer cuts).
"""

from __future__ import annotations

import socket
import threading
import time

from repro_torch.io.integrity import IntegrityError, block_digest, check_block
from repro_torch.io.retry import Retrier, RetryPolicy
from repro_torch.peer.protocol import PeerError, recv_msg, send_msg, span_block_id
from repro_torch.store.link import LinkModel

#: Peer RPCs fail fast: the fallback (a direct backing-store GET) is
#: always available, so burning seconds retrying a sick sibling is worse
#: than degrading. One retry absorbs a blip; anything longer marks the
#: peer suspect.
PEER_RETRY = RetryPolicy(max_retries=1, backoff_s=0.01, backoff_cap_s=0.05)


class PeerClient:
    def __init__(
        self,
        address: tuple[str, int],
        *,
        link: LinkModel | None = None,
        retry: RetryPolicy | None = None,
        timeout_s: float = 10.0,
        faults=None,
        peer_id: int = -1,
    ) -> None:
        self.address = (address[0], int(address[1]))
        self.link = link
        self.timeout_s = timeout_s
        self.faults = faults   # FaultSchedule | None (duck-typed: .decide)
        self.peer_id = peer_id
        self._retrier = Retrier(retry if retry is not None else PEER_RETRY)
        self._idle: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        # Telemetry.
        self.rpcs = 0
        self.failures = 0
        self.integrity_failures = 0
        self.bytes_received = 0
        self.bytes_sent = 0

    # -- connection pool ----------------------------------------------------
    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise PeerError(f"peer client {self.peer_id}: closed")
            if self._idle:
                return self._idle.pop()
        try:
            sock = socket.create_connection(self.address,
                                            timeout=self.timeout_s)
        except OSError as e:
            raise PeerError(
                f"peer {self.peer_id} unreachable at "
                f"{self.address[0]}:{self.address[1]}: {e}"
            ) from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed:
                self._idle.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for s in idle:
            try:
                s.close()
            except OSError:
                pass

    # -- fault injection ----------------------------------------------------
    def _inject(self, op: str, key: str) -> set[str]:
        """Apply scheduled transport faults for one attempt. Returns the
        set of *deferred* fault kinds — ``"cut"`` (the attempt completes
        and THEN loses its connection: the bytes crossed the wire, the
        socket did not survive to tell us) and ``"corrupt"`` (a byte of
        the received BLOCK frame payload is flipped in transit — the
        digest carried in the frame header no longer matches)."""
        if self.faults is None:
            return set()
        deferred: set[str] = set()
        for f in self.faults.decide(op, key):
            kind = getattr(f, "kind", None)
            if kind == "stall":
                time.sleep(getattr(f, "stall_s", 0.0))
            elif kind in ("transient", "throttle"):
                with self._lock:
                    self.failures += 1
                raise PeerError(f"{op} {key}: injected peer fault ({kind})")
            elif kind in ("cut", "corrupt"):
                deferred.add(kind)
        return deferred

    # -- RPC core -----------------------------------------------------------
    def _request_once(self, op: str, header: dict,
                      payload: bytes, key: str) -> tuple[dict, bytes]:
        deferred = self._inject(op, key)
        sock = self._checkout()
        try:
            send_msg(sock, header, payload)
            resp, data = recv_msg(sock)
        except (OSError, PeerError) as e:
            with self._lock:
                self.failures += 1
            try:
                sock.close()
            except OSError:
                pass
            if isinstance(e, PeerError):
                raise
            raise PeerError(
                f"peer {self.peer_id}: {op} failed: {e}"
            ) from e
        if "cut" in deferred:
            # The response arrived but the connection is declared dead
            # mid-transfer: drop it and fail the attempt — the retry (or
            # the caller's store fallback) must re-request, and the
            # re-request must observe byte-identical data.
            with self._lock:
                self.failures += 1
            try:
                sock.close()
            except OSError:
                pass
            raise PeerError(f"peer {self.peer_id}: {op} {key}: "
                            "connection cut mid-transfer")
        self._checkin(sock)
        if not resp.get("ok"):
            raise PeerError(
                f"peer {self.peer_id}: {op} {key}: remote error: "
                f"{resp.get('error')}"
            )
        if "corrupt" in deferred and data:
            # In-transit frame corruption: flip one byte of the payload
            # AFTER the frame was received intact — the header (and its
            # digest) survive, the block bytes do not. Detection is the
            # digest check below, exactly as it would be in production.
            buf = bytearray(data)
            buf[self.faults.rand_index(len(buf))] ^= 0xFF
            data = bytes(buf)
        digest = resp.get("digest")
        if digest is not None and data:
            # Verify the payload against the digest the sibling attested
            # in the frame header. A mismatch — bit-flipped in transit or
            # a byzantine peer serving wrong bytes under a correct-length
            # frame — degrades to a failed attempt, never to wrong data.
            try:
                check_block(data, digest, what=f"peer {self.peer_id} {op} {key}")
            except IntegrityError as e:
                with self._lock:
                    self.failures += 1
                    self.integrity_failures += 1
                raise PeerError(str(e)) from e
        with self._lock:
            self.rpcs += 1
            self.bytes_received += len(data)
            self.bytes_sent += len(payload)
        return resp, data

    def _rpc(self, op: str, header: dict, payload: bytes = b"",
             key: str = "") -> tuple[dict, bytes]:
        resp, data = self._retrier.call(
            lambda: self._request_once(op, header, payload, key),
            label=f"peer {self.peer_id} {op} {key}",
        )
        if self.link is not None and (data or payload):
            # Bill the LAN hop exactly once, for the dominant direction.
            self.link.transfer(max(len(data), len(payload)))
        return resp, data

    # -- public ops ---------------------------------------------------------
    def ping(self) -> bool:
        """Single-attempt liveness probe (the heartbeat IS the retry
        loop; wrapping it in another one would just slow down death
        detection). Never raises."""
        try:
            self._inject("peer_ping", "")
            sock = self._checkout()
            try:
                send_msg(sock, {"op": "ping"})
                resp, _ = recv_msg(sock)
            except (OSError, PeerError):
                try:
                    sock.close()
                except OSError:
                    pass
                return False
            self._checkin(sock)
            return bool(resp.get("ok"))
        except PeerError:
            return False

    def fetch(self, key: str, start: int, end: int, *,
              owner: bool = False) -> bytes | None:
        """Fetch block bytes from the sibling. ``owner=True`` authorizes
        the sibling — this block's home host — to perform the one
        backing-store GET on a miss; ``owner=False`` is a pure cache
        probe. Returns None on a miss; raises `PeerError` when the
        sibling is unreachable (after retries)."""
        bid = span_block_id(key, start, end)
        header = {"op": "fetch", "key": key, "start": start, "end": end,
                  "owner": owner}
        resp, data = self._rpc("peer_fetch", header, key=bid)
        if resp.get("status") == "miss":
            return None
        if len(data) != end - start:
            raise PeerError(
                f"peer {self.peer_id}: truncated block {bid}: "
                f"got {len(data)} of {end - start} bytes"
            )
        return data

    def put(self, key: str, start: int, end: int, data: bytes) -> bool:
        """Push a block to the sibling (HSM demotion into a `PeerTier`
        homed there). Returns True when the sibling stored it."""
        bid = span_block_id(key, start, end)
        # Attest what we are pushing: the sibling re-verifies before
        # publishing, so a frame corrupted on the way OVER is rejected
        # there instead of poisoning its cache.
        header = {"op": "put", "key": key, "start": start, "end": end,
                  "digest": block_digest(data)}
        resp, _ = self._rpc("peer_put", header, payload=data, key=bid)
        return resp.get("status") == "stored"

    def has(self, key: str, start: int, end: int) -> bool:
        bid = span_block_id(key, start, end)
        header = {"op": "has", "key": key, "start": start, "end": end}
        resp, _ = self._rpc("peer_has", header, key=bid)
        return resp.get("status") == "hit"

    def snapshot(self) -> dict:
        with self._lock:
            return dict(rpcs=self.rpcs, failures=self.failures,
                        integrity_failures=self.integrity_failures,
                        bytes_received=self.bytes_received,
                        bytes_sent=self.bytes_sent)
