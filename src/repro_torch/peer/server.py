"""BlockServer: serves locally cached blocks to sibling hosts.

One per host. It fronts the host's `CacheIndex` + tier list — the same
hierarchy the host's own engines read through — over the length-prefixed
socket protocol, so a block any local reader prefetched is one LAN hop
away for every sibling.

The ownership contract does the real work: when a sibling asks the
block's *home* host (``owner=True`` fetch) and the block is not resident,
this server performs the one backing-store GET itself, publishes the
block into its local tiers through the index's single-flight machinery,
and returns the bytes. Concurrent owner-fetches of one block — the local
engine plus N siblings — collapse onto one flight and therefore ONE
store GET; that is the cross-host single-flight the peer layer promises
(N hosts reading one dataset issue ~1x remote GETs, not Nx).

A non-owner fetch (``owner=False``) is a pure cache probe: resident →
bytes, absent → miss, never a store GET. `PeerTier` reads use this form,
keeping the tier's advertised LAN cost honest.
"""

from __future__ import annotations

import socket
import threading
import time

from repro_torch.io.integrity import IntegrityError, block_digest, check_block
from repro_torch.io.retry import Retrier, RetryPolicy
from repro_torch.peer.protocol import recv_msg, send_msg, span_block_id
from repro_torch.store.base import ObjectStore, StoreError
from repro_torch.store.tiers import BlockMeta, CacheIndex
from repro_torch.utils import get_logger

log = get_logger("peer.server")

#: Store GETs made on behalf of siblings retry like any other read path
#: (the issue's "peer RPCs reuse `repro_torch.io.retry`"): the owner absorbing
#: a throttle burst beats every sibling independently falling back to the
#: WAN at once.
OWNER_FETCH_RETRY = RetryPolicy(max_retries=2, backoff_s=0.02,
                                backoff_cap_s=0.2)


class BlockServer:
    """Serve the local cache hierarchy to sibling hosts.

    ``store`` must be the RAW backing store (never the host's
    `PeerAwareStore` wrapper — an owner fetch routed back through the
    peer layer would recurse). ``io_class="peer"`` stamps blocks fetched
    on behalf of siblings so the HSM's admission table can treat them as
    scan-resistant remote traffic.
    """

    #: How long a fetch handler waits on another reader's in-flight fetch
    #: before answering anyway. Deliberately below `PeerClient`'s RPC
    #: timeout: the server always responds (fallback GET for an owner
    #: fetch, miss otherwise) rather than letting the client time the
    #: connection out and mark us suspect.
    JOIN_PATIENCE_S = 6.0

    def __init__(
        self,
        index: CacheIndex,
        store: ObjectStore,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        host_id: int = -1,
        io_class: str = "peer",
        retry: RetryPolicy | None = None,
    ) -> None:
        self.index = index
        self.store = store
        self.host_id = host_id
        self.io_class = io_class
        self._retrier = Retrier(retry if retry is not None else OWNER_FETCH_RETRY)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._sock.settimeout(0.2)   # poll the stop flag while accepting
        self.address: tuple[str, int] = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        # Telemetry (merged into FSStats.peer via peer_snapshot()).
        self.requests = 0
        self.hits = 0
        self.misses = 0
        self.ownership_fetches = 0
        self.stores = 0
        self.bytes_served = 0
        self.errors = 0
        self.integrity_failures = 0
        self.owner_fetch_failures = 0   # backing GET failed while leading
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"peer-server-{self.host_id}",
            daemon=True,
        )
        self._accept_thread.start()

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop accepting and drop live connections. Siblings observe
        reset/refused sockets — i.e. `PeerError`s — which their group
        degrades to cache misses; killing a server mid-run is exactly the
        host-death experiment."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=2.0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                requests=self.requests,
                hits=self.hits,
                misses=self.misses,
                ownership_fetches=self.ownership_fetches,
                stores=self.stores,
                bytes_served=self.bytes_served,
                errors=self.errors,
                integrity_failures=self.integrity_failures,
                owner_fetch_failures=self.owner_fetch_failures,
            )

    # -- socket plumbing ----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return   # socket closed
            conn.settimeout(30.0)
            with self._lock:
                self._conns.add(conn)
            # repro: allow[RP006] — one daemon per live connection; close()
            # closes every tracked socket, which unblocks and ends them.
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"peer-conn-{self.host_id}", daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    header, payload = recv_msg(conn)
                except (StoreError, OSError, ValueError):
                    return   # client went away / junk frame: drop the conn
                try:
                    resp, data = self._dispatch(header, payload)
                except Exception as e:   # repro: allow[RP005] — reported to
                    # the client; a handler bug must not kill the conn loop.
                    with self._lock:
                        self.errors += 1
                    log.warning("peer server %d: %s failed: %s",
                                self.host_id, header.get("op"), e)
                    resp, data = {"ok": False, "error": str(e)}, b""
                try:
                    send_msg(conn, resp, data)
                except OSError:
                    return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- request handling ----------------------------------------------------
    def _dispatch(self, header: dict, payload: bytes) -> tuple[dict, bytes]:
        op = header.get("op")
        with self._lock:
            self.requests += 1
        if op == "ping":
            return {"ok": True, "host": self.host_id}, b""
        if op == "fetch":
            status, data, digest = self._fetch_block(
                header["key"], int(header["start"]), int(header["end"]),
                owner_fetch=bool(header.get("owner")),
            )
            with self._lock:
                if status == "miss":
                    self.misses += 1
                else:
                    if status == "hit":
                        self.hits += 1
                    self.bytes_served += len(data)
            resp = {"ok": True, "status": status}
            if digest is not None:
                # Attest the payload in the frame header: the client
                # verifies before trusting or publishing the bytes.
                resp["digest"] = digest
            return resp, data
        if op == "has":
            bid = span_block_id(header["key"], int(header["start"]),
                               int(header["end"]))
            status = "hit" if self.index.contains(bid) else "miss"
            return {"ok": True, "status": status}, b""
        if op == "put":
            status = self._store_pushed(
                header["key"], int(header["start"]), int(header["end"]),
                payload, digest=header.get("digest"),
            )
            return {"ok": True, "status": status}, b""
        return {"ok": False, "error": f"unknown op: {op!r}"}, b""

    def _store_get(self, key: str, start: int, end: int) -> tuple[bytes, str]:
        def attempt() -> tuple[bytes, str]:
            data, digest = self.store.get_range_verified(key, start, end)
            # Verify INSIDE the retried attempt: an in-transit flip of a
            # store response is transient, so the retrier re-fetches it
            # instead of handing siblings attested-but-wrong bytes.
            check_block(data, digest,
                        what=f"peer owner fetch {key}[{start}:{end}]")
            return data, digest

        data, digest = self._retrier.call(
            attempt, label=f"peer owner fetch {key}[{start}:{end}]",
        )
        if len(data) != end - start:
            raise StoreError(
                f"truncated owner fetch for {key}[{start}:{end}]: "
                f"got {len(data)} bytes"
            )
        return data, digest

    def _fetch_block(self, key: str, start: int, end: int,
                     owner_fetch: bool) -> tuple[str, bytes, str | None]:
        """Resolve one block against the local hierarchy.

        hit → serve from the resident tier; leader + owner → the ONE
        backing GET, published locally; leader + non-owner → miss (pure
        probe); wait → bounded join on whoever is fetching (a local
        engine or another sibling's request), then hit or fall through.
        """
        bid = span_block_id(key, start, end)
        deadline = time.monotonic() + self.JOIN_PATIENCE_S
        for _ in range(16):   # liveness guard: never loop unboundedly
            kind, val = self.index.acquire(bid, self.io_class)
            if kind == "hit":
                try:
                    try:
                        data = val.read(bid, 0, None)
                    finally:
                        self.index.unpin(bid)
                except IntegrityError:
                    # The resident copy rotted (self-verifying tier
                    # refused it): quarantine — evict + tombstone — and
                    # re-resolve, never serve it to a sibling.
                    with self._lock:
                        self.integrity_failures += 1
                    self.index.quarantine(bid)
                    continue
                except StoreError:
                    # Tier file vanished beneath the entry (sibling
                    # process eviction): drop it and re-resolve.
                    self.index.invalidate(bid)
                    continue
                return "hit", data, self._attest(bid, data)
            if kind == "leader":
                if not owner_fetch:
                    # Pure cache probe — do NOT become a fetch leader.
                    self.index.abort_fetch(val)
                    return "miss", b"", None
                with self._lock:
                    self.ownership_fetches += 1
                try:
                    data, digest = self._store_get(key, start, end)
                except Exception as e:  # repro: allow[RP005] — counted, flight
                    # aborted (waiters fail over), then re-raised to _dispatch.
                    with self._lock:
                        self.owner_fetch_failures += 1
                    self.index.abort_fetch(val, e)
                    raise
                self._publish(val, bid, key, start, data, digest)
                return "fetched", data, digest
            # kind == "wait": someone (local engine or another sibling's
            # request) is already fetching — join them.
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.index.leave(val)
                if owner_fetch:
                    # Answer rather than time the client out; the stuck
                    # flight is the index's problem (flight TTL).
                    data, digest = self._store_get(key, start, end)
                    return "fetched", data, digest
                return "miss", b"", None
            st, res = self.index.join(val, timeout=min(0.5, remaining))
            if st == "hit":
                try:
                    try:
                        data = res.read(bid, 0, None)
                    finally:
                        self.index.unpin(bid)
                except IntegrityError:
                    with self._lock:
                        self.integrity_failures += 1
                    self.index.quarantine(bid)
                    continue
                except StoreError:
                    self.index.invalidate(bid)
                    continue
                return "hit", data, self._attest(bid, data)
            # "failed" → re-acquire (maybe as the new leader); "timeout"
            # → loop with the remaining patience.
        raise StoreError(f"peer fetch of {bid} did not converge")

    def _attest(self, bid: str, data: bytes) -> str:
        """The digest to stamp on a served block: what the index carries
        (minted at the original store fetch) when known, else computed
        over the bytes we are about to send — so every BLOCK frame is
        attested even for blocks published before digests existed."""
        digest = self.index.digest_of(bid)
        return digest if digest is not None else block_digest(data)

    def _publish(self, flight, bid: str, key: str, start: int,
                 data: bytes, digest: str | None = None) -> None:
        """Publish an owner-fetched block into the local tiers (the
        engines' reserve→write→commit→publish dance). Failure to cache is
        never failure to serve: abort the flight and the caller returns
        the bytes regardless."""
        tier = self.index.reserve_space(len(data), self.io_class)
        if tier is None:
            self.index.abort_fetch(flight)
            return
        try:
            tier.write(bid, data, meta=BlockMeta(key=key, offset=start))
        except Exception:   # repro: allow[RP005] — cache write is best-effort
            tier.cancel(len(data))
            self.index.abort_fetch(flight)
            return
        tier.commit(len(data))
        self.index.publish(flight, tier, len(data), digest=digest)
        # Drop the leader pin; the block stays resident (the peer index
        # runs keep_cached) and evicts only under capacity pressure.
        self.index.unpin(bid)

    def _store_pushed(self, key: str, start: int, end: int,
                      payload: bytes, digest: str | None = None) -> str:
        """A sibling pushed a block at us (HSM demotion into its
        `PeerTier`, homed here). Adopt it through the normal single-flight
        machinery so a racing fetch and a push cannot double-register."""
        if len(payload) != end - start:
            # The header's (start, end) is the block's identity; a
            # payload of any other length is a protocol violation — a
            # lying or buggy sender — not a storable block. Before this
            # check a short push was adopted verbatim and served to every
            # sibling as the real thing.
            with self._lock:
                self.errors += 1
            log.warning(
                "peer server %d: rejected push of %s[%d:%d]: payload is "
                "%d bytes, span is %d", self.host_id, key, start, end,
                len(payload), end - start,
            )
            return "rejected"
        if digest is not None:
            try:
                check_block(payload, digest,
                            what=f"pushed block {key}[{start}:{end}]")
            except IntegrityError:
                # Bytes rotted between the sibling's attestation and our
                # doorstep: refuse, never poison the cache. The sender
                # demotes elsewhere (or drops the block).
                with self._lock:
                    self.integrity_failures += 1
                return "rejected"
        bid = span_block_id(key, start, end)
        kind, val = self.index.acquire(bid, self.io_class)
        if kind == "hit":
            self.index.unpin(bid)
            return "stored"        # already resident
        if kind == "wait":
            self.index.leave(val)  # someone is fetching it right now
            return "stored"
        try:
            tier = self.index.reserve_space(len(payload), self.io_class)
        except Exception:   # repro: allow[RP005] — adoption is best-effort
            # reserve_space can run eviction I/O; if that fails the
            # pushed flight must still be aborted or a racing local
            # fetch waits on it until the TTL.
            self.index.abort_fetch(val)
            return "rejected"
        if tier is None:
            self.index.abort_fetch(val)
            return "rejected"
        try:
            tier.write(bid, payload, meta=BlockMeta(key=key, offset=start))
        except Exception:   # repro: allow[RP005] — adoption is best-effort
            tier.cancel(len(payload))
            self.index.abort_fetch(val)
            return "rejected"
        tier.commit(len(payload))
        self.index.publish(val, tier, len(payload),
                           digest=digest if digest is not None
                           else block_digest(payload))
        self.index.unpin(bid)
        with self._lock:
            self.stores += 1
        return "stored"
