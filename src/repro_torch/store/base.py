"""Object-store protocol.

All remote data in the framework (training shards, `.trk` streamline files,
checkpoints) flows through this interface so that the simulated S3 store,
the real local-directory store, and any future real S3 binding are
interchangeable.

Writes come in two shapes: whole-object ``put`` and a multipart upload
(``start_multipart``) used by the write-behind pipeline in ``repro_torch.io`` —
parts upload concurrently while the producer keeps writing, and
``complete()`` is the atomic publish point.
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass


class StoreError(RuntimeError):
    """Permanent store failure (bad key, malformed range)."""


class TransientStoreError(StoreError):
    """Retryable failure (simulated network fault, dropped connection)."""


class ThrottleError(TransientStoreError):
    """Backend pushback (S3 503 SlowDown): retryable, but the correct
    response is to back off AND shrink concurrency — `repro_torch.io.retry`
    routes this subclass into the AIMD depth controller so the prefetch
    pipeline stops hammering a rate-limited store."""


class IntegrityError(TransientStoreError):
    """Payload bytes do not match their content digest (corrupt store
    response, bit-rotted cache block, mangled peer frame). Transient by
    design: a re-read from the next-more-authoritative source usually
    heals it, so the `Retrier` retries these like any network fault —
    but exhaustion re-raises *as* `IntegrityError` (not bare
    `StoreError`), so callers can distinguish "the data itself is bad
    everywhere" from ordinary unavailability."""


@dataclass(frozen=True)
class ObjectMeta:
    key: str
    size: int


def adjacent_runs(
    spans: list[tuple[int, int]],
) -> list[list[tuple[int, int]]]:
    """Group spans into maximal runs where each span starts exactly where
    the previous one ended — the unit a coalescing store can serve with a
    single request. Order is preserved; non-adjacent neighbours break the
    run."""
    runs: list[list[tuple[int, int]]] = []
    for span in spans:
        if runs and runs[-1][-1][1] == span[0]:
            runs[-1].append(span)
        else:
            runs.append([span])
    return runs


class MultipartUpload:
    """Portable client-buffered multipart upload.

    Parts accumulate in memory (``put_part`` is thread-safe and accepts
    parts in any order) and publish atomically with a single ``put()`` at
    ``complete()`` — correct for any store, no overlap benefit. Stores
    with a cheaper native path (the simulated S3's server-side assembly,
    the directory store's part files) override the ``_charge_part`` /
    ``_publish`` hooks or the methods themselves via
    :meth:`ObjectStore.start_multipart`.
    """

    def __init__(self, store: "ObjectStore", key: str) -> None:
        self.store = store
        self.key = key
        self._parts: dict[int, bytes] = {}
        self._lock = threading.Lock()
        self._aborted = False

    def put_part(self, index: int, data: bytes) -> None:
        """Upload part `index` (0-based). Re-putting the same index is
        idempotent (last write wins), which makes hedged uploads safe."""
        if index < 0:
            raise StoreError(f"multipart {self.key!r}: bad part index {index}")
        self._charge_part(data)
        with self._lock:
            if self._aborted:
                raise StoreError(f"multipart {self.key!r}: upload aborted")
            # Immutable input needs no defensive copy; only bytearray /
            # memoryview parts (mutable after return) are snapshotted.
            self._parts[index] = data if type(data) is bytes else bytes(data)

    def complete(self) -> None:
        """Assemble parts 0..n-1 and publish the object atomically. Safe
        to retry after a transient publish failure."""
        with self._lock:
            if self._aborted:
                raise StoreError(f"multipart {self.key!r}: upload aborted")
            parts = dict(self._parts)
        indexes = sorted(parts)
        if indexes != list(range(len(indexes))):
            raise StoreError(
                f"multipart {self.key!r}: non-contiguous parts {indexes}"
            )
        self._publish(b"".join(parts[i] for i in indexes))

    def abort(self) -> None:
        """Drop staged parts; the object is never published."""
        with self._lock:
            self._aborted = True
            self._parts.clear()

    # -- backend hooks -----------------------------------------------------
    def _charge_part(self, data: bytes) -> None:
        """Pay the transfer cost of one part at upload time (default: the
        cost is deferred to the final put in `_publish`)."""

    def _publish(self, data: bytes) -> None:
        self.store.put(self.key, data)


class ObjectStore(abc.ABC):
    """Byte-range addressable object store."""

    @abc.abstractmethod
    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        ...

    @abc.abstractmethod
    def size(self, key: str) -> int:
        ...

    @abc.abstractmethod
    def get_range(self, key: str, start: int, end: int) -> bytes:
        """Fetch bytes [start, end) of `key`. One call == one request
        (pays one latency)."""

    def get_ranges(
        self, key: str, spans: list[tuple[int, int]]
    ) -> list[bytes]:
        """Vectorized range fetch: bytes for each [start, end) span of
        `key`, in span order.

        The portable fallback issues one request per span. Stores with a
        cheaper native path override it: the simulated S3 coalesces runs
        of adjacent spans into one request (one latency for the whole
        run), the directory store serves every span from a single file
        open. Adjacent spans SHOULD therefore be passed in stream order —
        that is what the prefetch scheduler's coalesced GETs do.
        """
        return [self.get_range(key, start, end) for start, end in spans]

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None:
        ...

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        ...

    def get(self, key: str) -> bytes:
        """Fetch the whole object. The portable fallback pays two
        round-trips (HEAD for the size, then the ranged GET); concrete
        stores override it to serve whole-object gets in one request."""
        return self.get_range(key, 0, self.size(key))

    # -- verified reads ----------------------------------------------------
    # The integrity layer's store edge. A *verified* read returns
    # ``(payload, digest)`` where the digest describes the bytes the
    # store believes it holds — the authoritative reference the engines
    # check received bytes against and carry through the cache tiers,
    # the peer wire protocol, and checkpoint manifests. The defaults
    # hash the returned payload, which is exact for leaf stores (their
    # ``get_range`` IS the authority); wrapper stores that can corrupt
    # or substitute bytes in transit (`FaultyStore`, `PeerAwareStore`)
    # override these so the digest is computed from the authoritative
    # inner bytes BEFORE any mangling — modeling S3's GetObject
    # checksum mode, where the server attests what it sent.

    def get_range_verified(self, key: str, start: int,
                           end: int) -> tuple[bytes, str]:
        """Fetch bytes [start, end) plus the store-attested content
        digest (see `repro_torch.io.integrity.block_digest`)."""
        from repro_torch.io.integrity import block_digest

        data = self.get_range(key, start, end)
        return data, block_digest(data)

    def get_ranges_verified(
        self, key: str, spans: list[tuple[int, int]]
    ) -> list[tuple[bytes, str]]:
        """Vectorized :meth:`get_range_verified` (coalescing stores keep
        their one-request-per-run behaviour via `get_ranges`)."""
        from repro_torch.io.integrity import block_digest

        return [(d, block_digest(d)) for d in self.get_ranges(key, spans)]

    def digest_range(self, key: str, start: int, end: int) -> str:
        """Digest of bytes [start, end) without returning them — the
        authoritative cross-check `verify="full"` uses against
        peer-served payloads. The portable fallback reads the range
        (paying its full cost); stores with a cheap checksum RPC
        override it."""
        from repro_torch.io.integrity import block_digest

        return block_digest(self.get_range(key, start, end))

    def start_multipart(self, key: str) -> MultipartUpload:
        """Begin a multipart upload of `key`; see `MultipartUpload`."""
        return MultipartUpload(self, key)

    def exists(self, key: str) -> bool:
        try:
            self.size(key)
            return True
        except TransientStoreError:
            # A throttled/faulting store does NOT mean the object is
            # missing — propagate so callers can retry.
            raise
        except StoreError:
            return False
