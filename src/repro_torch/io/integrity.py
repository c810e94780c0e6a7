"""Per-block content digests: mint once, verify at every boundary.

The chaos harness long conceded that corruption was "delivered, not
detected": engines length-check but never checksum, so a flipped byte
from the store, a bit-rotted block in a persistent `DirTier`, or a
byzantine peer frame reached the application silently. This module is
the one place digests are defined; every path that moves block bytes —
store fetch, cache-tier read, HSM promotion/demotion, the peer wire
protocol, checkpoint manifests — carries the string this module mints
and calls :func:`check_block` at its boundary.

A digest is a short self-describing string, ``"<algo>:<hex>"``:

  * ``crc32:%08x`` — `zlib.crc32`, the default. Fast enough to sit on
    the hot read path (the "edges" verify mode is benchmarked at <5%
    read-throughput overhead) and *identical* to the crc the `DirTier`
    journal already records, so a journal record and an index digest
    are interchangeable (`crc_digest` converts).
  * ``blake2:<32 hex>`` — `hashlib.blake2b` (16-byte digest) for
    callers that want collision resistance over speed (checkpoint
    manifests default to crc32 too; flip `algo=` to harden).

On mismatch the caller raises (or lets :func:`check_block` raise)
`IntegrityError` — a `TransientStoreError` subclass, so the shared
`Retrier` re-fetches from the next-more-authoritative source instead
of surfacing wrong bytes; see `repro_torch.io.retry` for the typed
exhaustion contract.
"""

from __future__ import annotations

import hashlib
import zlib

from repro_torch.store.base import IntegrityError

__all__ = [
    "DIGEST_ALGOS",
    "IntegrityError",
    "block_digest",
    "check_block",
    "crc_digest",
    "digest_matches",
]

DIGEST_ALGOS = ("crc32", "blake2")

DEFAULT_ALGO = "crc32"


def block_digest(data: bytes, algo: str = DEFAULT_ALGO) -> str:
    """Content digest of a block payload, as ``"<algo>:<hex>"``."""
    if algo == "crc32":
        return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"
    if algo == "blake2":
        return f"blake2:{hashlib.blake2b(data, digest_size=16).hexdigest()}"
    raise ValueError(f"unknown digest algo {algo!r} (want one of {DIGEST_ALGOS})")


def crc_digest(crc: int) -> str:
    """Canonical digest string for a raw crc32 value — the bridge from
    `DirTier` journal records (which store the bare int) to the digest
    strings everything else carries."""
    return f"crc32:{crc & 0xFFFFFFFF:08x}"


def digest_matches(data: bytes, digest: str) -> bool:
    """Recompute ``digest``'s algorithm over ``data`` and compare. An
    unparseable digest never matches (fail closed)."""
    algo, _, _ = digest.partition(":")
    if algo not in DIGEST_ALGOS:
        return False
    return block_digest(data, algo) == digest


def check_block(data: bytes, digest: str | None, *,
                what: str = "block") -> None:
    """Raise `IntegrityError` when ``data`` does not match ``digest``.
    A ``None`` digest is a no-op — callers pass through whatever the
    index/journal/wire knows, which may be nothing (verify="off"
    producers, pre-digest journals)."""
    if digest is None:
        return
    if not digest_matches(data, digest):
        algo = digest.partition(":")[0]
        got = (block_digest(data, algo) if algo in DIGEST_ALGOS
               else "<unparseable reference>")
        raise IntegrityError(
            f"digest mismatch for {what}: expected {digest}, got {got} "
            f"over {len(data)} bytes"
        )
