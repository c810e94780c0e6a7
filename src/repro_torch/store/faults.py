"""Seeded, deterministic chaos injection for any `ObjectStore`.

The resilience layer (`repro_torch.io.retry`) is only trustworthy if the
failure modes it claims to survive can be *simulated*: throttling (503
SlowDown), stalls, truncated range responses, corrupt payloads, and
mid-transfer connection cuts. `FaultyStore` wraps any store and injects
those faults according to a `FaultSchedule` — a small scripting DSL whose
decisions are a pure function of (seed, request order), so a chaos test
that fails replays identically.

    sched = (FaultSchedule(seed=7)
             .throttle(ops=READ_OPS, prob=0.2)      # 503 on ~20% of GETs
             .stall(0.05, every=10)                 # every 10th op lags 50 ms
             .truncate(nbytes=128, times=2)         # two short responses
             .cut(after_bytes=4096, every=13)       # mid-object drops
             .transient(key="shard_0003", times=1)) # one targeted fault
    store = FaultyStore(SimS3Store(...), sched)

Cost honesty: a ``cut`` fetches the first ``after_bytes`` from the inner
store *for real* before raising — on a simulated S3 that pays one request
latency plus partial bandwidth, exactly what a dropped connection costs.
``throttle``/``transient`` raise without touching the inner store; pair
`FaultyStore` with a `LinkModel` rps limit when the raising request
itself should pay a round trip.

Corruption is detected AND healed since the integrity layer
(`repro_torch.io.integrity`) landed: the verified-read path
(:meth:`FaultyStore.get_range_verified` and friends) takes the
store-attested digest from the INNER store while payload shaping mangles
only the returned bytes — so a fired ``corrupt``/``truncate`` is exactly
the detectable wire-mangling S3's GetObject checksum mode catches, and
engines running ``IOPolicy(verify="edges")`` re-fetch through the shared
`Retrier` instead of delivering flipped bytes to the application. Only
the unverified legacy path (``verify="off"``) still delivers corruption
silently. ``flip_at_rest`` extends chaos to resident cache blocks: a
`DirTier` constructed with ``faults=schedule`` mutates the on-disk block
file between write and read, exercising the journal-crc steady-state
check.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from repro_torch.store.base import (
    MultipartUpload,
    ObjectMeta,
    ObjectStore,
    StoreError,
    ThrottleError,
    TransientStoreError,
)

READ_OPS = ("get_range", "get_ranges", "get")
WRITE_OPS = ("put", "put_part", "complete")
META_OPS = ("size", "list_objects", "delete")
ALL_OPS = READ_OPS + WRITE_OPS + META_OPS

# Faults that replace the normal raise/serve flow of a request.
# ``flip_at_rest`` is special: it fires on the pseudo-op "at_rest" that
# a `DirTier` consults on reads, mutating a RESIDENT block file rather
# than a wire payload.
_KINDS = ("throttle", "transient", "stall", "truncate", "corrupt", "cut",
          "flip_at_rest")


@dataclass
class FaultRule:
    """One line of a `FaultSchedule` script. Matching is by operation
    name and (optional) key substring; firing is either probabilistic
    (``prob``, drawn from the schedule's seeded rng) or deterministic
    (``every`` Nth matching request). ``after`` skips the first N
    matches, ``times`` caps total firings."""

    kind: str
    ops: tuple[str, ...]
    prob: float = 1.0
    key: str | None = None
    times: int | None = None
    after: int = 0
    every: int | None = None
    stall_s: float = 0.0
    nbytes: int = 1
    # Mutable bookkeeping (under the schedule's lock).
    seen: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {self.nbytes}")


class FaultSchedule:
    """Ordered fault rules plus the seeded rng that arbitrates them.

    Builder methods append a rule and return ``self`` for chaining; each
    takes the common matching knobs (``ops``, ``key``, ``prob``,
    ``times``, ``after``, ``every``). When ``every`` is given the rule is
    fully deterministic and ``prob`` is ignored.
    """

    def __init__(self, seed: int = 0) -> None:
        self.rules: list[FaultRule] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    # -- builder ----------------------------------------------------------
    def _add(self, kind: str, ops, key, prob, times, after, every,
             **extra) -> "FaultSchedule":
        if isinstance(ops, str):
            ops = (ops,)
        self.rules.append(FaultRule(
            kind=kind, ops=tuple(ops), key=key, prob=prob, times=times,
            after=after, every=every, **extra,
        ))
        return self

    def throttle(self, *, ops=ALL_OPS, key=None, prob=1.0, times=None,
                 after=0, every=None) -> "FaultSchedule":
        """Raise `ThrottleError` (503 SlowDown) for matching requests."""
        return self._add("throttle", ops, key, prob, times, after, every)

    def transient(self, *, ops=ALL_OPS, key=None, prob=1.0, times=None,
                  after=0, every=None) -> "FaultSchedule":
        """Raise `TransientStoreError` (dropped connection, 5xx)."""
        return self._add("transient", ops, key, prob, times, after, every)

    def stall(self, duration_s: float, *, ops=ALL_OPS, key=None, prob=1.0,
              times=None, after=0, every=None) -> "FaultSchedule":
        """Delay matching requests by ``duration_s`` then serve normally
        (the straggler the hedging machinery exists for)."""
        return self._add("stall", ops, key, prob, times, after, every,
                         stall_s=duration_s)

    def truncate(self, *, nbytes: int = 1, ops=READ_OPS, key=None, prob=1.0,
                 times=None, after=0, every=None) -> "FaultSchedule":
        """Chop ``nbytes`` off the tail of the response payload (a short
        read the server reported as complete)."""
        return self._add("truncate", ops, key, prob, times, after, every,
                         nbytes=nbytes)

    def corrupt(self, *, ops=READ_OPS, key=None, prob=1.0, times=None,
                after=0, every=None) -> "FaultSchedule":
        """Flip one (seeded-position) byte of the response payload."""
        return self._add("corrupt", ops, key, prob, times, after, every)

    def flip_at_rest(self, *, key=None, prob=1.0, times=None,
                     after=0, every=None) -> "FaultSchedule":
        """Flip one byte of a RESIDENT `DirTier` block file between its
        write and a later read (at-rest bit rot). Fires on the tier's
        ``"at_rest"`` pseudo-op — pass this schedule as the tier's
        ``faults=`` argument; wire-level ops never match it."""
        return self._add("flip_at_rest", ("at_rest",), key, prob, times,
                         after, every)

    def cut(self, *, after_bytes: int, ops=READ_OPS, key=None, prob=1.0,
            times=None, after=0, every=None) -> "FaultSchedule":
        """Drop the connection mid-transfer: the first ``after_bytes``
        are fetched from the inner store for real (paying latency and
        partial bandwidth), then the request raises."""
        return self._add("cut", ops, key, prob, times, after, every,
                         nbytes=after_bytes)

    # -- arbitration -------------------------------------------------------
    def decide(self, op: str, key: str) -> list[FaultRule]:
        """The rules firing for this request, in script order.
        Deterministic in (seed, sequence of matching requests)."""
        out: list[FaultRule] = []
        with self._lock:
            for r in self.rules:
                if op not in r.ops:
                    continue
                if r.key is not None and r.key not in key:
                    continue
                r.seen += 1
                if r.seen <= r.after:
                    continue
                if r.times is not None and r.fired >= r.times:
                    continue
                if r.every is not None:
                    if (r.seen - r.after) % r.every != 0:
                        continue
                elif r.prob < 1.0 and self._rng.random() >= r.prob:
                    continue
                r.fired += 1
                out.append(r)
        return out

    def rand_index(self, n: int) -> int:
        """A seeded index in [0, n) (corruption byte position)."""
        with self._lock:
            return self._rng.randrange(n)

    def total_fired(self) -> int:
        with self._lock:
            return sum(r.fired for r in self.rules)


class _FaultyMultipartUpload:
    """Proxy multipart handle: part puts and the final complete() pass
    through the schedule as ``put_part`` / ``complete`` operations."""

    def __init__(self, outer: "FaultyStore", inner: MultipartUpload,
                 key: str) -> None:
        self._outer = outer
        self._inner = inner
        self._key = key

    def put_part(self, index: int, data: bytes) -> None:
        self._outer._inject("put_part", self._key)
        self._inner.put_part(index, data)

    def complete(self) -> None:
        self._outer._inject("complete", self._key)
        self._inner.complete()

    def abort(self) -> None:
        self._inner.abort()


class FaultyStore(ObjectStore):
    """Chaos wrapper delegating every operation to ``inner`` with the
    faults a `FaultSchedule` scripts. Per-kind injection counts are kept
    in :attr:`injected` (read via :meth:`snapshot`)."""

    def __init__(self, inner: ObjectStore, schedule: FaultSchedule) -> None:
        self.inner = inner
        self.schedule = schedule
        self._lock = threading.Lock()
        self.injected: dict[str, int] = {k: 0 for k in _KINDS}

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.injected)

    # -- injection ---------------------------------------------------------
    def _inject(self, op: str, key: str) -> list[FaultRule]:
        """Apply the raising/stalling faults for this request; return the
        payload-shaping rules (truncate/corrupt/cut) for the caller."""
        rules = self.schedule.decide(op, key)
        payload_rules: list[FaultRule] = []
        for r in rules:
            with self._lock:
                self.injected[r.kind] += 1
            if r.kind == "stall":
                time.sleep(r.stall_s)
            elif r.kind == "throttle":
                raise ThrottleError(
                    f"injected throttle: {op} {key!r} (SlowDown)"
                )
            elif r.kind == "transient":
                raise TransientStoreError(
                    f"injected transient fault: {op} {key!r}"
                )
            else:
                payload_rules.append(r)
        return payload_rules

    def _mangle(self, rules: list[FaultRule], data: bytes) -> bytes:
        for r in rules:
            if r.kind == "truncate" and data:
                data = data[: max(0, len(data) - r.nbytes)]
            elif r.kind == "corrupt" and data:
                buf = bytearray(data)
                buf[self.schedule.rand_index(len(buf))] ^= 0xFF
                data = bytes(buf)
        return data

    @staticmethod
    def _cut_rule(rules: list[FaultRule]) -> FaultRule | None:
        return next((r for r in rules if r.kind == "cut"), None)

    # -- reads -------------------------------------------------------------
    def get_range(self, key: str, start: int, end: int) -> bytes:
        rules = self._inject("get_range", key)
        cut = self._cut_rule(rules)
        if cut is not None:
            stop = min(end, start + cut.nbytes)
            if stop > start:
                # The partial payload crosses the (inner) wire for real.
                self.inner.get_range(key, start, stop)
            raise TransientStoreError(
                f"injected cut: {key!r} dropped after {stop - start} "
                f"of {end - start} bytes"
            )
        return self._mangle(rules, self.inner.get_range(key, start, end))

    def get_ranges(self, key: str, spans: list[tuple[int, int]]) -> list[bytes]:
        rules = self._inject("get_ranges", key)
        cut = self._cut_rule(rules)
        if cut is not None:
            start = spans[0][0] if spans else 0
            stop = min(spans[-1][1] if spans else 0, start + cut.nbytes)
            if stop > start:
                self.inner.get_range(key, start, stop)
            raise TransientStoreError(
                f"injected cut: {key!r} dropped after {stop - start} bytes "
                f"of a {len(spans)}-span request"
            )
        out = self.inner.get_ranges(key, spans)
        if out and rules:
            # Payload shaping lands on the final span — the tail of the
            # wire transfer, where a short response actually bites.
            out = list(out)
            out[-1] = self._mangle(rules, out[-1])
        return out

    def get(self, key: str) -> bytes:
        rules = self._inject("get", key)
        cut = self._cut_rule(rules)
        if cut is not None:
            if cut.nbytes > 0:
                self.inner.get_range(key, 0, cut.nbytes)
            raise TransientStoreError(
                f"injected cut: {key!r} dropped after {cut.nbytes} bytes"
            )
        return self._mangle(rules, self.inner.get(key))

    # -- verified reads ----------------------------------------------------
    # The store-attested digest comes from the INNER store (the
    # authority) while payload shaping mangles only the returned bytes —
    # so a fired ``corrupt``/``truncate`` is *detectable* by the caller,
    # exactly like S3's GetObject checksum mode detects a mangled wire
    # transfer. ``cut`` still raises before any payload exists.
    def get_range_verified(self, key: str, start: int,
                           end: int) -> tuple[bytes, str]:
        rules = self._inject("get_range", key)
        cut = self._cut_rule(rules)
        if cut is not None:
            stop = min(end, start + cut.nbytes)
            if stop > start:
                self.inner.get_range(key, start, stop)
            raise TransientStoreError(
                f"injected cut: {key!r} dropped after {stop - start} "
                f"of {end - start} bytes"
            )
        data, digest = self.inner.get_range_verified(key, start, end)
        return self._mangle(rules, data), digest

    def get_ranges_verified(
        self, key: str, spans: list[tuple[int, int]]
    ) -> list[tuple[bytes, str]]:
        rules = self._inject("get_ranges", key)
        cut = self._cut_rule(rules)
        if cut is not None:
            start = spans[0][0] if spans else 0
            stop = min(spans[-1][1] if spans else 0, start + cut.nbytes)
            if stop > start:
                self.inner.get_range(key, start, stop)
            raise TransientStoreError(
                f"injected cut: {key!r} dropped after {stop - start} bytes "
                f"of a {len(spans)}-span request"
            )
        out = self.inner.get_ranges_verified(key, spans)
        if out and rules:
            out = list(out)
            data, digest = out[-1]
            out[-1] = (self._mangle(rules, data), digest)
        return out

    def digest_range(self, key: str, start: int, end: int) -> str:
        # A checksum RPC carries no payload to mangle; pass through to
        # the authority.
        return self.inner.digest_range(key, start, end)

    # -- writes ------------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        rules = self._inject("put", key)
        if self._cut_rule(rules) is not None:
            # A cut upload never lands (whole-object puts are atomic).
            raise TransientStoreError(f"injected cut: put {key!r} dropped")
        self.inner.put(key, data)

    def start_multipart(self, key: str) -> MultipartUpload:
        return _FaultyMultipartUpload(self, self.inner.start_multipart(key),
                                      key)  # type: ignore[return-value]

    def delete(self, key: str) -> None:
        self._inject("delete", key)
        self.inner.delete(key)

    # -- metadata ----------------------------------------------------------
    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        self._inject("list_objects", prefix)
        return self.inner.list_objects(prefix)

    def size(self, key: str) -> int:
        self._inject("size", key)
        return self.inner.size(key)

    def exists(self, key: str) -> bool:
        try:
            self.size(key)
            return True
        except TransientStoreError:
            raise
        except StoreError:
            return False
