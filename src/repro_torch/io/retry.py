"""Unified resilience layer: one RetryPolicy + Hedger for every store call.

At production scale the dominant failure mode of S3-backed workflows is
not hard errors but throttling (503 SlowDown), stalls, and partial
responses. Before this module the stack carried three hand-rolled retry
loops with unjittered ``2 ** attempt`` backoff — which *synchronizes*
concurrent streams: N streams tripped by the same transient fault all
sleep the same duration and re-collide at the same instant, a classic
retry storm. Every production call site (rolling + sequential engines,
write-behind `Writer`, checkpoint metadata) now resolves through this
single implementation:

  * `RetryPolicy` — frozen configuration: attempt cap, *full-jitter*
    exponential backoff (AWS architecture-blog recipe: sleep
    ``uniform(0, min(cap, base * 2**attempt))``), an optional per-reader
    retry *budget*, and an optional per-call wall-clock *deadline*;
  * `Retrier` — a thread-safe per-reader/per-writer executor of one
    policy. On `ThrottleError` it invokes ``on_throttle`` — the rolling
    engine wires that into its AIMD depth controller, closing the loop
    between backend pushback and prefetch concurrency;
  * `Hedger` — straggler hedging (duplicate a request that exceeds
    ``timeout_s``) with a max-hedges-in-flight cap, replacing the two
    copy-pasted ``_*_maybe_hedged`` implementations.

Retry and hedging compose as ``retrier.call(lambda: hedger.call(fn))``:
each retry attempt is independently hedged, and a hedged attempt's
timing is withheld from the autotuner (racing duplicates contaminate
the sample).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.store.base import (
    IntegrityError,
    StoreError,
    ThrottleError,
    TransientStoreError,
)


@dataclass(frozen=True)
class RetryPolicy:
    """How one logical store operation survives transient faults.

    ``max_retries`` bounds retries *per call* (``max_retries + 1``
    attempts); ``budget`` bounds retries across a `Retrier`'s lifetime —
    a reader drowning in faults stops burning time on retries once its
    budget is spent, instead of paying the full per-call cap on every
    block. ``deadline_s`` caps one call's wall clock: a retry whose
    backoff would land past the deadline is not taken.

    ``jitter="full"`` (the default) sleeps ``uniform(0, d)`` where
    ``d = min(backoff_cap_s, backoff_s * 2**attempt)``; ``"none"``
    sleeps exactly ``d`` — kept only for A/B benchmarks of the retry
    storms it causes.
    """

    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_cap_s: float = 5.0
    jitter: str = "full"
    budget: int | None = None
    deadline_s: float | None = None

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )
        if self.backoff_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff durations must be >= 0")
        if self.jitter not in ("full", "none"):
            raise ValueError(
                f"jitter must be 'full' or 'none', got {self.jitter!r}"
            )
        if self.budget is not None and self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}"
            )

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number ``attempt`` (0-based)."""
        cap = min(self.backoff_cap_s, self.backoff_s * (2 ** attempt))
        if self.jitter == "none":
            return cap
        return rng.uniform(0.0, cap)


class Retrier:
    """Thread-safe executor of a `RetryPolicy` for one reader/writer.

    Several streams of the same reader may call :meth:`call`
    concurrently; the shared state (jitter rng, remaining budget,
    telemetry counters) is lock-protected, everything else is per-call.

    ``on_retry(attempt, exc, pause_s)`` fires before each backoff sleep
    (stat counters); ``on_throttle()`` fires on every `ThrottleError` —
    including one the final attempt raises — so backend pushback reaches
    the depth controller even when no retry follows.
    """

    def __init__(
        self,
        policy: RetryPolicy | None = None,
        *,
        seed: int | None = None,
        on_retry: Callable[[int, Exception, float], None] | None = None,
        on_throttle: Callable[[], None] | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.policy = policy if policy is not None else RetryPolicy()
        self.on_retry = on_retry
        self.on_throttle = on_throttle
        self._sleep = sleep
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._budget_left = self.policy.budget
        # Telemetry.
        self.retries = 0
        self.throttles = 0

    @property
    def budget_left(self) -> int | None:
        with self._lock:
            return self._budget_left

    def _next_backoff(self, attempt: int) -> float:
        with self._lock:
            return self.policy.backoff(attempt, self._rng)

    def _spend_budget(self) -> bool:
        with self._lock:
            if self._budget_left is None:
                return True
            if self._budget_left <= 0:
                return False
            self._budget_left -= 1
            return True

    def call(self, fn: Callable[[], Any], *, label: str = "store request"):
        """Run ``fn`` to completion under the policy. `TransientStoreError`
        (including `ThrottleError`) retries with backoff; anything else
        propagates untouched. On exhaustion raises `StoreError` chained
        from the last transient fault."""
        pol = self.policy
        deadline = (self._clock() + pol.deadline_s
                    if pol.deadline_s is not None else None)
        last: Exception | None = None
        reason = "gave up"
        for attempt in range(pol.max_retries + 1):
            try:
                return fn()
            except TransientStoreError as e:
                last = e
                if isinstance(e, ThrottleError):
                    with self._lock:
                        self.throttles += 1
                    if self.on_throttle is not None:
                        self.on_throttle()
                if attempt >= pol.max_retries:
                    reason = f"exhausted {pol.max_retries + 1} attempts"
                    break
                pause = self._next_backoff(attempt)
                if deadline is not None and self._clock() + pause > deadline:
                    reason = f"deadline {pol.deadline_s:g}s exceeded"
                    break
                if not self._spend_budget():
                    reason = f"retry budget ({pol.budget}) exhausted"
                    break
                with self._lock:
                    self.retries += 1
                if self.on_retry is not None:
                    self.on_retry(attempt, e, pause)
                self._sleep(pause)
        # Typed exhaustion: when the LAST fault was an integrity failure,
        # every authority we could reach handed back bytes that do not
        # match their digest — re-raise as IntegrityError so callers can
        # distinguish "the data is bad" from ordinary unavailability.
        err_cls = IntegrityError if isinstance(last, IntegrityError) else StoreError
        raise err_cls(f"{label}: {reason}") from last


class Hedger:
    """Straggler hedging around one request function, with a cap on
    concurrent hedges.

    :meth:`call` runs ``fn`` and, if it has not reported within
    ``timeout_s``, races a duplicate attempt and takes the first result
    that lands (requests are idempotent: range GETs, same-index part
    puts). At most ``max_in_flight`` hedge duplicates exist at any
    moment across all concurrent calls — past the cap a straggling
    primary is simply waited out, so a systemic slowdown (e.g. a
    throttled backend) cannot amplify itself with a thundering herd of
    duplicates. ``timeout_s=None`` disables hedging: ``fn`` runs inline
    with no extra thread.

    A failure propagates only once every launched attempt has reported,
    so a still-in-flight duplicate can rescue the call and no attempt
    thread outlives the raise.
    """

    def __init__(
        self,
        timeout_s: float | None,
        *,
        max_in_flight: int = 4,
        on_hedge: Callable[[], None] | None = None,
    ) -> None:
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}"
            )
        self.timeout_s = timeout_s
        self.max_in_flight = max_in_flight
        self.on_hedge = on_hedge
        self._lock = threading.Lock()
        self._in_flight = 0
        # Telemetry (asserted by the chaos tests: hedges stay bounded).
        self.hedges = 0
        self.peak_in_flight = 0

    def _try_acquire(self) -> bool:
        with self._lock:
            if self._in_flight >= self.max_in_flight:
                return False
            self._in_flight += 1
            self.hedges += 1
            self.peak_in_flight = max(self.peak_in_flight, self._in_flight)
            return True

    def _release(self) -> None:
        with self._lock:
            self._in_flight -= 1

    def call(self, fn: Callable[[], Any]) -> tuple[Any, float | None]:
        """Returns ``(result, seconds)``. Seconds is the request's wall
        time when exactly one attempt ran, and ``None`` when a hedge
        fired — racing duplicates contaminate the timing, so hedged
        samples must never reach the autotuner."""
        if self.timeout_s is None:
            t0 = time.perf_counter()
            return fn(), time.perf_counter() - t0
        cond = threading.Condition()
        results: list[Any] = []
        errors: list[Exception] = []

        def attempt(hedge: bool) -> None:
            try:
                r = fn()
            except Exception as e:  # repro: allow[RP005] — propagated below
                with cond:
                    errors.append(e)
                    cond.notify_all()
            else:
                with cond:
                    results.append(r)
                    cond.notify_all()
            finally:
                if hedge:
                    self._release()

        # repro: allow[RP006] — attempts are daemons; call() returns only
        # after every launched attempt reported, so none outlives the raise.
        threading.Thread(target=attempt, args=(False,), daemon=True,
                         name="hedge-primary").start()
        launched = 1
        t0 = time.perf_counter()
        with cond:
            cond.wait_for(lambda: results or errors, timeout=self.timeout_s)
            want_hedge = not results and not errors
        if want_hedge and self._try_acquire():
            if self.on_hedge is not None:
                self.on_hedge()
            # repro: allow[RP006] — same lifecycle as the primary attempt.
            threading.Thread(target=attempt, args=(True,), daemon=True,
                             name="hedge-secondary").start()
            launched = 2
        with cond:
            # A success wins immediately; a failure only propagates once
            # every launched attempt has reported.
            cond.wait_for(lambda: results or len(errors) >= launched)
        if results:
            store_s = None if launched > 1 else time.perf_counter() - t0
            return results[0], store_s
        raise errors[0]
