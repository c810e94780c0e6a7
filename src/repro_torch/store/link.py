"""Link model: injects latency + shared-bandwidth cost into byte transfers.

Models the paper's Table I measurements. Latency is paid per request and
overlaps freely across threads (S3 is highly concurrent); bandwidth is a
shared serial resource (the instance NIC / DIMM bus), modeled as a
reservation queue: each transfer reserves the link for `bytes / bandwidth`
seconds starting no earlier than the previous reservation ends. This
reproduces the contention behaviour the paper discusses for parallel
workloads (§III-C).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from repro_torch.store.base import ThrottleError, TransientStoreError


@dataclass
class LinkModel:
    latency_s: float = 0.0
    bandwidth_Bps: float = float("inf")
    # Multiplicative jitter applied to latency (lognormal-ish, seeded).
    jitter: float = 0.0
    seed: int = 0
    # Failure injection: probability per request, and an explicit
    # fail-next counter (used by fault-tolerance tests).
    fail_prob: float = 0.0
    # Requests-per-second admission model (S3 per-prefix throttling): a
    # token bucket refilling at `rps_limit` with burst headroom
    # `rps_burst` (default: a quarter second's worth, at least 1). A
    # request arriving with no token pays its round-trip latency — the
    # 503 comes back one RTT later — and raises `ThrottleError`.
    # `rps_penalty` models SlowDown *escalation*: each rejected request
    # additionally drains that many tokens (floored at -burst), the way
    # real object stores extend throttling for clients that keep
    # hammering after a 503 — backing off (and shrinking concurrency)
    # is then genuinely cheaper than retrying at full pressure.
    rps_limit: float = float("inf")
    rps_burst: float | None = None
    rps_penalty: float = 0.0
    name: str = "link"

    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _free_at: float = field(default=0.0, repr=False)
    _rng: random.Random = field(default=None, repr=False)  # type: ignore
    _fail_next: int = field(default=0, repr=False)
    _tokens: float = field(default=0.0, repr=False)
    _tokens_t: float | None = field(default=None, repr=False)
    # Telemetry (read by the online autotuner and benchmarks).
    bytes_moved: int = field(default=0, repr=False)
    requests: int = field(default=0, repr=False)
    busy_s: float = field(default=0.0, repr=False)
    latency_paid_s: float = field(default=0.0, repr=False)
    # Failure telemetry: every raising request (injected fault, throttle)
    # counts into `failed_requests`; throttles also into `throttled`.
    # Failed requests still pay — and record — their request latency, so
    # benchmark timings under fault schedules stay honest.
    failed_requests: int = field(default=0, repr=False)
    throttled: int = field(default=0, repr=False)
    # Coalesced-transfer accounting: a vectorized get_ranges run charges
    # ONE request for several logical spans — `spans_served` counts the
    # spans, `coalesced_requests` the requests that carried more than one.
    spans_served: int = field(default=0, repr=False)
    coalesced_requests: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    # -- failure injection ------------------------------------------------
    def fail_next(self, n: int = 1) -> None:
        with self._lock:
            self._fail_next += n

    def _check_fail(self) -> str | None:
        """Failure decision for one request. Caller holds `_lock`."""
        if self._fail_next > 0:
            self._fail_next -= 1
            return f"{self.name}: injected failure"
        if self.fail_prob > 0.0 and self._rng.random() < self.fail_prob:
            return f"{self.name}: injected random failure"
        return None

    def _admit(self) -> bool:
        """Token-bucket admission at `rps_limit`. Caller holds `_lock`.
        A rejected request does not consume its token, so backed-off
        retries find capacity once pressure drops — but with
        `rps_penalty` set it *drains* penalty tokens (escalating
        SlowDown), so sustained hammering pushes the bucket below zero
        and admission recovers only after the pressure actually
        relents. The floor at ``-burst`` bounds the starvation."""
        if self.rps_limit == float("inf"):
            return True
        burst = (self.rps_burst if self.rps_burst is not None
                 else max(1.0, self.rps_limit / 4.0))
        now = time.perf_counter()
        if self._tokens_t is None:
            self._tokens = burst
        else:
            self._tokens = min(
                burst, self._tokens + (now - self._tokens_t) * self.rps_limit
            )
        self._tokens_t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        if self.rps_penalty > 0.0:
            self._tokens = max(-burst, self._tokens - self.rps_penalty)
        return False

    # -- transfer ---------------------------------------------------------
    def transfer(self, nbytes: int, spans: int = 1) -> None:
        """Block for the simulated duration of moving `nbytes` as ONE
        request. `spans` is telemetry only: how many logical ranges the
        request carried (a coalesced get_ranges run pays one latency for
        all of them; the cost charged here is identical either way).

        Raises `ThrottleError` under rps pressure and
        `TransientStoreError` for injected faults — in both cases AFTER
        paying the request latency: a 503 or dropped connection still
        costs a round trip, and the paid time lands in the telemetry.
        """
        lat = self.latency_s
        if self.jitter > 0.0:
            with self._lock:
                lat *= max(0.0, 1.0 + self._rng.gauss(0.0, self.jitter))
        # Latency overlaps across threads: plain sleep.
        if lat > 0.0:
            time.sleep(lat)
        with self._lock:
            self.requests += 1
            self.latency_paid_s += lat
            if not self._admit():
                self.failed_requests += 1
                self.throttled += 1
                raise ThrottleError(
                    f"{self.name}: rate limit exceeded "
                    f"({self.rps_limit:g} req/s)"
                )
            fail = self._check_fail()
            if fail is not None:
                self.failed_requests += 1
                raise TransientStoreError(fail)
        # Bandwidth is a shared serial resource: reserve a slot.
        if self.bandwidth_Bps != float("inf") and nbytes > 0:
            dur = nbytes / self.bandwidth_Bps
            with self._lock:
                now = time.perf_counter()
                start = max(now, self._free_at)
                self._free_at = start + dur
                finish = self._free_at
                self.busy_s += dur
            delay = finish - time.perf_counter()
            if delay > 0.0:
                time.sleep(delay)
        with self._lock:
            self.bytes_moved += nbytes
            self.spans_served += max(1, spans)
            if spans > 1:
                self.coalesced_requests += 1

    # -- observed constants (for the cost-model autotuner) -----------------
    def observed_bandwidth(self) -> float:
        with self._lock:
            if self.busy_s == 0.0:
                return self.bandwidth_Bps
            return self.bytes_moved / self.busy_s

    def observed_latency(self) -> float:
        """Mean per-request latency actually paid (== `latency_s` when
        jitter is off); the ground truth the closed-loop tuner's estimate
        is validated against."""
        with self._lock:
            if self.requests == 0:
                return self.latency_s
            return self.latency_paid_s / self.requests


@dataclass
class PeerLinkModel(LinkModel):
    """The LAN/loopback hop between sibling hosts of one job.

    A distinct class (not just different numbers) so peer transfers are
    billed to their own link — never to the backing-store WAN link — and
    so call sites can tell the two apart (`repro_torch.peer` charges every
    block served from a sibling here, and the peer tier's `TierCostModel`
    seeds from these constants). Defaults model a ~10 GbE intra-cluster
    hop: sub-millisecond latency, two orders of magnitude above the
    scaled S3 bandwidth; all knobs stay URI-tunable through ``peer://``
    (``peer_latency_ms`` / ``peer_bw_mbps`` / ``peer_rps``) so
    ``bench_peer.py`` can sweep realistic LAN-vs-WAN ratios.
    """

    latency_s: float = 2e-4
    bandwidth_Bps: float = 1.25e9
    name: str = "peer"


# Paper Table I constants (t2.xlarge, us-west-2), in SI bytes/sec.
PAPER_S3 = dict(latency_s=0.1, bandwidth_Bps=91e6)
PAPER_MEM = dict(latency_s=1.6e-6, bandwidth_Bps=2221e6)
# Default intra-cluster peer hop (see `PeerLinkModel`).
PEER_LAN = dict(latency_s=2e-4, bandwidth_Bps=1.25e9)
