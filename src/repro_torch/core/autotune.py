"""Online closed-loop tuning (beyond the paper).

The paper derives the optimal block count n̂_b = sqrt(c·f/l_c) (Eq. 4) but
leaves selection to the user. At thousand-node scale nobody hand-tunes
per-dataset block sizes, so we close the loop three ways:

  * `BlockSizeTuner` fits (l_c, b_cr, c) from observed request timings and
    reader compute gaps, then retunes block size AND coalesce width
    between opens. Per-request samples feed a least-squares fit of
    `seconds = l_c + nbytes / b_cr` — request sizes vary (coalesced runs,
    short tail blocks), which is exactly what separates the intercept
    (latency) from the slope (1/bandwidth). EWMA fallbacks cover callers
    that observe latency/bandwidth directly and let drifting cloud
    conditions (the paper's §III-C bandwidth variability) track.
  * `coalesce width` — Eq. 1's `n_b·l_c` term says adjacent blocks should
    share one request while the link is latency-bound (see
    `cost_model.coalesce_width`).
  * `AimdDepthController` — concurrent fetch streams are grown additively
    while observed fetch throughput keeps improving and cut
    multiplicatively when it regresses, the classic congestion-control
    loop applied to request concurrency.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass

from repro_torch.core import cost_model


@dataclass
class Ewma:
    alpha: float = 0.2
    value: float | None = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (1 - self.alpha) * self.value + self.alpha * x
        return self.value


class BlockSizeTuner:
    def __init__(
        self,
        min_blocksize: int = 1 << 20,
        max_blocksize: int = 1 << 31,
        alpha: float = 0.2,
        max_samples: int = 512,
    ) -> None:
        self.min_blocksize = min_blocksize
        self.max_blocksize = max_blocksize
        self._lat = Ewma(alpha)
        self._bw = Ewma(alpha)
        self._cpb = Ewma(alpha)  # compute seconds per byte
        # (nbytes, seconds) per store request, for the least-squares fit.
        self._samples: deque[tuple[float, float]] = deque(maxlen=max_samples)
        self._fit: tuple[float | None, float | None] | None = None
        self._lock = threading.Lock()

    # -- observations -------------------------------------------------------
    def observe_request(self, nbytes: int, seconds: float) -> None:
        """One store request (possibly a coalesced multi-block GET):
        `nbytes` payload moved in `seconds` wall time. Varied request
        sizes let the regression split latency from bandwidth."""
        if nbytes <= 0 or seconds <= 0:
            return
        with self._lock:
            self._samples.append((float(nbytes), float(seconds)))
            self._fit = None  # recompute lazily

    def observe_fetch(self, nbytes: int, seconds: float) -> None:
        """Back-compat alias for :meth:`observe_request`."""
        self.observe_request(nbytes, seconds)

    def observe_latency(self, seconds: float) -> None:
        self._lat.update(max(seconds, 0.0))

    def observe_bandwidth(self, bytes_per_s: float) -> None:
        if bytes_per_s > 0:
            self._bw.update(bytes_per_s)

    def observe_compute(self, nbytes: int, seconds: float) -> None:
        if nbytes > 0 and seconds >= 0:
            self._cpb.update(seconds / nbytes)

    # -- the request-timing fit --------------------------------------------
    def _fitted(self) -> tuple[float | None, float | None]:
        """(latency_s, bandwidth_Bps) from least squares over the request
        samples; (None, None) while underdetermined (too few samples or no
        size variance — a fixed-width scheduler at one block size cannot
        separate the two, which is why the scheduler probes widths)."""
        with self._lock:
            if self._fit is not None:
                return self._fit
            n = len(self._samples)
            if n < 4:
                self._fit = (None, None)
                return self._fit
            xs = [s[0] for s in self._samples]
            ys = [s[1] for s in self._samples]
            mx = sum(xs) / n
            my = sum(ys) / n
            sxx = sum((x - mx) ** 2 for x in xs)
            if sxx <= (0.01 * mx) ** 2 * n:  # effectively no size variance
                self._fit = (None, None)
                return self._fit
            slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
            if slope <= 0:
                # Noise swamped the payload term: everything we saw was
                # latency. Report the mean request time as latency.
                self._fit = (max(my, 0.0), None)
                return self._fit
            intercept = my - slope * mx
            self._fit = (max(intercept, 0.0), 1.0 / slope)
            return self._fit

    # -- estimates ----------------------------------------------------------
    @property
    def latency_s(self) -> float | None:
        if self._lat.value is not None:
            return self._lat.value
        return self._fitted()[0]

    @property
    def bandwidth_Bps(self) -> float | None:
        if self._bw.value is not None:
            return self._bw.value
        return self._fitted()[1]

    @property
    def compute_s_per_byte(self) -> float | None:
        return self._cpb.value

    @property
    def n_requests_observed(self) -> int:
        with self._lock:
            return len(self._samples)

    def estimates(self) -> dict:
        """Snapshot of every estimate (surfaced through `FSStats`)."""
        return {
            "latency_s": self.latency_s,
            "bandwidth_Bps": self.bandwidth_Bps,
            "compute_s_per_byte": self.compute_s_per_byte,
            "requests_observed": self.n_requests_observed,
        }

    # -- planning ---------------------------------------------------------
    def suggest_blocksize(self, total_bytes: int,
                          cache_budget: int | None = None,
                          default: int | None = None) -> int:
        """Eq.-4 optimum, clamped to [min, max, cache budget]; `default`
        (falling back to the paper's 64 MiB) while unobserved."""
        lc = self.latency_s
        c = self._cpb.value
        if not lc or c is None:
            if default:
                # The caller's configured blocksize is not ours to clamp
                # to the tuner's [min, max] — only the cache budget binds.
                if cache_budget is not None:
                    default = min(default, max(1, cache_budget // 2))
                return max(1, default)
            return self._clamp(64 << 20, cache_budget)
        nb = cost_model.optimal_num_blocks(total_bytes, c, lc)
        if not math.isfinite(nb) or nb < 1:
            nb = 1.0
        return self._clamp(int(total_bytes / nb), cache_budget)

    def suggest_coalesce(self, blocksize: int, max_width: int) -> int:
        """Cost-model coalesce width for the estimated link; 1 while the
        link constants are unknown (the scheduler probes instead)."""
        lc, bw = self.latency_s, self.bandwidth_Bps
        if not lc:
            return 1
        return cost_model.coalesce_width(
            lc, bw if bw else float("inf"), blocksize, max_width
        )

    def _clamp(self, blocksize: int, cache_budget: int | None) -> int:
        blocksize = max(self.min_blocksize, min(self.max_blocksize, blocksize))
        if cache_budget is not None:
            # Leave room for at least two blocks so the pipeline can roll.
            blocksize = min(blocksize, max(1, cache_budget // 2))
        return max(1, blocksize)

    def predicted_speedup(self, total_bytes: int, blocksize: int) -> float | None:
        lc, bw, c = self.latency_s, self.bandwidth_Bps, self._cpb.value
        if not lc or not bw or c is None:
            return None
        nb = max(1, math.ceil(total_bytes / blocksize))
        p = cost_model.CostParams(f=total_bytes, n_b=nb, l_c=lc, b_cr=bw, c=c)
        return cost_model.speedup(p)


class AimdDepthController:
    """Additive-increase / multiplicative-decrease control of concurrent
    prefetch streams, driven by observed fetch throughput.

    Every `window` completed fetches close a measurement window; if the
    window's throughput held (>= `tolerance` x the previous window's) the
    target grows by one stream, otherwise it halves — concurrency keeps
    probing upward while the store rewards it (S3 scales with request
    concurrency) and backs off fast when a shared link saturates.
    Thread-safe: fetch completions arrive from several streams at once.
    """

    def __init__(self, initial: int, max_depth: int, *, window: int = 4,
                 tolerance: float = 0.85,
                 throttle_cooldown_s: float = 0.25) -> None:
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.target = max(1, min(initial, max_depth))
        self.peak = self.target
        self._window = max(1, window)
        self._tolerance = tolerance
        self._cooldown = throttle_cooldown_s
        self._lock = threading.Lock()
        self._n = 0
        self._bytes = 0
        self._t0: float | None = None
        self._last_thr: float | None = None
        self._last_cut: float | None = None
        self._last_grow: float | None = None
        self.adjustments = 0
        self.throttle_cuts = 0

    def on_throttle(self, now: float | None = None) -> int:
        """Backend pushback (503 SlowDown, `ThrottleError`): cut the
        stream target multiplicatively NOW, without waiting for a
        throughput window to close — the store has said, explicitly,
        that concurrency is too high. Like TCP's one-halving-per-RTT
        rule, cuts within ``throttle_cooldown_s`` of the last one are
        coalesced: N streams throttled by the same pressure burst count
        as ONE signal, not N halvings to the floor. The measurement
        window resets so the next throughput sample doesn't mix the
        pre- and post-throttle regimes; additive growth then re-probes
        upward once throughput holds — rate-limited to one step per
        cooldown while pushback is recent (within 8x the cooldown),
        since per-window growth at high fetch rates would climb right
        back into the throttled regime before the next cut is even
        allowed (see :meth:`_may_grow`)."""
        if now is None:
            now = time.perf_counter()   # same clock as on_fetch callers
        with self._lock:
            if (self._last_cut is not None
                    and now - self._last_cut < self._cooldown):
                return self.target
            self._last_cut = now
            # Ceil halving: 3 -> 2, not 3 -> 1 — at small depths floor
            # division overshoots the cut and strands the target below
            # the sustainable point.
            new = max(1, (self.target + 1) // 2)
            if new != self.target:
                self.target = new
                self.adjustments += 1
            self.throttle_cuts += 1
            self._n = 0
            self._bytes = 0
            self._t0 = None
            self._last_thr = None
            return self.target

    def _may_grow(self, now: float) -> bool:
        """Additive-increase gate. Caller holds `_lock`. Free-running
        when the backend has never pushed back (or not for 8x the
        cooldown); under recent throttle pressure, at most one +1 step
        per cooldown — the TCP-flavoured asymmetry that lets the target
        settle near the sustainable depth instead of sawtoothing at the
        window-close rate."""
        if self._cooldown <= 0.0 or self._last_cut is None:
            return True
        if now - self._last_cut >= 8.0 * self._cooldown:
            return True
        return (self._last_grow is None
                or now - self._last_grow >= self._cooldown)

    def on_fetch(self, nbytes: int, now: float) -> int:
        """Record one completed fetch; returns the (possibly updated)
        target stream count."""
        with self._lock:
            if self._t0 is None:
                self._t0 = now
                return self.target
            self._n += 1
            self._bytes += nbytes
            if self._n < self._window:
                return self.target
            thr = self._bytes / max(now - self._t0, 1e-9)
            last, self._last_thr = self._last_thr, thr
            self._n, self._bytes, self._t0 = 0, 0, now
            if last is None or thr >= last * self._tolerance:
                if not self._may_grow(now):
                    return self.target
                self._last_grow = now
                new = min(self.max_depth, self.target + 1)
            else:
                new = max(1, self.target // 2)
            if new != self.target:
                self.target = new
                self.adjustments += 1
                self.peak = max(self.peak, new)
            return self.target
