"""User-space hierarchical storage manager over the cache tiers.

The paper treats local storage as a flat priority list of caches that mask
S3 latency; the authors' follow-up work (arXiv:2404.11556) argues the next
step is a real user-space HSM — mem -> local disk -> shared disk -> remote
— with cost-model-driven placement. This module promotes the shared
`CacheIndex` into exactly that:

  * **heat tracking** — every hit touches an exponentially-decaying
    per-block temperature (access count + recency in one number);
  * **promotion / demotion** — a background mover copies hot unpinned
    blocks up-tier when the cost model says the move pays for itself, and
    capacity pressure on a non-bottom tier *demotes* cold blocks down-tier
    instead of deleting them; only the bottom tier truly evicts;
  * **cost-model placement** — each tier carries a `TierCostModel` seeded
    from its `LinkModel` (latency + bandwidth) and refined online from the
    link's observed-request telemetry, the same signals `BlockSizeTuner`
    fits; placement walks candidate tiers in per-byte cost order, not list
    order;
  * **workload-class admission** — `IOPolicy.io_class` ("loader" /
    "ckpt" / "serve") selects an `AdmissionPolicy`: serve restores admit
    into mem and are *protected* (a non-protected class can never displace
    them), bulk loader scans enter at the disk level and are
    *scan-resistant* (their blocks queue at the FRONT of the eviction
    order, so one epoch sweep evicts its own blocks first and cannot flush
    the hot set).

`HSMStore` wraps a backing `ObjectStore` together with the assembled
hierarchy so one ``hsm://`` URI (registered in ``repro_torch.io.stores``)
carries the whole thing::

    hsm://?mem=64MB&disk=/scratch/cache:1GB&backing=mem://bucket

`PrefetchFS` recognizes the wrapper and adopts its tiers + `HSMIndex`, so
every existing engine, loader, checkpoint, and serve call site gets HSM
placement without code changes.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field

from repro_torch.store.base import (
    IntegrityError,
    MultipartUpload,
    ObjectMeta,
    ObjectStore,
)
from repro_torch.store.link import LinkModel
from repro_torch.store.tiers import (
    CacheIndex,
    CacheTier,
    DirTier,
    MemTier,
    _IndexEntry,
)
from repro_torch.utils import get_logger

log = get_logger("store.hsm")


def _check_move(data: bytes, digest: str | None, block_id: str,
                move: str) -> None:
    """Verify block bytes against their index digest before an HSM move
    copies them to another tier — a move is a tier/tier boundary, and
    boundaries are where digests get checked. No digest (verify="off"
    producers, pre-digest entries) verifies nothing. Lazy import: the io
    layer imports this module at package init."""
    if digest is None:
        return
    from repro_torch.io.integrity import check_block
    check_block(data, digest, what=f"hsm {move} of {block_id}")


# --------------------------------------------------------------------------- #
# sizes
# --------------------------------------------------------------------------- #
_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([KMGT]i?B?|B)?\s*$", re.IGNORECASE)
_SIZE_UNITS = {
    "": 1, "b": 1,
    "k": 1 << 10, "kb": 1 << 10, "kib": 1 << 10,
    "m": 1 << 20, "mb": 1 << 20, "mib": 1 << 20,
    "g": 1 << 30, "gb": 1 << 30, "gib": 1 << 30,
    "t": 1 << 40, "tb": 1 << 40, "tib": 1 << 40,
}


def parse_size(text: str | int) -> int:
    """``"64MB"`` / ``"1GiB"`` / ``"4096"`` -> bytes (binary units)."""
    if isinstance(text, int):
        return text
    m = _SIZE_RE.match(text)
    if not m:
        raise ValueError(f"not a size: {text!r} (expected e.g. 64MB, 1GiB, 4096)")
    value, unit = m.groups()
    return int(float(value) * _SIZE_UNITS[(unit or "").lower()])


# --------------------------------------------------------------------------- #
# cost model
# --------------------------------------------------------------------------- #
@dataclass
class TierCostModel:
    """Per-tier access cost: ``cost(n) = latency + n / bandwidth`` seconds.

    Seeded from the tier's read `LinkModel` (the configured simulation
    constants) and refined online from the link's observed telemetry —
    the same per-request latency/bandwidth signals `BlockSizeTuner` fits —
    via an EWMA, so a tier whose device behaves differently from its
    nameplate migrates the placement decisions with it.
    """

    latency_s: float
    bandwidth_Bps: float
    alpha: float = 0.3          # EWMA weight for observed telemetry
    refined: int = field(default=0, repr=False)   # observe() updates applied

    @classmethod
    def from_tier(cls, tier: CacheTier) -> "TierCostModel":
        link = tier.read_link
        return cls(latency_s=link.latency_s, bandwidth_Bps=link.bandwidth_Bps)

    def observe(self, tier: CacheTier) -> None:
        """Fold the tier's observed request telemetry into the estimates
        (no-op until the link has served traffic)."""
        link = tier.read_link
        if link.requests <= 0:
            return
        lat = link.observed_latency()
        bw = link.observed_bandwidth()
        self.latency_s += self.alpha * (lat - self.latency_s)
        if bw != float("inf") and self.bandwidth_Bps != float("inf"):
            self.bandwidth_Bps += self.alpha * (bw - self.bandwidth_Bps)
        elif bw != float("inf"):
            self.bandwidth_Bps = bw
        self.refined += 1

    def cost(self, nbytes: int) -> float:
        """Estimated seconds to read `nbytes` from this tier."""
        if self.bandwidth_Bps == float("inf") or self.bandwidth_Bps <= 0:
            return self.latency_s
        return self.latency_s + nbytes / self.bandwidth_Bps

    def snapshot(self) -> dict:
        return dict(latency_s=self.latency_s, bandwidth_Bps=self.bandwidth_Bps,
                    refined=self.refined)


# --------------------------------------------------------------------------- #
# admission
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class AdmissionPolicy:
    """How one workload class is admitted into the hierarchy.

    ``entry_level`` — highest (fastest) level the class may occupy, as an
    index into the tier list; new blocks are placed no higher than this
    and promotion never lifts them above it. ``protected`` — the class's
    blocks can only be displaced (demoted/evicted) by pressure from
    another protected class, so a bulk scan can never flush them.
    ``scan_resistant`` — the class's own blocks queue at the FRONT of the
    eviction order, so its sweep recycles its own footprint first.
    """

    entry_level: int = 0
    protected: bool = False
    scan_resistant: bool = False


#: Default per-class admission. ``serve`` models latency-critical restore
#: reads (pinned into the top tier, protected); ``ckpt`` restores admit
#: top but are displaceable; ``loader`` models bulk epoch sweeps
#: (disk-level entry, scan-resistant).
DEFAULT_ADMISSION: dict[str, AdmissionPolicy] = {
    "default": AdmissionPolicy(),
    "serve": AdmissionPolicy(entry_level=0, protected=True),
    "ckpt": AdmissionPolicy(entry_level=0),
    "loader": AdmissionPolicy(entry_level=1, scan_resistant=True),
    # Blocks a peer BlockServer fetches on a sibling host's behalf: the
    # local replica may never read them itself, so they stay out of the
    # top tier and recycle their own footprint under pressure.
    "peer": AdmissionPolicy(entry_level=1, scan_resistant=True),
}


class _Heat:
    """Exponentially-decayed access temperature of one block."""

    __slots__ = ("temp", "last_t")

    def __init__(self, now: float) -> None:
        self.temp = 1.0
        self.last_t = now

    def _decay(self, now: float, half_life_s: float) -> float:
        dt = max(0.0, now - self.last_t)
        if dt > 0.0 and half_life_s > 0.0:
            self.temp *= 0.5 ** (dt / half_life_s)
            self.last_t = now
        return self.temp

    def touch(self, now: float, half_life_s: float) -> None:
        self._decay(now, half_life_s)
        self.temp += 1.0

    def value(self, now: float, half_life_s: float) -> float:
        return self._decay(now, half_life_s)


# --------------------------------------------------------------------------- #
# the HSM index
# --------------------------------------------------------------------------- #
class HSMIndex(CacheIndex):
    """`CacheIndex` subclass that turns the flat tier walk into an HSM.

    Drop-in for every engine (same acquire/publish/unpin/evict_from/
    reserve_space surface); the differences:

      * retention is always on (`keep_cached`): demotion, not reader
        consumption, is what moves blocks down and out;
      * `reserve_space` starts the walk at the workload class's admission
        entry level and orders candidate tiers by modeled cost;
      * `evict_from` on a non-bottom tier *demotes* victims to the next
        level down (cascading; only the bottom tier deletes), skips
        blocks of protected classes unless the requester is protected
        itself, and falls back to deletion only when the whole hierarchy
        below is wedged (availability beats purity);
      * a background mover promotes hot unpinned blocks up-tier whenever
        the heat-weighted read-cost saving exceeds the cost of the move
        itself, and demotes cold blocks from tiers past their high-water
        mark — so placement converges even without capacity pressure.
    """

    def __init__(
        self,
        tiers: list[CacheTier],
        *,
        admission: dict[str, AdmissionPolicy] | None = None,
        half_life_s: float = 30.0,
        promote_threshold: float = 2.0,
        demote_watermark: float = 0.9,
        mover_interval_s: float | None = 0.5,
        promote_batch: int = 8,
        keep_cached: bool = True,
        flight_ttl_s: float | None = CacheIndex.FLIGHT_TTL_S,
    ) -> None:
        # State the base constructor's priming may touch must exist first.
        self._heat: dict[str, _Heat] = {}
        self.admission = dict(DEFAULT_ADMISSION)
        if admission:
            self.admission.update(admission)
        self.half_life_s = half_life_s
        self.promote_threshold = promote_threshold
        self.demote_watermark = demote_watermark
        self.promote_batch = promote_batch
        self.promotions = 0
        self.demotions = 0
        self.forced_evictions = 0      # non-bottom deletes (demotion wedged)
        self.moves_failed = 0
        self.tier_hits: dict[str, int] = {}
        self.class_hits: dict[str, int] = {}
        super().__init__(tiers, keep_cached=True, flight_ttl_s=flight_ttl_s)
        for level, tier in enumerate(self.tiers):
            tier.level = level
        self.costs = [TierCostModel.from_tier(t) for t in self.tiers]
        self._seed_recovered_heat()
        self._mover_stop = threading.Event()
        self._mover: threading.Thread | None = None
        if mover_interval_s is not None:
            self._mover = threading.Thread(
                target=self._mover_loop, args=(mover_interval_s,),
                name="hsm-mover", daemon=True,
            )
            self._mover.start()

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop the background mover (blocks stay where they are)."""
        self._mover_stop.set()
        if self._mover is not None:
            self._mover.join(timeout=5.0)
            self._mover = None

    def set_keep_cached(self, keep: bool) -> None:
        """Retention is the HSM's semantic — demotion moves blocks down
        and out, readers never flip it off. Upgrades are no-ops too."""

    def _seed_recovered_heat(self) -> None:
        """Blocks recovered from a persistent tier whose journal says they
        lived at a HOTTER level before the restart (the tier-generation
        ``lvl`` field) are seeded promotable heat, so the mover restores
        the pre-crash placement instead of treating them as cold."""
        now = time.monotonic()
        with self._cond:
            for bid, e in self._entries.items():
                lvl = None
                journaled = getattr(e.tier, "journaled_level", None)
                if journaled is not None:
                    lvl = journaled(bid)
                if lvl is not None and lvl < e.tier.level:
                    h = self._heat.setdefault(bid, _Heat(now))
                    h.temp = max(h.temp, self.promote_threshold + 1.0)

    # -- admission ----------------------------------------------------------
    def _admission(self, io_class: str | None) -> AdmissionPolicy:
        pol = self.admission.get(io_class or "default")
        if pol is None:
            pol = self.admission.get("default", AdmissionPolicy())
        return pol

    def _entry_level(self, io_class: str | None) -> int:
        return min(self._admission(io_class).entry_level, len(self.tiers) - 1)

    # -- hooks from the base index (caller holds `_cond`) --------------------
    def _note_hit(self, block_id: str, e: _IndexEntry, io_class: str) -> None:
        now = time.monotonic()
        h = self._heat.get(block_id)
        if h is None:
            h = self._heat[block_id] = _Heat(now)
        else:
            h.touch(now, self.half_life_s)
        name = e.tier.name
        self.tier_hits[name] = self.tier_hits.get(name, 0) + 1
        ck = f"{io_class}:{name}"
        self.class_hits[ck] = self.class_hits.get(ck, 0) + 1

    def _on_insert(self, block_id: str, e: _IndexEntry) -> None:
        now = time.monotonic()
        h = self._heat.get(block_id)
        if h is None:
            self._heat[block_id] = _Heat(now)
        else:
            h.touch(now, self.half_life_s)

    def _note_evictable(self, block_id: str, e: _IndexEntry) -> None:
        self._evictable[block_id] = None
        if self._admission(e.io_class).scan_resistant:
            # Scan-resistant classes recycle their own footprint: their
            # blocks are the first pressure victims, so a sweep can never
            # push out the hot set behind them.
            self._evictable.move_to_end(block_id, last=False)
        else:
            self._evictable.move_to_end(block_id)

    # -- placement -----------------------------------------------------------
    def reserve_space(self, nbytes: int,
                      io_class: str = "default") -> CacheTier | None:
        start = self._entry_level(io_class)
        levels = sorted(range(start, len(self.tiers)),
                        key=lambda lv: self.costs[lv].cost(nbytes))
        for lv in levels:
            cand = self.tiers[lv]
            if cand.available() < nbytes:
                cand.verify_used()
            if cand.reserve(nbytes):
                return cand
            if (self.evict_from(cand, nbytes, requester=io_class) > 0
                    and cand.reserve(nbytes)):
                return cand
        return None

    def _tier_reserve(self, level: int, nbytes: int, requester: str) -> bool:
        """Reservation on one specific tier, applying pressure (which on a
        non-bottom tier cascades demotions further down)."""
        cand = self.tiers[level]
        if cand.available() < nbytes:
            cand.verify_used()
        if cand.reserve(nbytes):
            return True
        return (self.evict_from(cand, nbytes, requester=requester) > 0
                and cand.reserve(nbytes))

    # -- pressure: demote-not-evict ------------------------------------------
    def evict_from(self, tier: CacheTier, nbytes: int,
                   requester: str | None = None) -> int:
        req_protected = self._admission(requester).protected
        bottom = tier is self.tiers[-1]
        victims: list[tuple[str, _IndexEntry]] = []
        planned = 0
        with self._cond:
            for bid in list(self._evictable):
                e = self._entries.get(bid)
                if e is None or e.tier is not tier or bid in self._deleting:
                    continue
                if (self._admission(e.io_class).protected
                        and not req_protected):
                    continue
                victims.append((bid, e))
                planned += e.size
                if planned >= nbytes:
                    break
            for bid, e in victims:
                del self._entries[bid]
                self._evictable.pop(bid, None)
                self._deleting.add(bid)
        if not victims:
            return 0
        freed = 0
        try:
            for bid, e in victims:
                if not bottom and self._demote(bid, e):
                    freed += e.size
                    continue
                # Bottom tier — or the hierarchy below is wedged (full of
                # pinned bytes): delete. A stuck demotion must not stall
                # the prefetch pipeline.
                self._delete_from_tier(e.tier, bid, e.size)
                freed += e.size
                with self._cond:
                    self.evictions += 1
                    if not bottom:
                        self.forced_evictions += 1
                    self._heat.pop(bid, None)
        finally:
            with self._cond:
                for bid, _ in victims:
                    self._deleting.discard(bid)
                self._cond.notify_all()
        return freed

    def _demote(self, block_id: str, e: _IndexEntry) -> bool:
        """Move an (already tombstoned) victim one level down. Returns
        False when the copy could not be placed — the caller deletes."""
        dst_level = e.tier.level + 1
        if dst_level >= len(self.tiers):
            return False
        dst = self.tiers[dst_level]
        if not self._tier_reserve(dst_level, e.size, e.io_class):
            return False
        try:
            data = e.tier.read(block_id, 0, e.size)
            _check_move(data, e.digest, block_id, "demotion")
            dst.write(block_id, data)
            dst.commit(e.size)
        except IntegrityError as exc:
            # The copy rotted in the source tier: propagating it down
            # would launder corruption into a colder (often persistent)
            # level. Refuse the move — the caller deletes, and the next
            # read re-fetches clean bytes from the backing store.
            dst.cancel(e.size)
            with self._cond:
                self.moves_failed += 1
                self.quarantined += 1
            log.warning("demotion of %s: copy is corrupt, evicting: %s",
                        block_id, exc)
            return False
        except Exception as exc:   # repro: allow[RP005] — fall back to eviction
            dst.cancel(e.size)
            with self._cond:
                self.moves_failed += 1
            log.warning("demotion of %s to %s failed: %s",
                        block_id, dst.name, exc)
            return False
        self._delete_from_tier(e.tier, block_id, e.size)
        with self._cond:
            ne = _IndexEntry(dst, e.size, refs=0, io_class=e.io_class,
                             digest=e.digest)
            self._entries[block_id] = ne
            self._note_evictable(block_id, ne)
            self.demotions += 1
        return True

    # -- mover: promotion + watermark demotion --------------------------------
    def _mover_loop(self, interval_s: float) -> None:
        while not self._mover_stop.wait(interval_s):
            try:
                self.mover_tick()
            except Exception:   # repro: allow[RP005] — the mover must survive
                log.exception("hsm mover tick failed")

    def mover_tick(self) -> None:
        """One synchronous placement pass (the background thread calls
        this periodically; tests and benchmarks call it directly for
        determinism): refresh cost models from link telemetry, promote
        profitable hot blocks, demote from tiers past high-water, and
        prune dead heat records."""
        for cm, t in zip(self.costs, self.tiers):
            cm.observe(t)
        self._promote_pass()
        self._demote_pass()
        self._prune_heat()

    def _promote_pass(self) -> None:
        now = time.monotonic()
        plans: list[tuple[float, str]] = []
        with self._cond:
            for bid, e in self._entries.items():
                if e.refs > 0 or bid in self._deleting:
                    continue
                level = e.tier.level
                ceiling = self._entry_level(e.io_class)
                if level <= ceiling:
                    continue
                h = self._heat.get(bid)
                if h is None:
                    continue
                heat = h.value(now, self.half_life_s)
                if heat < self.promote_threshold:
                    continue
                if not self._worth_promoting(heat, e.size, level, level - 1):
                    continue
                plans.append((heat, bid))
        plans.sort(reverse=True)
        for _, bid in plans[: self.promote_batch]:
            self._promote(bid)

    def _worth_promoting(self, heat: float, size: int,
                         src: int, dst: int) -> bool:
        """Promote when the heat-weighted read-cost saving beats the move
        cost (read once from src + write once to dst ~ cost of both)."""
        saving = heat * (self.costs[src].cost(size) - self.costs[dst].cost(size))
        move_cost = self.costs[src].cost(size) + self.costs[dst].cost(size)
        return saving > move_cost

    def _promote(self, block_id: str) -> bool:
        with self._cond:
            e = self._entries.get(block_id)
            if e is None or e.refs > 0 or block_id in self._deleting:
                return False
            dst_level = e.tier.level - 1
            if dst_level < self._entry_level(e.io_class):
                return False
            del self._entries[block_id]
            self._evictable.pop(block_id, None)
            self._deleting.add(block_id)
        src = e.tier
        dst = self.tiers[dst_level]
        ok = False
        rotted = False
        try:
            if self._tier_reserve(dst_level, e.size, e.io_class):
                try:
                    data = src.read(block_id, 0, e.size)
                    _check_move(data, e.digest, block_id, "promotion")
                    dst.write(block_id, data)
                    dst.commit(e.size)
                    ok = True
                except IntegrityError as exc:
                    # Rotted in place: neither promote it NOR put it
                    # back. Quarantine — the entry stays gone, the tier
                    # copy is deleted below, the next read re-fetches.
                    dst.cancel(e.size)
                    rotted = True
                    with self._cond:
                        self.moves_failed += 1
                        self.quarantined += 1
                    log.warning("promotion of %s: copy is corrupt, "
                                "quarantining: %s", block_id, exc)
                except Exception as exc:   # repro: allow[RP005] — keep in place
                    dst.cancel(e.size)
                    with self._cond:
                        self.moves_failed += 1
                    log.warning("promotion of %s to %s failed: %s",
                                block_id, dst.name, exc)
        finally:
            with self._cond:
                if ok:
                    ne = _IndexEntry(dst, e.size, refs=0, io_class=e.io_class,
                                     digest=e.digest)
                    self._entries[block_id] = ne
                    self._note_evictable(block_id, ne)
                    self.promotions += 1
                elif not rotted:
                    self._entries[block_id] = e
                    self._note_evictable(block_id, e)
                self._deleting.discard(block_id)
                self._cond.notify_all()
        if ok or rotted:
            self._delete_from_tier(src, block_id, e.size)
        return ok

    def _demote_pass(self) -> None:
        for tier in self.tiers[:-1]:
            high = int(self.demote_watermark * tier.capacity)
            excess = tier.used - high
            if excess > 0:
                # Default-class pressure: demotes cold unprotected blocks,
                # leaves the protected hot set in place.
                self.evict_from(tier, excess, requester="default")

    def _prune_heat(self) -> None:
        now = time.monotonic()
        with self._cond:
            dead = [bid for bid, h in self._heat.items()
                    if bid not in self._entries
                    and bid not in self._flights
                    and h.value(now, self.half_life_s) < 0.05]
            for bid in dead:
                del self._heat[bid]

    # -- introspection --------------------------------------------------------
    def heat_of(self, block_id: str) -> float:
        """Current decayed temperature of a block (0.0 when untracked)."""
        now = time.monotonic()
        with self._cond:
            h = self._heat.get(block_id)
            return h.value(now, self.half_life_s) if h is not None else 0.0

    def level_of(self, block_id: str) -> int | None:
        """Hierarchy level currently holding the block (None = absent)."""
        with self._cond:
            e = self._entries.get(block_id)
            return e.tier.level if e is not None else None

    def hsm_snapshot(self) -> dict:
        with self._cond:
            per_level = {}
            for e in self._entries.values():
                d = per_level.setdefault(
                    e.tier.name, {"blocks": 0, "bytes": 0})
                d["blocks"] += 1
                d["bytes"] += e.size
            return dict(
                promotions=self.promotions,
                demotions=self.demotions,
                evictions=self.evictions,
                forced_evictions=self.forced_evictions,
                moves_failed=self.moves_failed,
                tier_hits=dict(self.tier_hits),
                class_hits=dict(self.class_hits),
                resident_per_tier=per_level,
                heat_tracked=len(self._heat),
                costs={t.name: cm.snapshot()
                       for t, cm in zip(self.tiers, self.costs)},
            )

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["hsm"] = self.hsm_snapshot()
        return out


# --------------------------------------------------------------------------- #
# composite store
# --------------------------------------------------------------------------- #
class HSMStore(ObjectStore):
    """A backing `ObjectStore` bundled with its cache hierarchy.

    Pure delegation for the store protocol (the hierarchy caches *blocks*,
    which live above the store interface, in the engines); `PrefetchFS`
    recognizes the wrapper and adopts ``tiers`` + ``index``, reading
    through ``inner``. Built by the ``hsm://`` factory in
    ``repro_torch.io.stores`` or directly.
    """

    def __init__(self, inner: ObjectStore, tiers: list[CacheTier],
                 index: HSMIndex) -> None:
        self.inner = inner
        self.tiers = list(tiers)
        self.index = index

    # -- delegation ---------------------------------------------------------
    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        return self.inner.list_objects(prefix)

    def size(self, key: str) -> int:
        return self.inner.size(key)

    def get_range(self, key: str, start: int, end: int) -> bytes:
        return self.inner.get_range(key, start, end)

    def get_ranges(self, key: str, spans: list[tuple[int, int]]) -> list[bytes]:
        return self.inner.get_ranges(key, spans)

    def get_range_verified(self, key: str, start: int,
                           end: int) -> tuple[bytes, str]:
        return self.inner.get_range_verified(key, start, end)

    def get_ranges_verified(
        self, key: str, spans: list[tuple[int, int]],
    ) -> list[tuple[bytes, str]]:
        return self.inner.get_ranges_verified(key, spans)

    def digest_range(self, key: str, start: int, end: int) -> str:
        return self.inner.digest_range(key, start, end)

    def put(self, key: str, data: bytes) -> None:
        self.inner.put(key, data)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def get(self, key: str) -> bytes:
        return self.inner.get(key)

    def start_multipart(self, key: str) -> MultipartUpload:
        return self.inner.start_multipart(key)

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def close(self) -> None:
        """Stop the mover and release tier OS resources (persistent tiers
        keep their blocks on disk)."""
        self.index.close()
        for t in self.tiers:
            t.close()


# Default simulated device links for URI-assembled hierarchies (scaled
# Table-I-style constants; override per deployment by constructing tiers
# directly).
MEM_LINK = dict(latency_s=1.6e-6, bandwidth_Bps=2221e6)
DISK_LINK = dict(latency_s=1e-4, bandwidth_Bps=500e6)
SHARED_LINK = dict(latency_s=1e-3, bandwidth_Bps=200e6)

HSM_URI_PARAMS = {
    "mem", "disk", "shared", "backing",
    "half_life_s", "promote_threshold", "watermark", "mover_ms",
}


def _dir_spec(value: str, what: str) -> tuple[str, int]:
    """``/path:1GB`` -> (path, capacity). The LAST colon splits, so
    Windows drive letters survive."""
    path, sep, size = value.rpartition(":")
    if not sep or not path:
        raise ValueError(
            f"hsm:// {what} must be path:size (e.g. /scratch/cache:1GB), "
            f"got {value!r}"
        )
    return path, parse_size(size)


def build_hsm(uri, open_inner) -> HSMStore:
    """Assemble an `HSMStore` from a parsed ``hsm://`` `StoreURI`.

    Recognized params: ``mem=<size>``, ``disk=<path>:<size>``,
    ``shared=<path>:<size>`` (each optional, at least one required; level
    order is mem, disk, shared), ``backing=<uri>`` (required; a nested
    query string must be percent-encoded), and the tuning knobs
    ``half_life_s``, ``promote_threshold``, ``watermark``, ``mover_ms``
    (``mover_ms=0`` disables the background mover).

    ``open_inner`` resolves the backing URI (the store registry's
    ``open_store``, injected to keep this module free of the io layer).
    """
    uri.require_known_params(HSM_URI_PARAMS)
    backing = uri.params.get("backing")
    if not backing:
        raise ValueError("hsm:// URI needs backing=<store uri>")
    tiers: list[CacheTier] = []
    if "mem" in uri.params:
        cap = parse_size(uri.params["mem"])
        tiers.append(MemTier(
            cap,
            read_link=LinkModel(name="hsm.mem.r", **MEM_LINK),
            write_link=LinkModel(name="hsm.mem.w", **MEM_LINK),
            name="hsm.mem",
        ))
    if "disk" in uri.params:
        path, cap = _dir_spec(uri.params["disk"], "disk")
        tiers.append(DirTier(
            cap, root=path,
            read_link=LinkModel(name="hsm.disk.r", **DISK_LINK),
            write_link=LinkModel(name="hsm.disk.w", **DISK_LINK),
            name="hsm.disk",
        ))
    if "shared" in uri.params:
        path, cap = _dir_spec(uri.params["shared"], "shared")
        tiers.append(DirTier(
            cap, root=path,
            read_link=LinkModel(name="hsm.shared.r", **SHARED_LINK),
            write_link=LinkModel(name="hsm.shared.w", **SHARED_LINK),
            name="hsm.shared",
        ))
    if not tiers:
        raise ValueError(
            "hsm:// URI needs at least one tier (mem=, disk=, or shared=)"
        )
    mover_ms = uri.float_param("mover_ms", 500.0)
    index = HSMIndex(
        tiers,
        half_life_s=uri.float_param("half_life_s", 30.0) or 30.0,
        promote_threshold=uri.float_param("promote_threshold", 2.0) or 2.0,
        demote_watermark=uri.float_param("watermark", 0.9) or 0.9,
        mover_interval_s=(mover_ms / 1e3 if mover_ms else None),
    )
    return HSMStore(open_inner(backing), tiers, index)
