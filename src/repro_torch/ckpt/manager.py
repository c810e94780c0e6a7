"""Sharded checkpointing to the object store, with Rolling-Prefetch restore
and write-behind save, for trees of PyTorch tensors.

The checkpoint format is the JAX package's, byte for byte, so either
package restores what the other saved: every state leaf serializes to one
object under ``{prefix}/step_{N:08d}/`` as raw little-endian bytes, and
the manifest (shape, numpy dtype name and digest per leaf) is written
LAST and is the atomic commit point — a crash mid-save leaves no visible
checkpoint. Leaves are numbered in the order `jax.tree_util` flattens a
tree (`repro_torch.tree`): dict keys sorted at every level, tuple and
NamedTuple fields in order, so a port `TrainState` and the JAX package's
number their leaves alike. Leaf bytes flow through
``PrefetchFS.open_write``: serializing leaf k+1 overlaps with uploading
leaf k, and ``IOPolicy.write_depth`` part uploads run concurrently.

Stores may be passed as `ObjectStore` instances, `PrefetchFS` facades, or
registry URIs (``"sims3://ckpt?latency_ms=10"``) — see
``repro_torch.io.open_store``.

Restore: the leaf objects form exactly the sequential multi-file stream
Rolling Prefetch was built for; they stream through the `PrefetchFS`
facade. `policy=IOPolicy(engine="rolling")` (the default) runs the
three-thread engine, so fetching leaf k+1..k+d from the store overlaps
with checking and copying leaf k. On a CUDA device each leaf goes through
a ring of pinned staging buffers and an asynchronous host-to-device copy
on a side stream, so the copy of leaf k also overlaps the fetch and digest
check of leaf k+1. `engine="sequential"` is the S3Fs-style baseline.
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.io import IOPolicy, PrefetchFS, open_store
from repro_torch.io.integrity import block_digest, check_block
from repro_torch.io.retry import Retrier, RetryPolicy
from repro_torch.store.base import ObjectMeta, ObjectStore
from repro_torch.store.tiers import CacheTier
from repro_torch.tree import flatten as _flatten
from repro_torch.tree import unflatten as _unflatten
from repro_torch.utils import get_logger

log = get_logger("ckpt")

MANIFEST = "MANIFEST.json"

# Metadata ops (list/size/get-manifest) retry through the shared
# resilience layer — full-jitter backoff, so a fleet of restarting
# workers hitting the same manifest does not re-collide in one backoff
# window. Bulk leaf reads retry inside the reader engines themselves.
META_RETRY = RetryPolicy(max_retries=4, backoff_s=0.02, backoff_cap_s=1.0)

# ONE long-lived executor for the default policy: the Retrier's state
# (seeded jitter rng, retry budget, telemetry) is designed to span calls
# — a fresh instance per metadata op would silently degrade a policy
# budget to a per-call cap.
_META_RETRIER = Retrier(META_RETRY)

# The manifest names dtypes as numpy does (ml_dtypes' names for bfloat16
# and the fp8 types), and torch uses the same names.
_DTYPES = {name: getattr(torch, name) for name in (
    "bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32",
    "int64", "float16", "bfloat16", "float32", "float64", "complex64",
    "complex128", "float8_e4m3fn", "float8_e5m2",
)}
_DTYPE_NAMES = {dt: name for name, dt in _DTYPES.items()}

# Host-to-device restore: a ring of pinned buffers, each reused only after
# the copy out of it has completed. Leaves larger than one buffer go
# through in pieces.
STAGING_SLOTS = 2
STAGING_BYTES = 32 << 20


def _with_retries(fn, *, policy: RetryPolicy = META_RETRY):
    retrier = _META_RETRIER if policy is META_RETRY else Retrier(policy)
    return retrier.call(fn, label="checkpoint metadata")


def _step_prefix(prefix: str, step: int) -> str:
    return f"{prefix}/step_{step:08d}"


def _leaf_key(prefix: str, step: int, idx: int) -> str:
    return f"{_step_prefix(prefix, step)}/{idx:06d}.raw"


def _dtype_from_str(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"checkpoint dtype {name!r} has no torch counterpart") from None


def _byte_view(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous CPU tensor, as a writable uint8 array that
    shares its memory (any dtype, 0-d included)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _host_bytes(leaf) -> tuple[bytes, list[int], str]:
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"checkpoint leaves must be tensors, got {type(leaf).__name__}")
    t = leaf.detach().cpu().contiguous()
    return _byte_view(t).tobytes(), list(t.shape), _DTYPE_NAMES[t.dtype]


def save_checkpoint(
    store: ObjectStore | PrefetchFS | str,
    prefix: str,
    step: int,
    state,
    *,
    extra: dict | None = None,
    policy: IOPolicy | None = None,
) -> dict:
    """Blocking save; returns the manifest.

    Leaf objects stream through the write-behind pipeline
    (`PrefetchFS.open_write`): every leaf writer is opened and written in
    serialization order but closed only after the last leaf, so uploads
    overlap with serializing subsequent leaves. The manifest writer closes
    after every leaf writer — the commit point stays manifest-last and the
    stored bytes are identical to a synchronous per-leaf ``put``.
    ``policy`` carries the write knobs (``write_depth``, ``blocksize`` as
    part size, retries/hedging); `store` may be an `ObjectStore`, an
    already-open `PrefetchFS`, or a store URI.
    """
    leaves = _flatten(state)
    own_fs = not isinstance(store, PrefetchFS)
    fs = PrefetchFS(store, policy=policy) if own_fs else store
    entries = []
    writers = []
    try:
        for idx, leaf in enumerate(leaves):
            raw, shape, dtype = _host_bytes(leaf)
            key = _leaf_key(prefix, step, idx)
            w = fs.open_write(key, policy=policy)
            w.write(raw)
            w.close_async()   # publish in the background, barrier below
            writers.append(w)
            # Per-leaf digest: restore verifies the streamed bytes against
            # the manifest, so a leaf corrupted anywhere between this
            # serialization and a later restore fails loudly instead of
            # resuming from silently wrong weights.
            entries.append(
                dict(key=key, shape=shape, dtype=dtype, digest=block_digest(raw))
            )
        for w in writers:   # durability barrier: all leaves published
            w.join()
        manifest = dict(
            step=step,
            leaves=entries,
            extra=extra or {},
            format_version=1,
            saved_unix_time=time.time(),
        )
        with fs.open_write(f"{_step_prefix(prefix, step)}/{MANIFEST}",
                           policy=policy) as w:
            w.write(json.dumps(manifest).encode())
        return manifest
    except BaseException:
        # A failed save must stay invisible: drop in-flight leaf uploads;
        # without a manifest the step can never be restored.
        for w in writers:
            with contextlib.suppress(Exception):
                w.abort()
        raise
    finally:
        if own_fs:
            with contextlib.suppress(Exception):
                fs.close()


def latest_step(store: ObjectStore | str, prefix: str) -> int | None:
    """Largest step with a committed manifest."""
    store = open_store(store)
    best = None
    pat = re.compile(re.escape(prefix) + r"/step_(\d+)/" + re.escape(MANIFEST) + "$")
    for meta in _with_retries(lambda: store.list_objects(prefix)):
        m = pat.match(meta.key)
        if m:
            s = int(m.group(1))
            best = s if best is None or s > best else best
    return best


def _load_manifest(store: ObjectStore, prefix: str, step: int) -> dict:
    return json.loads(
        _with_retries(lambda: store.get(f"{_step_prefix(prefix, step)}/{MANIFEST}"))
    )


def _warm_shard(fs: PrefetchFS, files: list[ObjectMeta],
                policy: IOPolicy, shard: tuple[int, int]) -> None:
    """Pre-read this host's rendezvous-owned blocks of the restore stream
    into the (shared, keep_cached) cache. The warm reader uses the SAME
    blocksize as the main stream, so the published block ids are exactly
    the content-addressed ids sibling hosts' peer fetches arrive with."""
    from repro_torch.core.plan import BlockPlan

    host_id, num_hosts = shard
    if num_hosts <= 1:
        return   # a 1-host "mesh" owns everything; the stream warms itself
    mine = BlockPlan(files, policy.blocksize).shard(host_id, num_hosts)
    if not mine:
        return
    warm = fs.open_many(files, engine="sequential", depth=1,
                        keep_cached=True)
    try:
        for b in mine:
            warm.seek(b.global_start)
            warm.read(b.size)
    finally:
        warm.close()
    log.info("restore shard %d/%d warmed %d blocks (%.1f MiB)",
             host_id, num_hosts, len(mine),
             sum(b.size for b in mine) / (1 << 20))


class _DeviceStager:
    """Host-to-device copies through `STAGING_SLOTS` pinned buffers on a
    side CUDA stream. A slot is refilled only after the event recorded
    behind the copy out of it has completed, so the host copy of the next
    piece overlaps the device copy of the previous one, and both overlap
    the reader's prefetch."""

    def __init__(self, device: torch.device, largest: int) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)
        # The destinations were allocated on the current stream: order
        # the side stream's writes after whatever that stream last did
        # with the same memory.
        self.stream.wait_stream(torch.cuda.current_stream(device))
        size = max(1, min(STAGING_BYTES, largest))
        self.slots = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                      for _ in range(STAGING_SLOTS)]
        self.events: list[torch.cuda.Event | None] = [None] * STAGING_SLOTS
        self.next = 0
        self.stage_s = 0.0      # host copies into the pinned buffers
        self.wait_s = 0.0       # waiting for a slot's device copy

    def _wait(self, slot: int) -> None:
        ev = self.events[slot]
        if ev is not None:
            t0 = time.perf_counter()
            ev.synchronize()
            self.wait_s += time.perf_counter() - t0
            self.events[slot] = None

    def copy(self, raw, dst: torch.Tensor) -> None:
        src = np.frombuffer(raw, dtype=np.uint8)
        out = dst.reshape(-1).view(torch.uint8)
        cap = self.slots[0].numel()
        for off in range(0, src.size, cap):
            n = min(cap, src.size - off)
            slot = self.next
            self.next = (slot + 1) % STAGING_SLOTS
            self._wait(slot)
            buf = self.slots[slot]
            t0 = time.perf_counter()
            _byte_view(buf)[:n] = src[off:off + n]
            self.stage_s += time.perf_counter() - t0
            with torch.cuda.stream(self.stream):
                out[off:off + n].copy_(buf[:n], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self.events[slot] = ev

    def finish(self) -> None:
        """Wait for every copy (the pinned buffers die with this object)
        and order the current stream after the side stream."""
        for slot in range(STAGING_SLOTS):
            self._wait(slot)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)


def restore_checkpoint(
    store: ObjectStore | str,
    prefix: str,
    template,
    *,
    step: int | None = None,
    policy: IOPolicy | None = None,
    mode: str | None = None,
    tiers: list[CacheTier] | None = None,
    cache_dir: str | None = None,
    cache_capacity: int | None = None,
    blocksize: int = 8 << 20,
    prefetch_depth: int = 2,
    shard: tuple[int, int] | None = None,
    device="cuda",
):
    """Restore into the structure of `template` (a tree of dicts, tuples and
    NamedTuples, see `repro_torch.tree`, whose leaves may be tensors or
    ``meta`` tensors: only the structure is used; shapes
    and dtypes come from the manifest). Returns (state, manifest), every
    leaf a new tensor on `device`. A CUDA device that cannot be reached
    raises; there is no CPU fallback.

    Leaf bytes stream through `PrefetchFS`; pass ``policy`` to select the
    reader engine and its knobs. ``mode``/``blocksize``/``prefetch_depth``
    are the deprecated pre-facade spelling and are folded into a policy
    when no explicit ``policy`` is given.

    ``cache_dir`` makes the restore crash-warm: leaf blocks cache in a
    persistent journaled `DirTier` under that directory and stay resident
    after the restore (``keep_cached``), so a restarted job — a replaced
    serve replica, a preempted trainer — restores the same step with zero
    store GETs for every block that survived on local disk. The journal's
    checksums discard torn blocks from a mid-write crash.
    ``cache_capacity`` bounds the directory (default: 4x blocksize or
    256 MiB, whichever is larger).

    ``shard=(host_id, num_hosts)`` makes the restore mesh-aware: before
    the full stream, the host warms ONLY its rendezvous-owned sub-plan
    (`BlockPlan.shard`) into the cache — the exact blocks its siblings'
    peer layers will route to it — and ``keep_cached`` is forced so the
    warmed blocks stay servable. Over a ``peer://`` store, every host
    then restores the full state while the backing store is read ~once
    in aggregate: each block's WAN fetch happens on its one home host,
    everything else moves over the LAN. Without a peer store the shard
    warm pass is still correct, just not shared.

    The time the restore spent waiting on the reader, checking digests,
    copying into host memory and waiting on host-to-device copies is
    logged at info level and attached to that record as
    ``restore_split`` (a dict of seconds).
    """
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"restore onto {device} is not supported (cpu or cuda)")
    store = open_store(store)
    warm_cache = cache_dir is not None and tiers is None
    if warm_cache:
        from repro_torch.store.tiers import DirTier

        cap = cache_capacity
        if cap is None:
            bs = policy.blocksize if policy is not None else blocksize
            cap = max(4 * bs, 256 << 20)
        tiers = [DirTier(cap, root=cache_dir, name="ckpt.cache")]
    # Everything past tier construction runs under the finally that
    # releases the cache root's advisory lock — a missing manifest or a
    # failed metadata call must not leak the lock in a long-lived process
    # (the retry's DirTier would silently become a non-owner).
    try:
        if mode is not None:
            warnings.warn(
                "restore_checkpoint(mode=...) is deprecated; pass "
                "policy=IOPolicy(engine=...) instead",
                DeprecationWarning,
                stacklevel=2,
            )
        if policy is None:
            policy = IOPolicy(
                engine=mode or "rolling",
                blocksize=blocksize,
                depth=prefetch_depth,
                eviction_interval_s=0.2,
            )
        if policy.io_class == "default":
            # Restore streams are the checkpoint workload class (top-tier
            # HSM admission); an explicit io_class — e.g. "serve" from
            # `ServeEngine.from_store` — wins.
            policy = policy.replace(io_class="ckpt")
        if (warm_cache or shard is not None) and not policy.keep_cached:
            # Sharded restore serves warmed blocks to siblings: they must
            # outlive their own consumption.
            policy = policy.replace(keep_cached=True)
        if step is None:
            step = latest_step(store, prefix)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {prefix!r}")
        manifest = _load_manifest(store, prefix, step)
        t_leaves = _flatten(template)
        entries = manifest["leaves"]
        if len(entries) != len(t_leaves):
            raise ValueError(
                f"template has {len(t_leaves)} leaves, checkpoint {len(entries)}"
            )

        files = [
            ObjectMeta(e["key"], _with_retries(lambda k=e["key"]: store.size(k)))
            for e in entries
        ]
        # Every destination exists before the first byte arrives, so a
        # leaf's bytes go straight from the stream to their tensor.
        out = [torch.empty(e["shape"], dtype=_dtype_from_str(e["dtype"]), device=device)
               for e in entries]
        for meta, entry, t in zip(files, entries, out):
            if meta.size != t.numel() * t.element_size():
                raise ValueError(
                    f"checkpoint leaf {entry['key']}: {meta.size} bytes, manifest "
                    f"{entry['dtype']}{entry['shape']} needs {t.numel() * t.element_size()}"
                )
        stager = (_DeviceStager(device, max((m.size for m in files), default=0))
                  if device.type == "cuda" else None)
        split = dict(reader_s=0.0, digest_s=0.0, stage_s=0.0, h2d_wait_s=0.0)
        t_start = time.perf_counter()
        with PrefetchFS(store, policy=policy, tiers=tiers) as fs:
            if shard is not None:
                _warm_shard(fs, files, policy, shard)
            stream = fs.open_many(files)
            read = getattr(stream, "readview", stream.read)
            try:
                for meta, entry, dst in zip(files, entries, out):
                    t0 = time.perf_counter()
                    # readview: a zero-copy view of the cached block when
                    # the leaf lies inside one; it is copied out below,
                    # never aliased by the returned tensor.
                    raw = read(meta.size)
                    t1 = time.perf_counter()
                    split["reader_s"] += t1 - t0
                    if policy.verify != "off":
                        # End-to-end: the digest minted over the serialized
                        # leaf at save time must match the bytes about to
                        # become model state — whatever path they took
                        # (store, cache tiers). Manifests predating digests
                        # verify nothing (entry.get -> None).
                        check_block(raw, entry.get("digest"),
                                    what=f"checkpoint leaf {entry['key']}")
                    t2 = time.perf_counter()
                    split["digest_s"] += t2 - t1
                    if stager is None:
                        _byte_view(dst)[:] = np.frombuffer(raw, dtype=np.uint8)
                        split["stage_s"] += time.perf_counter() - t2
                    else:
                        stager.copy(raw, dst)
            finally:
                if stager is not None:
                    # Also on a failed restore: no copy may still read a
                    # staging buffer once the stager is gone.
                    stager.finish()
                    split["stage_s"] = stager.stage_s
                    split["h2d_wait_s"] = stager.wait_s
        split["total_s"] = time.perf_counter() - t_start
        log.info("restored step %d: %d leaves, %.1f MiB onto %s in %.3fs "
                 "(reader %.3fs, digest %.3fs, staging %.3fs, host-to-device "
                 "wait %.3fs)", step, len(out), sum(m.size for m in files) / (1 << 20),
                 device, split["total_s"], split["reader_s"], split["digest_s"],
                 split["stage_s"], split["h2d_wait_s"], extra={"restore_split": split})
    finally:
        if warm_cache:
            # Release the lock; blocks stay on disk for the next —
            # possibly warm — restore.
            for t in tiers:
                with contextlib.suppress(Exception):
                    t.close()
    return _unflatten(template, iter(out)), manifest


def gc_checkpoints(store: ObjectStore | str, prefix: str,
                   keep_last: int = 3) -> int:
    """Delete all but the newest `keep_last` committed checkpoints."""
    store = open_store(store)
    steps = sorted(
        {
            int(m.group(1))
            for meta in store.list_objects(prefix)
            if (m := re.match(re.escape(prefix) + r"/step_(\d+)/", meta.key))
        }
    )
    deleted = 0
    for s in steps[:-keep_last] if keep_last else steps:
        for meta in store.list_objects(_step_prefix(prefix, s)):
            store.delete(meta.key)
            deleted += 1
    return deleted


@dataclass
class CheckpointManager:
    """Periodic async checkpointing for the train loop. `store` may be an
    `ObjectStore` or a registry URI; `policy` forwards write-behind knobs
    to `save_checkpoint`."""

    store: ObjectStore | str
    prefix: str
    interval_steps: int = 100
    keep_last: int = 3
    policy: IOPolicy | None = None

    def __post_init__(self) -> None:
        self.store = open_store(self.store)
        self._thread: threading.Thread | None = None
        self._err: list[BaseException] = []

    def maybe_save(self, step: int, state, *, extra: dict | None = None,
                   force: bool = False) -> bool:
        if not force and (step == 0 or step % self.interval_steps != 0):
            return False
        self.wait()
        # Snapshot synchronously into host copies, upload in background —
        # training continues (and may update its tensors in place) while
        # bytes stream to the store.
        snapshot = _unflatten(state, iter(
            leaf.detach().to("cpu", copy=True) for leaf in _flatten(state)))

        def upload() -> None:
            try:
                save_checkpoint(self.store, self.prefix, step, snapshot,
                                extra=extra, policy=self.policy)
                gc_checkpoints(self.store, self.prefix, self.keep_last)
            except BaseException as e:  # repro: allow[RP005] — stashed; wait() re-raises
                self._err.append(e)

        self._thread = threading.Thread(target=upload, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            raise self._err[0]
