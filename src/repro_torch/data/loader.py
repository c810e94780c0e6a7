"""PrefetchingDataLoader: the paper's technique as the training input path.

Two overlap levels, both instances of the paper's max(T_cloud, T_comp)
pipeline law:

  1. object store -> local cache tiers: readers come from the `PrefetchFS`
     facade, so `IOPolicy(engine="rolling")` masks S3-like latency/bandwidth
     inside step compute versus the S3Fs-style `engine="sequential"`
     baseline (any registered engine works);
  2. host RAM -> device memory: a background thread keeps `depth`
     batches in flight, each copied from pinned host memory on a side CUDA
     stream (`DeviceFeeder`).

Per-host sharding: host h of H streams shard files h::H, so a restarted
or replacement host recomputes its plan deterministically (fault
tolerance); the data cursor (files consumed, windows emitted) is
checkpointable and restorable.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tree
from repro_torch.data.tokens import TokenStreamReader
from repro_torch.io import IOPolicy, PrefetchFS
from repro_torch.store.base import ObjectMeta, ObjectStore
from repro_torch.store.tiers import CacheTier
from repro_torch.utils import get_logger

log = get_logger("data.loader")


@dataclass
class LoaderConfig:
    seq_len: int
    batch_size: int              # per-host batch
    mode: str | None = None      # DEPRECATED: use policy=IOPolicy(engine=...)
    blocksize: int = 8 << 20
    depth: int = 2               # device-feed pipeline depth
    host_id: int = 0
    num_hosts: int = 1
    hedge_timeout_s: float | None = None
    prefetch_depth: int = 1      # concurrent fetch streams (beyond paper)
    eviction_interval_s: float = 0.2
    autotune: bool = False
    # Epoch-to-epoch cache reuse: consumed blocks stay resident in the
    # tiers (LRU under capacity pressure) so the per-epoch stream reopen
    # starts warm — with a persistent DirTier, so does a restarted job.
    keep_cached: bool = False
    # Partition the file list per host (host h streams files h::H). Set
    # False when every host must see the FULL dataset in the same order
    # (e.g. evaluation sweeps, or data-parallel recipes that shard at the
    # batch level): over a `peer://` store the N-fold read does NOT
    # become N-fold WAN traffic — each block's home host performs the one
    # backing GET and siblings pull it over the LAN.
    shard_files: bool = True
    policy: IOPolicy | None = None   # reader policy (preferred over mode/...)

    def reader_policy(self) -> IOPolicy:
        """Effective `IOPolicy`: `policy` wins; otherwise one is assembled
        from the legacy per-field knobs (with a deprecation warning when the
        legacy `mode` string was passed)."""
        if self.mode is not None:
            # stacklevel 3: reader_policy <- loader __init__ <- user code.
            warnings.warn(
                "LoaderConfig(mode=...) is deprecated; pass "
                "policy=IOPolicy(engine=...) instead",
                DeprecationWarning,
                stacklevel=3,
            )
        if self.policy is not None:
            return self.policy
        return IOPolicy(
            engine=self.mode or "rolling",
            blocksize=self.blocksize,
            depth=self.prefetch_depth,
            eviction_interval_s=self.eviction_interval_s,
            hedge_timeout_s=self.hedge_timeout_s,
            autotune=self.autotune,
            keep_cached=self.keep_cached,
        )


@dataclass
class DataCursor:
    """Checkpointable input-stream position."""
    epoch: int = 0
    windows_emitted: int = 0

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "windows_emitted": self.windows_emitted}

    @classmethod
    def from_dict(cls, d: dict) -> "DataCursor":
        return cls(epoch=d["epoch"], windows_emitted=d["windows_emitted"])


class PrefetchingDataLoader:
    """Iterates (inputs, labels) numpy batches; optionally feeds devices."""

    def __init__(
        self,
        store: ObjectStore,
        files: list[ObjectMeta],
        tiers: list[CacheTier] | None,
        cfg: LoaderConfig,
        cursor: DataCursor | None = None,
    ) -> None:
        self.store = store
        self.cfg = cfg
        self.tiers = tiers
        self.my_files = (files[cfg.host_id :: cfg.num_hosts]
                         if cfg.shard_files else list(files))
        if not self.my_files:
            raise ValueError(f"host {cfg.host_id}: no files assigned")
        self.cursor = cursor or DataCursor()
        policy = cfg.reader_policy()
        if cfg.autotune and not policy.autotune:
            policy = policy.replace(autotune=True)
        if cfg.keep_cached and not policy.keep_cached:
            policy = policy.replace(keep_cached=True)
        if policy.io_class == "default":
            # Epoch sweeps are the canonical bulk-scan class: under an HSM
            # hierarchy they enter at the disk level and are
            # scan-resistant, so one epoch cannot flush the hot set. An
            # explicit io_class on the caller's policy wins.
            policy = policy.replace(io_class="loader")
        self.policy = policy
        # `tiers=None` lets the filesystem own placement: it builds its
        # default MemTier, or adopts the hierarchy of an `hsm://` store.
        self.fs = PrefetchFS(store, policy=self.policy, tiers=tiers)
        self._file = None
        self._reader = None

    @property
    def tuner(self):
        """The filesystem's closed-loop `BlockSizeTuner` (None unless
        autotune is on). The rolling engine feeds it observed request
        timings and reader compute gaps; `PrefetchFS` retunes blocksize
        and coalesce width from it on every per-epoch reopen."""
        return self.fs.tuner

    # -- stream management ------------------------------------------------
    def _open_stream(self):
        # With autotune on, PrefetchFS picks the Eq.-4 blocksize and
        # coalesce width per open — nothing to override here.
        f = self.fs.open_many(self.my_files)
        self._file = f
        self._reader = TokenStreamReader(f, f.size)

    def _close_stream(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._reader = None

    # -- iteration -----------------------------------------------------------
    def batches(self, max_batches: int | None = None):
        """Yield (inputs (B,S) int32, labels (B,S) int32); restarts from the
        cursor (skipping already-emitted windows after a resume)."""
        emitted = 0
        window = self.cfg.seq_len + 1
        skip = self.cursor.windows_emitted
        while max_batches is None or emitted < max_batches:
            if self._reader is None:
                self._open_stream()
            rows = []
            while len(rows) < self.cfg.batch_size:
                w = self._reader.read_window(window)
                if w is None:
                    self._close_stream()
                    self.cursor.epoch += 1
                    self.cursor.windows_emitted = 0
                    skip = 0
                    self._open_stream()
                    w = self._reader.read_window(window)
                    if w is None:
                        raise RuntimeError("dataset smaller than one window")
                if skip > 0:
                    skip -= 1
                    continue
                rows.append(w)
                self.cursor.windows_emitted += 1
            batch = np.stack(rows).astype(np.int32)
            yield batch[:, :-1], batch[:, 1:]
            emitted += 1

    def close(self) -> None:
        self._close_stream()
        self.fs.close()

    @property
    def stats(self):
        """Stats of the currently-open stream (engine-specific object)."""
        return getattr(self._file, "stats", None)

    def fs_stats(self):
        """Aggregated `FSStats` across every stream this loader opened
        (one per epoch)."""
        return self.fs.stats()


class DeviceFeeder:
    """Host->device double buffering: keeps `depth` batches resident on
    device ahead of the consumer (the second overlap level).

    A batch is a tree (`repro_torch.tree`) whose numpy arrays and tensors
    are moved to `device`; other leaves (a data cursor's ints, say) pass
    through as they are. On a CUDA device each array is copied into pinned
    host memory and then to the card by a `non_blocking` copy on a side
    stream, with an event recorded behind the batch's copies; the consumer's
    current stream waits on that event before the batch is handed out, so
    the copies overlap the consumer's compute and are ordered before its
    use of the batch. On the CPU the arrays become tensors by a plain copy.
    `observe(seconds)` is called with the host time each batch's transfer
    took to issue."""

    _STOP = object()

    def __init__(self, batch_iter, depth: int = 2, device="cuda",
                 observe=None) -> None:
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.device = torch.device(device)
        self.observe = observe
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._err: list[BaseException] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(batch_iter,), daemon=True
        )
        self._thread.start()

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        if self._stream is None:
            return x.to(self.device, copy=True)
        # The pinned buffer may be freed at once: PyTorch's host allocator
        # reuses it only after the copy out of it has completed.
        return x.pin_memory().to(self.device, non_blocking=True)

    def _transfer(self, host_batch):
        if self._stream is None:
            return tree.map_leaves(self._to_device, host_batch), None
        with torch.cuda.stream(self._stream):
            dev = tree.map_leaves(self._to_device, host_batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _run(self, batch_iter) -> None:
        try:
            for host_batch in batch_iter:
                if self._stop.is_set():
                    break
                t0 = time.perf_counter()
                item = self._transfer(host_batch)
                if self.observe:
                    self.observe(time.perf_counter() - t0)
                self.q.put(item)
        except BaseException as e:  # repro: allow[RP005] — stashed; __iter__ re-raises
            self._err.append(e)
        finally:
            self.q.put(self._STOP)

    def close(self) -> None:
        """Stop the feeder thread and reap it. Safe to call repeatedly;
        also called automatically when the iterator is exhausted."""
        self._stop.set()
        # The feeder may be parked in q.put() with the queue full; drain
        # until it observes the stop flag and posts the sentinel.
        while self._thread.is_alive():
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._STOP:
                self._thread.join()
                if self._err:
                    raise self._err[0]
                return
            dev, done = item
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                # The batch was allocated on the side stream: its memory
                # must not return to that stream's pool while the
                # consumer's stream may still read it.
                for t in tree.flatten(dev):
                    if isinstance(t, torch.Tensor):
                        t.record_stream(current)
            yield dev
