"""The uniform Reader protocol plus the direct (uncached) engine.

Every engine returned by `PrefetchFS.open`/`open_many` satisfies `Reader`:
sequential ``read``/``seek``/``tell``/``close`` over one logical byte
stream (the concatenation of the opened objects), a ``size`` property, and
a ``stats`` object with a ``snapshot()`` dict — the subset of the
S3Fs/fsspec file API the paper's applications use.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from repro_torch.core.plan import BlockPlan
from repro_torch.store.base import ObjectMeta, ObjectStore


@runtime_checkable
class Reader(Protocol):
    """File-object protocol shared by all engines."""

    @property
    def size(self) -> int: ...

    @property
    def closed(self) -> bool: ...

    def read(self, n: int = -1) -> bytes: ...

    def seek(self, offset: int, whence: int = 0) -> int: ...

    def tell(self) -> int: ...

    def close(self) -> None: ...


@dataclass
class DirectStats:
    requests: int = 0
    bytes_read: int = 0
    fetch_s: float = 0.0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class DirectReader:
    """Pass-through engine: every ``read`` becomes store range requests,
    no caching, no background threads. This is the random-access fallback
    (each request pays full store latency) and the control arm for
    benchmarks that want raw link behaviour."""

    def __init__(self, store: ObjectStore, files: list[ObjectMeta]) -> None:
        self.store = store
        # One "block" per file: the plan is used only for stream->file
        # offset math; requests are cut to exactly the bytes asked for.
        blocksize = max((m.size for m in files), default=1)
        self.plan = BlockPlan(files, max(1, blocksize))
        self.stats = DirectStats()
        self._pos = 0
        self._closed = False

    @property
    def size(self) -> int:
        return self.plan.total_bytes

    @property
    def closed(self) -> bool:
        return self._closed

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("read on closed file")
        if n < 0:
            n = self.size - self._pos
        end = min(self._pos + n, self.size)
        out = bytearray()
        while self._pos < end:
            block = self.plan.block_at(self._pos)
            lo = self._pos - block.global_start
            hi = min(end, block.global_end) - block.global_start
            t0 = time.perf_counter()
            data = self.store.get_range(block.key, block.start + lo,
                                        block.start + hi)
            self.stats.fetch_s += time.perf_counter() - t0
            self.stats.requests += 1
            out.extend(data)
            self._pos += len(data)
        self.stats.bytes_read += len(out)
        return bytes(out)

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 1:
            offset += self._pos
        elif whence == 2:
            offset += self.size
        if not 0 <= offset <= self.size:
            raise ValueError(f"seek out of range: {offset}")
        self._pos = offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "DirectReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
