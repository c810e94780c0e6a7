"""Block plan: a logical byte stream over a list of objects.

Rolling Prefetch treats a list of sharded files as one sequential stream
(the paper: "only Rolling Prefetch is capable of treating a list of files
as a single file"). The plan maps the stream to per-file, block-aligned
ranges — the unit of prefetch, caching, and eviction.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from repro_torch.store.base import ObjectMeta
from repro_torch.utils.hashing import rendezvous_owner


@dataclass(frozen=True)
class Block:
    index: int          # global block index in prefetch order
    file_index: int
    key: str
    start: int          # offset within the file
    end: int            # exclusive
    global_start: int   # offset within the logical stream

    @property
    def size(self) -> int:
        return self.end - self.start

    @property
    def global_end(self) -> int:
        return self.global_start + self.size

    @property
    def block_id(self) -> str:
        # Content-addressed (key + byte range), NOT plan-relative: two
        # readers with different file lists — or a restarted job — derive
        # the same id for the same stored bytes, which is what lets the
        # shared CacheIndex and a recovered persistent DirTier serve them
        # without re-fetching.
        return f"{self.key}@{self.start:015d}-{self.end:015d}"


class BlockPlan:
    """Block-aligned decomposition of a list of objects.

    Blocks never span files (matching the paper: each file is fetched in
    `blocksize` pieces; the last piece of each file may be short).
    """

    def __init__(self, files: list[ObjectMeta], blocksize: int) -> None:
        if blocksize <= 0:
            raise ValueError(f"blocksize must be positive, got {blocksize}")
        self.files = list(files)
        self.blocksize = blocksize
        self.blocks: list[Block] = []
        self._file_global_start: list[int] = []
        offset = 0
        for fi, meta in enumerate(self.files):
            self._file_global_start.append(offset)
            pos = 0
            while pos < meta.size:
                end = min(pos + blocksize, meta.size)
                self.blocks.append(
                    Block(
                        index=len(self.blocks),
                        file_index=fi,
                        key=meta.key,
                        start=pos,
                        end=end,
                        global_start=offset + pos,
                    )
                )
                pos = end
            offset += meta.size
        self.total_bytes = offset
        self._block_global_starts = [b.global_start for b in self.blocks]

    def __len__(self) -> int:
        return len(self.blocks)

    def block_at(self, global_offset: int) -> Block:
        """Block containing the logical-stream offset."""
        if not 0 <= global_offset < self.total_bytes:
            raise IndexError(
                f"offset {global_offset} outside stream of {self.total_bytes} bytes"
            )
        i = bisect.bisect_right(self._block_global_starts, global_offset) - 1
        return self.blocks[i]

    def file_range(self, file_index: int) -> tuple[int, int]:
        """Logical-stream [start, end) of one file."""
        start = self._file_global_start[file_index]
        size = self.files[file_index].size
        return start, start + size

    def shard(self, host_id: int, num_hosts: int) -> list[Block]:
        """The sub-plan host `host_id` of `num_hosts` owns — the unit one
        host of a mesh prefetches, with the rest of the stream filled
        from its peers.

        Ownership is rendezvous-hashed on the content-addressed block id,
        NOT striped by block index: it is the same function
        `repro_torch.peer.PeerGroup` routes remote reads with, so when every
        host warms its own shard, each block is already resident on
        exactly the host its siblings will ask for it — N hosts reading
        one dataset pay ~1x (not Nx) backing-store GETs. Hash ownership
        also survives membership changes the way striping cannot: a dead
        host's blocks redistribute uniformly over the survivors while
        every other block keeps its owner.
        """
        if num_hosts <= 0:
            raise ValueError(f"num_hosts must be positive, got {num_hosts}")
        if not 0 <= host_id < num_hosts:
            raise ValueError(
                f"host_id must be in [0, {num_hosts}), got {host_id}"
            )
        hosts = range(num_hosts)
        return [b for b in self.blocks
                if rendezvous_owner(b.block_id, hosts) == host_id]

    def run_from(self, index: int, max_width: int,
                 limit: int | None = None) -> list[Block]:
        """Maximal run of byte-adjacent same-file blocks starting at
        `index`, at most `max_width` long and stopping before block index
        `limit` — the unit the adaptive scheduler fetches with one
        coalesced `get_ranges` request."""
        run = [self.blocks[index]]
        while len(run) < max_width:
            j = run[-1].index + 1
            if j >= len(self.blocks) or (limit is not None and j >= limit):
                break
            nxt = self.blocks[j]
            if nxt.key != run[-1].key or nxt.start != run[-1].end:
                break
            run.append(nxt)
        return run
