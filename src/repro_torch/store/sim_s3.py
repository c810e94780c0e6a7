"""Simulated S3: a MemStore (or any backing store) behind a LinkModel.

Reproduces the cost structure of the paper's measurements: every request
pays `latency_s`, payload pays `bytes / bandwidth_Bps` on a shared link.
Failure injection on the link drives the fault-tolerance tests.
"""

from __future__ import annotations

from repro_torch.store.base import (
    MultipartUpload,
    ObjectMeta,
    ObjectStore,
    adjacent_runs,
)
from repro_torch.store.link import LinkModel
from repro_torch.store.local import MemStore


class _SimS3MultipartUpload(MultipartUpload):
    """S3-shaped multipart cost model: each part pays the put link when it
    uploads (so concurrent part uploads overlap latency exactly like
    concurrent GETs), and completion is server-side assembly — one
    latency-only request, no payload re-transfer."""

    def _charge_part(self, data: bytes) -> None:
        self.store.put_link.transfer(len(data))

    def _publish(self, data: bytes) -> None:
        self.store.put_link.transfer(0)
        self.store.backing.put(self.key, data)


class SimS3Store(ObjectStore):
    def __init__(
        self,
        link: LinkModel | None = None,
        backing: ObjectStore | None = None,
        put_link: LinkModel | None = None,
    ) -> None:
        self.link = link if link is not None else LinkModel(name="s3")
        self.put_link = put_link if put_link is not None else self.link
        self.backing = backing if backing is not None else MemStore()

    # Metadata ops are modeled as one-latency requests with tiny payloads.
    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        self.link.transfer(0)
        return self.backing.list_objects(prefix)

    def size(self, key: str) -> int:
        # HEAD request: latency only.
        self.link.transfer(0)
        return self.backing.size(key)

    def get_range(self, key: str, start: int, end: int) -> bytes:
        data = self.backing.get_range(key, start, end)
        self.link.transfer(len(data))
        return data

    def get_ranges(self, key: str, spans: list[tuple[int, int]]) -> list[bytes]:
        """Coalesced range GET: every maximal run of adjacent spans is one
        request — one `latency_s` for the whole run, payload charged once
        at the run's total size (an S3 `Range: a-b` header covering the
        run). Non-adjacent runs each pay their own request."""
        out: list[bytes] = []
        for run in adjacent_runs(spans):
            start, end = run[0][0], run[-1][1]
            data = self.backing.get_range(key, start, end)
            self.link.transfer(len(data), spans=len(run))
            if len(run) == 1:
                out.append(data)
            else:
                out.extend(data[s - start:e - start] for s, e in run)
        return out

    def get(self, key: str) -> bytes:
        # Whole-object GET: one request, no HEAD round-trip for the size.
        data = self.backing.get(key)
        self.link.transfer(len(data))
        return data

    def put(self, key: str, data: bytes) -> None:
        self.put_link.transfer(len(data))
        self.backing.put(key, data)

    def start_multipart(self, key: str) -> MultipartUpload:
        return _SimS3MultipartUpload(self, key)

    def delete(self, key: str) -> None:
        self.link.transfer(0)
        self.backing.delete(key)
