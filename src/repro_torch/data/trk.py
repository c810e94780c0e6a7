"""Streamline (.trk-style) codec — the paper's data format.

Files carry a fixed 1000-byte header and a body of variable-length
streamline records: int32 point count, then npoints x 3 float32
coordinates, then n_properties float32 per-streamline properties
(paper §II-C). The reader is nibabel-like: a lazy generator over any
file-like object (any `repro_torch.io.Reader` from `PrefetchFS.open`, or a
plain BytesIO), issuing
one small read per record section — reproducing the paper's observation
that "Nibabel reads may incur significant overhead: three read calls for
each streamline" — and always applying the header affine to coordinates
("some amount of compute is always executed when data is read").
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

HEADER_SIZE = 1000
MAGIC = b"TRKR"
_HDR = struct.Struct("<4sIII")  # magic, version, n_count, n_properties
_AFFINE_OFFSET = 16             # affine stored right after the fixed fields


@dataclass
class TrkHeader:
    n_count: int
    n_properties: int
    affine: np.ndarray  # (4, 4) float32
    version: int = 1

    def to_bytes(self) -> bytes:
        buf = bytearray(HEADER_SIZE)
        _HDR.pack_into(buf, 0, MAGIC, self.version, self.n_count,
                       self.n_properties)
        buf[_AFFINE_OFFSET:_AFFINE_OFFSET + 64] = (
            self.affine.astype("<f4").tobytes()
        )
        return bytes(buf)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TrkHeader":
        if len(raw) < HEADER_SIZE:
            raise ValueError(f"truncated header: {len(raw)} bytes")
        magic, version, n_count, n_props = _HDR.unpack_from(raw, 0)
        if magic != MAGIC:
            raise ValueError(f"bad magic: {magic!r}")
        affine = np.frombuffer(
            raw, dtype="<f4", count=16, offset=_AFFINE_OFFSET
        ).reshape(4, 4).copy()
        return cls(n_count=n_count, n_properties=n_props, affine=affine,
                   version=version)


@dataclass
class Streamline:
    points: np.ndarray       # (n, 3) float32, affine-transformed
    properties: np.ndarray   # (n_properties,) float32


def write_trk(
    streamlines: list[tuple[np.ndarray, np.ndarray]],
    *,
    affine: np.ndarray | None = None,
    n_properties: int | None = None,
) -> bytes:
    """Serialize [(points (n,3), properties (p,)), ...] to .trk bytes."""
    if affine is None:
        affine = np.eye(4, dtype=np.float32)
    if n_properties is None:
        n_properties = len(streamlines[0][1]) if streamlines else 0
    out = io.BytesIO()
    out.write(
        TrkHeader(
            n_count=len(streamlines), n_properties=n_properties, affine=affine
        ).to_bytes()
    )
    for points, props in streamlines:
        points = np.asarray(points, dtype="<f4").reshape(-1, 3)
        props = np.asarray(props, dtype="<f4").reshape(-1)
        if len(props) != n_properties:
            raise ValueError(f"expected {n_properties} properties, got {len(props)}")
        out.write(struct.pack("<i", points.shape[0]))
        out.write(points.tobytes())
        out.write(props.tobytes())
    return out.getvalue()


def synth_trk(
    rng: np.random.Generator,
    n_streamlines: int,
    *,
    mean_points: int = 40,
    n_properties: int = 2,
) -> bytes:
    """Synthetic tractography shard (benchmark data generator)."""
    affine = np.eye(4, dtype=np.float32)
    affine[:3, 3] = rng.normal(size=3).astype(np.float32)
    streamlines = []
    for _ in range(n_streamlines):
        n = max(3, int(rng.poisson(mean_points)))
        pts = rng.normal(size=(n, 3)).astype(np.float32).cumsum(axis=0)
        props = rng.normal(size=n_properties).astype(np.float32)
        streamlines.append((pts, props))
    return write_trk(streamlines, affine=affine, n_properties=n_properties)


class LazyTrkReader:
    """Nibabel-style lazy streamline iterator over a file-like object.

    Reads the 1000-byte header eagerly; `streamlines()` yields one record
    at a time with three reads per record (count, points, properties) and
    applies the affine to every coordinate.
    """

    def __init__(self, fileobj) -> None:
        self.f = fileobj
        self.header = TrkHeader.from_bytes(fileobj.read(HEADER_SIZE))
        self._rot = self.header.affine[:3, :3].astype(np.float32)
        self._trans = self.header.affine[:3, 3].astype(np.float32)

    def streamlines(self) -> Iterator[Streamline]:
        n_props = self.header.n_properties
        for _ in range(self.header.n_count):
            raw_n = self.f.read(4)
            if len(raw_n) < 4:
                return  # truncated (multi-file stream boundary handled upstream)
            (npoints,) = struct.unpack("<i", raw_n)
            pts = np.frombuffer(
                self.f.read(npoints * 12), dtype="<f4"
            ).reshape(npoints, 3)
            props = np.frombuffer(
                self.f.read(n_props * 4), dtype="<f4"
            ) if n_props else np.empty(0, np.float32)
            # Affine is always applied on read (paper: compute is inherent).
            pts = pts @ self._rot.T + self._trans
            yield Streamline(points=pts, properties=props)


def iter_streamlines_multi(fileobj, total_size: int) -> Iterator[Streamline]:
    """Iterate streamlines across a concatenated multi-file logical stream
    (Rolling Prefetch treats the shard list as one file; each shard carries
    its own header)."""
    while fileobj.tell() < total_size:
        reader = LazyTrkReader(fileobj)
        yield from reader.streamlines()
