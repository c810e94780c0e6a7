"""Token-shard format for LM training data on object stores.

Shard = 64-byte header (magic, version, dtype code, token count) + packed
little-endian token payload. Designed for sequential streaming through
Rolling Prefetch: fixed-size records, no random access needed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

HEADER_SIZE = 64
MAGIC = b"TOKS"
_HDR = struct.Struct("<4sIIQ")  # magic, version, dtype code, count
_DTYPES = {1: np.uint16, 2: np.uint32}
_DTYPE_CODES = {np.dtype(np.uint16): 1, np.dtype(np.uint32): 2}


@dataclass
class TokenShardHeader:
    count: int
    dtype: np.dtype
    version: int = 1

    def to_bytes(self) -> bytes:
        buf = bytearray(HEADER_SIZE)
        _HDR.pack_into(buf, 0, MAGIC, self.version,
                       _DTYPE_CODES[np.dtype(self.dtype)], self.count)
        return bytes(buf)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TokenShardHeader":
        magic, version, code, count = _HDR.unpack_from(raw, 0)
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        return cls(count=count, dtype=np.dtype(_DTYPES[code]), version=version)


def write_token_shard(tokens: np.ndarray) -> bytes:
    tokens = np.asarray(tokens)
    if tokens.dtype not in (np.uint16, np.uint32):
        tokens = tokens.astype(np.uint32)
    hdr = TokenShardHeader(count=tokens.size, dtype=tokens.dtype)
    return hdr.to_bytes() + tokens.astype(tokens.dtype.newbyteorder("<")).tobytes()


def synth_token_shard(rng: np.random.Generator, n_tokens: int,
                      vocab: int = 50000) -> bytes:
    return write_token_shard(
        rng.integers(0, vocab, size=n_tokens, dtype=np.uint32)
    )


class TokenStreamReader:
    """Stream fixed-length (seq_len + 1) token windows from a concatenated
    multi-shard logical stream (each shard has its own header)."""

    def __init__(self, fileobj, total_size: int) -> None:
        self.f = fileobj
        self.total_size = total_size
        self._buf = np.empty(0, np.uint32)

    def _next_shard(self) -> bool:
        if self.f.tell() >= self.total_size:
            return False
        hdr = TokenShardHeader.from_bytes(self.f.read(HEADER_SIZE))
        payload = self.f.read(hdr.count * hdr.dtype.itemsize)
        tokens = np.frombuffer(payload, dtype=hdr.dtype.newbyteorder("<"))
        self._buf = np.concatenate([self._buf, tokens.astype(np.uint32)])
        return True

    def read_window(self, n: int) -> np.ndarray | None:
        while len(self._buf) < n:
            if not self._next_shard():
                return None
        out, self._buf = self._buf[:n], self._buf[n:]
        return out
