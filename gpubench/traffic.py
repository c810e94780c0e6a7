"""The benchmark's one traffic generator: token shards drawn from the seed.
A traffic file (``traffic/<name>.json``) gives the sizes; the same seed
gives the same inputs, and every seed the same sizes."""

from __future__ import annotations

import numpy as np

# The seed's stream that the token shards are drawn from.
SHARDS = 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def token_shards(seed: int, shards: int, tokens: int, vocab: int, dtype: str) -> list:
    """`shards` arrays of `tokens` ids below `vocab` each."""
    g = rng(seed, SHARDS)
    return [g.integers(0, vocab, size=tokens, dtype=np.int64).astype(dtype)
            for _ in range(shards)]


def batch_of(stream: np.ndarray, step: int, batch: int, seq_len: int) -> tuple:
    """The (inputs, labels) int32 rows of training step `step` that a
    sequential reader of the shards gives (`stream`: the shards end to
    end): consecutive windows of seq_len + 1 tokens, the stream restarted
    when a window no longer fits."""
    window = seq_len + 1
    per_epoch = len(stream) // window
    rows = [stream[(i % per_epoch) * window:(i % per_epoch + 1) * window]
            for i in range(step * batch, (step + 1) * batch)]
    rows = np.stack(rows).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]
