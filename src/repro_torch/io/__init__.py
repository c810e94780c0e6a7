"""Unified I/O subsystem: the `PrefetchFS` facade, `IOPolicy` config, the
`Reader` protocol and reader-engine registry on the consume side, and the
URI store registry plus write-behind `Writer` pipeline on the produce side.

This is the one construction path for prefetched reads AND pipelined
writes — the S3Fs-shaped API the paper argues for, extended with policy
objects and backend registries so new engines and stores plug in without
touching call sites::

    from repro_torch.io import IOPolicy, PrefetchFS, open_store

    fs = PrefetchFS("sims3://bucket?latency_ms=40&bw_mbps=200",
                    policy=IOPolicy(engine="rolling", blocksize=1 << 20))
    with fs.open_many(files) as f:      # one logical stream over many objects
        data = f.read()
    with fs.open_write("out/key") as w:  # background part uploads
        w.write(data)                    # close() = durable atomic publish
    print(fs.stats().snapshot())
"""

from repro_torch.io.fs import FSStats, PrefetchFS
from repro_torch.io.policy import IOPolicy
from repro_torch.io.reader import DirectReader, DirectStats, Reader
from repro_torch.io.registry import available_engines, engine_spec, register_reader
from repro_torch.io.retry import Hedger, Retrier, RetryPolicy
from repro_torch.io.stores import (
    StoreURI,
    available_stores,
    clear_store_cache,
    open_store,
    parse_store_uri,
    register_store,
)
from repro_torch.io.write import UploadPool, Writer, WriteStats

__all__ = [
    "FSStats",
    "PrefetchFS",
    "IOPolicy",
    "Reader",
    "DirectReader",
    "DirectStats",
    "available_engines",
    "engine_spec",
    "register_reader",
    "RetryPolicy",
    "Retrier",
    "Hedger",
    "StoreURI",
    "available_stores",
    "clear_store_cache",
    "open_store",
    "parse_store_uri",
    "register_store",
    "UploadPool",
    "Writer",
    "WriteStats",
]
