"""The port's token loader and device feeder: the JAX package's
`TestTokenLoader` (tests/test_data_ckpt_ft.py) on the port's classes, the
feeder on the CPU, and the port's loader yielding the JAX loader's batches
from the same objects."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.data import LoaderConfig as JaxLoaderConfig
from repro.data import PrefetchingDataLoader as JaxLoader
from repro.data import synth_token_shard as jax_synth_token_shard
from repro.store import LinkModel as JaxLinkModel
from repro.store import MemTier as JaxMemTier
from repro.store import SimS3Store as JaxSimS3Store
from repro_torch.data import (
    DataCursor,
    DeviceFeeder,
    LoaderConfig,
    PrefetchingDataLoader,
    synth_token_shard,
)
from repro_torch.io import IOPolicy
from repro_torch.store import LinkModel, MemTier, SimS3Store


def make_store(objects: dict[str, bytes], **kw) -> SimS3Store:
    store = SimS3Store(link=LinkModel(**kw))
    for k, v in objects.items():
        store.backing.put(k, v)
    return store


def _objects(n_shards=4, tokens_per_shard=5000) -> dict[str, bytes]:
    rng = np.random.default_rng(2)
    return {f"tok{i:03d}.bin": synth_token_shard(rng, tokens_per_shard)
            for i in range(n_shards)}


class TestTokenLoader:
    def _dataset(self, n_shards=4, tokens_per_shard=5000, **link_kw):
        return make_store(_objects(n_shards, tokens_per_shard), **link_kw)

    def test_rolling_and_sequential_yield_identical_batches(self):
        store = self._dataset()
        files = store.backing.list_objects()
        out = {}
        for mode in ("rolling", "sequential"):
            cfg = LoaderConfig(seq_len=128, batch_size=4,
                               policy=IOPolicy(engine=mode, blocksize=4096))
            loader = PrefetchingDataLoader(store, files, [MemTier(1 << 20)], cfg)
            out[mode] = list(loader.batches(max_batches=5))
            loader.close()
        for (i1, l1), (i2, l2) in zip(out["rolling"], out["sequential"]):
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(l1, l2)

    def test_labels_are_shifted_inputs(self):
        store = self._dataset(n_shards=1)
        files = store.backing.list_objects()
        cfg = LoaderConfig(seq_len=64, batch_size=2, blocksize=4096)
        loader = PrefetchingDataLoader(store, files, [MemTier(1 << 20)], cfg)
        inputs, labels = next(iter(loader.batches(max_batches=1)))
        loader.close()
        assert inputs.dtype == labels.dtype == np.int32
        np.testing.assert_array_equal(inputs[:, 1:], labels[:, :-1])

    def test_per_host_sharding_partitions_files(self):
        store = self._dataset(n_shards=4)
        files = store.backing.list_objects()
        seen = []
        for host in range(2):
            cfg = LoaderConfig(seq_len=32, batch_size=1, host_id=host,
                               num_hosts=2, blocksize=4096)
            loader = PrefetchingDataLoader(store, files, [MemTier(1 << 20)], cfg)
            assert [m.key for m in loader.my_files] == [m.key for m in files[host::2]]
            seen.append(next(iter(loader.batches(max_batches=1)))[0])
            loader.close()
        assert not np.array_equal(seen[0], seen[1])

    def test_cursor_resume_continues_stream(self):
        store = self._dataset(n_shards=2)
        files = store.backing.list_objects()

        def collect(cursor, n):
            cfg = LoaderConfig(seq_len=64, batch_size=2, blocksize=4096)
            loader = PrefetchingDataLoader(store, files, [MemTier(1 << 20)],
                                           cfg, cursor=cursor)
            bs = list(loader.batches(max_batches=n))
            cur = DataCursor(**loader.cursor.to_dict())
            loader.close()
            return bs, cur

        all_batches, _ = collect(DataCursor(), 6)
        _, cur = collect(DataCursor(), 3)
        resumed, _ = collect(cur, 3)
        for (a, _), (b, _) in zip(all_batches[3:], resumed):
            np.testing.assert_array_equal(a, b)

    def test_epoch_wraparound(self):
        store = self._dataset(n_shards=1, tokens_per_shard=200)
        files = store.backing.list_objects()
        cfg = LoaderConfig(seq_len=64, batch_size=2, blocksize=4096)
        loader = PrefetchingDataLoader(store, files, [MemTier(1 << 20)], cfg)
        batches = list(loader.batches(max_batches=4))
        loader.close()
        assert len(batches) == 4
        assert loader.cursor.epoch >= 1

    def test_device_feeder(self):
        store = self._dataset(n_shards=1)
        files = store.backing.list_objects()
        cfg = LoaderConfig(seq_len=32, batch_size=2, blocksize=4096)
        loader = PrefetchingDataLoader(store, files, [MemTier(1 << 20)], cfg)
        plain = PrefetchingDataLoader(store, files, [MemTier(1 << 20)], cfg)
        want = list(plain.batches(max_batches=3))
        plain.close()
        feeder = DeviceFeeder(loader.batches(max_batches=3), depth=2, device="cpu")
        out = list(feeder)
        loader.close()
        assert len(out) == 3
        for (x, y), (wx, wy) in zip(out, want):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            assert x.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), wx)
            np.testing.assert_array_equal(y.numpy(), wy)
        # Exhausting the iterator reaps the feeder thread.
        assert not feeder._thread.is_alive()

    def test_device_feeder_close_mid_stream(self):
        # A consumer that stops early must be able to reap the feeder even
        # while it is parked on a full queue.
        batches = (np.zeros((2, 8), np.int32) for _ in itertools.count())
        feeder = DeviceFeeder(batches, depth=1, device="cpu")
        next(iter(feeder))
        feeder.close()
        assert not feeder._thread.is_alive()
        feeder.close()  # idempotent


def test_feeder_moves_arrays_and_passes_other_leaves_through():
    """Arrays and tensors in a batch tree become tensors on the device, in
    copies; ints and strings (a cursor, a tag) come through as they are."""
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = torch.ones(2)
    batch = (a[:, ::2], {"t": t, "cursor": {"epoch": 1, "windows_emitted": 4}}, "tag")
    feeder = DeviceFeeder(iter([batch]), device="cpu")
    (x, rest, tag), = list(feeder)
    np.testing.assert_array_equal(x.numpy(), a[:, ::2])
    assert torch.equal(rest["t"], t) and rest["t"].data_ptr() != t.data_ptr()
    assert rest["cursor"] == {"epoch": 1, "windows_emitted": 4} and tag == "tag"


def test_feeder_reraises_the_iterators_error():
    def batches():
        yield np.zeros(2, np.int32)
        raise OSError("store went away")

    feeder = DeviceFeeder(batches(), device="cpu")
    it = iter(feeder)
    next(it)
    with pytest.raises(OSError, match="store went away"):
        next(it)
    assert not feeder._thread.is_alive()
    feeder.close()


def test_feeder_observes_each_transfer():
    seen: list[float] = []
    feeder = DeviceFeeder((np.zeros(4, np.int32) for _ in range(3)), device="cpu",
                          observe=seen.append)
    assert len(list(feeder)) == 3
    assert len(seen) == 3 and all(s >= 0 for s in seen)


@pytest.mark.parametrize("mode", ["rolling", "sequential"])
def test_port_loader_yields_the_jax_loaders_batches(mode):
    """The same token objects behind the JAX package's loader and the
    port's: equal batches, cursor included, across an epoch boundary."""
    rng = np.random.default_rng(5)
    objects = {f"data/tok{i:04d}.bin": jax_synth_token_shard(rng, 3000, vocab=700)
               for i in range(3)}
    jstore = JaxSimS3Store(link=JaxLinkModel(latency_s=0.0))
    store = SimS3Store(link=LinkModel(latency_s=0.0))
    for k, v in objects.items():
        jstore.backing.put(k, v)
        store.backing.put(k, v)
    jax_loader = JaxLoader(jstore, jstore.list_objects("data/"), [JaxMemTier(1 << 20)],
                           JaxLoaderConfig(seq_len=127, batch_size=4, mode=None,
                                           blocksize=4096))
    loader = PrefetchingDataLoader(store, store.list_objects("data/"), [MemTier(1 << 20)],
                                   LoaderConfig(seq_len=127, batch_size=4,
                                                policy=IOPolicy(engine=mode, blocksize=4096)))
    try:
        for (wx, wy), (x, y) in zip(jax_loader.batches(max_batches=20),
                                    loader.batches(max_batches=20)):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
        assert loader.cursor.to_dict() == jax_loader.cursor.to_dict()
        assert loader.cursor.epoch >= 1
    finally:
        jax_loader.close()
        loader.close()
