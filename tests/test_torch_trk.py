"""The port's streamline codec (repro_torch.data.trk): the JAX package's
trk cases (tests/test_codecs_property.py, TestTrk in
tests/test_data_ckpt_ft.py) against the port's copy, and the port's
reader against the reference's over the same multi-shard prefetched
stream."""

from __future__ import annotations

import io

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.data import trk as ref_trk
from repro.io import IOPolicy as RefIOPolicy
from repro.io import PrefetchFS as RefPrefetchFS
from repro.store import LinkModel as RefLinkModel
from repro.store import SimS3Store as RefSimS3Store
from repro_torch.core.rolling import RollingPrefetchFile, RollingPrefetcher
from repro_torch.data import LazyTrkReader, TrkHeader, iter_streamlines_multi, synth_trk, write_trk
from repro_torch.io import IOPolicy, PrefetchFS
from repro_torch.store import LinkModel, MemTier, SimS3Store


def make_store(objects: dict[str, bytes], **kw) -> SimS3Store:
    store = SimS3Store(link=LinkModel(**kw))
    for k, v in objects.items():
        store.backing.put(k, v)
    return store


class TestTrkProperty:
    @given(
        n_streamlines=st.integers(0, 20),
        n_props=st.integers(0, 4),
        seed=st.integers(0, 2**31 - 1),
    )
    @settings(max_examples=25, deadline=None)
    def test_roundtrip(self, n_streamlines, n_props, seed):
        rng = np.random.default_rng(seed)
        sls = [
            (
                rng.normal(size=(int(rng.integers(1, 30)), 3)).astype(np.float32),
                rng.normal(size=n_props).astype(np.float32),
            )
            for _ in range(n_streamlines)
        ]
        raw = write_trk(sls, n_properties=n_props)
        assert len(raw) >= 1000
        reader = LazyTrkReader(io.BytesIO(raw))
        assert reader.header.n_count == n_streamlines
        got = list(reader.streamlines())
        assert len(got) == n_streamlines
        for (pts, props), sl in zip(sls, got):
            np.testing.assert_allclose(sl.points, pts, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(sl.properties, props)

    @given(affine_seed=st.integers(0, 1000))
    @settings(max_examples=10, deadline=None)
    def test_affine_roundtrips_in_header(self, affine_seed):
        rng = np.random.default_rng(affine_seed)
        affine = np.eye(4, dtype=np.float32)
        affine[:3, :] = rng.normal(size=(3, 4)).astype(np.float32)
        hdr = TrkHeader(n_count=0, n_properties=0, affine=affine)
        back = TrkHeader.from_bytes(hdr.to_bytes())
        np.testing.assert_array_equal(back.affine, affine)

    def test_bad_magic_rejected(self):
        with pytest.raises(ValueError):
            TrkHeader.from_bytes(b"XXXX" + b"\0" * 996)


class TestTrk:
    def test_roundtrip(self):
        rng = np.random.default_rng(0)
        pts = [rng.normal(size=(5 + i, 3)).astype(np.float32) for i in range(4)]
        props = [rng.normal(size=2).astype(np.float32) for _ in range(4)]
        raw = write_trk(list(zip(pts, props)))
        reader = LazyTrkReader(io.BytesIO(raw))
        assert reader.header.n_count == 4
        got = list(reader.streamlines())
        assert len(got) == 4
        for sl, p, pr in zip(got, pts, props):
            np.testing.assert_allclose(sl.points, p, rtol=1e-6)  # identity affine
            np.testing.assert_allclose(sl.properties, pr)

    def test_affine_applied_on_read(self):
        affine = np.eye(4, dtype=np.float32)
        affine[:3, 3] = [1.0, 2.0, 3.0]
        pts = np.zeros((3, 3), np.float32)
        raw = write_trk([(pts, np.zeros(0, np.float32))], affine=affine,
                        n_properties=0)
        sl = next(LazyTrkReader(io.BytesIO(raw)).streamlines())
        np.testing.assert_allclose(sl.points, np.tile([1, 2, 3], (3, 1)))

    def test_multi_file_stream_via_rolling_prefetch(self):
        rng = np.random.default_rng(1)
        objects = {f"shard{i}.trk": synth_trk(rng, 20) for i in range(3)}
        store = make_store(objects)
        files = store.backing.list_objects()
        f = RollingPrefetchFile(
            RollingPrefetcher(store, files, [MemTier(1 << 20)], 4096,
                              eviction_interval_s=0.01)
        )
        with f:
            got = list(iter_streamlines_multi(f, f.size))
        assert len(got) == 60
        assert all(s.points.shape[1] == 3 for s in got)


@pytest.mark.parametrize("seed", [0, 7])
def test_writers_give_the_references_bytes(seed):
    """The same generator state gives byte-identical shards on both sides."""
    a = synth_trk(np.random.default_rng(seed), 50, mean_points=12, n_properties=3)
    b = ref_trk.synth_trk(np.random.default_rng(seed), 50, mean_points=12, n_properties=3)
    assert a == b


@pytest.mark.parametrize("engine", ["sequential", "rolling"])
def test_reader_yields_the_references_points_over_prefetchfs(engine):
    """The port's LazyTrkReader and the reference's, each over its own
    package's PrefetchFS multi-shard stream of the same objects, yield the
    same points and properties, bit for bit."""
    rng = np.random.default_rng(5)
    objects = {f"hydi/shard{i}.trk": synth_trk(rng, 200, mean_points=25) for i in range(3)}
    policy = dict(engine=engine, blocksize=8 << 10, eviction_interval_s=0.01)

    port_store = make_store(objects, latency_s=0.0)
    fs = PrefetchFS(port_store, policy=IOPolicy(**policy), tiers=[MemTier(1 << 20)])
    with fs.open_many(port_store.backing.list_objects()) as f:
        got = list(iter_streamlines_multi(f, f.size))
    fs.close()

    ref_store = RefSimS3Store(link=RefLinkModel(latency_s=0.0))
    for k, v in objects.items():
        ref_store.backing.put(k, v)
    ref_fs = RefPrefetchFS(ref_store, policy=RefIOPolicy(**policy))
    with ref_fs.open_many(ref_store.backing.list_objects()) as f:
        want = list(ref_trk.iter_streamlines_multi(f, f.size))
    ref_fs.close()

    assert len(got) == len(want) == 600
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.properties, b.properties)
