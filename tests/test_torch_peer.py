"""The port's copies of the peer tier and the fault-injection store, through
its own facade: a two-host loopback cluster, the `peer://` scheme adopted by
`PrefetchFS`, transient store faults retried by the port's engines, and the
port's peer client and server speaking the reference's wire protocol both
ways. Every server binds an ephemeral loopback port and is closed in a
`finally`."""

from __future__ import annotations

import threading
from urllib.parse import quote

import pytest

from repro.peer import BlockServer as RefBlockServer
from repro.peer import PeerClient as RefPeerClient
from repro.store import CacheIndex as RefCacheIndex
from repro.store import MemStore as RefMemStore
from repro.store import MemTier as RefMemTier
from repro_torch.core.rolling import RollingPrefetchFile, RollingPrefetcher
from repro_torch.io import IOPolicy, PrefetchFS, open_store
from repro_torch.io.retry import RetryPolicy
from repro_torch.peer import BlockServer, PeerAwareStore, PeerClient, PeerGroup
from repro_torch.peer.sim import CountingStore, SimCluster
from repro_torch.store import (
    CacheIndex,
    FaultSchedule,
    FaultyStore,
    LinkModel,
    MemStore,
    MemTier,
    SimS3Store,
    TransientStoreError,
)


def payload(n: int, seed: int = 0) -> bytes:
    return bytes((i * 31 + seed * 7) % 256 for i in range(n))


def test_two_host_cluster_reads_the_direct_bytes():
    objects = {f"f{i}": payload(20_000, seed=i) for i in range(3)}
    inner = MemStore()
    for k, v in objects.items():
        inner.put(k, v)
    want = b"".join(objects[k] for k in sorted(objects))
    cluster = SimCluster(2, inner)
    try:
        outs, stats, errors = {}, {}, []

        def run(h):
            try:
                fs = cluster.host(h).open_fs(IOPolicy(
                    engine="rolling", blocksize=4096, depth=2,
                    keep_cached=True, eviction_interval_s=0.05))
                files = sorted(cluster.host(h).store.list_objects(), key=lambda m: m.key)
                with fs.open_many(files) as f:
                    outs[h] = f.read()
                stats[h] = fs.stats().snapshot()
            except BaseException as e:  # repro: allow[RP005] — stashed; asserted after join
                errors.append((h, e))

        threads = [threading.Thread(target=run, args=(h,)) for h in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert outs[0] == outs[1] == want
        n_blocks = sum(-(-len(v) // 4096) for v in objects.values())
        # Both hosts read everything; the backing store saw each block about once.
        assert cluster.backing_fetches <= 1.2 * n_blocks
        for h in range(2):
            peer = stats[h]["peer"]
            assert peer is not None
            assert peer["local_fetches"] + peer["peer_hits"] > 0
    finally:
        cluster.close()


def test_peer_uri_opens_a_store_prefetchfs_adopts():
    backing = open_store("mem://torch-peer-uri")
    data = payload(30_000, seed=5)
    backing.put("obj", data)
    uri = ("peer://?self=0&peers=" + quote("0@127.0.0.1:0", safe="")
           + "&backing=" + quote("mem://torch-peer-uri", safe="") + "&mem=8MB")
    store = open_store(uri, fresh=True)
    fs = None
    try:
        assert isinstance(store, PeerAwareStore)
        assert store.server is not None and store.tiers
        fs = PrefetchFS(store, policy=IOPolicy(engine="sequential", blocksize=4096))
        assert fs.store is store
        with fs.open_many(store.list_objects()) as f:
            assert f.read() == data
        snap = fs.stats().snapshot()
        assert snap["peer"] is not None and snap["peer"]["local_fetches"] > 0
        # The fs read into the peer store's own tiers.
        assert store.tiers[0].used > 0
    finally:
        if fs is not None:
            fs.close()
        store.close()


def test_peer_store_in_a_single_member_group_reads_direct():
    backing = CountingStore(MemStore())
    backing.put("k", payload(10_000))
    group = PeerGroup(0, [])
    store = PeerAwareStore(backing, group)
    try:
        assert store.get_range("k", 0, 4096) == payload(10_000)[:4096]
        assert store.peer_snapshot()["local_fetches"] == 1
        assert backing.fetches == 1
    finally:
        store.close()
        group.close()


def test_transient_faults_are_retried_to_the_right_bytes():
    data = payload(64 << 10, seed=1)
    store = SimS3Store(link=LinkModel(latency_s=0.0))
    store.backing.put("a", data)
    faulty = FaultyStore(store, FaultSchedule().transient(ops=("get_range", "get_ranges"),
                                                          every=3, times=5))
    pf = RollingPrefetcher(faulty, store.backing.list_objects(), [MemTier(1 << 20)],
                           blocksize=4096, depth=2,
                           retry=RetryPolicy(max_retries=6, backoff_s=0.001),
                           eviction_interval_s=0.01)
    f = RollingPrefetchFile(pf)
    try:
        assert f.read() == data
    finally:
        f.close()
    assert faulty.snapshot()["transient"] == 5
    assert pf.stats.retries == 5


def test_faulty_store_raises_then_serves():
    inner = MemStore()
    inner.put("k", b"abcdef")
    st = FaultyStore(inner, FaultSchedule().transient(ops=("get_range",), times=1))
    with pytest.raises(TransientStoreError):
        st.get_range("k", 0, 6)
    assert st.get_range("k", 0, 6) == b"abcdef"
    assert st.snapshot()["transient"] == 1


def _serve(server_cls, index_cls, tier_cls, store):
    index = index_cls([tier_cls(8 << 20)], keep_cached=True)
    return server_cls(index, store, host="127.0.0.1", port=0, host_id=0)


@pytest.mark.parametrize("direction", ["port client, reference server",
                                       "reference client, port server"])
def test_wire_protocol_matches_the_reference(direction):
    data = payload(40_000, seed=3)
    if direction.startswith("port"):
        store = RefMemStore()
        store.put("obj", data)
        server = _serve(RefBlockServer, RefCacheIndex, RefMemTier, store)
        client_cls = PeerClient
    else:
        store = MemStore()
        store.put("obj", data)
        server = _serve(BlockServer, CacheIndex, MemTier, store)
        client_cls = RefPeerClient
    client = client_cls(server.address, peer_id=0)
    try:
        assert client.ping()
        assert client.fetch("obj", 0, 4096, owner=True) == data[:4096]
        assert client.fetch("obj", 4096, 8192, owner=False) is None
        assert client.put("obj", 8192, 12288, data[8192:12288])
        assert client.fetch("obj", 8192, 12288, owner=False) == data[8192:12288]
        assert server.snapshot()["ownership_fetches"] == 1
    finally:
        client.close()
        server.close()
