"""Elastic resharding on the port (`repro_torch.ft.elastic`, sharded trees in
`repro_torch.ckpt.manager`) against the JAX package's checkpoints, on the
CPU.

One gloo world of 8 spawned ranks runs examples/torch/elastic_restore.py:
reduced olmo-1b placed on a (4, 2) mesh, saved, restored onto (2, 4) with
every rank checking that its shard is its slice of the logical array and
that the gathered arrays are bit-identical, then snapshotted. The tests
here read what that world left in its store: the objects of a mesh save
equal a one-process save's byte for byte, and the JAX package restores
both steps. Checks that move no data across ranks (a JAX checkpoint
restored onto a port mesh, rank by rank) run in this process on the
``fake`` backend.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.ckpt import manager as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.io import IOPolicy as JaxIOPolicy
from repro.io import open_store as jax_open_store
from repro.models import make_model as jax_make_model
from repro_torch import tree
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.ft.elastic import reshard_tree, restore_resharded
from repro_torch.io import IOPolicy, open_store
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import make_model
from repro_torch.sharding.rules import NamedSharding, ShardingRules
from repro_torch.store.local import MemStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "torch", "elastic_restore.py")


def _olmo():
    return make_model(get_config("olmo-1b").reduced())


def _jax_olmo_template():
    jmodel = jax_make_model(jax_get_config("olmo-1b").reduced())
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                        jmodel.abstract_params())


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """The example's 8 gloo ranks, once for the module: its output and the
    directory holding its local:// store."""
    workdir = tmp_path_factory.mktemp("elastic")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, EXAMPLE, "--device", "cpu", "--workdir", str(workdir)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    return res, workdir


@pytest.fixture
def fake_world():
    """`start(world, rank)`: this process as `rank` of a ``fake`` group of
    `world` ranks (no data moves); destroyed at teardown."""

    def start(world: int, rank: int = 0) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_eight_ranks_restore_onto_another_mesh_bit_identical(gloo_world):
    res, _ = gloo_world
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines == [
        "saved on mesh {'data': 4, 'model': 2} (8 cpu ranks)",
        "restored onto mesh {'data': 2, 'model': 4} by TRAIN_RULES: values identical, "
        "8 sharded leaves re-laid-out",
        "OK: elastic restore verified; post-reshard snapshot committed",
    ]


def test_mesh_save_equals_a_one_process_save(gloo_world, tmp_path):
    """Step 0 of the 8-rank save (each leaf gathered from its shards) and
    its post-reshard snapshot (step 1) hold the bytes a single process
    writes for the same values: every leaf object, and the manifest but
    for its time."""
    _, workdir = gloo_world
    ranks = open_store(f"local://{workdir / 'store'}")
    alone = open_store(f"local://{tmp_path / 'alone'}")
    params = _olmo().init(0, device="cpu")
    for step in (0, 1):
        save_checkpoint(alone, "elastic", step, params)
        prefix = f"elastic/step_{step:08d}/"
        keys = sorted(m.key for m in alone.list_objects(prefix))
        assert sorted(m.key for m in ranks.list_objects(prefix)) == keys
        for key in keys:
            if key.endswith("MANIFEST.json"):
                want, got = json.loads(alone.get(key)), json.loads(ranks.get(key))
                want.pop("saved_unix_time"), got.pop("saved_unix_time")
                assert got == want
            else:
                assert ranks.get(key) == alone.get(key), key


def test_jax_restores_the_port_mesh_save(gloo_world):
    """The JAX package's restore of both steps the 8 ranks wrote gives the
    port's values."""
    _, workdir = gloo_world
    want = [t.numpy() for t in tree.flatten(_olmo().init(0, device="cpu"))]
    store = jax_open_store(f"local://{workdir / 'store'}")
    for step in (0, 1):
        got, manifest = jax_ckpt.restore_checkpoint(
            store, "elastic", _jax_olmo_template(), step=step,
            policy=JaxIOPolicy(engine="sequential"))
        assert manifest["step"] == step
        leaves = jax.tree_util.tree_leaves(got)
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_checkpoint_restores_onto_a_port_mesh(fake_world, tmp_path):
    """A checkpoint the JAX package saved (reduced olmo-1b, its own init)
    restores onto a (2, 4) port mesh under TRAIN_RULES: on each of the 8
    ranks every leaf has its template's placements, the logical shape, and
    that rank's slice of the JAX array."""
    jmodel = jax_make_model(jax_get_config("olmo-1b").reduced())
    jparams = jmodel.init(jax.random.key(0))
    uri = f"local://{tmp_path / 'jax'}"
    jax_ckpt.save_checkpoint(jax_open_store(uri), "ckpt", 3, jparams)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    model = _olmo()
    for rank in range(8):
        fake_world(8, rank)
        mesh = make_mesh_compat((2, 4), ("data", "model"), device_type="cpu")
        template = model.abstract_params(ShardingRules(mesh))
        got, manifest = restore_checkpoint(open_store(uri), "ckpt", template, device="cpu")
        assert manifest["step"] == 3
        coord = mesh.get_coordinate()
        for g, t, w in zip(tree.flatten(got), tree.flatten(template), want):
            assert isinstance(g, DTensor) and g.placements == t.placements
            assert tuple(g.shape) == w.shape
            piece = torch.from_numpy(np.array(w))
            for m, p in enumerate(g.placements):
                if isinstance(p, Shard):
                    n = piece.shape[p.dim] // mesh.size(m)
                    piece = piece.narrow(p.dim, coord[m] * n, n)
            assert torch.equal(g.to_local(), piece), rank
            # The shard owns its memory: the whole leaf is not kept alive.
            assert g.to_local().untyped_storage().nbytes() == piece.numel() * 4


class TestElastic:
    """tests/test_data_ckpt_ft.py::TestElastic on the port: a plain save
    restores onto a template laid out on a mesh."""

    def test_restore_onto_different_sharding(self, fake_world):
        store = MemStore()
        state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
        save_checkpoint(store, "ckpt", 1, state)
        fake_world(1)
        mesh = make_mesh_compat((1,), ("data",), device_type="cpu")
        sharding = NamedSharding(mesh, (Shard(0),))
        template = reshard_tree({"w": torch.empty((8, 8), device="meta")}, {"w": sharding})
        restored, _ = restore_checkpoint(store, "ckpt", template, device="cpu")
        assert torch.equal(restored["w"].full_tensor(), state["w"])
        assert restored["w"].placements == sharding.placements
        assert restored["w"].device_mesh == mesh

    def test_reshard_tree_none_is_the_logical_array(self, fake_world):
        fake_world(1)
        mesh = make_mesh_compat((1,), ("data",), device_type="cpu")
        x = torch.arange(6.0).reshape(2, 3)
        placed = reshard_tree({"a": x, "b": x}, {"a": NamedSharding(mesh, (Shard(1),)),
                                                 "b": None})
        assert isinstance(placed["a"], DTensor) and placed["b"] is x
        back = reshard_tree(placed, {"a": None, "b": None})
        assert type(back["a"]) is torch.Tensor and torch.equal(back["a"], x)


def test_restore_resharded_delegates(monkeypatch):
    """tests/test_peer.py's TestShardedRestore: `restore_resharded` passes
    ``shard=(host_id, num_hosts)`` on and restores the whole state."""
    from repro_torch.ckpt import manager

    store = MemStore()
    state = {"w": torch.arange(16_384, dtype=torch.float32).reshape(128, 128),
             "b": torch.ones((4097,), dtype=torch.float32)}
    save_checkpoint(store, "ckpt", 7, state, policy=IOPolicy(blocksize=4096))
    shards = []
    real = manager._warm_shard
    monkeypatch.setattr(manager, "_warm_shard",
                        lambda fs, files, policy, shard: (shards.append(shard),
                                                          real(fs, files, policy, shard)))
    restored, manifest = restore_resharded(
        store, "ckpt", state, host_id=1, num_hosts=3, device="cpu",
        policy=IOPolicy(engine="sequential", blocksize=4096))
    assert manifest["step"] == 7 and shards == [(1, 3)]
    for k in state:
        assert torch.equal(restored[k], state[k])


@pytest.mark.parametrize("host", [(0, 1), (1, 3)], ids=["one-process", "host-1-of-3"])
def test_train_resumes_with_the_mesh_host_shard(monkeypatch, tmp_path, host):
    """The driver's resume passes the shard `mesh_host_shard` gives when
    the mesh has more than one host, and no shard for one process."""
    uri = f"local://{tmp_path / 'ckpt'}"
    args = ["--device", "cpu", "--batch", "2", "--seq-len", "32", "--ckpt-interval", "2",
            "--log-every", "1", "--ckpt-store", uri]
    train.main(["--steps", "2", *args])
    seen = []
    real = train.restore_checkpoint

    def spy(*a, **kw):
        seen.append(kw.get("shard"))
        return real(*a, **kw)

    monkeypatch.setattr(train, "mesh_host_shard", lambda: host)
    monkeypatch.setattr(train, "restore_checkpoint", spy)
    result = train.main(["--steps", "4", *args])
    assert seen == [host if host[1] > 1 else None]
    assert len(result.losses) == 2
