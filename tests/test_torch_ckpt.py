"""The port's checkpoint manager on the CPU against the JAX package's: the
same format both ways (a checkpoint either side saves restores bit-exact on
the other, leaf objects byte-identical), every restore engine, the warm
disk cache, integrity, and tests/test_data_ckpt_ft.py's TestCheckpoint
mirrored against `repro_torch.ckpt`.

Weights come from the JAX package's init in this process (reduced
smollm-135m and mamba2-1.3b), carried over as numpy arrays."""

from __future__ import annotations

import itertools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.io import open_store as jax_open_store
from repro.models import make_model as jax_make_model
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.ckpt.manager import CheckpointManager, _flatten, _leaf_key, gc_checkpoints
from repro_torch.configs import get_config
from repro_torch.io import IOPolicy, open_store
from repro_torch.models import make_model
from repro_torch.store import LinkModel, MemTier, SimS3Store
from repro_torch.store.base import IntegrityError

ARCHS = ["smollm-135m", "mamba2-1.3b"]
DTYPES = ["float32", "bfloat16"]
BLOCK = 8 << 10     # ~32 blocks per reduced model: every leaf spans or shares blocks
_bucket = itertools.count()


def _uri(tag: str) -> str:
    """A fresh simulated-S3 bucket with a free link (one per test side)."""
    return f"sims3://{tag}{next(_bucket)}?latency_ms=0"


def _jax_tree(arch: str, dtype: str) -> dict:
    """Reduced `arch`'s JAX-initialised weights in `dtype`, as numpy arrays
    (bfloat16 ones as ml_dtypes arrays)."""
    params = jax_make_model(jax_get_config(arch).reduced()).init(jax.random.key(0))
    return jax.tree.map(lambda x: np.asarray(x.astype(getattr(jnp, dtype))), params)


def _port_tree(arch: str, tree: dict, device) -> dict:
    """`tree` as the port's tensors, its dicts in the order the port's own
    spec builds them (not sorted: `jax.tree.map` hands numpy trees over
    with sorted keys, which would hide a flatten that kept insertion
    order)."""
    def reorder(t, spec):
        return {k: reorder(t[k], v) if isinstance(v, dict) else t[k] for k, v in spec.items()}

    spec = make_model(get_config(arch).reduced()).spec()
    assert list(spec) != sorted(spec)
    return params_from_numpy(reorder(tree, spec), device)


def _bits(a) -> np.ndarray:
    """Raw bytes of a numpy array or CPU tensor, for bit-exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _assert_same(np_tree: dict, t_tree: dict) -> None:
    """Every leaf of the numpy tree equals the tensor tree's, bit for bit,
    with the same dtype name and shape; the keys match at every level."""
    assert sorted(np_tree) == sorted(t_tree)
    for k, v in np_tree.items():
        if isinstance(v, dict):
            _assert_same(v, t_tree[k])
            continue
        t = t_tree[k]
        assert str(t.dtype).removeprefix("torch.") == v.dtype.name, k
        assert tuple(t.shape) == v.shape, k
        np.testing.assert_array_equal(_bits(t), _bits(v), err_msg=k)


def _copy_objects(src, dst) -> None:
    """Move every object of one package's store into the other's."""
    for meta in src.backing.list_objects(""):
        dst.backing.put(meta.key, src.backing.get(meta.key))


def _policy(engine: str = "rolling", **kw) -> IOPolicy:
    return IOPolicy(engine=engine, blocksize=BLOCK, eviction_interval_s=0.01, **kw)


def test_leaf_order_matches_jax_tree_util():
    """Leaves are numbered in `jax.tree_util`'s order (keys sorted at every
    level), not in insertion order."""
    tree = {"z": {"b": 1, "a": 2}, "a": {"y": {"q": 3, "c": 4}, "b": 5}, "m": 6}
    assert _flatten(tree) == jax.tree.leaves(tree) == [5, 4, 3, 6, 2, 1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_saved_checkpoint_restores_into_port(arch, dtype):
    tree = _jax_tree(arch, dtype)
    jstore, store = jax_open_store(_uri("j")), open_store(_uri("t"))
    jax_ckpt.save_checkpoint(jstore, "ckpt", 3, jax.tree.map(jnp.asarray, tree))
    _copy_objects(jstore, store)
    template = _port_tree(arch, tree, "meta")
    restored, manifest = restore_checkpoint(store, "ckpt", template, device="cpu",
                                            policy=_policy())
    assert manifest["step"] == 3
    _assert_same(tree, restored)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_saved_checkpoint_restores_into_jax(arch, dtype):
    tree = _jax_tree(arch, dtype)
    jstore, store = jax_open_store(_uri("j")), open_store(_uri("t"))
    save_checkpoint(store, "ckpt", 3, _port_tree(arch, tree, "cpu"))
    _copy_objects(store, jstore)
    restored, manifest = jax_ckpt.restore_checkpoint(
        jstore, "ckpt", jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree))
    assert manifest["step"] == 3
    got, want = jax.tree.leaves(restored), jax.tree.leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_both_sides_store_identical_objects(arch, dtype):
    """The same weights saved by each package: byte-identical leaf objects,
    and manifests equal apart from the save time."""
    tree = _jax_tree(arch, dtype)
    jstore, store = jax_open_store(_uri("j")), open_store(_uri("t"))
    jman = jax_ckpt.save_checkpoint(jstore, "ckpt", 5, jax.tree.map(jnp.asarray, tree),
                                    extra={"note": "x"})
    tman = save_checkpoint(store, "ckpt", 5, _port_tree(arch, tree, "cpu"),
                           extra={"note": "x"})
    jkeys = sorted(m.key for m in jstore.backing.list_objects(""))
    assert jkeys == sorted(m.key for m in store.backing.list_objects(""))
    stored = []
    for key in jkeys:
        jb, tb = jstore.backing.get(key), store.backing.get(key)
        if key.endswith("MANIFEST.json"):
            stored = [json.loads(jb), json.loads(tb)]
        else:
            assert jb == tb, key
    for m in [jman, tman, *stored]:
        assert m.pop("saved_unix_time") > 0
    assert jman == tman == stored[0] == stored[1]
    assert len(tman["leaves"]) == len(jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_rolling_sequential_and_autotuned_restores_agree(arch):
    tree = _jax_tree(arch, "float32")
    store = open_store(_uri("t"))
    save_checkpoint(store, "ckpt", 1, params_from_numpy(tree, "cpu"))
    policies = {
        "rolling": _policy("rolling", depth=2),
        "sequential": _policy("sequential"),
        # The driver's --autotune: coalesced range GETs, AIMD depth, tuning.
        "autotune": _policy("rolling", depth=2, max_depth=8, autotune=True),
    }
    out = {name: restore_checkpoint(store, "ckpt", tree, policy=p, device="cpu")[0]
           for name, p in policies.items()}
    for name, restored in out.items():
        _assert_same(tree, restored)
    for a, b, c in zip(*(_flatten(t) for t in out.values())):
        assert torch.equal(a, b) and torch.equal(a, c)


def _count_gets(store) -> list:
    """Count the store's data GETs (range and coalesced-range requests):
    one entry per call, appended by whichever engine thread makes it."""
    calls: list = []
    for name in ("get_range", "get_ranges"):
        fn = getattr(store, name)

        def counted(*args, _fn=fn, **kw):
            calls.append(1)
            return _fn(*args, **kw)

        setattr(store, name, counted)
    return calls


@pytest.mark.parametrize("engine", ["rolling", "sequential"])
def test_warm_cache_dir_restore_makes_no_store_gets(tmp_path, engine):
    tree = _jax_tree("smollm-135m", "float32")
    store = open_store(_uri("t"))
    save_checkpoint(store, "ckpt", 2, params_from_numpy(tree, "cpu"))
    calls = _count_gets(store)
    cache = str(tmp_path / "wcache")
    cold, _ = restore_checkpoint(store, "ckpt", tree, policy=_policy(engine),
                                 cache_dir=cache, device="cpu")
    cold_gets = len(calls)
    assert cold_gets > 0
    warm, _ = restore_checkpoint(store, "ckpt", tree, policy=_policy(engine),
                                 cache_dir=cache, device="cpu")
    assert len(calls) == cold_gets          # the warm restore made none
    _assert_same(tree, cold)
    _assert_same(tree, warm)


def test_corrupted_leaf_raises_integrity_error():
    tree = _jax_tree("smollm-135m", "float32")
    store = open_store(_uri("t"))
    manifest = save_checkpoint(store, "ckpt", 4, params_from_numpy(tree, "cpu"))
    key = manifest["leaves"][2]["key"]
    raw = bytearray(store.backing.get(key))
    raw[len(raw) // 2] ^= 0x40
    store.backing.put(key, bytes(raw))
    with pytest.raises(IntegrityError, match="checkpoint leaf"):
        restore_checkpoint(store, "ckpt", tree, policy=_policy(), device="cpu")


def test_restored_cpu_tensors_are_writable_and_do_not_alias_cache_blocks():
    """Restored leaves are the caller's own memory: writing to them raises
    no warning and changes neither the cached blocks nor the next restore
    served from that cache."""
    tree = _jax_tree("smollm-135m", "float32")
    store = open_store(_uri("t"))
    save_checkpoint(store, "ckpt", 1, params_from_numpy(tree, "cpu"))
    tiers = [MemTier(4 << 20)]
    policy = _policy(keep_cached=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first, _ = restore_checkpoint(store, "ckpt", tree, policy=policy, tiers=tiers,
                                      device="cpu")
        calls = _count_gets(store)
        for t in _flatten(first):
            t.add_(1)
        again, _ = restore_checkpoint(store, "ckpt", tree, policy=policy, tiers=tiers,
                                      device="cpu")
    assert len(calls) == 0                  # served from the same cached blocks
    _assert_same(tree, again)
    for a, b in zip(_flatten(first), _flatten(again)):
        assert torch.equal(a, b + 1)


def test_cuda_restore_without_a_card_raises():
    """No CPU fallback hides a missing device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda_restore.py covers it")
    store = open_store(_uri("t"))
    state = {"w": torch.ones(4)}
    save_checkpoint(store, "ckpt", 1, state)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        restore_checkpoint(store, "ckpt", state, device="cuda")


# --------------------------------------------------------------------------- #
# tests/test_data_ckpt_ft.py::TestCheckpoint, against the port
# --------------------------------------------------------------------------- #
def make_store(**kw) -> SimS3Store:
    return SimS3Store(link=LinkModel(**kw))


def _state(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn((32, 64), generator=g),
            "b": torch.zeros((64,), dtype=torch.bfloat16),
        },
        "step": torch.tensor(7, dtype=torch.int32),
    }


class TestCheckpoint:
    @pytest.mark.parametrize("mode", ["rolling", "sequential"])
    def test_save_restore_roundtrip(self, mode):
        store = make_store()
        state = _state()
        save_checkpoint(store, "ckpt", 10, state, extra={"cursor": {"epoch": 1}})
        with pytest.warns(DeprecationWarning):
            restored, manifest = restore_checkpoint(store, "ckpt", _state(1), mode=mode,
                                                    device="cpu")
        assert manifest["step"] == 10
        assert manifest["extra"]["cursor"]["epoch"] == 1
        assert list(restored) == ["params", "step"] and list(restored["params"]) == ["w", "b"]
        for a, b in zip(_flatten(state), _flatten(restored)):
            assert torch.equal(a, b) and a.dtype == b.dtype

    def test_latest_step_and_gc(self):
        store = make_store()
        for s in (5, 10, 15, 20):
            save_checkpoint(store, "ckpt", s, _state())
        assert latest_step(store, "ckpt") == 20
        gc_checkpoints(store, "ckpt", keep_last=2)
        assert latest_step(store, "ckpt") == 20
        assert sorted({m.key.split("/")[1] for m in store.list_objects("ckpt")}) == [
            "step_00000015", "step_00000020"]
        with pytest.raises(Exception):
            restore_checkpoint(store, "ckpt", _state(), step=5, device="cpu")

    def test_manifest_is_commit_point(self):
        """A save interrupted before the manifest is invisible."""
        store = make_store()
        save_checkpoint(store, "ckpt", 10, _state())
        # Simulate partial save of step 20: leaves but no manifest.
        store.put(_leaf_key("ckpt", 20, 0), b"garbage")
        assert latest_step(store, "ckpt") == 10
        restored, manifest = restore_checkpoint(store, "ckpt", _state(), device="cpu")
        assert manifest["step"] == 10

    def test_async_manager(self):
        store = make_store()
        mgr = CheckpointManager(store, "ckpt", interval_steps=2, keep_last=2)
        state = _state()
        saved = [mgr.maybe_save(s, state) for s in range(1, 7)]
        mgr.wait()
        assert saved == [False, True, False, True, False, True]
        assert latest_step(store, "ckpt") == 6

    def test_async_manager_snapshots_before_training_moves_on(self):
        """The upload sees the state as it was at `maybe_save`, even when
        training updates its tensors in place while bytes stream out."""
        store = make_store(latency_s=0.002)
        mgr = CheckpointManager(store, "ckpt", interval_steps=1)
        state = _state()
        want = {k: v.clone() for k, v in state["params"].items()}
        assert mgr.maybe_save(1, state)
        state["params"]["w"].add_(1)
        mgr.wait()
        restored, _ = restore_checkpoint(store, "ckpt", state, device="cpu")
        assert torch.equal(restored["params"]["w"], want["w"])

    def test_restore_with_abstract_template(self):
        """Templates may be meta tensors (the counterpart of JAX's
        ShapeDtypeStruct)."""
        store = make_store()
        state = _state()
        save_checkpoint(store, "ckpt", 1, state)
        template = {"params": {k: v.to("meta") for k, v in state["params"].items()},
                    "step": state["step"].to("meta")}
        restored, _ = restore_checkpoint(store, "ckpt", template, device="cpu")
        assert restored["params"]["w"].device.type == "cpu"
        assert torch.equal(restored["params"]["w"], state["params"]["w"])

    def test_store_failures_during_restore_are_retried(self):
        store = make_store()
        save_checkpoint(store, "ckpt", 3, _state())
        store.link.fail_next(2)
        restored, _ = restore_checkpoint(store, "ckpt", _state(),
                                         policy=IOPolicy(engine="rolling"), device="cpu")
        assert int(restored["step"]) == 7
