"""Restarts and `TrainState` checkpoints in the port: the JAX package's
`TestRestart` (tests/test_data_ckpt_ft.py) with a torch step function, a
crashed training run of reduced smollm-135m that resumes to the
uninterrupted run's losses, and `TrainState` checkpoints carried between
the two packages both ways, leaf for leaf and byte for byte."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore_checkpoint
from repro.ckpt import save_checkpoint as jax_save_checkpoint
from repro.store import LinkModel as JaxLinkModel
from repro.store import SimS3Store as JaxSimS3Store
from repro.train import TrainState as JaxTrainState
from repro.train.optimizer import AdamWState as JaxAdamWState
from repro_torch import tree
from repro_torch.bridge import tensor_from_numpy
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import LoaderConfig, PrefetchingDataLoader, synth_token_shard
from repro_torch.ft import RestartManager, run_with_restarts
from repro_torch.io import IOPolicy
from repro_torch.models import make_model
from repro_torch.store import LinkModel, MemTier, SimS3Store
from repro_torch.train import (
    AdamWConfig,
    AdamWState,
    StepConfig,
    TrainState,
    build_train_step,
    init_train_state,
)


def make_store(objects: dict[str, bytes], **kw) -> SimS3Store:
    store = SimS3Store(link=LinkModel(**kw))
    for k, v in objects.items():
        store.backing.put(k, v)
    return store


class TestRestart:
    def test_crash_resume_matches_uninterrupted_run(self):
        """Training with injected crashes lands on the same final state as
        an uninterrupted run (determinism of plan + checkpoint/restore)."""
        rng = np.random.default_rng(3)
        objects = {f"tok{i}.bin": synth_token_shard(rng, 4000, vocab=100)
                   for i in range(2)}

        def build(crash_at):
            store = make_store(dict(objects))
            ckpt_store = make_store({})
            mgr = RestartManager(ckpt_store, "run", ckpt_interval=2, device="cpu")

            def make_initial_state():
                return {"w": torch.zeros(8), "count": torch.tensor(0, dtype=torch.int32)}

            def make_loader(cursor):
                cfg = LoaderConfig(seq_len=32, batch_size=2, blocksize=2048)
                return PrefetchingDataLoader(
                    store, store.backing.list_objects(),
                    [MemTier(1 << 20)], cfg, cursor=cursor,
                )

            def step_fn(state, inputs, labels):
                upd = torch.bincount(torch.from_numpy(inputs).reshape(-1) % 8,
                                     minlength=8).float()
                new = {"w": state["w"] + upd, "count": state["count"] + 1}
                return new, {"loss": upd.sum()}

            return run_with_restarts(
                total_steps=9,
                make_initial_state=make_initial_state,
                make_loader=make_loader,
                train_step=step_fn,
                restart_mgr=mgr,
                crash_at=crash_at,
            ), ckpt_store

        clean, clean_store = build(crash_at=None)
        crashed, ckpt_store = build(crash_at={4, 7})
        assert clean.restarts == 0
        assert crashed.restarts == 2
        assert crashed.final_step == clean.final_step == 9
        t = {"w": torch.zeros(8), "count": torch.tensor(0, dtype=torch.int32)}
        s1, _ = restore_checkpoint(ckpt_store, "run", t, device="cpu")
        s2, _ = restore_checkpoint(clean_store, "run", t, device="cpu")
        assert int(s1["count"]) == 9
        assert torch.equal(s1["w"], s2["w"])

    def test_store_failures_during_restore_are_retried(self):
        store = make_store({})
        state = {"w": torch.arange(6.0), "step": torch.tensor(7, dtype=torch.int32)}
        save_checkpoint(store, "ckpt", 3, state)
        store.link.fail_next(2)
        restored, _ = restore_checkpoint(store, "ckpt", state,
                                         policy=IOPolicy(engine="rolling"), device="cpu")
        assert int(restored["step"]) == 7


def test_training_resumes_to_the_uninterrupted_runs_losses():
    """Reduced smollm-135m trained through `run_with_restarts` with a crash
    after the step-4 checkpoint: the restarted run's losses from step 5 on
    equal the uninterrupted run's, bit for bit (CPU arithmetic repeats)."""
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)
    rng = np.random.default_rng(4)
    objects = {f"tok{i}.bin": synth_token_shard(rng, 3000, cfg.vocab_size) for i in range(2)}
    step = build_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                            StepConfig(q_chunk=32, loss_chunk=32))

    def train_step(state, inputs, labels):
        return step(state, {"inputs": torch.from_numpy(inputs),
                            "labels": torch.from_numpy(labels)})

    class Restarts(RestartManager):
        """Lets the previous attempt's write-behind save commit before a
        restore looks for the newest checkpoint, as a replacement host
        arriving later would find it."""
        last = None

        def manager(self):
            self.last = super().manager()
            return self.last

        def restore(self, template, **kw):
            if self.last is not None:
                self.last.wait()
            return super().restore(template, **kw)

    def run(crash_at):
        store = make_store(dict(objects))
        return run_with_restarts(
            total_steps=8,
            make_initial_state=lambda: init_train_state(model, 0, device="cpu"),
            make_loader=lambda cursor: PrefetchingDataLoader(
                store, store.backing.list_objects(), [MemTier(1 << 20)],
                LoaderConfig(seq_len=32, batch_size=2, blocksize=4096), cursor=cursor),
            train_step=train_step,
            restart_mgr=Restarts(make_store({}), "run", ckpt_interval=4, device="cpu"),
            crash_at=crash_at,
        )

    clean, crashed = run(None), run({6})
    assert crashed.restarts == 1 and len(clean.losses) == 8
    # The crashed run logs steps 1-6, then 5-8 again from the step-4 checkpoint.
    assert crashed.losses[:6] == clean.losses[:6]
    assert crashed.losses[6:] == clean.losses[4:]


# --------------------------------------------------------------------------- #
# TrainState checkpoints across the two packages
# --------------------------------------------------------------------------- #
def _port_state(moments: str) -> TrainState:
    """A reduced smollm-135m TrainState part way through training: moments
    and the step are not zero."""
    model = make_model(get_config("smollm-135m").reduced())
    opt = AdamWConfig(moments_dtype=moments, warmup_steps=1)
    state = init_train_state(model, 0, device="cpu", opt_cfg=opt)
    step = build_train_step(model, opt, StepConfig(q_chunk=16, loss_chunk=16))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 17)))
    state, _ = step(state, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
    return state


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _jax_state(state: TrainState) -> JaxTrainState:
    """The same values in the JAX package's TrainState."""
    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else jnp.asarray(_to_numpy(v))
                for k, v in t.items()}

    return JaxTrainState(conv(state.params), JaxAdamWState(
        jnp.asarray(state.opt.step.numpy()), conv(state.opt.m), conv(state.opt.v)))


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _same(port: TrainState, jx: JaxTrainState) -> None:
    jleaves = jax.tree.leaves(jx)
    leaves = tree.flatten(port)
    assert len(leaves) == len(jleaves) == 3 * len(tree.flatten(port.params)) + 1
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == np.asarray(b).dtype.name
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_jax_trainstate_checkpoint_restores_into_port(moments):
    state = _port_state(moments)
    jstore = JaxSimS3Store(link=JaxLinkModel(latency_s=0.0))
    jax_save_checkpoint(jstore, "ckpt", 7, _jax_state(state))
    store = make_store({}, latency_s=0.0)
    for meta in jstore.backing.list_objects():
        store.backing.put(meta.key, jstore.backing.get(meta.key))
    got, manifest = restore_checkpoint(store, "ckpt", init_train_state(
        make_model(get_config("smollm-135m").reduced()), 1, device="cpu",
        opt_cfg=AdamWConfig(moments_dtype=moments)), device="cpu")
    assert manifest["step"] == 7
    assert isinstance(got, TrainState) and isinstance(got.opt, AdamWState)
    assert list(got.params) == list(state.params)      # the template's key order
    _same(got, _jax_state(state))
    for a, b in zip(tree.flatten(got), tree.flatten(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_trainstate_checkpoint_restores_into_jax(moments):
    state = _port_state(moments)
    store = make_store({}, latency_s=0.0)
    save_checkpoint(store, "ckpt", 3, state, extra={"cursor": {"epoch": 0,
                                                              "windows_emitted": 4}})
    jstore = JaxSimS3Store(link=JaxLinkModel(latency_s=0.0))
    for meta in store.backing.list_objects():
        jstore.backing.put(meta.key, store.backing.get(meta.key))
    template = jax.tree.map(jnp.zeros_like, _jax_state(state))
    got, manifest = jax_restore_checkpoint(jstore, "ckpt", template)
    assert isinstance(got, JaxTrainState)
    assert manifest["extra"]["cursor"]["windows_emitted"] == 4
    _same(state, got)


def test_both_packages_store_the_same_trainstate_objects():
    state = _port_state("bfloat16")
    store, jstore = make_store({}, latency_s=0.0), JaxSimS3Store(link=JaxLinkModel(latency_s=0.0))
    save_checkpoint(store, "ckpt", 1, state)
    jax_save_checkpoint(jstore, "ckpt", 1, _jax_state(state))
    keys = [m.key for m in store.backing.list_objects()]
    assert keys == [m.key for m in jstore.backing.list_objects()]
    for key in keys:
        if not key.endswith("MANIFEST.json"):
            assert store.backing.get(key) == jstore.backing.get(key), key


def test_tensor_from_numpy_carries_a_jax_trainstate_leaf():
    """The bridge takes the JAX state's bf16 moments as they come."""
    state = _port_state("bfloat16")
    leaf = np.asarray(_jax_state(state).opt.m["embed"]["table"])
    assert torch.equal(tensor_from_numpy(leaf, "cpu"), state.opt.m["embed"]["table"])
