"""Train-step builder: loss -> grads -> AdamW, with optional microbatch
gradient accumulation, as the JAX package's ``train/train_step.py``.

The forward and backward passes are plain PyTorch autograd (the
hand-written kernels are forward only and are not on this path); the
gradients of the parameter leaves come from `torch.autograd.grad`. The
step keeps its metrics on the device, so it never waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.models.api import Model
from repro_torch.models.spec import abstract_tensor
from repro_torch.sharding.rules import NamedSharding
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    _moment_dtype,
    apply_updates,
    init_state,
)


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState


def init_train_state(model: Model, seed: int = 0, *, device="cuda",
                     param_dtype=torch.float32,
                     opt_cfg: AdamWConfig | None = None) -> TrainState:
    params = model.init(seed, device=device, param_dtype=param_dtype)
    return TrainState(params=params, opt=init_state(params, opt_cfg))


def abstract_train_state(model: Model, rules, param_dtype=torch.float32,
                         opt_cfg: AdamWConfig | None = None) -> TrainState:
    """The train state as abstract tensors (`models.spec.abstract_tensor`)
    for the dry-run and restore templates, with no allocation: the
    parameters sharded per `rules`, each moment like its parameter in the
    moments' dtype, the step a 0-d int32."""
    params = model.abstract_params(rules, param_dtype)
    mdt = _moment_dtype(opt_cfg)

    def like(p):
        sharding = NamedSharding(p.device_mesh, p.placements) if isinstance(p, DTensor) else None
        return abstract_tensor(tuple(p.shape), mdt, sharding)

    opt = AdamWState(
        step=abstract_tensor((), torch.int32),
        m=tree.map_leaves(like, params),
        v=tree.map_leaves(like, params),
    )
    return TrainState(params=params, opt=opt)


@dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    q_chunk: int = 512
    loss_chunk: int = 512
    remat: bool = True


def _split_batch(batch: dict, n: int) -> list[dict]:
    """`n` microbatches along B, in order (the reference's reshape to
    (n, B // n, ...))."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split into {n} microbatches")
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(n)]


def build_train_step(model: Model, opt_cfg: AdamWConfig,
                     step_cfg: StepConfig = StepConfig()):
    """Returns train_step(state, batch) -> (state, metrics): `batch` holds
    ``inputs`` and ``labels`` tensors on the parameters' device; metrics
    are 0-d tensors there (``loss``, ``grad_norm``, ``lr``)."""

    def loss_and_grads(params, batch: dict) -> tuple[torch.Tensor, dict]:
        # Fresh leaves that share the parameters' memory and record a graph;
        # the state's own tensors never require grad.
        live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = model.loss(live, batch, q_chunk=step_cfg.q_chunk,
                              loss_chunk=step_cfg.loss_chunk, remat=step_cfg.remat)
            leaves = tree.flatten(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), tree.unflatten(params, iter(grads))

    def train_step(state: TrainState, batch: dict):
        if step_cfg.microbatches <= 1:
            loss, grads = loss_and_grads(state.params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=batch["inputs"].device)
            grads = tree.map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                          device=p.device), state.params)
            for micro in _split_batch(batch, step_cfg.microbatches):
                loss_i, g_i = loss_and_grads(state.params, micro)
                loss = loss + loss_i
                grads = tree.map_leaves(lambda a, b: a + b.float(), grads, g_i)
            inv = 1.0 / step_cfg.microbatches
            loss = loss * inv
            grads = tree.map_leaves(lambda g: g * inv, grads)

        params, opt, metrics = apply_updates(opt_cfg, state.params, grads, state.opt)
        return TrainState(params, opt), {"loss": loss, **metrics}

    return train_step
