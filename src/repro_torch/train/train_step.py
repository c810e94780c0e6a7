"""Train-step builder: loss -> grads -> AdamW, with optional microbatch
gradient accumulation, as the JAX package's ``train/train_step.py``.

The forward and backward passes are PyTorch autograd: plain ops, and on
the card the flash attention kernel with its backward where the model
code finds the call fits (`models.layers.trains_through_flash`); the
gradients of the parameter leaves come from `torch.autograd.grad`. The
step keeps its metrics on the device, so it never waits for the card.
While a profiler session runs, the step and its phases are spans
(`repro_torch.spans`): ``step``, and in it ``step.forward``,
``step.backward`` (the periods' recompute under remat included) and
``step.optimizer``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import spans, tree
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
    """`n` microbatches along B. A plain tensor splits in order (the
    reference's reshape to (n, B // n, ...)); a `DTensor` splits each
    rank's local rows so, and keeps its layout: microbatch i holds every
    rank's i-th n-th of its rows. Splitting the global rows instead would
    cut a dim sharded over the batch's ranks at other than their bounds."""
    for x in batch.values():
        rows = x.to_local().shape[0] if isinstance(x, DTensor) else x.shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows (on this rank) does not split into "
                             f"{n} microbatches")

    def split(x: torch.Tensor) -> list[torch.Tensor]:
        if not isinstance(x, DTensor):
            return list(x.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0))
        local = x.to_local()
        shape = (x.shape[0] // n, *x.shape[1:])
        return [DTensor.from_local(part, x.device_mesh, x.placements, run_check=False,
                                   shape=shape, stride=_contiguous_strides(shape))
                for part in local.reshape(n, local.shape[0] // n, *local.shape[1:]).unbind(0)]

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _contiguous_strides(shape: tuple) -> tuple:
    strides, acc = [], 1
    for size in reversed(shape):
        strides.append(acc)
        acc *= size
    return tuple(reversed(strides))


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient `g` laid out as its parameter `p`, a partial sum
    reduced once into the parameter's shards. `DTensor` leaves some
    gradients partial sums (an expert weight's over the batch's axes);
    the optimizer reads each gradient three times (the norm, the two
    moments) and would reduce it at each read."""
    if isinstance(g, DTensor) and isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_train_step(model: Model, opt_cfg: AdamWConfig,
                     step_cfg: StepConfig = StepConfig()):
    """Returns train_step(state, batch) -> (state, metrics): `batch` holds
    ``inputs`` and ``labels`` tensors on the parameters' device; metrics
    are 0-d tensors there (``loss``, ``grad_norm``, ``lr``)."""

    def loss_and_grads(params, batch: dict) -> tuple[torch.Tensor, dict]:
        with spans.span("step.forward"), torch.enable_grad():
            # Fresh leaves that share the parameters' memory and record a
            # graph; the state's own tensors never require grad.
            live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), params)
            loss = model.loss(live, batch, q_chunk=step_cfg.q_chunk,
                              loss_chunk=step_cfg.loss_chunk, remat=step_cfg.remat)
        leaves = tree.flatten(live)
        with spans.span("step.backward"), torch.enable_grad():
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _laid_out_as(g, p)
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree.unflatten(params, iter(grads))

    def train_step(state: TrainState, batch: dict):
        with spans.span("step"):
            if step_cfg.microbatches <= 1:
                loss, grads = loss_and_grads(state.params, batch)
            else:
                # The reference adds each microbatch to fp32 zeros: the first
                # sum is that microbatch itself, so it starts the running sums.
                loss = grads = None
                for micro in _split_batch(batch, step_cfg.microbatches):
                    loss_i, g_i = loss_and_grads(state.params, micro)
                    if loss is None:
                        loss, grads = loss_i.float(), tree.map_leaves(lambda g: g.float(), g_i)
                    else:
                        loss = loss + loss_i
                        grads = tree.map_leaves(lambda a, b: a + b.float(), grads, g_i)
                inv = 1.0 / step_cfg.microbatches
                loss = loss * inv
                grads = tree.map_leaves(lambda g: g * inv, grads)

            with spans.span("step.optimizer"):
                params, opt, metrics = apply_updates(opt_cfg, state.params, grads, state.opt)
            return TrainState(params, opt), {"loss": loss, **metrics}

    return train_step
