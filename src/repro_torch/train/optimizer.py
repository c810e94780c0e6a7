"""AdamW by hand, the JAX package's ``train/optimizer.py`` for trees of
PyTorch tensors.

The optimizer state mirrors the parameter tree (the same nested dicts), so
a `TrainState` checkpoint numbers its leaves as the JAX package's does.
The arithmetic is the reference's, in fp32 whatever the parameters' dtype:
linear warmup then cosine decay, a global-norm clip, bias correction and
decoupled weight decay on every leaf. Moments are accumulated in fp32 and
rounded to `moments_dtype` when stored. Updates are functional: new
tensors come back and the old ones are left as they were.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the parameters' device
    m: dict             # first moments  (same tree as params)
    v: dict             # second moments


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # Moment storage dtype: "float32" (default) or "bfloat16" — halves
    # optimizer-state memory (8 -> 4 bytes/param beyond the fp32 master);
    # moments are accumulated in fp32 and rounded on store.
    moments_dtype: str = "float32"


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr (0-d fp32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(step < cfg.warmup_steps, 1.0, cos)


def _moment_dtype(cfg: AdamWConfig | None) -> torch.dtype:
    if cfg is not None and cfg.moments_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


def init_state(params, cfg: AdamWConfig | None = None) -> AdamWState:
    mdt = _moment_dtype(cfg)
    leaves = tree.flatten(params)
    device = leaves[0].device if leaves else None

    def zeros(p: torch.Tensor) -> torch.Tensor:
        # Like the parameter: a `DTensor` parameter's moments take its layout.
        return torch.zeros_like(p, dtype=mdt)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree.map_leaves(zeros, params),
        v=tree.map_leaves(zeros, params),
    )


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.flatten(grads)))


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig, params, grads, state: AdamWState
) -> tuple[dict, AdamWState, dict]:
    """One AdamW step; returns (params, state, metrics), metrics as 0-d
    tensors on the device (no host sync)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    mdt = _moment_dtype(cfg)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / b1c
        vhat = v32 / b2c
        step_vec = mhat / (torch.sqrt(vhat) + cfg.eps)
        new_p = p.float() - lr * (step_vec + cfg.weight_decay * p.float())
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = [upd(*leaves) for leaves in zip(
        tree.flatten(params), tree.flatten(grads), tree.flatten(state.m),
        tree.flatten(state.v))]
    new_params = tree.unflatten(params, (o[0] for o in out))
    new_m = tree.unflatten(params, (o[1] for o in out))
    new_v = tree.unflatten(params, (o[2] for o in out))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step, new_m, new_v), metrics
