"""Plain fp32 training reference: the loss of `reference.lm`, its gradients
by autograd, and AdamW (Loshchilov & Hutter) with a global-norm clip,
linear warmup then cosine decay to ``min_lr_ratio`` of the rate, bias
correction, and decoupled weight decay on every leaf. It imports nothing of
the program.

The batch's rows go through the model one at a time and their gradients
are summed (the loss is the mean over every token of the batch), and each
layer is computed again in the backward pass, so that a full-width model at
the published context fits on one card.
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import lm as ref


def leaves(tree: dict) -> list:
    """The tensors of a nested dict, by sorted key at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def paths(tree: dict, prefix: str = "") -> list:
    """The dotted paths of `leaves`' tensors, in the same order."""
    out = []
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        out.extend(paths(v, path + ".") if isinstance(v, dict) else [path])
    return out


def _replace(tree: dict, new: iter) -> dict:
    return {k: _replace(tree[k], new) if isinstance(tree[k], dict) else next(new)
            for k in sorted(tree)}


def learning_rate(opt: dict, step: int) -> float:
    """The rate of optimizer step `step` (1 for the first)."""
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    floor = opt["min_lr_ratio"]
    return lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw_steps(params0: dict, c: dict, batches: list, opt: dict,
                pr: ref.Precision = ref.FP32, chunk: int = 512) -> dict:
    """Train from `params0` one AdamW step on each of `batches` ((inputs,
    labels) of shape (B, T)). Returns each step's loss, each leaf's norm of
    the first step's (unclipped) gradient, and each leaf's norm of the
    change from `params0` after the last step, all in float64 on the CPU."""
    start = [p.detach().float() for p in leaves(params0)]
    params = [p.clone() for p in start]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first_grad = [], None
    with ref.fp32_strict():
        for step, (inputs, labels) in enumerate(batches, start=1):
            live = [p.requires_grad_(True) for p in params]
            tree = _replace(params0, iter(live))
            rows = inputs.shape[0]
            total = 0.0
            for r in range(rows):
                loss = ref.loss(tree, c, inputs[r:r + 1], labels[r:r + 1], pr, chunk,
                                remat=True) / rows
                loss.backward()
                total += float(loss.detach())
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in live]
            losses.append(total)
            gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
            if first_grad is None:
                first_grad = torch.tensor([float(g.double().norm()) for g in grads],
                                          dtype=torch.float64)
            scale = min(1.0, opt["grad_clip_norm"] / (gnorm + 1e-9))
            lr = learning_rate(opt, step)
            b1, b2 = opt["b1"], opt["b2"]
            with torch.no_grad():
                new = []
                for p, g, mi, vi in zip(live, grads, m, v):
                    g = g * scale
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = mi / (1 - b1 ** step)
                    vhat = vi / (1 - b2 ** step)
                    p0 = p.detach()
                    new.append(p0 - lr * (mhat / (vhat.sqrt() + opt["eps"])
                                          + opt["weight_decay"] * p0))
            params = new
    change = torch.tensor([float((p - s).double().norm()) for p, s in zip(params, start)],
                          dtype=torch.float64)
    return {"loss": torch.tensor(losses, dtype=torch.float64), "grad": first_grad,
            "change": change}
