"""Weight-only int8 quantization for serving; the port of the JAX package's
``models/quant.py``.

Symmetric int8 with per-group fp32 scales: a 2-D weight keeps one scale per
output channel (its input axis collapsed); a stacked or per-expert weight
(>= 3-D) keeps its leading axis and its last, and collapses the middle.
Embeddings, norms, biases named ``bias``, Mamba's ``dt_bias``/``a_log``/
``d_skip`` and routers stay as they are.

`QTensor` answers what the model code calls on a parameter leaf
(``.to(dtype)``, ``.shape``, ``.ndim``, and ``.unbind(0)`` when a stacked
tree is split into periods), so every model serves quantized with no change
to its code. Each ``.to`` dequantizes in full before the product that
consumes it: eager PyTorch does not fuse the convert into the matmul, as the
reference counts on the TPU's compiler doing.

Leaves are walked in ``jax.tree_util``'s order (dict keys sorted), and the
path a leaf is tested by is spelled as ``jax.tree_util.keystr`` spells it
(``['layers']['block0']['attn']['wq']``), so the same leaves match the skip
tokens as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.spec import ParamSpec, abstract_tensor


@dataclass
class QTensor:
    q: torch.Tensor        # int8, the weight's shape
    scale: torch.Tensor    # fp32, the weight's shape with the collapsed axes set to 1

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize: the reference's ``(q.astype(f32) * scale).astype(dtype)``.
        ``q * scale`` promotes int8 to fp32 inside the multiply (every int8
        is exact in fp32), so it gives the same numbers with one pass fewer
        than ``q.float() * scale``; the one rounding is the cast to `dtype`."""
        return (self.q * self.scale).to(dtype)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def unbind(self, dim: int = 0) -> tuple[QTensor, ...]:
        """Views of the periods of a stacked leaf (axis 0), each with its
        own scale. A scale that collapses axis 0 (a 2-D stacked leaf, such
        as whisper's ``bo`` of shape (periods, d)) is shared by every
        period."""
        if dim != 0:
            raise ValueError(f"QTensor unbinds along axis 0 only, got {dim}")
        scales = self.scale.expand(self.q.shape[0], *self.scale.shape[1:]).unbind(0)
        return tuple(QTensor(q, s) for q, s in zip(self.q.unbind(0), scales))


def _scale_axes(ndim: int) -> tuple[int, ...]:
    """Axes collapsed into the quantization group: the input axis of a 2-D
    weight; every axis but the first (the stack or expert axis) and the
    last (the output channel) of a >= 3-D one."""
    if ndim <= 2:
        return (0,)
    return tuple(range(1, ndim - 1))


def quantize_array(w: torch.Tensor) -> QTensor:
    """Symmetric int8 with per-group scales (see `_scale_axes`), on `w`'s
    device: the reference's arithmetic (an fp32 true division, round half
    to even), bit for bit. The rounding and clamp work in place on one
    fp32 temporary of `w`'s size."""
    wf = w.float()
    amax = wf.abs().amax(dim=_scale_axes(wf.ndim), keepdim=True)
    # A tensor divisor: PyTorch's CUDA kernel multiplies by the reciprocal
    # of a Python-scalar divisor, which rounds some scales one bit away
    # from the reference's true division.
    scale = torch.where(amax == 0, 1.0, amax / torch.full_like(amax, 127.0))
    t = wf / scale
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


_SKIP_TOKENS = ("embed", "norm", "scale", "bias", "dt_bias", "a_log",
                "d_skip", "router")


def _quantizable(path: str, ndim: int) -> bool:
    if ndim < 2:
        return False
    return not any(t in path for t in _SKIP_TOKENS)


def _walk(tree, path: str, fn):
    """`tree` with `fn(path, leaf)` in place of every leaf, visited in sorted
    key order (each dict keeps its own key order); `path` in
    ``jax.tree_util.keystr``'s spelling."""
    if isinstance(tree, dict):
        filled = {k: _walk(tree[k], f"{path}[{k!r}]", fn) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    return fn(path, tree)


def quantize_params(params: dict) -> tuple[dict, int]:
    """Quantize every eligible weight leaf; returns (tree, n_quantized).
    Other leaves are the input's own tensors."""
    count = 0

    def leaf(path: str, x):
        nonlocal count
        if _quantizable(path, x.ndim):
            count += 1
            return quantize_array(x)
        return x

    return _walk(params, "", leaf), count


def abstract_quantized_params(spec_tree: dict, rules=None) -> dict:
    """No-allocation stand-ins for a quantized parameter tree (dry-run,
    restore template): int8 ``q`` and fp32 ``scale`` for a quantizable
    leaf, bf16 for every other, as the reference builds its
    ``ShapeDtypeStruct``s; sharded per `rules` (`spec.abstract_tensor`),
    a scale by the weight's axes with its collapsed ones unsharded."""

    def leaf(path: str, ps: ParamSpec):
        shard = rules.sharding(ps.axes, ps.shape) if rules else None
        if _quantizable(path, len(ps.shape)):
            collapsed = _scale_axes(len(ps.shape))
            s_shape = tuple(1 if i in collapsed else d for i, d in enumerate(ps.shape))
            s_axes = tuple(None if i in collapsed else a for i, a in enumerate(ps.axes))
            s_shard = rules.sharding(s_axes, s_shape) if rules else None
            return QTensor(q=abstract_tensor(ps.shape, torch.int8, shard),
                           scale=abstract_tensor(s_shape, torch.float32, s_shard))
        return abstract_tensor(ps.shape, torch.bfloat16, shard)

    return _walk(spec_tree, "", leaf)


def quantized_bytes(tree) -> int:
    """Bytes of every tensor in `tree` (a `QTensor` counts its q and scale)."""
    from repro_torch import tree as T   # tree.py imports QTensor from here

    return sum(t.numel() * t.element_size() for t in T.flatten(tree))
