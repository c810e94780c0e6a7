"""Parameter specifications: one declarative tree drives parameter init,
abstract init (``meta`` tensors, and `DTensor`s over ``meta`` shards when
sharded) for the no-allocation dry-run and restore templates, and sharding
assignment, with the JAX package's paths, shapes and logical axes.

Trees are nested dicts whose leaves are `ParamSpec` (a spec tree) or
tensors (a parameter tree); a leaf's path is its keys joined by dots, as
in ``layers.block0.attn.wq``.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass
from typing import Callable, Iterator

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.sharding.rules import NamedSharding, ShardingRules


@dataclass(frozen=True)
class Ax:
    """Leaf marker carrying logical sharding axes for a non-parameter tensor
    (caches, activations) in a structure-matched axes tree. A plain tuple
    cannot serve: tuples are tree nodes and would dissolve into leaves."""

    axes: tuple


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]       # logical axis names
    init: tuple | str = ("normal", 0.02)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree):
    """Apply `fn` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(dotted path, leaf) for every leaf, in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_leaves(v, path)
        else:
            yield path, v


def stacked(n: int, tree):
    """Add a leading stacking dim (one slot per period) to every spec."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), (None, *s.axes), s.init, s.dtype), tree
    )


def _materialize(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    kind = spec.init if isinstance(spec.init, str) else spec.init[0]
    if kind == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=device)
        return u * (hi - lo) + lo

    if kind == "uniform":
        return uniform(spec.init[1], spec.init[2]).to(dtype)
    if kind == "a_log":
        # Mamba-2 A initialization: A = -exp(a_log), a_log = log(U[1,16]).
        return torch.log(uniform(1.0, 16.0)).to(dtype)
    if kind == "dt_bias":
        # dt bias such that softplus(dt_bias) ~ log-uniform on [1e-3, 0.1].
        dt = torch.exp(uniform(math.log(1e-3), math.log(0.1)))
        return torch.log(torch.expm1(dt)).to(dtype)
    if kind == "normal":
        std = spec.init[1]
    elif kind == "fan_in":
        std = 1.0 / math.sqrt(spec.init[1])
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def init_params(spec_tree, seed: int, *, device, param_dtype=torch.float32):
    """Materialize real parameters on `device`. Each leaf draws from its own
    `torch.Generator`, seeded with the CRC-32 of `seed` and its path, so
    adding a parameter never reshuffles the others' values and the same seed
    gives the same weights in every process."""
    device = torch.device(device)

    def leaf(path: str, s: ParamSpec) -> torch.Tensor:
        gen = torch.Generator(device=device)
        # The CPU generator keeps 32 bits of its seed: hash seed and path together.
        gen.manual_seed(zlib.crc32(f"{seed}:{path}".encode()))
        dtype = s.dtype if s.dtype != torch.float32 else param_dtype
        return _materialize(s, gen, dtype, device)

    def walk(tree, prefix: str):
        return {
            k: walk(v, f"{prefix}{k}.") if isinstance(v, dict) else leaf(prefix + k, v)
            for k, v in tree.items()
        }

    return walk(spec_tree, "")


def placed_tensor(shape, dtype: torch.dtype, sharding: NamedSharding | None = None, *,
                  device="meta") -> torch.Tensor:
    """A tensor of global `shape` laid out by `sharding`: a ``meta`` tensor
    (no allocation) on the ``meta`` device, zeros on any other; with a
    `sharding`, a `DTensor` over this rank's shard of that kind, the whole
    tensor never built."""
    def make(size):
        if torch.device(device).type == "meta":
            return torch.empty(size, dtype=dtype, device="meta")
        return torch.zeros(size, dtype=dtype, device=device)

    if sharding is None:
        return make(shape)
    # Every rank's shard has one shape: the rules shard a dim only where
    # it divides evenly.
    local = list(shape)
    for size, p in zip(sharding.mesh.shape, sharding.placements):
        if isinstance(p, Shard):
            if local[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split into {size}")
            local[p.dim] //= size
    # The global shape and stride given: from_local would otherwise infer
    # them, wrongly for replicated dims, or by a collective.
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(make(local), sharding.mesh, sharding.placements,
                              shape=torch.Size(shape), stride=stride)


def abstract_tensor(shape, dtype: torch.dtype,
                    sharding: NamedSharding | None = None) -> torch.Tensor:
    """A no-allocation stand-in of a tensor (the counterpart of
    ``jax.ShapeDtypeStruct``): a ``meta`` tensor, or with a `sharding` a
    `DTensor` of global `shape` over this rank's ``meta`` shard."""
    return placed_tensor(shape, dtype, sharding)


def abstract_params(spec_tree, rules: ShardingRules | None = None,
                    param_dtype=torch.float32):
    """Abstract tensors with shardings — the dry-run's no-allocation
    stand-in for real parameters, and a restore template."""

    def leaf(s: ParamSpec):
        dtype = s.dtype if s.dtype != torch.float32 else param_dtype
        return abstract_tensor(s.shape, dtype, rules.sharding(s.axes, s.shape) if rules else None)

    return tree_map(leaf, spec_tree)


def param_shardings(spec_tree, rules: ShardingRules):
    return tree_map(lambda s: rules.sharding(s.axes, s.shape), spec_tree)


def abstract_like(shape_tree, axes_tree, rules: ShardingRules | None, *, device="meta"):
    """Attach shardings (from an Ax tree) to a tree of ``meta`` tensors:
    ``meta`` stand-ins, or on another `device` zeros (`placed_tensor`).
    Dicts and dataclasses (`KVCache`, `MambaCache`) are walked field by
    field; a leaf that is not a tensor (a cache's host-side length) is
    kept as it is."""

    def walk(x, ax):
        if isinstance(x, dict):
            return {k: walk(v, ax[k]) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name), getattr(ax, f.name))
                                             for f in dataclasses.fields(x)})
        if not isinstance(x, torch.Tensor):
            return x
        sharding = None
        if rules is not None and isinstance(ax, Ax):
            sharding = rules.sharding(ax.axes, tuple(x.shape))
        return placed_tensor(tuple(x.shape), x.dtype, sharding, device=device)

    return walk(shape_tree, axes_tree)


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(spec_tree))
