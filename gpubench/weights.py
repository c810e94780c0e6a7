"""Seeded weights for a model of the program, made on the device in a few
large calls.

Only the shapes and paths of the program's parameter tree are read (its
spec); the values are the benchmark's own, from `--seed`. Every normally
distributed leaf is a view of one flat buffer drawn by one `randn` call in
the dtype the weights are used in, then scaled in place; Mamba's A and dt
biases come from one `rand` call. The same seed gives the same values on
the same device, so the reference can make them again after the window.
"""

from __future__ import annotations

import math

import torch

# Leaves whose input (fan-in) dims lead, and how many of them: a query, key
# or value projection (d, H, D_h) multiplies d; every other matrix
# multiplies all its dims but the last.
_FAN_IN_DIMS = {"wq": 1, "wk": 1, "wv": 1}
_EMBED = {"table": 0.02, "out_table": 0.02}
_ONES = ("d_skip", "norm_scale", "scale")
_ZEROS = ("bias", "bq", "bk", "bv", "bo", "b_up", "b_down")
_UNIFORM = ("a_log", "dt_bias")


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, tuple(v.shape)


def _set(tree: dict, path: str, value) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    # Any whole number: folded into 62 bits, two bits left for the stream.
    g.manual_seed((int(seed) % (1 << 62)) * 4 + stream)
    return g


def _normal_std(name: str, shape: tuple, stacked: bool) -> float:
    if name in _EMBED:
        return _EMBED[name]
    dims = shape[1:] if stacked else shape
    lead = _FAN_IN_DIMS.get(name, len(dims) - 1)
    return 1.0 / math.sqrt(math.prod(dims[:lead]))


def make_params(spec: dict, seed: int, *, dtype: torch.dtype, device) -> dict:
    """A parameter tree shaped as `spec` (the program's spec tree: only each
    leaf's ``.shape`` is read), its values drawn from `seed` on `device`."""
    device = torch.device(device)
    normal, uniform, out = [], [], {}
    for path, shape in _leaves(spec):
        name = path.rsplit(".", 1)[-1]
        if name in _ONES:
            _set(out, path, torch.ones(shape, dtype=dtype, device=device))
        elif name in _ZEROS:
            _set(out, path, torch.zeros(shape, dtype=dtype, device=device))
        elif name in _UNIFORM:
            uniform.append((path, name, shape))
        else:
            normal.append((path, name, shape))

    total = sum(math.prod(s) for _, _, s in normal)
    flat = torch.randn(total, generator=_generator(seed, 0, device), dtype=dtype, device=device)
    at = 0
    for path, name, shape in normal:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(_normal_std(name, shape, path.startswith("layers.")))
        _set(out, path, leaf)
        at += n

    total = sum(math.prod(s) for _, _, s in uniform)
    if total:
        u = torch.rand(total, generator=_generator(seed, 1, device), dtype=torch.float32,
                       device=device)
        at = 0
        for path, name, shape in uniform:
            n = math.prod(shape)
            x = u[at:at + n].view(shape)
            if name == "a_log":       # A = -exp(a_log), a_log = log(U[1, 16])
                leaf = torch.log(1.0 + 15.0 * x)
            else:                     # softplus(dt_bias) log-uniform on [1e-3, 0.1]
                dt = torch.exp(math.log(1e-3) + x * (math.log(0.1) - math.log(1e-3)))
                leaf = torch.log(torch.expm1(dt))
            _set(out, path, leaf.to(dtype))
            at += n
    return _ordered(spec, out)


def _ordered(spec: dict, values: dict) -> dict:
    """`values` with `spec`'s key order at every level."""
    return {k: _ordered(v, values.get(k, {})) if isinstance(v, dict) else values[k]
            for k, v in spec.items()}
