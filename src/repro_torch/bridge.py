"""Carry parameters across from the JAX package.

The JAX side hands its tree over as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module imports neither JAX
nor ml_dtypes. A quantized weight arrives as the JAX package's own
``QTensor`` holding numpy ``q`` and ``scale`` arrays, and becomes the
port's `QTensor`. The walk goes by key, so it does not depend on the order in
which either framework flattens a tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.quant import QTensor


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A copy of `a` on `device`, dtype kept. bfloat16 (ml_dtypes) arrays,
    which `torch.from_numpy` rejects, cross as their uint16 bits."""
    a = np.array(a, order="C")  # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf(v, device):
    # The reference's QTensor cannot be imported here: it is known by its
    # two fields.
    if hasattr(v, "q") and hasattr(v, "scale"):
        return QTensor(tensor_from_numpy(np.asarray(v.q), device),
                       tensor_from_numpy(np.asarray(v.scale), device))
    return tensor_from_numpy(np.asarray(v), device)


def params_from_numpy(tree: dict, device) -> dict:
    """Nested dicts of numpy arrays (or of quantized weights holding them)
    -> the same nested dicts of tensors (or of port `QTensor`s)."""
    return {
        k: params_from_numpy(v, device) if isinstance(v, dict) else _leaf(v, device)
        for k, v in tree.items()
    }
