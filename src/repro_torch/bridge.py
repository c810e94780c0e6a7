"""Carry parameters across from the JAX package.

The JAX side hands its tree over as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module imports neither JAX
nor ml_dtypes. The walk goes by key, so it does not depend on the order in
which either framework flattens a tree.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A copy of `a` on `device`, dtype kept. bfloat16 (ml_dtypes) arrays,
    which `torch.from_numpy` rejects, cross as their uint16 bits."""
    a = np.array(a, order="C")  # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: dict, device) -> dict:
    """Nested dicts of numpy arrays -> the same nested dicts of tensors."""
    return {
        k: params_from_numpy(v, device) if isinstance(v, dict)
        else tensor_from_numpy(np.asarray(v), device)
        for k, v in tree.items()
    }
