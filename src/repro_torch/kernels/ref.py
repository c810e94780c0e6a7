"""Plain oracles, as the JAX package's ``kernels/ref.py`` has them. Used by
the tests only."""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,      # (B, Hq, Sq, D)
    k: torch.Tensor,      # (B, Hkv, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal masking counts from the bottom-right (``tril(k=Sk-Sq)``), unlike
    the flash kernel's top-left mask; the two agree when Sq == Sk."""
    sq, d = q.shape[2], q.shape[3]
    sk, group = k.shape[2], q.shape[1] // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
