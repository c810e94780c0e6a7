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


def ssd_ref(
    x: torch.Tensor,       # (B, S, H, P): dt-scaled inputs
    dt_a: torch.Tensor,    # (B, S, H)
    b_proj: torch.Tensor,  # (B, S, G, N)
    c_proj: torch.Tensor,  # (B, S, G, N)
    initial_state: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential (token-by-token) state-space recurrence, the definitional
    oracle that both the chunked path and the kernel must match:
        h_t = exp(dt_a_t) h_{t-1} + B_t x_t ;  y_t = C_t . h_t
    """
    bsz, s, h, p = x.shape
    g, n = b_proj.shape[2], b_proj.shape[3]
    rep = h // g
    bh = b_proj.float().repeat_interleave(rep, dim=2)   # (B, S, H, N)
    ch = c_proj.float().repeat_interleave(rep, dim=2)
    xf = x.float()
    decay = torch.exp(dt_a.float())                     # (B, S, H)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t], bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state
