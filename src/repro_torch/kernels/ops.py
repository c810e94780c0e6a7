"""Public entries for the kernels: a CUDA tensor goes to the kernel, a CPU
tensor to its plain version. There is no fallback: a CUDA tensor the kernel
does not take raises.

Both kernels are forward only, as the Pallas kernels they replace are: a
launch returns tensors with no autograd history. So a CUDA input that
requires grad while grad mode is on raises rather than silently cutting
the graph; training takes the plain paths (`models.layers._attn_core`,
`models.ssd.ssd_chunked`), as the JAX package's training does."""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd records an op on these inputs: such a call must take
    a plain path, since the kernels are forward only."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _forward_only(name: str, *tensors: torch.Tensor | None) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward only and would cut the "
                           f"autograd graph of an input that requires grad; call it under "
                           f"torch.no_grad() or take the plain path")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D), with the
    top-left causal mask. The kernel is compiled for one tile, `block_q` =
    `block_k` = 64; any other asks for a kernel that does not exist."""
    if block_q != _fa.BLOCK or block_k != _fa.BLOCK:
        raise ValueError(f"tile ({block_q}, {block_k}) not compiled; have "
                         f"({_fa.BLOCK}, {_fa.BLOCK})")
    if q.is_cuda:
        _forward_only("flash_attention", q, k, v)
        return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")


def ssd_scan(x: torch.Tensor, dt_a: torch.Tensor, b_proj: torch.Tensor,
             c_proj: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Mamba-2 SSD scan. x: (B, S, H, P) dt-scaled; dt_a: (B, S, H);
    B/C: (B, S, G, N); returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) fp32). The chunk is min(chunk, S) and must divide S."""
    if x.is_cuda:
        _forward_only("ssd_scan", x, dt_a, b_proj, c_proj, initial_state)
        return _ssd.ssd_scan_cuda(x, dt_a, b_proj, c_proj, chunk=chunk,
                                  initial_state=initial_state)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt_a, b_proj, c_proj, chunk=chunk,
                                   initial_state=initial_state)
    raise ValueError(f"no ssd scan for device {x.device}")
