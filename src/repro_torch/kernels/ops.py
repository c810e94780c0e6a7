"""Public entries for the kernels: a CUDA tensor goes to the kernel, a CPU
tensor to its plain version. There is no fallback: a CUDA tensor the kernel
does not take raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa


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
        return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")
