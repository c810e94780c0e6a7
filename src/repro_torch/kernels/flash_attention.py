"""Flash attention (forward) for Hopper: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_flash_kernel`` of ``src/repro/kernels/flash_attention.py``: blocked
online-softmax GQA attention with the top-left causal mask, fp32 softmax
state, and the output in q's dtype. bf16 inputs go to a tensor-core kernel
(bf16 products with fp32 sums, P rounded to bf16 before P V); fp32 inputs
to a scalar kernel in exact fp32. `flash_attention_cuda` launches it on
PyTorch's current stream; `flash_attention_plain` computes the same
function in plain PyTorch, for CPU tensors and as the kernel's yardstick on
the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.sharding.rules import replicate_like

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
BLOCK = 64  # the kernel's q and kv tile, fixed in csrc/flash_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: `flash_attention_cuda` adds one per
# launch and nothing else touches it, so a run can show that its main path
# went through the kernel.
launches = 0


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hkv dividing Hq."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Hq,Sq,D), k = v (B,Hkv,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         f"on batch, head dim or GQA grouping")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores, top-left causal
    mask (column <= row, counted from position 0 of both q and k), fp32
    softmax and product, output in q's dtype."""
    check_shapes(q, k, v)
    sq, d = q.shape[2], q.shape[3]
    sk, group = k.shape[2], q.shape[1] // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(replicate_like(cols > rows, s), NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), vf).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    )
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_occupancy.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.flash_attention_occupancy.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), any
    strides with a unit stride on D. Returns a tensor of q's shape, dtype and
    memory layout. Raises on anything the kernel does not take."""
    global launches
    check_shapes(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must lie on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtype must be float32 or bfloat16 for all of q, k, v; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled; have {HEAD_DIMS}")
    if min(b, sq, sk) < 1 or max(b, hq) > 65535:
        raise ValueError(f"unsupported sizes: batch {b}, heads {hq}, Sq {sq}, Sk {sk}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    out = torch.empty_like(q)  # keeps q's layout: (B,S,H,D) memory stays (B,S,H,D)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    scale = d ** -0.5 if scale is None else scale
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d,
            strides, scale, int(causal), stream)
    if code != 0:
        raise RuntimeError(f"flash attention launch failed: "
                           f"{lib.flash_attention_error_string(code).decode()}")
    launches += 1
    return out


def occupancy(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> tuple[int, int]:
    """(CTAs per SM, dynamic shared memory in bytes) of the kernel that
    `dtype`, `head_dim` and 16-byte alignment of the inputs select, from the
    CUDA runtime's occupancy query on the current device."""
    lib = _library()
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    code = lib.flash_attention_occupancy(_DTYPE_CODES[dtype], head_dim, int(aligned),
                                         ctypes.byref(blocks), ctypes.byref(smem))
    if code != 0:
        raise RuntimeError(f"flash attention occupancy query failed: "
                           f"{lib.flash_attention_error_string(code).decode()}")
    return blocks.value, smem.value
