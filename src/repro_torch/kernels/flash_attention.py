"""Flash attention for Hopper: the CUDA kernels' wrappers and their plain
PyTorch version.

The serving kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU
kernel ``_flash_kernel`` of ``src/repro/kernels/flash_attention.py``:
blocked online-softmax GQA attention with the top-left causal mask, fp32
softmax state, and the output in q's dtype. bf16 inputs go to a tensor-core
kernel (bf16 products with fp32 sums, P rounded to bf16 before P V); fp32
inputs to a scalar kernel in exact fp32. `flash_attention_cuda` launches it
on PyTorch's current stream.

Training (bf16, head dims 64 and 128; kernels of the same source) runs the
same bf16 forward with each row's log-sum-exp written out, and a
backward of two kernels (dQ; dK and dV) that recomputes the probabilities
from it: `flash_attention_train_cuda`, an autograd function.
`flash_attention_plain` computes the forward in plain PyTorch, for CPU
tensors (autograd gives its backward) and as the kernels' yardstick on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.sharding.rules import replicate_like

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
TRAIN_HEAD_DIMS = (64, 128)  # training's kernels, bf16 only
BLOCK = 64  # the kernels' q and kv tile, fixed in csrc/flash_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches since the last reset: `flash_attention_cuda` and the training
# forward add one to `launches` per forward launch, the training backward one
# to `backward_launches` per backward (its two kernels), and nothing else
# touches them, so a run can show that its main path went through the kernels.
launches = 0
backward_launches = 0


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
    lib.flash_attention_train_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_train_fwd.restype = ctypes.c_int
    lib.flash_attention_train_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_train_bwd.restype = ctypes.c_int
    lib.flash_attention_occupancy.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.flash_attention_occupancy.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _library().flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash attention {what} failed: {msg}")


def _check_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtypes,
                  head_dims) -> None:
    """Raise on q, k, v that a kernel of `dtypes` and `head_dims` does not
    take: shapes, device, dtype, head dim, sizes, a head dim that is not
    contiguous."""
    check_shapes(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must lie on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise ValueError(f"dtype must be {names} for all of q, k, v; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    if d not in head_dims:
        raise ValueError(f"head dim {d} not compiled; have {head_dims}")
    if min(b, sq, sk) < 1 or max(b, hq) > 65535:
        raise ValueError(f"unsupported sizes: batch {b}, heads {hq}, Sq {sq}, Sk {sk}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), any
    strides with a unit stride on D. Returns a tensor of q's shape, dtype and
    memory layout. Raises on anything the kernel does not take."""
    global launches
    _check_launch(q, k, v, _DTYPE_CODES, HEAD_DIMS)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
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
    _raise_on(code, "launch")
    launches += 1
    return out


# The kernels an occupancy query names, in the C entry's order.
_KERNELS = ("serving", "train_forward", "dq", "dkdv")


def occupancy(dtype: torch.dtype, head_dim: int, aligned: bool = True, *,
              kernel: str = "serving") -> tuple[int, int]:
    """(CTAs per SM, dynamic shared memory in bytes) of a kernel on the
    current device, from the CUDA runtime's occupancy query: the serving
    forward that `dtype`, `head_dim` and 16-byte alignment of the inputs
    select, or one of training's bf16 kernels at `head_dim` ("train_forward",
    "dq" or "dkdv")."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    code = _library().flash_attention_occupancy(
        _KERNELS.index(kernel), _DTYPE_CODES[dtype], head_dim, int(aligned),
        ctypes.byref(blocks), ctypes.byref(smem))
    _raise_on(code, "occupancy query")
    return blocks.value, smem.value


# --------------------------------------------------------------------------- #
# Training: the forward with each row's log-sum-exp, and the backward
# --------------------------------------------------------------------------- #
def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` (B, H, S, D) with every row start 16-byte aligned, as the
    training kernels' cp.async copies need: itself where it is, else a
    contiguous copy."""
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            s % 8 == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def _lse_rows(sq: int) -> int:
    """The rows of lse and delta a (batch, head) slice holds: Sq rounded up
    to the kernels' tile, so that the backward reads whole tiles."""
    return -(-sq // BLOCK) * BLOCK


def flash_attention_train_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                   causal: bool = True, scale: float | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (o of q's shape and memory layout, lse (B, Hq,
    Sq rounded up to 64) fp32, +inf past Sq). bf16 q (B, Hq, Sq, D), k, v
    (B, Hkv, Sk, D) with D in `TRAIN_HEAD_DIMS`."""
    global launches
    _check_launch(q, k, v, (torch.bfloat16,), TRAIN_HEAD_DIMS)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, _lse_rows(sq)), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    scale = d ** -0.5 if scale is None else scale
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_train_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, sk, d, strides, scale, int(causal), stream)
    _raise_on(code, "training forward")
    launches += 1
    return out, lse


def flash_attention_train_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                                   causal: bool = True, scale: float | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each of its input's shape, dtype and memory layout, from
    the forward's inputs, its output `o` and `lse`, and the output's
    gradient `dout`."""
    global backward_launches
    _check_launch(q, k, v, (torch.bfloat16,), TRAIN_HEAD_DIMS)
    if (o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype
            or dout.dtype != q.dtype or o.device != q.device or dout.device != q.device):
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} must be of q's "
                         f"shape {tuple(q.shape)}, dtype and device")
    q, k, v, o, dout = (_aligned(t) for t in (q, k, v, o, dout))
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if lse.shape != (b, hq, _lse_rows(sq)) or not lse.is_contiguous():
        raise ValueError(f"lse {tuple(lse.shape)} is not the forward's")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, dout, dq, dk, dv)
                                         for s in t.stride()[:3]))
    scale = d ** -0.5 if scale is None else scale
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, hq, hkv, sq, sk, d, strides, scale, int(causal), stream)
    _raise_on(code, "backward")
    backward_launches += 1
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    """Attention whose forward and backward are the training kernels. Saves
    q, k, v, o and lse, no probabilities; under a checkpoint the forward
    runs again in the backward pass, as any op does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        o, lse = flash_attention_train_fwd_cuda(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_train_bwd_cuda(q, k, v, o, lse, dout,
                                                    causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_train_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               causal: bool = True, scale: float | None = None
                               ) -> torch.Tensor:
    """Attention under autograd on the training kernels: the forward's
    output (q's shape and memory layout), differentiable in q, k and v."""
    return _FlashTrain.apply(q, k, v, causal, scale)
