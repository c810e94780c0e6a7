"""Mamba-2 SSD chunked scan for Hopper: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``_ssd_kernel`` of ``src/repro/kernels/ssd_scan.py``. Per (batch, head) the
chunks run in order, with the (P, N) state carried from one to the next:

    acs    = cumsum(dt_a)                     within the chunk
    L      = exp(acs_i - acs_j) for i >= j, 0 above the diagonal
    y      = ((C B^T) * L) X + (C h^T) * exp(acs)
    h      = exp(acs_last) h + X^T (B * exp(acs_last - acs))

The state is fp32 throughout; y comes back in x's dtype and the final state
in fp32. bf16 inputs go to a tensor-core kernel (bf16 products with fp32
sums; the masked decayed scores, a bf16 copy of the entering state and
B * exp(acs_last - acs) are rounded to bf16); fp32 inputs to a scalar
kernel in exact fp32. `ssd_scan_cuda` launches the kernel on PyTorch's current
stream; `ssd_scan_plain` computes the same function in plain PyTorch (the
chunked einsum formulation of the JAX package's ``models/ssd.py``), for
CPU tensors and as the kernel's yardstick on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.sharding.rules import replicate_like

HEAD_DIMS = (16, 32, 64, 128)    # P values compiled in csrc/ssd_scan.cu
MAX_STATE = 128                  # N: at most this, and a multiple of 4
MAX_CHUNK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: `ssd_scan_cuda` adds one per launch
# and nothing else touches it, so a run can show that its main path went
# through the kernel.
launches = 0


def check_shapes(x: torch.Tensor, dt_a: torch.Tensor, b_proj: torch.Tensor,
                 c_proj: torch.Tensor, initial_state: torch.Tensor | None,
                 chunk: int) -> int:
    """x: (B, S, H, P); dt_a: (B, S, H); b_proj = c_proj: (B, S, G, N) with G
    dividing H; initial_state: (B, H, P, N). Returns the chunk the scan
    uses, min(chunk, S), which must divide S."""
    if x.ndim != 4 or dt_a.ndim != 3 or b_proj.ndim != 4 or b_proj.shape != c_proj.shape:
        raise ValueError(f"want x (B,S,H,P), dt_a (B,S,H), b = c (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt_a.shape)}, {tuple(b_proj.shape)}, "
                         f"{tuple(c_proj.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_proj.shape[2], b_proj.shape[3]
    if tuple(dt_a.shape) != (bsz, s, h) or tuple(b_proj.shape[:2]) != (bsz, s) \
            or g < 1 or h % g:
        raise ValueError(f"x {tuple(x.shape)}, dt_a {tuple(dt_a.shape)} and B/C "
                         f"{tuple(b_proj.shape)} disagree on batch, length or groups")
    if initial_state is not None and tuple(initial_state.shape) != (bsz, h, p, n):
        raise ValueError(f"initial_state {tuple(initial_state.shape)}, want "
                         f"{(bsz, h, p, n)}")
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    return chunk


# --------------------------------------------------------------------------- #
# Plain PyTorch version: the chunked SSD algorithm (fp32 state math)
# --------------------------------------------------------------------------- #
def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] for
    j < i, -inf above the diagonal. Produces the 1-semiseparable log-decay
    matrix."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = replicate_like(torch.ones(t, t, dtype=torch.bool, device=x.device).tril(), x)
    return out.masked_fill(~mask, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P): inputs, already dt-scaled
    dt_a: torch.Tensor,     # (B, S, H): dt * A (negative)
    b_proj: torch.Tensor,   # (B, S, G, N)
    c_proj: torch.Tensor,   # (B, S, G, N)
    chunk: int,
    initial_state: torch.Tensor | None = None,   # (B, H, P, N) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32)."""
    bsz, s, h, p = x.shape
    g, n = b_proj.shape[2], b_proj.shape[3]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    rep = h // g  # heads per B/C group: head i belongs to group i // rep

    xc = x.reshape(bsz, nc, chunk, h, p).float()
    ac = dt_a.reshape(bsz, nc, chunk, h).float()
    bh = b_proj.reshape(bsz, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)
    ch = c_proj.reshape(bsz, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)

    a_perm = ac.permute(0, 3, 1, 2)               # (B, H, NC, L)
    a_cumsum = torch.cumsum(a_perm, dim=-1)       # (B, H, NC, L)

    # 1) Intra-chunk (diagonal blocks).
    l_mat = torch.exp(segsum(a_perm))             # (B, H, NC, L, L)
    scores = torch.einsum("bclhn,bcshn->bhcls", ch, bh) * l_mat
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xc)

    # 2) Per-chunk end states.
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)        # (B, H, NC, L)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          bh * decay_states.permute(0, 2, 3, 1)[..., None], xc)

    # 3) Inter-chunk recurrence over chunk states.
    chunk_decay = torch.exp(a_cumsum[..., -1])    # (B, H, NC)
    carry = (x.new_zeros((bsz, h, p, n), dtype=torch.float32)
             if initial_state is None else initial_state.float())
    entering = []
    for c in range(nc):
        entering.append(carry)                    # the state entering chunk c
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    entering_t = torch.stack(entering, dim=1)     # (B, NC, H, P, N)

    # 4) Inter-chunk output contribution.
    state_decay_out = torch.exp(a_cumsum).permute(0, 2, 3, 1)[..., None]   # (B, NC, L, H, 1)
    y_off = torch.einsum("bclhn,bchpn->bclhp", ch, entering_t) * state_decay_out

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), carry


def ssd_scan_plain(x: torch.Tensor, dt_a: torch.Tensor, b_proj: torch.Tensor,
                   c_proj: torch.Tensor, *, chunk: int = 256,
                   initial_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, with the Pallas wrapper's
    contract: the chunk is min(chunk, S) and must divide S."""
    chunk = check_shapes(x, dt_a, b_proj, c_proj, initial_state, chunk)
    return ssd_chunked(x, dt_a, b_proj, c_proj, chunk, initial_state)


# --------------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------------- #
@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    )
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.ssd_scan_occupancy.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_cuda(x: torch.Tensor, dt_a: torch.Tensor, b_proj: torch.Tensor,
                  c_proj: torch.Tensor, *, chunk: int = 256,
                  initial_state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. x (B, S, H, P) and B/C (B, S, G, N) in float32
    or bfloat16, one dtype; dt_a (B, S, H) and initial_state (B, H, P, N) in
    float32. Any strides with a unit stride on the last dim. Returns y, a
    contiguous (B, S, H, P) tensor in x's dtype, and the final state, a
    contiguous (B, H, P, N) float32 tensor. Raises on anything the kernel
    does not take."""
    global launches
    chunk = check_shapes(x, dt_a, b_proj, c_proj, initial_state, chunk)
    tensors = [x, dt_a, b_proj, c_proj] + ([] if initial_state is None else [initial_state])
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError(f"x, dt_a, B, C and the initial state must lie on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPE_CODES or b_proj.dtype != x.dtype or c_proj.dtype != x.dtype:
        raise ValueError(f"dtype of x, B and C must be one of float32 or bfloat16; got "
                         f"{x.dtype}, {b_proj.dtype}, {c_proj.dtype}")
    if dt_a.dtype != torch.float32 or (initial_state is not None
                                       and initial_state.dtype != torch.float32):
        raise ValueError(f"dtype of dt_a and the initial state must be float32; got "
                         f"{dt_a.dtype}, "
                         f"{None if initial_state is None else initial_state.dtype}")
    bsz, s, h, p = x.shape
    g, n = b_proj.shape[2], b_proj.shape[3]
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p} not compiled; have {HEAD_DIMS}")
    if not (4 <= n <= MAX_STATE and n % 4 == 0):
        raise ValueError(f"state size {n} not taken: a multiple of 4 up to {MAX_STATE}")
    if chunk > MAX_CHUNK or bsz * h >= 2 ** 31:
        raise ValueError(f"unsupported sizes: chunk {chunk} (at most {MAX_CHUNK}), "
                         f"batch {bsz} x heads {h}")
    if any(t.stride(-1) != 1 for t in (x, b_proj, c_proj)) or (
            initial_state is not None and initial_state.stride(-1) != 1):
        raise ValueError("the last dim of x, B, C and the initial state must be contiguous")
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    init_strides = (0, 0, 0) if initial_state is None else initial_state.stride()[:3]
    strides = (ctypes.c_longlong * 18)(
        *x.stride()[:3], *dt_a.stride(), *b_proj.stride()[:3], *c_proj.stride()[:3],
        *init_strides, *y.stride()[:3])
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_scan_fwd(
            x.data_ptr(), dt_a.data_ptr(), b_proj.data_ptr(), c_proj.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), final.data_ptr(),
            _DTYPE_CODES[x.dtype], bsz, s, h, g, p, n, chunk,
            strides, stream)
    if code != 0:
        raise RuntimeError(f"ssd scan launch failed: "
                           f"{lib.ssd_scan_error_string(code).decode()}")
    launches += 1
    return y, final


def occupancy(dtype: torch.dtype, head_dim: int, state: int, chunk: int,
              aligned: bool = True) -> tuple[int, int]:
    """(CTAs per SM, dynamic shared memory in bytes) of the kernel that
    `dtype`, the sizes and 16-byte alignment of the inputs select, from the
    CUDA runtime's occupancy query on the current device."""
    lib = _library()
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    code = lib.ssd_scan_occupancy(_DTYPE_CODES[dtype], head_dim, state, chunk, int(aligned),
                                  ctypes.byref(blocks), ctypes.byref(smem))
    if code != 0:
        raise RuntimeError(f"ssd scan occupancy query failed: "
                           f"{lib.ssd_scan_error_string(code).decode()}")
    return blocks.value, smem.value
