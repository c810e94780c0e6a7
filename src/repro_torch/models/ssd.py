"""Mamba-2 block via SSD (state-space duality).

The port of the JAX package's ``models/ssd.py``. Prefill (S > 1) runs the
chunked scan through `ops.ssd_scan`: the CUDA kernel for CUDA tensors, its
plain version (`ssd_chunked`, re-exported here with `segsum` under the
reference's names) for CPU tensors. The kernel is forward only, so a call
that needs gradients (training) runs `ssd_chunked` itself, differentiable
by autograd, as the JAX package's training does; on `DTensor`s rank by
rank through `local_map`, as the kernel's entry runs. A decode step (S == 1
with a cache) is the plain recurrence `ssd_decode_step`, as in the
reference, its ``y = C h`` one batched product. Matmuls run in the
activations' dtype (bf16) on fp32 parameters cast at use; the scan, its
state and the gated norm's statistics are fp32.

Under a mesh the projections and the output are laid out where the
reference's `constrain` calls put them, the conv's zero state takes its
input's layout, and a cache's states are written in place in the layout
they already have. The scan goes through `ops.ssd_scan` only when every
rank holds whole sequences: the projections that feed the conv and the
scan are laid out so.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import segsum, ssd_chunked
from repro_torch.models import layers as L
from repro_torch.models.spec import Ax, ParamSpec, placed_tensor
from repro_torch.sharding.rules import NamedSharding, constrain, merge_dims, split_dim, write_slice

__all__ = ["segsum", "ssd_chunked", "ssd_decode_step", "causal_conv", "MambaCache",
           "mamba_spec", "make_mamba_cache", "mamba_block"]


def ssd_decode_step(
    state: torch.Tensor,    # (B, H, P, N) fp32
    x_t: torch.Tensor,      # (B, H, P): dt-scaled input
    dt_a_t: torch.Tensor,   # (B, H)
    b_t: torch.Tensor,      # (B, G, N)
    c_t: torch.Tensor,      # (B, G, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: h' = exp(dt·A) h + B x ; y = C h'."""
    h = x_t.shape[1]
    rep = h // b_t.shape[1]
    bh = b_t.float().repeat_interleave(rep, dim=1)       # (B, H, N)
    ch = c_t.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(dt_a_t.float())                    # (B, H)
    # The outer product as a broadcast product: no reshape of the (B, H)
    # dims, which a `DTensor` split on both could take only at a strided
    # layout.
    new_state = state * decay[..., None, None] + x_t.float()[..., None] * bh[:, :, None, :]
    y = _read_state(new_state, ch)
    return y.to(x_t.dtype), new_state


def _read_state(state: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """y = C h: the state (B, H, P, N) contracted with C (B, H, N) over N
    into (B, H, P), one batched product, as the reference's einsum. A
    `DTensor` state goes rank by rank through `local_map`, C laid out to
    match its shards (a few KB), so that no reshape of the product's
    batching meets two split dims; a split N gives a partial sum."""
    if not isinstance(state, DTensor):
        return torch.einsum("bhpn,bhn->bhp", state, ch)
    c_at, out = [], []
    for p in state.placements:
        d = p.dim % state.ndim if isinstance(p, Shard) else None
        c_at.append(Shard(d) if d in (0, 1) else Shard(2) if d == 3 else Replicate())
        out.append(Partial() if d == 3 or p.is_partial() else Replicate() if d is None else Shard(d))
    mesh = state.device_mesh
    return local_map(lambda s, c: torch.einsum("bhpn,bhn->bhp", s, c), out_placements=out,
                     in_placements=(state.placements, c_at),
                     device_mesh=mesh)(state, ch.redistribute(mesh, c_at))


def _layout_of(x: torch.Tensor) -> NamedSharding | None:
    """A `DTensor`'s mesh and placements, a partial sum's taken as
    replicated (None for a plain tensor): the layout a tensor made beside
    it takes."""
    if not isinstance(x, DTensor):
        return None
    return NamedSharding(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                              for p in x.placements))


def _seq_whole(t: torch.Tensor) -> torch.Tensor:
    """A (B, S, ...) `DTensor` with its sequence whole on every rank and no
    partial sum: the conv and the scan run along the sequence. Not a
    `constrain` (the reference leaves B, C and dt to the partitioner):
    `DTensor`, which weighs communication alone, may split the sequence of
    a projection whose contraction dim is split on the batch's mesh axis."""
    if not isinstance(t, DTensor):
        return t
    placements = [Replicate() if p.is_partial() or (isinstance(p, Shard) and p.dim % t.ndim == 1)
                  else p for p in t.placements]
    if placements == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _differentiable_scan(x, dt_a, b_proj, c_proj, chunk: int, init):
    """The scan for a call that needs gradients: `ssd_chunked`, which
    autograd differentiates (the kernel is forward only). `DTensor`s go
    rank by rank through `local_map` on whole (batch, head) slices, as the
    kernel's entry lays them out (`ops.ssd_on_shards`): each rank runs the
    plain scan on its own slices, and no reshape of the scan meets a split
    dim."""
    def scan(x, dt_a, b_proj, c_proj, init=None):
        return ssd_chunked(x, dt_a, b_proj, c_proj, chunk, initial_state=init)

    if isinstance(x, DTensor):
        return ops.ssd_on_shards(scan, "ssd_chunked", x, dt_a, b_proj, c_proj, init)
    return scan(x, dt_a, b_proj, c_proj, init)


# --------------------------------------------------------------------------- #
# Causal depthwise conv (shift-and-add; K is tiny)
# --------------------------------------------------------------------------- #
def causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """x: (B, S, C); w: (K, C). Returns (y (B,S,C), new_state (B,K-1,C)).
    `state` carries the last K-1 inputs for decode continuity. A
    shift-and-add in x's dtype, in the reference's order (no conv1d: cuDNN
    sums in another order, and in TF32 for fp32)."""
    k = w.shape[0]
    if state is None:
        state = placed_tensor((x.shape[0], k - 1, x.shape[2]), x.dtype, _layout_of(x),
                              device=x.device)
    xp = torch.cat([state, x], dim=1)                   # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------- #
# Mamba-2 block
# --------------------------------------------------------------------------- #
@dataclass
class MambaCache:
    """Decode state of one Mamba block. Unlike the reference's immutable
    NamedTuple, `mamba_block` updates these buffers IN PLACE when given a
    cache: the caller's tensors change and the returned cache shares them."""

    conv_x: torch.Tensor   # (B, K-1, d_inner), or (periods, B, ...) when stacked
    conv_b: torch.Tensor   # (B, K-1, G*N)
    conv_c: torch.Tensor   # (B, K-1, G*N)
    ssm: torch.Tensor      # (B, H, P, N) fp32


def mamba_cache_logical_axes() -> MambaCache:
    return MambaCache(
        conv_x=Ax(("batch", None, "tp")),
        conv_b=Ax(("batch", None, None)),
        conv_c=Ax(("batch", None, None)),
        ssm=Ax(("batch", "tp", None, None)),
    )


def mamba_spec(cfg: ModelConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    g, n, h, k = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv_kernel
    return {
        "w_z": ParamSpec((d, din), ("fsdp", "tp"), ("fan_in", d)),
        "w_x": ParamSpec((d, din), ("fsdp", "tp"), ("fan_in", d)),
        "w_b": ParamSpec((d, g * n), ("fsdp", None), ("fan_in", d)),
        "w_c": ParamSpec((d, g * n), ("fsdp", None), ("fan_in", d)),
        "w_dt": ParamSpec((d, h), ("fsdp", "tp"), ("fan_in", d)),
        "conv_x": ParamSpec((k, din), (None, "tp"), ("fan_in", k)),
        "conv_b": ParamSpec((k, g * n), (None, None), ("fan_in", k)),
        "conv_c": ParamSpec((k, g * n), (None, None), ("fan_in", k)),
        "dt_bias": ParamSpec((h,), ("tp",), "dt_bias"),
        "a_log": ParamSpec((h,), ("tp",), "a_log"),
        "d_skip": ParamSpec((h,), ("tp",), "ones"),
        "norm_scale": ParamSpec((din,), ("tp",), "ones"),
        "w_out": ParamSpec((din, d), ("tp", "fsdp"), ("fan_in", din)),
    }


def make_mamba_cache(cfg: ModelConfig, batch: int, *, device,
                     dtype: torch.dtype | None = None) -> MambaCache:
    """Zero states; the conv states in `dtype`, by default the activations'
    dtype (`layers.COMPUTE_DTYPE`, bf16), the SSM state in fp32."""
    g, n, h, k = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv_kernel
    p = cfg.ssm_head_dim
    dtype = L.COMPUTE_DTYPE if dtype is None else dtype

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return MambaCache(
        conv_x=zeros(batch, k - 1, cfg.d_inner),
        conv_b=zeros(batch, k - 1, g * n),
        conv_c=zeros(batch, k - 1, g * n),
        ssm=zeros(batch, h, p, n, dt=torch.float32),
    )


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    # silu(z) is rounded to y's dtype before the product, as in the reference.
    yf = (y * F.silu(z.float()).to(y.dtype)).float()
    var = L._mean(yf.square())
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def mamba_block(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, S, D)
    *,
    cache: MambaCache | None = None,
    update_cache: bool = False,
) -> tuple[torch.Tensor, MambaCache | None]:
    bsz, s, _ = x.shape
    h, pdim, g, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups, cfg.ssm_state
    dt = x.dtype

    z = x @ p["w_z"].to(dt)
    xs = x @ p["w_x"].to(dt)
    bp = x @ p["w_b"].to(dt)
    cp = x @ p["w_c"].to(dt)
    dt_raw = x @ p["w_dt"].to(dt)
    xs = constrain(xs, "batch", None, "tp")
    z = constrain(z, "batch", None, "tp")
    bp, cp, dt_raw = _seq_whole(bp), _seq_whole(cp), _seq_whole(dt_raw)

    conv_state = (cache.conv_x, cache.conv_b, cache.conv_c) if cache else (None,) * 3
    xs, st_x = causal_conv(xs, p["conv_x"].to(dt), conv_state[0])
    bp, st_b = causal_conv(bp, p["conv_b"].to(dt), conv_state[1])
    cp, st_c = causal_conv(cp, p["conv_c"].to(dt), conv_state[2])
    xs, bp, cp = F.silu(xs), F.silu(bp), F.silu(cp)

    dt_val = F.softplus(dt_raw.float() + p["dt_bias"].float())   # (B, S, H)
    a = -torch.exp(p["a_log"].float())                           # (H,)
    dt_a = dt_val * a                                            # (B, S, H)

    xh = split_dim(xs, 2, (h, pdim))
    x_scaled = xh.float() * dt_val[..., None]                    # dt-discretized input
    bg = split_dim(bp, 2, (g, n))
    cg = split_dim(cp, 2, (g, n))

    if s == 1 and cache is not None:
        y_t, new_ssm = ssd_decode_step(
            cache.ssm, x_scaled[:, 0].to(dt), dt_a[:, 0], bg[:, 0], cg[:, 0])
        y = y_t[:, None]
    else:
        pad = (-s) % cfg.ssm_chunk
        if pad:
            x_scaled = F.pad(x_scaled, (0, 0, 0, 0, 0, pad))
            dt_a = F.pad(dt_a, (0, 0, 0, pad))
            bg = F.pad(bg, (0, 0, 0, 0, 0, pad))
            cg = F.pad(cg, (0, 0, 0, 0, 0, pad))
        init = cache.ssm if cache is not None else None
        x_scaled = x_scaled.to(dt)
        if ops.needs_grad(x_scaled, dt_a, bg, cg):
            y_full, new_ssm = _differentiable_scan(x_scaled, dt_a, bg, cg, cfg.ssm_chunk, init)
        else:
            y_full, new_ssm = ops.ssd_scan(x_scaled, dt_a, bg, cg, chunk=cfg.ssm_chunk,
                                           initial_state=init)
        y = y_full[:, :s]

    y = y + xh * p["d_skip"].to(dt)[None, None, :, None]
    y = merge_dims(y, 2, 3)
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
    out = constrain(y @ p["w_out"].to(dt), "batch", None, "residual")

    if cache is not None:
        for buf, new in ((cache.conv_x, st_x), (cache.conv_b, st_b),
                         (cache.conv_c, st_c), (cache.ssm, new_ssm)):
            write_slice(buf, 0, 0, new)
        return out, cache
    if update_cache:
        return out, MambaCache(conv_x=st_x, conv_b=st_b, conv_c=st_c, ssm=new_ssm)
    return out, None
