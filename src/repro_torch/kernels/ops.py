"""Public entries for the kernels. The path is chosen by device and layout
alone; there is no fallback, and a tensor the chosen path does not take
raises:

- a `DTensor` on which every rank holds whole (batch, head) slices: each
  rank's local shard goes to the entries below, through `local_map`. Inputs
  are first laid out alike: a batch dim sharded on a mesh dim in any of
  them is sharded there in all; a head dim sharded on it in the first is
  sharded there in all when every input's heads split evenly (an input
  with one head or group, which all heads read, stays replicated), else
  replicated in all; a partial sum is reduced. A dim of the sequence, the head
  dim or the state split across more than one rank cannot reach a kernel,
  which sees one rank's rows only: that raises. The model code takes the
  plain path for such a layout itself (`models.layers.attention`,
  `models.ssd.mamba_block`), as the reference's kv_seq mode does. A
  `Shard` over a mesh dim of one rank counts as whole;
- a ``meta`` tensor (the dry-run's, which allocates nothing, and a
  ``meta`` shard of its `DTensor`s): the plain version, which gives the
  shapes and, traced, the ops a rank runs. The reference's dry-run lowers
  its plain paths too: its model code never calls its Pallas kernels;
- a CUDA tensor: the kernel; a CPU tensor: its plain version.

`flash_attention` and `ssd_scan` are forward only, as the Pallas kernels
they replace are: a launch returns tensors with no autograd history. So a
CUDA input that requires grad while grad mode is on raises rather than
silently cutting the graph. `flash_attention_train` is attention with a
backward: on CUDA a `torch.autograd.Function` whose forward and backward
are kernels, elsewhere the plain version under autograd. Training's
attention takes it where the model code finds the call fits
(`models.layers.attention_context`) and `_attn_core` otherwise; the Mamba
mixer trains through the plain `models.ssd.ssd_chunked`."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd records an op on these inputs: such a call must take
    a plain path or `flash_attention_train`, since the other entries are
    forward only."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _forward_only(name: str, *tensors: torch.Tensor | None) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward only and would cut the "
                           f"autograd graph of an input that requires grad; call it under "
                           f"torch.no_grad() or take the plain path")


def _whole_layout(name: str, tensors: list, batch_dims: list, head_dims: list) -> list:
    """One placement per mesh dim for each of `tensors` (DTensors on one
    mesh) under which every rank holds whole (batch, head) slices, by the
    rule in the module docstring. `batch_dims` / `head_dims` give each
    tensor's batch and head dim (None: it has none)."""
    mesh = tensors[0].device_mesh
    out = [[] for _ in tensors]
    for m in range(mesh.ndim):
        size = mesh.size(m)
        for t, b, h in zip(tensors, batch_dims, head_dims):
            p = t.placements[m]
            if size > 1 and isinstance(p, Shard) and p.dim % t.ndim not in (b, h):
                raise ValueError(
                    f"{name}: an input of shape {tuple(t.shape)} is split on dim "
                    f"{p.dim % t.ndim} across {size} ranks of mesh dim {m}; only batch and "
                    f"head dims may be split (the caller takes the plain path for a "
                    f"sequence-sharded layout)")
        placed = tensors[0].placements[m]
        batch = any(isinstance(t.placements[m], Shard) and t.placements[m].dim % t.ndim == b
                    for t, b in zip(tensors, batch_dims))
        # Heads split only where each input's heads split evenly or it has
        # one head (group) that every rank's heads read.
        heads = (isinstance(placed, Shard) and placed.dim % tensors[0].ndim == head_dims[0]
                 and all(h is None or t.shape[h] % size == 0 or t.shape[h] == 1
                         for t, h in zip(tensors, head_dims)))
        for i, (t, b, h) in enumerate(zip(tensors, batch_dims, head_dims)):
            if batch:
                out[i].append(Shard(b))
            elif heads and h is not None and t.shape[h] % size == 0:
                out[i].append(Shard(h))
            else:
                out[i].append(Replicate())
    return out


def _on_shards(fn, name: str, tensors: list, batch_dims: list, head_dims: list,
               out_dims: list):
    """`fn` on each rank's local shards of `tensors`, laid out by
    `_whole_layout`; the outputs are DTensors whose batch and head dims
    (`out_dims`: (batch, head) of each) are split as the first input's.
    Under autograd, an input replicated across a mesh dim on which another
    is split (B and C of one group, which every rank's heads read) gets a
    partial-sum gradient there: each rank's is its own heads' share."""
    layout = _whole_layout(name, tensors, batch_dims, head_dims)
    mesh = tensors[0].device_mesh
    tensors = [t.redistribute(mesh, pl) for t, pl in zip(tensors, layout)]
    lead = layout[0]

    def out_placements(b: int, h: int) -> list:
        return [Shard(b) if isinstance(p, Shard) and p.dim == batch_dims[0] else
                Shard(h) if isinstance(p, Shard) else Replicate() for p in lead]

    split = [any(isinstance(pl[m], Shard) for pl in layout) for m in range(mesh.ndim)]
    grads = tuple([Partial() if split[m] and isinstance(p, Replicate) else p
                   for m, p in enumerate(pl)] for pl in layout)
    outs = [out_placements(b, h) for b, h in out_dims]
    return local_map(fn, out_placements=outs[0] if len(outs) == 1 else tuple(outs),
                     in_placements=tuple(layout), in_grad_placements=grads,
                     device_mesh=mesh)(*tensors)


def ssd_on_shards(scan, name: str, x: DTensor, dt_a: DTensor, b_proj: DTensor,
                  c_proj: DTensor, initial_state: DTensor | None = None):
    """``scan(x, dt_a, b_proj, c_proj[, initial_state])``, a function with the
    SSD scan's signature and results, on each rank's local shards of
    `DTensor`s laid out whole (batch dim 0, head dims 2, 2, 2, 2 and 1;
    `_whole_layout`): the outputs y and the final state are `DTensor`s.
    `to_local` and `from_local` carry gradients, so a differentiable `scan`
    (`ssd_chunked`, training's) stays differentiable."""
    tensors = [x, dt_a, b_proj, c_proj]
    batch, heads = [0, 0, 0, 0], [2, 2, 2, 2]
    if initial_state is not None:
        tensors.append(initial_state)
        batch.append(0)
        heads.append(1)
    return _on_shards(scan, name, tensors, batch, heads, [(0, 2), (0, 1)])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D), with the
    top-left causal mask. The kernel is compiled for one tile, `block_q` =
    `block_k` = 64; any other asks for a kernel that does not exist."""
    if block_q != _fa.BLOCK or block_k != _fa.BLOCK:
        raise ValueError(f"tile ({block_q}, {block_k}) not compiled; have "
                         f"({_fa.BLOCK}, {_fa.BLOCK})")
    if isinstance(q, DTensor):
        return _on_shards(lambda a, b, c: flash_attention(a, b, c, causal=causal, scale=scale),
                          "flash_attention", [q, k, v], [0, 0, 0], [1, 1, 1], [(0, 1)])
    if q.device.type == "meta":
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.is_cuda:
        _forward_only("flash_attention", q, k, v)
        return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_train_fits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether `flash_attention_train` runs q, k, v on the training kernels:
    bf16 CUDA tensors (`DTensor`s included) at a head dim they compile."""
    return (q.is_cuda and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in _fa.TRAIN_HEAD_DIMS)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Attention differentiable in q, k and v. q: (B, Hq, Sq, D); k/v: (B,
    Hkv, Sk, D) -> (B, Hq, Sq, D), with the top-left causal mask. On CUDA the
    training kernels (for inputs that `flash_train_fits`; others raise); on
    CPU and ``meta`` the plain version, whose backward is autograd's."""
    if isinstance(q, DTensor):
        return _on_shards(lambda a, b, c: flash_attention_train(a, b, c, causal=causal,
                                                                scale=scale),
                          "flash_attention_train", [q, k, v], [0, 0, 0], [1, 1, 1], [(0, 1)])
    if q.device.type in ("cpu", "meta"):
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.is_cuda:
        return _fa.flash_attention_train_cuda(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")


def ssd_scan(x: torch.Tensor, dt_a: torch.Tensor, b_proj: torch.Tensor,
             c_proj: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Mamba-2 SSD scan. x: (B, S, H, P) dt-scaled; dt_a: (B, S, H);
    B/C: (B, S, G, N); returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) fp32). The chunk is min(chunk, S) and must divide S."""
    if isinstance(x, DTensor):
        def scan(x, dt_a, b_proj, c_proj, init=None):
            return ssd_scan(x, dt_a, b_proj, c_proj, chunk=chunk, initial_state=init)

        return ssd_on_shards(scan, "ssd_scan", x, dt_a, b_proj, c_proj, initial_state)
    if x.device.type == "meta":
        return _ssd.ssd_scan_plain(x, dt_a, b_proj, c_proj, chunk=chunk,
                                   initial_state=initial_state)
    if x.is_cuda:
        _forward_only("ssd_scan", x, dt_a, b_proj, c_proj, initial_state)
        return _ssd.ssd_scan_cuda(x, dt_a, b_proj, c_proj, chunk=chunk,
                                  initial_state=initial_state)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt_a, b_proj, c_proj, chunk=chunk,
                                   initial_state=initial_state)
    raise ValueError(f"no ssd scan for device {x.device}")
