"""Logical-axis sharding rules with divisibility-aware fallback, on
`torch.distributed`'s `DeviceMesh` and `DTensor`; the port of the JAX
package's ``sharding/rules.py``.

Model code annotates tensors with *logical* axis names ("batch", "tp",
"fsdp", ...). Rules map each name to an ordered list of candidate mesh-axis
tuples; resolution picks the first candidate whose axes all exist in the
mesh and whose total size divides the tensor dimension, else leaves the
dimension unsharded. This is what lets one model implementation serve
every assigned architecture: smollm's 9 heads or whisper's 20 heads simply
fall back to replicated attention while d_ff / vocab / experts still shard.

`ShardingRules.spec` gives the reference's ``PartitionSpec`` as a plain
tuple (``None``, an axis name, or a tuple of names per tensor dimension);
`ShardingRules.sharding` turns it into one `Placement` per mesh dimension,
the form `DTensor` takes, held with its mesh in a `NamedSharding` as JAX's
is.

Under a mesh the model code runs on `DTensor`s, and two things XLA does
for the reference are done here: a tensor the code builds beside a
`DTensor` (a RoPE table, a mask, an index) joins its mesh, replicated
(`replicate_like`), and a write of a slice into a buffer sharded along the
written dim lands, rank by rank, on the part of the slice each rank holds
(`write_slice`, the counterpart of ``dynamic_update_slice`` on a sharded
operand).
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import local_map


# Candidate mesh-axis assignments per logical axis, in priority order.
# ("pod", "data") composes the multi-pod and single-pod meshes: resolution
# drops axes absent from the mesh, so the same table serves both.
TRAIN_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    "batch": (("pod", "data"),),        # activation batch
    "fsdp": (("pod", "data"),),         # parameter FSDP dim
    "tp": (("model",),),                # heads / d_ff / vocab columns
    "expert": (("model",),),            # MoE expert dim
    "residual": (("model",),),          # activation d_model (2D sharding)
    # Attention q-head dim ("heads"): preferred internal sharding when the
    # head count divides the tensor axis — zero intra-attention collectives
    # (KV expands to q-heads via a shard-local gather). Falls back to
    # KV-sequence sharding ("kv_seq") otherwise (9/20/24-head archs), which
    # keeps score tensors distributed at the price of per-chunk partial-sum
    # all-reduces. Both decisions are divisibility-resolved per arch.
    "heads": (("model",),),
    "kv_seq": (("model",),),
    "seq": ((),),                       # sequence: unsharded by default
}

# Decode: batch may be tiny (long_500k has batch 1) and the KV cache is the
# dominant tensor -> shard its sequence dim over the tensor axis
# (flash-decoding-style partial softmax; GSPMD inserts the LSE collectives).
DECODE_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    **TRAIN_RULES,
    "kv_seq": (("model",),),
}

# TP-only serving weights (int8 weight-only quantization, §Perf cell 3):
# the FSDP dim replicates, eliminating per-step weight all-gathers; int8
# makes the replicated-within-data layout fit HBM.
DECODE_TP_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    **DECODE_RULES,
    "fsdp": ((),),
}


@dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies on `mesh`: one `Placement` per mesh dimension, the
    form `DTensor` takes. The counterpart of
    ``jax.sharding.NamedSharding``, which also carries its mesh."""

    mesh: DeviceMesh
    placements: tuple[Placement, ...]


def placements_of(mesh: DeviceMesh, spec: tuple) -> NamedSharding:
    """`spec` (a ``PartitionSpec`` as a tuple) as placements on `mesh`:
    ``Shard(d)`` on every mesh dimension that tensor dimension `d` takes,
    ``Replicate()`` elsewhere. A dimension over several mesh axes is split
    over the first of them, then each piece over the next (JAX's order for
    ``P(("pod", "data"))``, pod-major), which `DTensor` gives only when the
    axes come in the mesh's own order."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * mesh.ndim
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"mesh axes {axes} of tensor dim {d} are not in the mesh's order "
                             f"{tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return NamedSharding(mesh, tuple(out))


@dataclass
class ShardingRules:
    mesh: DeviceMesh | None = None
    table: dict[str, tuple[tuple[str, ...], ...]] = field(
        default_factory=lambda: dict(TRAIN_RULES)
    )

    def _axis_size(self, name: str) -> int | None:
        if self.mesh is None:
            return None
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape)).get(name)

    def resolve_dim(self, logical: str | None, dim: int) -> tuple[str, ...] | None:
        """Mesh axes for one tensor dimension, or None (replicated)."""
        if logical is None or self.mesh is None:
            return None
        for candidate in self.table.get(logical, ()):
            axes = tuple(a for a in candidate if self._axis_size(a) is not None)
            if not axes:
                continue
            total = math.prod(self._axis_size(a) for a in axes)  # type: ignore
            if total > 0 and dim % total == 0:
                return axes
        return None

    def spec(self, logical_axes: tuple, shape: tuple) -> tuple:
        if len(logical_axes) != len(shape):
            raise ValueError(f"axes {logical_axes} vs shape {shape}")
        parts = []
        used: set[str] = set()
        for logical, dim in zip(logical_axes, shape):
            axes = self.resolve_dim(logical, dim)
            if axes is None or any(a in used for a in axes):
                parts.append(None)
            else:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def sharding(self, logical_axes: tuple, shape: tuple) -> NamedSharding | None:
        if self.mesh is None:
            return None
        return placements_of(self.mesh, self.spec(logical_axes, shape))


# --------------------------------------------------------------------------- #
# Ambient rules (so layer code can constrain without threading a mesh arg)
# --------------------------------------------------------------------------- #
_tls = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def under_current_rules(fn):
    """`fn` bound to the rules ambient now: the wrapper runs it under them
    wherever it is called. The ambient rules are per thread, and autograd
    runs a CUDA backward pass, where `torch.utils.checkpoint` recomputes a
    segment, on a thread of its own."""
    rules = current_rules()

    def bound(*args, **kwargs):
        with use_rules(rules):
            return fn(*args, **kwargs)

    return bound


def replicate_like(t: torch.Tensor, partner: torch.Tensor) -> torch.Tensor:
    """`t` (the same value on every rank) as a replicated `DTensor` on
    `partner`'s mesh when `partner` is a `DTensor`, else `t` itself: the
    tables and masks the model code builds from shapes join the operands
    they meet, with no communication."""
    if not isinstance(partner, DTensor) or isinstance(t, DTensor):
        return t
    mesh = partner.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def split_dim(t: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """`t` with dim `dim` reshaped to `sizes`. A `DTensor` split on that
    dim across a mesh dim whose size does not divide ``sizes[0]`` (3 kv
    heads of 16 over 2 ranks) is first replicated there: `DTensor` splits a
    sharded dim only at a shard boundary."""
    if isinstance(t, DTensor):
        mesh, d = t.device_mesh, dim % t.ndim
        placements = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim == d
                      and sizes[0] % mesh.size(m) else p for m, p in enumerate(t.placements)]
        if placements != list(t.placements):
            t = t.redistribute(mesh, placements)
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim % t.ndim + 1:])


def merge_dims(t: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """`t.flatten(start, end)`. For a `DTensor` its gradient is brought back
    to this layout before the backward pass splits the dims again, which
    an unevenly sharded gradient would not allow."""
    return grad_in_layout(t.flatten(start, end))


def grad_in_layout(t: torch.Tensor) -> torch.Tensor:
    """`t`; a `DTensor` that requires grad gets its gradient laid out as
    `t` is before the backward pass goes on (a redistribute to its own
    placements: nothing in the forward pass)."""
    if isinstance(t, DTensor) and t.requires_grad:
        return t.redistribute(t.device_mesh, t.placements)
    return t


def local_extent(x: DTensor, dim: int) -> tuple[int, int]:
    """(global offset, length) of this rank's shard of `x` along `dim`.
    Several mesh dims sharding one tensor dim split it in mesh order, the
    first outermost (`placements_of`'s order)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    offset, length = 0, x.shape[dim]
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            if length % mesh.size(m):
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into "
                                 f"{mesh.size(m)}")
            length //= mesh.size(m)
            offset += coord[m] * length
    return offset, length


def write_slice(buf: torch.Tensor, dim: int, start: int, value: torch.Tensor) -> None:
    """buf[..., start:start + n, ...] = value along `dim`, IN PLACE. A
    `DTensor` buffer takes `value` in its own layout when the write covers
    all of `dim`; otherwise laid out as the buffer on every other dim and
    whole along `dim`, each rank copying the part of the slice that falls in
    its own shard, so a buffer sharded along `dim` (a KV cache on
    ``kv_seq``) is written where it lies, with no gather."""
    n = value.shape[dim]
    if not isinstance(buf, DTensor):
        buf.narrow(dim, start, n).copy_(value)
        return
    mesh = buf.device_mesh
    full = start == 0 and n == buf.shape[dim]
    target = [p if full or not (isinstance(p, Shard) and p.dim % buf.ndim == dim % buf.ndim)
              else Replicate() for p in buf.placements]
    if isinstance(value, DTensor):
        value = value.redistribute(mesh, target)
    else:
        value = distribute_tensor(value, mesh, target, src_data_rank=None)
    if full:
        buf.to_local().copy_(value.to_local())
        return
    offset, length = local_extent(buf, dim)
    lo, hi = max(start, offset), min(start + n, offset + length)
    if lo < hi:
        buf.to_local().narrow(dim, lo - offset, hi - lo).copy_(
            value.to_local().narrow(dim, lo - start, hi - lo))


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Lay `x` out per the ambient rules: a `DTensor` is redistributed
    (`relaid`), a plain tensor (the global value, the same on every rank)
    distributed with no communication. Outside a mesh context (CPU smoke
    tests) it returns `x` itself."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    sharding = rules.sharding(tuple(logical_axes), tuple(x.shape))
    if isinstance(x, DTensor):
        return relaid(x, sharding.placements)
    return distribute_tensor(x, rules.mesh, sharding.placements, src_data_rank=None)


def relaid(x: DTensor, placements) -> DTensor:
    """``x.redistribute(mesh, placements)``, a split moved by one
    all-to-all where it moves in one of two ways; every other mesh dim is
    laid out as asked first (a gather, a partial sum reduced).
      * Between two tensor dims on one mesh dim (a table's rows to its
        columns, a projection's columns to its sequence): each rank sends
        every other one the part of its shard that the other will hold.
        `DTensor` does this itself on a CUDA mesh; on a CPU mesh (gloo,
        and the dry-run's fake groups) it gathers the dim whole and keeps
        a slice (granite-2l prefill_32k on 16 x 16: k and v each a (32,
        32768, 32) all-gather, 16 times the all-to-all's bytes).
      * Between two mesh dims on one tensor dim, `a` to `b` (a one-token
        residual's d from the model axis to the data axis that its batch
        of 1 leaves idle): each rank receives the slice it will hold from
        the ranks of `a` that hold it, 1/n of the bytes of `DTensor`'s own
        way, which gathers the dim whole over `a` and keeps a slice
        (jamba-8l long_500k on 16 x 16: (1, 1, 8192) bf16 gathers, 16 KB
        a layer each way, where the reference's partitioner permutes 1 KB).
        A partial sum on `b` is reduced first."""
    mesh, target, cur, nd = x.device_mesh, list(placements), list(x.placements), x.ndim

    swaps = [(m, p.dim % nd, q.dim % nd) for m, (p, q) in enumerate(zip(cur, target))
             if isinstance(p, Shard) and isinstance(q, Shard) and p.dim % nd != q.dim % nd]
    moves = [(a, b, p.dim % nd) for a, p in enumerate(cur) if isinstance(p, Shard)
             and target[a] == Replicate() for b, q in enumerate(target)
             if isinstance(q, Shard) and q.dim % nd == p.dim % nd
             and not isinstance(cur[b], Shard)]
    if len(swaps) + len(moves) != 1:
        return x.redistribute(mesh, target)
    if swaps:
        m, i, j = swaps[0]
        n = mesh.size(m)
        others = {p.dim % nd for k, p in enumerate(target) if k != m and isinstance(p, Shard)}
        if n == 1 or x.shape[i] % n or x.shape[j] % n or {i, j} & others:
            return x.redistribute(mesh, target)
        mid = [cur[m] if k == m else t for k, t in enumerate(target)]
        if mid != cur:
            x = x.redistribute(mesh, mid)
        return local_map(lambda t: _dims_swapped(t, i, j, n, (mesh, m)), out_placements=target,
                         in_placements=(mid,), device_mesh=mesh)(x)
    a, b, k = moves[0]
    na, nb, n = mesh.size(a), mesh.size(b), x.shape[k]
    if na == 1 or nb == 1 or n % na or n % nb or sum(
            isinstance(p, Shard) and p.dim % nd == k for p in cur + target) != 2:
        return x.redistribute(mesh, target)
    mid = [cur[m] if m == a else Replicate() if m == b else target[m] for m in range(len(cur))]
    if mid != cur:
        x = x.redistribute(mesh, mid)
    la, lb = n // na, n // nb
    coord = mesh.get_coordinate()
    lo, hi = coord[b] * lb, (coord[b] + 1) * lb      # the slice this rank's group of `a` wants
    sizes = [max(0, min(hi, (j + 1) * la) - max(lo, j * la)) for j in range(na)]
    mine = sizes[coord[a]]
    first = max(lo, coord[a] * la) - coord[a] * la if mine else 0
    at = sum(sizes[:coord[a]])
    # Every rank of `b` holds the gradient of its own slice: a partial sum.
    grad = [Partial() if m == b else p for m, p in enumerate(mid)]
    return local_map(lambda t: _SliceMoved.apply(t, k, first, mine, at, sizes, (mesh, a)),
                     out_placements=target, in_placements=(mid,), in_grad_placements=(grad,),
                     device_mesh=mesh)(x)


def _dims_swapped(t: torch.Tensor, i: int, j: int, n: int, group) -> torch.Tensor:
    """`relaid`'s all-to-all on a rank's shard `t`, split along dim `i`
    over the `n` ranks of `group`, as the same split along dim `j`: the
    n-th parts of `t` along `j` go to the ranks in order, and the parts
    received are stacked along `i` in rank order. Its gradient is the
    reverse all-to-all."""
    # Where a dim of one row lets the reshape be a view, it is a strided
    # one, which torch 2.11's all-to-all refuses.
    send = t.unflatten(j, (n, -1)).movedim(j, 0).flatten(0, 1).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single_autograd(send, None, None, group))
    return got.unflatten(0, (n, -1)).movedim(0, i).flatten(i, i + 1)


class _SliceMoved(torch.autograd.Function):
    """`relaid`'s all-to-all on a rank's shard `t`: its part of the wanted
    slice (`mine` rows of dim `k` from row `first`) sent to every rank of
    the group, which concatenates the parts it receives (`sizes`, in rank
    order). The output is the same on every rank of the group, so the
    gradient of this rank's part is its own output gradient's rows `at`
    .. `at + mine`: a slice, moving nothing."""

    @staticmethod
    def forward(ctx, t, k, first, mine, at, sizes, group):
        ctx.shape, ctx.k, ctx.first, ctx.mine, ctx.at = t.shape, k, first, mine, at
        piece = t.narrow(k, first, mine).movedim(k, 0)
        send = piece.repeat(len(sizes), *([1] * (piece.ndim - 1))).contiguous()
        got = funcol.all_to_all_single(send, sizes, [mine] * len(sizes), group)
        return funcol.wait_tensor(got).movedim(0, k)

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.k, ctx.first, ctx.mine).copy_(g.narrow(ctx.k, ctx.at, ctx.mine))
        return out, None, None, None, None, None, None
