"""Per-rank FX graph accounting for the roofline; the counterpart of the JAX
package's ``roofline/hlo_parse.py``, which parses XLA's optimized HLO.

`launch.dryrun` traces a cell with `make_fx` around a function that wraps
each rank's local shards with `DTensor.from_local` and returns the outputs'
`to_local()`: the graph holds one rank's ops on its local shapes, with
`DTensor`'s communication as ``_c10d_functional`` collectives (each
followed by a ``wait_tensor``). Its shapes are per rank, so every total
here is per chip, as the post-SPMD HLO's are. The conventions are the
reference's:

  * FLOPs: `FlopCounterMode` over the graph's own execution on ``meta``
    tensors (matmuls, convolutions and attention ops, as PyTorch counts
    them). `FlopCounterMode` around the `DTensor` ops themselves would
    count each product whole, not a chip's share;
  * memory bytes: about 2x the output bytes of every node that
    materializes a tensor (read + write); an in-place write (``copy_``
    into a slice, ``index_put_``, a scatter) at its update's size, which
    is its output (the slice it writes); views, reshapes and bookkeeping
    skipped. Reads of the graph's inputs (weights, caches), which no node
    of the graph writes, are charged once per node that reads them;
  * collective bytes: output bytes of ``all_gather_into_tensor`` and
    ``all_to_all_single``, x2 for ``all_reduce`` (a ring all-reduce moves
    about twice its payload), operand bytes for ``reduce_scatter_tensor``;
    (n-1)/n ring factors folded to 1. The counts by kind are the ones
    `CommDebugMode` gives for the same cell run eagerly.

`make_fx` unrolls the port's Python loops (periods, query chunks, scan
chunks), so every op appears as often as it runs: there are no loops and
no trip counts to recover (`while_trip_counts` is empty). The reference
halves the payload of a bf16 all-reduce that XLA's CPU backend promoted to
f32 ("promoted"); that is an artifact of XLA and has no counterpart here.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field

import torch
import torch.fx
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


@dataclass
class GraphCost:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = field(default_factory=dict)
    collective_count: dict = field(default_factory=dict)
    while_trip_counts: list = field(default_factory=list)
    # Profiling: (bytes_or_flops, mult, op, shape, hint), the reference's rows.
    top_traffic: list = field(default_factory=list)
    top_collectives: list = field(default_factory=list)
    top_flops: list = field(default_factory=list)
    memory_stats: dict = field(default_factory=dict)


def _nbytes(val) -> float:
    if isinstance(val, torch.Tensor):
        return float(val.numel() * val.element_size())
    if isinstance(val, (list, tuple)):
        return sum(_nbytes(v) for v in val)
    return 0.0


def _shape(val):
    return tuple(val.shape) if isinstance(val, torch.Tensor) else None


def _op_parts(node: torch.fx.Node) -> tuple[str, str]:
    """(namespace, op name without overload) of a call_function node."""
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return target.namespace, target._schema.name.split("::")[-1]
    return "", getattr(target, "__name__", str(target))


def _is_view(node: torch.fx.Node) -> bool:
    """An op whose output aliases an input without writing it (views,
    reshapes that need no copy), or Python bookkeeping (getitem)."""
    if node.target is operator.getitem:
        return True
    target = node.target
    if not isinstance(target, torch._ops.OpOverload):
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in target._schema.returns)


def _hint(node: torch.fx.Node) -> str:
    return node.name


class _Runner(torch.fx.Interpreter):
    """Runs the graph on its ``meta`` inputs under `FlopCounterMode`,
    keeping each node's output (for shapes) and its FLOPs."""

    def __init__(self, gm: torch.fx.GraphModule, counter: FlopCounterMode):
        super().__init__(gm, garbage_collect_values=False)
        self.counter = counter
        self.flops: dict[torch.fx.Node, float] = {}

    def run_node(self, n: torch.fx.Node):
        before = self.counter.get_total_flops()
        out = super().run_node(n)
        self.flops[n] = float(self.counter.get_total_flops() - before)
        return out


def analyze_graph_module(gm: torch.fx.GraphModule, inputs: list) -> GraphCost:
    """The roofline terms of one rank's graph `gm`, run on `inputs` (its
    ``meta`` local shards)."""
    cost = GraphCost()
    with FlopCounterMode(display=False) as counter:
        runner = _Runner(gm, counter)
        runner.run(*inputs)
    env = runner.env
    nodes = list(gm.graph.nodes)
    placeholders = {n for n in nodes if n.op == "placeholder"}

    for n in nodes:
        if n.op != "call_function":
            continue
        val = env.get(n)
        f = runner.flops.get(n, 0.0)
        if f:
            cost.flops += f
            cost.top_flops.append((f, 1.0, _op_parts(n)[1], _shape(val), _hint(n)))
        ns, name = _op_parts(n)
        if ns == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is None:          # wait_tensor and other bookkeeping
                continue
            nbytes = _nbytes(val)
            if kind == "reduce-scatter":
                nbytes = _nbytes(env.get(n.args[0]))
            if kind == "all-reduce":
                nbytes *= 2
            cost.collective_bytes += nbytes
            cost.collective_by_kind[kind] = cost.collective_by_kind.get(kind, 0.0) + nbytes
            cost.collective_count[kind] = cost.collective_count.get(kind, 0) + 1
            cost.top_collectives.append((nbytes, 1.0, kind, _shape(val), _hint(n)))
            continue
        if _is_view(n):
            continue
        # Reads of the graph's inputs (weights, caches), which no node wrote.
        for arg in n.all_input_nodes:
            src = arg
            while src.op == "call_function" and _is_view(src) and src.all_input_nodes:
                src = src.all_input_nodes[0]
            if src in placeholders:
                rb = _nbytes(env.get(arg))
                if rb:
                    cost.traffic_bytes += rb
                    cost.top_traffic.append((rb, 1.0, f"read<-{name}", _shape(env.get(arg)),
                                             _hint(n)))
        b = 2.0 * _nbytes(val)
        if b:
            cost.traffic_bytes += b
            cost.top_traffic.append((b, 1.0, name, _shape(val), _hint(n)))

    cost.memory_stats = _memory_stats(nodes, env, inputs)
    for lst in (cost.top_traffic, cost.top_collectives, cost.top_flops):
        lst.sort(key=lambda t: -t[0])
        del lst[40:]
    return cost


def _memory_stats(nodes: list, env: dict, inputs: list) -> dict:
    """Argument and output bytes of the rank's local shards, and temp
    bytes as the peak over node order of the intermediates still to be
    read: an estimate that, unlike XLA's buffer assignment, reuses no
    buffer and fuses nothing. A view keeps its base alive."""
    arg_bytes = sum(_nbytes(t) for t in inputs)
    out_node = next(n for n in nodes if n.op == "output")
    out_bytes = sum(_nbytes(env.get(o)) for o in out_node.all_input_nodes)

    # The node that owns each value's storage: views point at their base.
    owner: dict = {}
    for n in nodes:
        if n.op == "call_function" and _is_view(n) and n.all_input_nodes:
            owner[n] = owner.get(n.all_input_nodes[0], n.all_input_nodes[0])
        else:
            owner[n] = n
    last_use: dict = {}
    for i, n in enumerate(nodes):
        for arg in n.all_input_nodes:
            last_use[owner[arg]] = i
    live, peak = 0.0, 0.0
    frees: dict[int, list] = {}
    for n, i in last_use.items():
        frees.setdefault(i, []).append(n)
    for i, n in enumerate(nodes):
        if n.op == "call_function" and owner[n] is n:
            live += _nbytes(env.get(n))
            peak = max(peak, live)
        for dead in frees.get(i, []):
            if dead.op == "call_function":
                live -= _nbytes(env.get(dead))
    return dict(argument_bytes=int(arg_bytes), output_bytes=int(out_bytes),
                temp_bytes=int(peak), alias_bytes=0, code_bytes=0)
