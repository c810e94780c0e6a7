"""Roofline-term extraction from dry-run artifacts; the port of the JAX
package's ``roofline/analysis.py``.

Per (arch x shape x mesh):

  compute term    = FLOPs_per_chip / peak_FLOP/s
  memory term     = bytes_per_chip / HBM_bw
  collective term = collective_bytes_per_chip / link_bw

The per-chip numbers come from one rank's FX graph (`graph_parse`): its
shapes are that rank's local shards, as the post-partitioning HLO's are
per partition. Collective bytes count output bytes per op with an
all-reduce x2 multiplier (a ring all-reduce moves about twice its
payload); (n-1)/n ring factors are folded to 1.

The hardware is one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
no sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and NVLink 4's 900 GB/s
counted one way, 450 GB/s. The production meshes' 16-wide ``model`` axis
spans two 8-GPU hosts, whose link between hosts is slower than NVLink, so
for the part of a collective that crosses hosts the collective term is a
lower bound. These terms are derived from published peaks, not measured.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# One H100 SXM (NVIDIA data sheet, dense).
HW_H100 = dict(
    name="h100_sxm",
    peak_flops=989e12,     # bf16 FLOP/s
    hbm_bw=3.35e12,        # B/s
    link_bw=450e9,         # B/s, NVLink 4 one way
)


@dataclass
class CollectiveStats:
    total_bytes: float = 0.0
    by_kind_bytes: dict = field(default_factory=dict)
    by_kind_count: dict = field(default_factory=dict)

    def add(self, kind: str, nbytes: float) -> None:
        self.total_bytes += nbytes
        self.by_kind_bytes[kind] = self.by_kind_bytes.get(kind, 0.0) + nbytes
        self.by_kind_count[kind] = self.by_kind_count.get(kind, 0) + 1


def model_flops(kind: str, n_active_params: int, tokens: int) -> float:
    """Standard accounting: 6·N per train token (fwd+bwd), 2·N per
    forward-only token (prefill/decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


@dataclass
class RooflineReport:
    arch: str
    shape: str
    kind: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float
    memory_stats: dict
    hw: dict

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def summary_line(self) -> str:
        return (
            f"{self.arch:28s} {self.shape:12s} {self.mesh:10s} "
            f"tc={self.t_compute:.3e}s tm={self.t_memory:.3e}s "
            f"tcoll={self.t_collective:.3e}s dom={self.dominant:10s} "
            f"useful={self.useful_flops_ratio:.2f}"
        )


def analyze_graph(
    gm,
    inputs: list,
    *,
    arch: str,
    shape: str,
    kind: str,
    mesh_name: str,
    chips: int,
    n_active_params: int,
    tokens: int,
    alias_bytes: int = 0,
    hw: dict = HW_H100,
) -> RooflineReport:
    """The counterpart of the reference's `analyze_compiled`: the terms of
    one rank's traced graph `gm` run on its ``meta`` local shards
    `inputs` (`graph_parse.analyze_graph_module`). `alias_bytes` is the
    bytes of the inputs donated to the step (a train cell's state), which
    the reference's memory analysis reports as aliased."""
    from repro_torch.roofline.graph_parse import analyze_graph_module

    parsed = analyze_graph_module(gm, inputs)
    stats = CollectiveStats(
        total_bytes=parsed.collective_bytes,
        by_kind_bytes=parsed.collective_by_kind,
        by_kind_count=parsed.collective_count,
    )

    t_compute = parsed.flops / hw["peak_flops"]
    t_memory = parsed.traffic_bytes / hw["hbm_bw"]
    t_collective = stats.total_bytes / hw["link_bw"]
    terms = {
        "compute": t_compute,
        "memory": t_memory,
        "collective": t_collective,
    }
    dominant = max(terms, key=terms.get)  # type: ignore[arg-type]

    mf = model_flops(kind, n_active_params, tokens)
    total_flops = parsed.flops * chips
    useful = mf / total_flops if total_flops else 0.0

    memory_stats = dict(parsed.memory_stats, alias_bytes=int(alias_bytes))
    memory_stats["while_trip_counts"] = parsed.while_trip_counts

    return RooflineReport(
        arch=arch,
        shape=shape,
        kind=kind,
        mesh=mesh_name,
        chips=chips,
        flops_per_chip=parsed.flops,
        bytes_per_chip=parsed.traffic_bytes,
        coll_bytes_per_chip=stats.total_bytes,
        coll_breakdown={
            "bytes": stats.by_kind_bytes,
            "count": stats.by_kind_count,
        },
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_collective,
        dominant=dominant,
        model_flops_total=mf,
        useful_flops_ratio=useful,
        memory_stats=memory_stats,
        hw=dict(hw),
    )
