from repro_torch.roofline.analysis import (
    HW_H100,
    CollectiveStats,
    RooflineReport,
    analyze_graph,
    model_flops,
)

__all__ = [
    "HW_H100",
    "CollectiveStats",
    "RooflineReport",
    "analyze_graph",
    "model_flops",
]
