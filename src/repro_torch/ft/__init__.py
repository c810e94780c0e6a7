from repro_torch.ft.restart import RestartManager, TrainLoopResult, run_with_restarts
from repro_torch.ft.elastic import reshard_tree, snapshot_resharded

__all__ = [
    "RestartManager",
    "TrainLoopResult",
    "run_with_restarts",
    "reshard_tree",
    "snapshot_resharded",
]
