from repro_torch.ft.restart import RestartManager, TrainLoopResult, run_with_restarts

__all__ = [
    "RestartManager",
    "TrainLoopResult",
    "run_with_restarts",
]
