from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    apply_updates,
    global_norm,
    init_state,
    schedule,
)
from repro_torch.train.train_step import (
    StepConfig,
    TrainState,
    abstract_train_state,
    build_train_step,
    init_train_state,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "apply_updates",
    "global_norm",
    "init_state",
    "schedule",
    "StepConfig",
    "TrainState",
    "abstract_train_state",
    "build_train_step",
    "init_train_state",
]
