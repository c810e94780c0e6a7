from repro_torch.sharding.rules import (
    ShardingRules,
    TRAIN_RULES,
    DECODE_RULES,
    constrain,
    current_rules,
    use_rules,
)

__all__ = [
    "ShardingRules",
    "TRAIN_RULES",
    "DECODE_RULES",
    "constrain",
    "current_rules",
    "use_rules",
]
