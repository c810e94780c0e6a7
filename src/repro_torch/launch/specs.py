"""Abstract input specs for every (arch x shape) cell; the port of the JAX
package's ``launch/specs.py``.

The dry-run never allocates: inputs, parameters and decode caches are
stand-ins with shapes, dtypes and shardings (`models.spec.abstract_tensor`:
a ``meta`` tensor, or a `DTensor` of the global shape over a ``meta`` shard
where the reference's ``ShapeDtypeStruct`` carries a sharding).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models.api import Model
from repro_torch.models.spec import abstract_tensor
from repro_torch.sharding.rules import ShardingRules


def _sds(rules: ShardingRules | None, shape, dtype, *axes) -> torch.Tensor:
    sharding = rules.sharding(tuple(axes), tuple(shape)) if rules else None
    return abstract_tensor(tuple(shape), dtype, sharding)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                      rules: ShardingRules | None) -> dict:
    b, s = shape.global_batch, shape.seq_len
    labels = _sds(rules, (b, s), torch.int32, "batch", None)
    if cfg.is_encdec:
        return dict(
            enc_inputs=_sds(rules, (b, s, cfg.d_model), L.COMPUTE_DTYPE,
                            "batch", None, None),
            dec_ids=_sds(rules, (b, s), torch.int32, "batch", None),
            labels=labels,
        )
    if cfg.embed_inputs:
        return dict(
            inputs=_sds(rules, (b, s, cfg.d_model), L.COMPUTE_DTYPE,
                        "batch", None, None),
            labels=labels,
        )
    return dict(inputs=_sds(rules, (b, s), torch.int32, "batch", None),
                labels=labels)


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                        rules: ShardingRules | None) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return dict(
            enc_inputs=_sds(rules, (b, s, cfg.d_model), L.COMPUTE_DTYPE,
                            "batch", None, None),
            dec_prompt=_sds(rules, (b, cfg.dec_prefill_len), torch.int32,
                            "batch", None),
        )
    if cfg.embed_inputs:
        return dict(inputs=_sds(rules, (b, s, cfg.d_model), L.COMPUTE_DTYPE,
                                "batch", None, None))
    return dict(inputs=_sds(rules, (b, s), torch.int32, "batch", None))


def decode_input_specs(model: Model, shape: ShapeConfig,
                       rules: ShardingRules | None) -> dict:
    """One-token decode against a seq_len cache: {inputs, caches, position}.
    The caches hold seq_len - 1 valid positions (their host-side length),
    so the new token's position is seq_len - 1; `position` is its 0-d
    int32 stand-in, as the reference's."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    if cfg.embed_inputs and not cfg.is_encdec:
        inputs = _sds(rules, (b, 1, cfg.d_model), L.COMPUTE_DTYPE,
                      "batch", None, None)
    else:
        inputs = _sds(rules, (b, 1), torch.int32, "batch", None)
    caches = model.abstract_decode_caches(b, s, rules)
    return dict(
        inputs=inputs,
        caches=caches,
        position=abstract_tensor((), torch.int32),
    )


def input_specs(model: Model, shape: ShapeConfig,
                rules: ShardingRules | None) -> dict:
    if shape.kind == "train":
        return train_input_specs(model.cfg, shape, rules)
    if shape.kind == "prefill":
        return prefill_input_specs(model.cfg, shape, rules)
    if shape.kind == "decode":
        return decode_input_specs(model, shape, rules)
    raise ValueError(shape.kind)
