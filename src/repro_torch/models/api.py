"""Model facade: one object per architecture config exposing
spec/init/prefill/decode, as the JAX package's ``models/api.py`` does, for
decoder-only configs of the ``(attn, dense)`` pattern and Mamba-2 configs
(``(mamba, -)``, e.g. ``mamba2-1.3b``).

Parameters are nested dicts of tensors with the JAX tree's paths and
shapes (``layers.block0.attn.wq`` is (periods, d, Hq, D_h),
``layers.block0.mamba.w_x`` is (periods, d, d_inner)), so a JAX parameter
tree carries across as a copy with no transposes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.spec import init_params, param_count


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- parameters -----------------------------------------------------------
    def spec(self) -> dict:
        return LM.lm_spec(self.cfg)

    def init(self, seed: int = 0, *, device="cuda", param_dtype=torch.float32) -> dict:
        return init_params(self.spec(), seed, device=device, param_dtype=param_dtype)

    def param_count(self) -> int:
        return param_count(self.spec())

    # -- serving ---------------------------------------------------------------
    def prefill(self, params, batch: dict, *, q_chunk: int = 512):
        return LM.lm_prefill(params, self.cfg, batch["inputs"], q_chunk=q_chunk)

    def decode_step(self, params, inputs, caches, position: int):
        return LM.lm_decode_step(params, self.cfg, inputs, caches, position)

    # -- decode-state construction ---------------------------------------------
    def make_decode_caches(self, batch: int, seq_len: int, *, filled: bool,
                           device="cuda"):
        """Decode caches; `filled` marks seq_len-1 positions valid (one new
        token against a seq_len cache). A Mamba block's cache is its conv and
        SSM state, of one size whatever `seq_len` and `filled` are."""
        length = seq_len - 1 if filled else 0
        return LM.make_stack_cache(self.cfg, batch, seq_len, device=device,
                                   length=length)

    def decode_inputs(self, batch: int, device="cuda"):
        """One-token decode inputs (zeros)."""
        if self.cfg.embed_inputs:
            return torch.zeros((batch, 1, self.cfg.d_model), dtype=L.COMPUTE_DTYPE,
                               device=device)
        return torch.zeros((batch, 1), dtype=torch.long, device=device)


def make_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
