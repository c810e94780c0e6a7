"""Model facade: one object per architecture config exposing
spec/init/loss/prefill/decode, as the JAX package's ``models/api.py`` does:
decoder-only configs with dense attention (``(attn, dense)``), Mamba-2
(``(mamba, -)``, e.g. ``mamba2-1.3b``), MoE (``(attn, moe)``, e.g.
``granite-moe-3b-a800m``) and hybrids of these (``jamba-1.5-large-398b``),
and the encoder-decoder ``whisper-large-v3`` (``models/encdec.py``).

Parameters are nested dicts of tensors with the JAX tree's paths and
shapes (``layers.block0.attn.wq`` is (periods, d, Hq, D_h),
``layers.block0.mamba.w_x`` is (periods, d, d_inner), ``layers.block0.ffn.w_up``
of an MoE block (periods, E_pad, d, f)), so a JAX parameter
tree carries across as a copy with no transposes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.moe import moe_spec
from repro_torch.models.spec import abstract_like, abstract_params, init_params, param_count
from repro_torch.sharding.rules import ShardingRules


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- parameters -----------------------------------------------------------
    def spec(self) -> dict:
        if self.cfg.is_encdec:
            return ED.encdec_spec(self.cfg)
        return LM.lm_spec(self.cfg)

    def init(self, seed: int = 0, *, device="cuda", param_dtype=torch.float32) -> dict:
        return init_params(self.spec(), seed, device=device, param_dtype=param_dtype)

    def abstract_params(self, rules: ShardingRules | None = None,
                        param_dtype=torch.float32):
        return abstract_params(self.spec(), rules, param_dtype)

    def param_count(self) -> int:
        return param_count(self.spec())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts), by the
        reference's arithmetic: the router is counted as d x the real
        expert count, and the rest of each MoE layer (padding experts
        included) scales by 1 - top_k / num_experts."""
        total = self.param_count()
        cfg = self.cfg
        if not cfg.is_moe:
            return total
        moe_layers = sum(1 for b in cfg.pattern if b.ffn == "moe") * cfg.periods
        expert_part = param_count(moe_spec(cfg)) - cfg.d_model * cfg.moe_num_experts
        inactive = moe_layers * expert_part * (1 - cfg.moe_top_k / cfg.moe_num_experts)
        return int(total - inactive)

    # -- training -------------------------------------------------------------
    def loss(self, params, batch: dict, *, q_chunk: int = 512,
             loss_chunk: int = 512, remat: bool = True) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["inputs"]`` (an
        encoder-decoder's: of ``batch["dec_ids"]`` over ``batch["enc_inputs"]``)
        against ``batch["labels"]`` (labels < 0 masked), differentiable in
        `params`."""
        cfg = self.cfg
        if cfg.is_encdec:
            return ED.encdec_loss(params, cfg, batch["enc_inputs"], batch["dec_ids"],
                                  batch["labels"], q_chunk=q_chunk, loss_chunk=loss_chunk,
                                  remat=remat)
        return LM.lm_loss(params, self.cfg, batch["inputs"], batch["labels"],
                          q_chunk=q_chunk, loss_chunk=loss_chunk, remat=remat)

    # -- serving ---------------------------------------------------------------
    def prefill(self, params, batch: dict, *, q_chunk: int = 512):
        cfg = self.cfg
        if cfg.is_encdec:
            return ED.encdec_prefill(params, cfg, batch["enc_inputs"], batch["dec_prompt"],
                                     q_chunk=q_chunk)
        return LM.lm_prefill(params, cfg, batch["inputs"], q_chunk=q_chunk)

    def decode_step(self, params, inputs, caches, position: int):
        cfg = self.cfg
        if cfg.is_encdec:
            return ED.encdec_decode_step(params, cfg, inputs, caches, position)
        return LM.lm_decode_step(params, cfg, inputs, caches, position)

    # -- decode-state construction ---------------------------------------------
    def make_decode_caches(self, batch: int, seq_len: int, *, filled: bool,
                           device="cuda"):
        """Decode caches; `filled` marks seq_len-1 positions valid (one new
        token against a seq_len cache). A Mamba block's cache is its conv and
        SSM state, of one size whatever `seq_len` and `filled` are. An
        encoder-decoder's cross caches hold `seq_len` encoder positions."""
        cfg = self.cfg
        length = seq_len - 1 if filled else 0
        if cfg.is_encdec:
            return ED.make_decode_caches(cfg, batch, seq_len, cross_len=seq_len,
                                         device=device, length=length)
        return LM.make_stack_cache(cfg, batch, seq_len, device=device, length=length)

    def abstract_decode_caches(self, batch: int, seq_len: int,
                               rules: ShardingRules | None):
        """`make_decode_caches(filled=True)`'s tree as ``meta`` tensors
        (sharded per `rules`), with nothing allocated."""
        shapes = self.make_decode_caches(batch, seq_len, filled=True, device="meta")
        return abstract_like(shapes, LM.stack_cache_axes(self.cfg), rules)

    def decode_inputs(self, batch: int, device="cuda"):
        """One-token decode inputs (zeros): token ids, or embeddings for a
        VLM (an encoder-decoder's decoder takes token ids)."""
        if self.cfg.embed_inputs and not self.cfg.is_encdec:
            return torch.zeros((batch, 1, self.cfg.d_model), dtype=L.COMPUTE_DTYPE,
                               device=device)
        return torch.zeros((batch, 1), dtype=torch.long, device=device)


def make_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
