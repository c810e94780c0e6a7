"""Config system: model architecture + input-shape configs.

A copy, value for value, of the JAX package's configs: the port imports
nothing of that package. Every architecture is a `ModelConfig` in its own
module under ``repro_torch.configs``; shapes are the four assigned
(seq_len, global_batch) cells. Block layout is a repeating *period* of
blocks whose parameters are stacked on a leading periods axis, so a
parameter tree carries across from the JAX package with no reshaping.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


# --------------------------------------------------------------------------- #
# Block pattern
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class BlockDef:
    mixer: str          # "attn" | "mamba"
    ffn: str | None     # "dense" | "moe" | None (mamba2 blocks carry no FFN)
    cross_attn: bool = False  # decoder blocks of enc-dec models


# --------------------------------------------------------------------------- #
# Model config
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # block layout: `pattern` repeated `periods` times == num_layers blocks
    pattern: tuple[BlockDef, ...] = (BlockDef("attn", "dense"),)

    # normalization / misc structure
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    norm_eps: float = 1e-5
    parametric_norm: bool = True  # False: OLMo-style non-parametric LN
    norm_bias: bool = False
    qkv_bias: bool = False
    out_bias: bool = False        # bias on attn-out / MLP projections
    parallel_block: bool = False  # Cohere: attn + FFN share the input norm
    qk_norm: bool = False
    act: str = "silu"             # silu (SwiGLU) | gelu (plain / GeGLU)
    glu: bool = True              # gated FFN
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    pos_embedding: str | None = None  # "sinusoidal" | "learned" | None
    logit_scale: float = 1.0      # Cohere logit_scale / granite logits_scaling
    embedding_multiplier: float = 1.0  # granite
    residual_multiplier: float = 1.0   # granite
    embed_inputs: bool = False    # VLM/audio: inputs are embeddings, not ids
    max_seq_len: int = 524288

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    # Pad the expert dim to this multiple so it shards over the tensor axis
    # (granite's 40 -> 48 on a 16-way axis); dummy experts are masked out of
    # routing and receive no tokens. 1 disables padding.
    moe_pad_multiple: int = 16

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    ssm_conv_kernel: int = 4

    # encoder-decoder
    is_encdec: bool = False
    enc_layers: int = 0           # encoder depth (decoder depth = num_layers)
    dec_prefill_len: int = 256    # decoder prompt length for prefill shapes

    # provenance
    source: str = ""

    # ---- derived ----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )

    @property
    def periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0

    @property
    def moe_padded_experts(self) -> int:
        m = max(1, self.moe_pad_multiple)
        return int(math.ceil(self.moe_num_experts / m) * m)

    @property
    def has_attention(self) -> bool:
        return any(b.mixer == "attn" for b in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: no full-attention over the whole sequence
        dominates (SSM or hybrid-with-few-attn archs)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    # ---- reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family/block-structure, tiny dims: one pattern period (or two
        for depth), small width, few experts — runnable on CPU."""
        num_layers = len(self.pattern)
        d_model = 64
        n_heads = max(1, min(4, self.num_heads)) if self.num_heads else 0
        if n_heads and self.num_kv_heads:
            if self.num_kv_heads == self.num_heads:
                n_kv = n_heads  # MHA stays MHA
            else:
                group = max(2, self.num_heads // self.num_kv_heads)
                n_kv = max(1, n_heads // group)
                n_heads = n_kv * min(group, n_heads)  # keep divisibility
        else:
            n_kv = 0
        kw = dict(
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=16 if n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            max_seq_len=2048,
        )
        if self.is_moe:
            kw.update(moe_num_experts=4, moe_top_k=min(2, self.moe_top_k),
                      moe_pad_multiple=1)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.is_encdec:
            kw.update(enc_layers=len(self.pattern), dec_prefill_len=8)
        return replace(self, **kw)


# --------------------------------------------------------------------------- #
# Shape configs (assigned per-arch shape set)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The assigned shape cells applicable to `cfg`. long_500k needs
    sub-quadratic sequence mixing; full-attention archs skip it (recorded in
    DESIGN.md §Arch-applicability)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config: {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def all_configs() -> dict[str, ModelConfig]:
    _load_all()
    return dict(_REGISTRY)


_ARCH_MODULES = [
    "command_r_plus_104b",
    "codeqwen1_5_7b",
    "smollm_135m",
    "olmo_1b",
    "llava_next_mistral_7b",
    "jamba_1_5_large_398b",
    "whisper_large_v3",
    "granite_moe_3b_a800m",
    "dbrx_132b",
    "mamba2_1_3b",
]

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
