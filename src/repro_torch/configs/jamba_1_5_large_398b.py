"""jamba-1.5-large-398b — hybrid Mamba+attention MoE.

72L, d_model 8192, 64 q-heads / 8 kv-heads on attention layers, d_ff 24576,
vocab 65536, MoE 16 experts top-2. Structure: 1 attention layer per 8
(1:7 attn:mamba interleave), MoE on every other layer.

Pattern period (8 blocks, repeated 9x) preserves both ratios exactly:
  [attn+moe, mamba, mamba+moe, mamba, mamba+moe, mamba, mamba+moe, mamba+dense... ]
Concretely: MoE on even in-period indices (4/8 = every other layer), the
single attention block leads each period (Jamba places it mid-period; the
ratio and adjacency structure are preserved, position within the period is
a documented simplification for scan-ability).

TPU adaptation note (DESIGN.md): Jamba uses Mamba-1 selective-scan blocks;
we use the Mamba-2 SSD formulation, whose chunked matmul structure maps to
the MXU (the published successor formulation — same state-space class).
[arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

_PERIOD = (
    BlockDef("attn", "moe"),
    BlockDef("mamba", "dense"),
    BlockDef("mamba", "moe"),
    BlockDef("mamba", "dense"),
    BlockDef("mamba", "moe"),
    BlockDef("mamba", "dense"),
    BlockDef("mamba", "moe"),
    BlockDef("mamba", "dense"),
)

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        pattern=_PERIOD,
        norm_type="rmsnorm",
        act="silu",
        glu=True,
        use_rope=False,  # Jamba uses no positional encoding on attn layers
        moe_num_experts=16,
        moe_top_k=2,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        ssm_chunk=256,
        ssm_conv_kernel=4,
        source="arXiv:2403.19887",
    )
)
