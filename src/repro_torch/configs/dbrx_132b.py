"""dbrx-132b — Databricks fine-grained MoE transformer.

40L, d_model 6144, 48 q-heads / 8 kv-heads (head_dim 128), per-expert
d_ff 10752, vocab 100352, MoE 16 experts top-4 on every layer. DBRX
specifics: LayerNorm (no bias), GLU experts, RoPE, no attention biases.
16 experts divide the 16-way tensor axis exactly -> expert-parallel
all-to-all path available (a hillclimb target). [hf:databricks/dbrx-base;
unverified]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        pattern=(BlockDef("attn", "moe"),),
        norm_type="layernorm",
        norm_bias=False,
        act="silu",
        glu=True,
        rope_theta=500000.0,
        moe_num_experts=16,
        moe_top_k=4,
        source="hf:databricks/dbrx-base",
    )
)
