"""granite-moe-3b-a800m — IBM Granite fine-grained MoE.

32L, d_model 1536, 24 q-heads / 8 kv-heads (head_dim 64), per-expert
d_ff 512, vocab 49155, MoE 40 experts top-8 on every layer. Granite
specifics: RMSNorm, SwiGLU experts, embedding/residual/logit multipliers,
no biases, tied embeddings.

40 experts do not divide the 16-way tensor axis: the MoE falls back to the
per-expert-d_ff tensor-parallel path (experts replicated, d_ff sharded);
24 heads likewise fall back to replicated heads.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        pattern=(BlockDef("attn", "moe"),),
        norm_type="rmsnorm",
        act="silu",
        glu=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logit_scale=1.0 / 6.0,
        moe_num_experts=40,
        moe_top_k=8,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
)
