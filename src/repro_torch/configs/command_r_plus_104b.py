"""command-r-plus-104b — Cohere dense GQA transformer.

64L, d_model 12288, 96 q-heads / 8 kv-heads (head_dim 128), d_ff 33792,
vocab 256000. Cohere specifics: parallel attention+FFN block sharing one
input LayerNorm (no bias), no QKV bias, tied embeddings, logit scaling.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        pattern=(BlockDef("attn", "dense"),),
        norm_type="layernorm",
        norm_bias=False,
        parallel_block=True,
        act="silu",
        glu=True,
        tie_embeddings=True,
        logit_scale=0.0625,
        use_rope=True,
        rope_theta=75000000.0,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )
)
