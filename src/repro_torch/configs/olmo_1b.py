"""olmo-1b — AI2 OLMo dense transformer.

16L, d_model 2048, 16 heads (MHA), d_ff 8192, vocab 50304.
OLMo specifics: NON-PARAMETRIC LayerNorm (no scale, no bias), SwiGLU,
RoPE, no biases anywhere, tied embeddings. [arXiv:2402.00838; hf]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        pattern=(BlockDef("attn", "dense"),),
        norm_type="layernorm",
        parametric_norm=False,
        act="silu",
        glu=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        source="arXiv:2402.00838",
    )
)
