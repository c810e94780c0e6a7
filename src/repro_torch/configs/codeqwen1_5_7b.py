"""codeqwen1.5-7b — Qwen1.5-architecture dense transformer.

32L, d_model 4096, 32 heads (GQA kv=32, i.e. MHA), d_ff 13440,
vocab 92416. Qwen1.5 specifics: QKV bias, RMSNorm, SwiGLU.
[hf:Qwen/CodeQwen1.5-7B; hf]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        pattern=(BlockDef("attn", "dense"),),
        norm_type="rmsnorm",
        qkv_bias=True,
        act="silu",
        glu=True,
        rope_theta=1000000.0,
        source="hf:Qwen/CodeQwen1.5-7B",
    )
)
