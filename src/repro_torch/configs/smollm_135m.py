"""smollm-135m — small Llama-architecture dense transformer.

30L, d_model 576, 9 heads (GQA kv=3, head_dim 64), d_ff 1536, vocab 49152.
Llama specifics: RMSNorm, SwiGLU, RoPE, tied embeddings, no biases.
9 heads / 3 kv-heads do not divide a 16-way tensor axis: the sharding rules
fall back to replicated attention heads (d_ff and vocab still shard).
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        pattern=(BlockDef("attn", "dense"),),
        norm_type="rmsnorm",
        act="silu",
        glu=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
)
