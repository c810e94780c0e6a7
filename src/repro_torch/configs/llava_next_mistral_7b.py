"""llava-next-mistral-7b — VLM; Mistral-7B backbone, anyres-tiling frontend.

Backbone: 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 32000.
The modality frontend (CLIP vision tower + anyres tiling + projector) is a
STUB per the assignment: `input_specs()` provides precomputed patch+text
embeddings of shape (batch, seq, d_model); the backbone consumes embeddings
directly (embed_inputs=True). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        pattern=(BlockDef("attn", "dense"),),
        norm_type="rmsnorm",
        act="silu",
        glu=True,
        rope_theta=1000000.0,
        embed_inputs=True,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
)
