"""whisper-large-v3 — encoder-decoder audio transformer backbone.

32L encoder + 32L decoder, d_model 1280, 20 heads (MHA), d_ff 5120,
vocab 51866. The conv frontend (2x conv1d over mel frames) is a STUB per
the assignment: `input_specs()` provides precomputed frame embeddings
(batch, seq, d_model). Whisper uses GELU MLPs (non-gated), parametric
LayerNorm with biases, sinusoidal encoder positions / learned decoder
positions, and biases on projections.

Shape-cell semantics (enc-dec is not decoder-only; documented in
DESIGN.md): train_4k = encoder over seq_len frames + teacher-forced decoder
over seq_len tokens; prefill_32k = encoder over seq_len frames + decoder
prefill of `dec_prefill_len` tokens; decode shapes = one decoder step with
self-KV of seq_len and cross-attention to seq_len encoder states.
20 heads do not divide the 16-way tensor axis -> heads replicated,
d_ff/vocab sharded. long_500k skipped (full attention).
[arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        num_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        pattern=(BlockDef("attn", "dense", cross_attn=True),),
        norm_type="layernorm",
        norm_bias=True,
        qkv_bias=True,   # whisper: q/v have bias (k does not; we use full bias)
        out_bias=True,
        act="gelu",
        glu=False,
        use_rope=False,
        pos_embedding="sinusoidal",
        is_encdec=True,
        enc_layers=32,
        dec_prefill_len=256,
        embed_inputs=True,  # encoder inputs are stub frame embeddings
        source="arXiv:2212.04356",
    )
)
