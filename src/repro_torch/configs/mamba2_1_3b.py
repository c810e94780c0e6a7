"""mamba2-1.3b — attention-free SSM with state-space duality (SSD).

48L pure Mamba-2 blocks (no attention, no separate FFN), d_model 2048,
expand 2 (d_inner 4096), head_dim 64 (64 ssm heads), state 128, conv 4,
vocab 50280. RMSNorm, tied embeddings. Runs long_500k (sub-quadratic).
[arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        pattern=(BlockDef("mamba", None),),
        norm_type="rmsnorm",
        act="silu",
        tie_embeddings=True,
        use_rope=False,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        ssm_chunk=256,
        ssm_conv_kernel=4,
        source="arXiv:2405.21060",
    )
)
