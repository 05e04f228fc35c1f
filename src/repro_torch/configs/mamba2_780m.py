"""mamba2-780m [ssm]: attention-free, SSD (state-space duality).

48L d_model=1536, ssm_state=128, head_dim 64, expand 2, vocab=50280.
[arXiv:2405.21060; unverified]

Linear-time sequence mixing with O(1) decode state -> runs long_500k.
The paper's multicast technique applies to weight distribution only (no
attention to shard).
"""
from repro_torch.configs.base import BlockDef, ModelConfig, SsmConfig

_SSD = BlockDef(mixer="ssd", ff="none")


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        d_model=1536,
        n_layers=48,
        vocab=50_280,
        d_ff=0,
        stages=(((_SSD,), 48),),
        ssm=SsmConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=128),
        act="silu",
        glu=False,
        tie_embeddings=True,
        supports_long_context=True,
        source="[arXiv:2405.21060; unverified]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-reduced",
        family="ssm",
        d_model=64,
        n_layers=4,
        vocab=512,
        d_ff=0,
        stages=(((_SSD,), 4),),
        ssm=SsmConfig(d_state=16, head_dim=8, expand=2, conv_width=4, chunk=8),
        act="silu",
        glu=False,
        tie_embeddings=True,
        supports_long_context=True,
    )
