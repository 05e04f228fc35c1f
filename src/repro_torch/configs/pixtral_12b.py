"""pixtral-12b [vlm]: pixtral-ViT frontend (stub) + mistral-nemo backbone.

40L d_model=5120 32H (kv=8, head_dim 128) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409; unverified]

The ViT frontend is a stub: the caller provides
precomputed patch embeddings (1024-dim), which the backbone projects and
prepends to the text tokens.  long_500k skipped (full attention).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, dense_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        d_model=5120,
        n_layers=40,
        vocab=131_072,
        d_ff=14336,
        stages=dense_stages(40),
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=1_000_000.0),
        act="silu",
        glu=True,
        tie_embeddings=False,
        frontend="vision",
        frontend_dim=1024,
        source="[hf:mistralai/Pixtral-12B-2409; unverified]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-reduced",
        family="vlm",
        d_model=64,
        n_layers=3,
        vocab=512,
        d_ff=128,
        stages=dense_stages(3),
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        act="silu",
        glu=True,
        tie_embeddings=False,
        frontend="vision",
        frontend_dim=32,
    )
