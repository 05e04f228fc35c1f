"""moonshot-v1-16b-a3b [moe]: kimi/moonlight-style, 64 experts top-6 +
2 shared experts, dense first layer.  48L d_model=2048 16H (kv=16,
head_dim 128) expert d_ff=1408 vocab=163840.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import AttnConfig, BlockDef, ModelConfig, MoeConfig

_DENSE = BlockDef(mixer="attn", ff="mlp")
_MOE = BlockDef(mixer="attn", ff="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        d_model=2048,
        n_layers=48,
        vocab=163_840,
        d_ff=11264,  # dense first layer: 8 x expert width (moonlight-style)
        stages=(((_DENSE,), 1), ((_MOE,), 47)),
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128, rope_theta=50_000.0),
        moe=MoeConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2),
        act="silu",
        glu=True,
        tie_embeddings=True,
        source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-reduced",
        family="moe",
        d_model=64,
        n_layers=4,
        vocab=512,
        d_ff=256,
        stages=(((_DENSE,), 1), ((_MOE,), 3)),
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        moe=MoeConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=2),
        act="silu",
        glu=True,
        tie_embeddings=True,
    )
