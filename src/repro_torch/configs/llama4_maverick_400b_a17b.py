"""llama4-maverick-400b-a17b [moe]: interleaved dense/MoE, 128 experts
top-1 + shared expert.  48L d_model=5120 40H (kv=8, head_dim 128)
d_ff=8192 vocab=202048.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Early-fusion multimodality is a stub (text path only; the vision frontend
pattern is exercised by pixtral-12b).  Dense/MoE layers alternate
(interleave step 2, llama4-style): 24 x (dense, moe) = 48 layers; the
routed experts (128 x 3 x 5120 x 8192 x 24 ~ 386B) plus backbone give
~400B total with ~17B active (top-1 + shared).  long_500k skipped
(full-attention arch).
"""
from repro_torch.configs.base import AttnConfig, BlockDef, ModelConfig, MoeConfig

_DENSE = BlockDef(mixer="attn", ff="mlp")
_MOE = BlockDef(mixer="attn", ff="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        d_model=5120,
        n_layers=48,
        vocab=202_048,
        d_ff=8192,
        stages=(((_DENSE, _MOE), 24),),
        attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128, rope_theta=500_000.0),
        moe=MoeConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared_experts=1),
        act="silu",
        glu=True,
        tie_embeddings=False,
        source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-reduced",
        family="moe",
        d_model=64,
        n_layers=4,
        vocab=512,
        d_ff=128,
        stages=(((_DENSE, _MOE), 2),),
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        moe=MoeConfig(n_experts=8, top_k=1, d_ff_expert=128, n_shared_experts=1),
        act="silu",
        glu=True,
        tie_embeddings=False,
    )
