"""command-r-35b [dense]: GQA, no biases. 40L d_model=8192 64H (kv=8)
d_ff=22528 vocab=256000.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, dense_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        d_model=8192,
        n_layers=40,
        vocab=256_000,
        d_ff=22528,
        stages=dense_stages(40),
        attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128, rope_theta=8_000_000.0),
        norm="layernorm",
        act="silu",
        glu=True,
        tie_embeddings=True,
        source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-reduced",
        family="dense",
        d_model=64,
        n_layers=3,
        vocab=512,
        d_ff=160,
        stages=dense_stages(3),
        attn=AttnConfig(n_heads=8, n_kv_heads=2, head_dim=8),
        norm="layernorm",
        act="silu",
        glu=True,
        tie_embeddings=True,
    )
