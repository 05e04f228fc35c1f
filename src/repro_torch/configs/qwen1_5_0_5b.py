"""qwen1.5-0.5b [dense]: llama-like with QKV bias. 24L d_model=1024 16H
(kv=16) d_ff=2816 vocab=151936.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, dense_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        d_model=1024,
        n_layers=24,
        vocab=151_936,
        d_ff=2816,
        stages=dense_stages(24),
        attn=AttnConfig(
            n_heads=16, n_kv_heads=16, head_dim=64, qkv_bias=True,
            rope_theta=1_000_000.0,
        ),
        act="silu",
        glu=True,
        tie_embeddings=True,
        source="[hf:Qwen/Qwen1.5-0.5B; hf]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b-reduced",
        family="dense",
        d_model=64,
        n_layers=3,
        vocab=512,
        d_ff=160,
        stages=dense_stages(3),
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, qkv_bias=True),
        act="silu",
        glu=True,
        tie_embeddings=True,
    )
