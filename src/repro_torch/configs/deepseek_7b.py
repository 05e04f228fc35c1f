"""deepseek-7b [dense]: llama-architecture. 30L d_model=4096 32H (kv=32)
d_ff=11008 vocab=102400.  [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, dense_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        d_model=4096,
        n_layers=30,
        vocab=102_400,
        d_ff=11008,
        stages=dense_stages(30),
        attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=128, rope_theta=10000.0),
        act="silu",
        glu=True,
        tie_embeddings=False,
        source="[arXiv:2401.02954; hf]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-reduced",
        family="dense",
        d_model=64,
        n_layers=3,
        vocab=512,
        d_ff=160,
        stages=dense_stages(3),
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        act="silu",
        glu=True,
        tie_embeddings=False,
    )
