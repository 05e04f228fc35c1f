"""whisper-medium [audio]: encoder-decoder, conv frontend STUB.

24 encoder + 24 decoder layers, d_model=1024 16H (kv=16, head_dim 64)
d_ff=4096 vocab=51865.  [arXiv:2212.04356; unverified]

The conv frontend is a stub: the caller provides
precomputed 1500-frame embeddings.  ``max_position`` is widened from
whisper's 448 to 32k, as in the JAX package's config.
"""
from repro_torch.configs.base import AttnConfig, EncoderConfig, ModelConfig, dense_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        d_model=1024,
        n_layers=24,
        vocab=51_865,
        d_ff=4096,
        stages=dense_stages(24),
        attn=AttnConfig(
            n_heads=16, n_kv_heads=16, head_dim=64, rope=False, learned_pos=True,
        ),
        norm="layernorm",
        act="gelu",
        glu=False,
        tie_embeddings=True,
        max_position=32_768,
        encoder=EncoderConfig(n_layers=24, n_frames=1500),
        frontend="audio",
        frontend_dim=1024,
        source="[arXiv:2212.04356; unverified]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-reduced",
        family="audio",
        d_model=64,
        n_layers=2,
        vocab=512,
        d_ff=128,
        stages=dense_stages(2),
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, rope=False, learned_pos=True),
        norm="layernorm",
        act="gelu",
        glu=False,
        tie_embeddings=True,
        max_position=128,
        encoder=EncoderConfig(n_layers=2, n_frames=24),
        frontend="audio",
        frontend_dim=32,
    )
