"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000.
[arXiv:2402.19427; hf]

Griffin pattern: (rglru, rglru, local-attn) repeated; 26 layers =
8 x (R, R, A) + (R, R) tail.  Local window 2048.  Sub-quadratic
sequence mixing -> runs the long_500k shape (ring-buffer local caches +
O(1) recurrent state).
"""
from repro_torch.configs.base import AttnConfig, BlockDef, ModelConfig, RglruConfig

_R = BlockDef(mixer="rglru", ff="mlp")
_A = BlockDef(mixer="attn", window=2048, ff="mlp")


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        d_model=2560,
        n_layers=26,
        vocab=256_000,
        d_ff=7680,
        stages=(((_R, _R, _A), 8), ((_R, _R), 1)),
        attn=AttnConfig(n_heads=10, n_kv_heads=1, head_dim=256, rope_theta=10000.0),
        rglru=RglruConfig(d_rnn=2560, conv_width=4),
        act="gelu_tanh",
        glu=True,
        tie_embeddings=True,
        embed_scale=True,
        supports_long_context=True,
        source="[arXiv:2402.19427; hf]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced",
        family="hybrid",
        d_model=64,
        n_layers=5,
        vocab=512,
        d_ff=128,
        stages=(((_R, _R, _A), 1), ((_R, _A), 1)),
        attn=AttnConfig(n_heads=4, n_kv_heads=1, head_dim=16),
        rglru=RglruConfig(d_rnn=64, conv_width=4),
        act="gelu_tanh",
        glu=True,
        tie_embeddings=True,
        embed_scale=True,
        supports_long_context=True,
    )
