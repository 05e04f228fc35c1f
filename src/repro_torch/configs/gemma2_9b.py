"""gemma2-9b [dense]: alternating local/global attention, logit softcaps,
post-block norms. 42L d_model=3584 16H (kv=8, head_dim 256) d_ff=14336
vocab=256000.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import AttnConfig, BlockDef, ModelConfig

_LOCAL = BlockDef(mixer="attn", window=4096, ff="mlp")
_GLOBAL = BlockDef(mixer="attn", window=None, ff="mlp")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        d_model=3584,
        n_layers=42,
        vocab=256_000,
        d_ff=14336,
        stages=(((_LOCAL, _GLOBAL), 21),),
        attn=AttnConfig(
            n_heads=16, n_kv_heads=8, head_dim=256, logit_softcap=50.0,
        ),
        act="gelu_tanh",
        glu=True,
        tie_embeddings=True,
        embed_scale=True,
        final_softcap=30.0,
        post_block_norm=True,
        source="[arXiv:2408.00118; hf]",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-reduced",
        family="dense",
        d_model=64,
        n_layers=4,
        vocab=512,
        d_ff=128,
        stages=(((BlockDef(mixer="attn", window=16), _GLOBAL), 2),),
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, logit_softcap=50.0),
        act="gelu_tanh",
        glu=True,
        tie_embeddings=True,
        embed_scale=True,
        final_softcap=30.0,
        post_block_norm=True,
    )
