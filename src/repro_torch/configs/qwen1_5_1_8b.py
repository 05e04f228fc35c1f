"""qwen1.5-1.8b [dense]: llama-like with QKV bias. 24L d_model=2048 16H
(kv=16) d_ff=5504 vocab=151936.  [hf:Qwen/Qwen1.5-1.8B; hf]

Registered speculative-decoding target: ``DRAFT`` names the small
same-tokenizer family member (qwen1.5-0.5b) that proposes tokens for it
(`configs.registry.draft_for`).  The reduced variant shares the reduced
qwen1.5-0.5b vocab (512) so the pairing validates in the CPU smoke
configuration too.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, dense_stages

#: registry metadata: the paired draft architecture for speculative
#: decoding (same tokenizer family — identical vocab — smaller trunk).
DRAFT = "qwen1.5-0.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-1.8b",
        family="dense",
        d_model=2048,
        n_layers=24,
        vocab=151_936,
        d_ff=5504,
        stages=dense_stages(24),
        attn=AttnConfig(
            n_heads=16, n_kv_heads=16, head_dim=128, qkv_bias=True,
            rope_theta=1_000_000.0,
        ),
        act="silu",
        glu=True,
        # unlike the 0.5B, the 1.8B does NOT tie embeddings: 1.53B trunk
        # + 0.31B output head is exactly the advertised 1.84B
        tie_embeddings=False,
        source="[hf:Qwen/Qwen1.5-1.8B; hf]",
    )


def reduced_config() -> ModelConfig:
    # vocab matches qwen1.5-0.5b-reduced (512) so the draft pairing's
    # tokenizer-compat check holds for the reduced pair as well.
    return ModelConfig(
        name="qwen1.5-1.8b-reduced",
        family="dense",
        d_model=128,
        n_layers=4,
        vocab=512,
        d_ff=320,
        stages=dense_stages(4),
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32, qkv_bias=True),
        act="silu",
        glu=True,
        tie_embeddings=True,
    )
