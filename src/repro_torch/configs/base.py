"""Architecture configuration schema.

A model is a sequence of *stages*; each stage is a (super-block pattern,
repeat count) pair.  The port runs every repeat as its own layer in a
Python loop over per-layer parameters.  A
super-block is a tuple of ``BlockDef``s (e.g. gemma-2 alternates
local/global attention -> pattern of length 2; recurrentgemma repeats
(rglru, rglru, local-attn) triples).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "rglru", "ssd"]
Ff = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class BlockDef:
    mixer: Mixer = "attn"
    window: int | None = None  # local-attention window (None = global)
    ff: Ff = "mlp"


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    out_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    logit_softcap: float | None = None
    learned_pos: bool = False  # whisper-style absolute positions


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0  # shared-expert ffn width = n * d_ff_expert
    capacity_factor: float = 1.25
    router_softcap: float | None = None
    # routing-group size (tokens): dispatch-einsum flops scale with
    # (k*group)^2 / E, so small groups are the perf lever (§Perf iter 3);
    # capacity is enforced per group (finer-grained dropping).
    group_size: int = 512


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RglruConfig:
    d_rnn: int = 0  # 0 -> d_model
    conv_width: int = 4
    c: float = 8.0  # Griffin's fixed recurrence-sharpness constant


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper)."""

    n_layers: int
    n_frames: int = 1500  # precomputed frame embeddings (conv stub output)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_layers: int
    vocab: int
    d_ff: int
    stages: tuple[tuple[tuple[BlockDef, ...], int], ...]
    attn: AttnConfig | None = None
    moe: MoeConfig | None = None
    ssm: SsmConfig | None = None
    rglru: RglruConfig | None = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"
    glu: bool = True  # gated (SwiGLU/GeGLU) vs plain MLP
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    final_softcap: float | None = None
    post_block_norm: bool = False  # gemma-2 post-norms
    max_position: int = 0  # learned-pos table size (0 = rope-only)
    encoder: EncoderConfig | None = None
    frontend: str | None = None  # audio | vision (stub, precomputed embeds)
    frontend_dim: int = 0
    supports_long_context: bool = False  # may run the long_500k shape
    has_decoder: bool = True  # encoder-only models skip decode shapes
    # reference provenance: "[source; verified-tier]" from the assignment
    source: str = ""

    def __post_init__(self):
        total = sum(len(p) * r for p, r in self.stages)
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: stages cover {total} layers, expected {self.n_layers}"
            )

    # -- derived -----------------------------------------------------------
    @property
    def layer_defs(self) -> list[BlockDef]:
        out: list[BlockDef] = []
        for pattern, repeats in self.stages:
            out.extend(list(pattern) * repeats)
        return out

    def params_count(self) -> int:
        """Total parameter count (exact, from the spec tree)."""
        from repro_torch.models import lm  # local import to avoid cycles

        from repro_torch.nn.spec import tree_params

        return tree_params(lm.model_spec(self))

    def active_params_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        from repro_torch.models import lm

        from repro_torch.nn.spec import tree_params

        total = tree_params(lm.model_spec(self))
        if self.moe is None:
            return total
        # subtract the non-active expert fraction of the expert weights
        moe_layers = sum(1 for b in self.layer_defs if b.ff == "moe")
        glu_mult = 3 if self.glu else 2
        expert_params = (
            moe_layers * self.moe.n_experts * glu_mult
            * self.d_model * self.moe.d_ff_expert
        )
        active_frac = self.moe.top_k / self.moe.n_experts
        return int(total - expert_params * (1 - active_frac))


def dense_stages(n_layers: int, ff: Ff = "mlp") -> tuple:
    return (((BlockDef(mixer="attn", ff=ff),), n_layers),)
