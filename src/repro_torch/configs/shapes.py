"""Assigned input shapes and per-(arch x shape) input specs: the port of
the JAX package's ``configs/shapes.py``.

Four shapes per architecture:

* ``train_4k``     seq 4096,   global batch 256  -> the train step
* ``prefill_32k``  seq 32768,  global batch 32   -> the prefill step
* ``decode_32k``   KV len 32768, global batch 128 -> the decode step
* ``long_500k``    KV len 524288, global batch 1  -> the decode step,
  sub-quadratic archs only (ssm / hybrid): recurrentgemma-2b, mamba2-780m.

:func:`input_specs` returns tensors on the ``meta`` device (shape and
dtype, no allocation) where the JAX package returns ``ShapeDtypeStruct``
stand-ins; decode caches are the port's own caches built on ``meta``
(``lm.init_cache``, ``encdec.cache_spec``), one entry per layer.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

VISION_PATCHES = 1024  # pixtral: image patches prepended to the text


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}


def shape_of(shape: str | ShapeCfg) -> ShapeCfg:
    """A shape by name from :data:`SHAPES`, or a :class:`ShapeCfg` as
    given (the launcher's own batch and sequence; the JAX launcher adds
    it to ``SHAPES`` as ``"custom"`` instead)."""
    return shape if isinstance(shape, ShapeCfg) else SHAPES[shape]


def applicable(cfg: ModelConfig, shape_name: str | ShapeCfg) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable?  Returns (ok, reason)."""
    shape = shape_of(shape_name)
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 500k dense KV decode is the quadratic case the assignment skips"
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""


def _meta(*shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(b, s):
    return _meta(b, s, dtype=torch.int32)


def input_specs(cfg: ModelConfig, shape_name: str | ShapeCfg) -> dict:
    """``meta`` tensors for the step inputs of this cell.

    Keys match the step builders' signatures in ``repro_torch.dist.step``:
    train:   tokens, labels [, frontend_embeds | frames]
    prefill: tokens [, frontend_embeds | frames]
    decode:  cache, tokens, index
    """
    from repro_torch.models import encdec, lm  # local import to avoid cycles

    shape = shape_of(shape_name)
    ok, reason = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name} skipped: {reason}")
    b, s = shape.global_batch, shape.seq_len
    index = _meta(dtype=torch.int32)

    if cfg.family == "audio":  # enc-dec: frames + decoder tokens
        frames = _meta(b, cfg.encoder.n_frames, cfg.frontend_dim)
        if shape.kind == "train":
            return {"tokens": _tok(b, s), "labels": _tok(b, s), "frames": frames}
        if shape.kind == "prefill":
            return {"tokens": _tok(b, s), "frames": frames}
        return {"cache": encdec.cache_spec(cfg, b, s), "tokens": _tok(b, 1), "index": index}

    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        emb = _meta(b, VISION_PATCHES, cfg.frontend_dim)
        text = _tok(b, s - VISION_PATCHES)
        if shape.kind == "train":
            return {"tokens": text, "labels": _tok(b, s), "frontend_embeds": emb}
        return {"tokens": text, "frontend_embeds": emb}

    if shape.kind == "train":
        return {"tokens": _tok(b, s), "labels": _tok(b, s)}
    if shape.kind == "prefill":
        return {"tokens": _tok(b, s)}
    return {"cache": lm.init_cache(cfg, b, s, device="meta"), "tokens": _tok(b, 1),
            "index": index}


def cells(cfg: ModelConfig) -> list[str]:
    """The applicable shape names for an arch."""
    return [n for n in SHAPES if applicable(cfg, n)[0]]
