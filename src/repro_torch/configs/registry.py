"""Architecture registry of the port: ``get_config(arch_id)`` -> ModelConfig.

The registry holds the JAX package's eleven architectures, in its order:
the dense decoders qwen1.5-0.5b, qwen1.5-1.8b, deepseek-7b, command-r-35b
(layernorm) and gemma2-9b (alternating local / global attention,
softcaps, post-block norms), the vision-language pixtral-12b (projected
patch embeddings prepended to the text), the audio model whisper-medium
(``models/encdec.py``; through ``models/lm.py`` as the launcher serves it,
with learned positions), the mixture-of-experts moonshot-v1-16b-a3b and
llama4-maverick-400b-a17b, the SSD model mamba2-780m and the RG-LRU /
local-attention hybrid recurrentgemma-2b.  Paged serving refuses MoE,
recurrent mixers and local windows (gemma2, the MoE and recurrent archs
take the dense ``Server`` only), as in the JAX package.

Also the draft-pairing API of speculative decoding, as in the JAX
package: a config module may export ``DRAFT = "<arch>"`` naming the
small same-tokenizer family member that proposes tokens for it.
:func:`draft_for` reads that metadata; :func:`validate_draft_pair`
checks that the pair is compatible (identical vocab, a draft trunk no
wider than the target's, a draft the paged stack can run) and raises
the typed :class:`DraftPairingError` otherwise.
"""
from __future__ import annotations

import importlib

ARCHS: tuple[str, ...] = (
    "recurrentgemma-2b",
    "deepseek-7b",
    "qwen1.5-0.5b",
    "qwen1.5-1.8b",
    "command-r-35b",
    "gemma2-9b",
    "whisper-medium",
    "llama4-maverick-400b-a17b",
    "moonshot-v1-16b-a3b",
    "mamba2-780m",
    "pixtral-12b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


class DraftPairingError(ValueError):
    """A (target, draft) speculative-decoding pair failed validation."""


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, *, reduced: bool = False):
    """Load an architecture config; ``reduced=True`` returns the small
    same-family config used by the CPU tests."""
    mod = _module(arch)
    return mod.reduced_config() if reduced else mod.config()


def draft_for(arch: str) -> str | None:
    """The registered draft architecture for ``arch`` (the config
    module's ``DRAFT`` metadata), or None when the registry pairs no
    draft with it."""
    return getattr(_module(arch), "DRAFT", None)


def _as_config(arch_or_cfg, *, reduced: bool):
    if isinstance(arch_or_cfg, str):
        return get_config(arch_or_cfg, reduced=reduced)
    return arch_or_cfg


def validate_draft_pair(target, draft, *, reduced: bool = False):
    """Check ``draft`` can propose tokens for ``target``.

    Both may be arch names (resolved through the registry, honouring
    ``reduced``) or ``ModelConfig``s.  Returns ``(target_cfg,
    draft_cfg)``; raises :class:`DraftPairingError` with the first
    violated constraint: identical vocab (proposals are token ids), a
    draft ``d_model`` no wider than the target's, and a draft the paged
    stack can serve (attention-only, global windows, non-MoE)."""
    tcfg = _as_config(target, reduced=reduced)
    dcfg = _as_config(draft, reduced=reduced)
    if tcfg.vocab != dcfg.vocab:
        raise DraftPairingError(
            f"draft {dcfg.name!r} (vocab {dcfg.vocab}) is not "
            f"tokenizer-compatible with target {tcfg.name!r} (vocab "
            f"{tcfg.vocab}): speculative proposals are token ids")
    if dcfg.d_model > tcfg.d_model:
        raise DraftPairingError(
            f"draft {dcfg.name!r} (d_model {dcfg.d_model}) is wider than "
            f"target {tcfg.name!r} (d_model {tcfg.d_model}); pick a "
            f"smaller draft")
    for i, bd in enumerate(dcfg.layer_defs):
        if bd.mixer != "attn" or bd.window is not None or bd.ff == "moe":
            raise DraftPairingError(
                f"draft {dcfg.name!r} layer {i} ({bd.mixer}, "
                f"window={bd.window}, ff={bd.ff}) is not servable by the "
                f"paged stack (needs attention-only, global-window, "
                f"non-MoE blocks)")
    return tcfg, dcfg
