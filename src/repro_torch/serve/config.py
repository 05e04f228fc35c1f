"""One typed, validated config for the whole serving stack.

The port's copy of the JAX package's ``serve/config.py``: every serving
knob of the stack, including those the port does not run yet (the engine
refuses them by name).  :class:`ServeConfig` is the single definition:

* every field carries its CLI help string and type in ``metadata``, so
  :func:`add_serve_args` derives the ``launch/serve.py`` flags from the
  dataclass (one definition, no drift);
* ``__post_init__`` validates cross-field invariants once (page
  divisibility, shard divisibility, known multicast mode) instead of
  each consumer re-checking its slice;
* old keyword call sites (``PagedEngine(cfg, params, max_batch=8,
  num_pages=384)``) keep working through :func:`config_from_legacy`,
  which maps the legacy names and warns **once per call site** (module +
  lineno).
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Any

from repro_torch.serve.faults import Fault, FaultPlan

#: multicast delivery modes for the page-chain broadcast (the port serves
#: one shard only, so only the default is reachable).
MCAST_MODES = ("unicast", "sw_tree", "hw")

#: token-selection rules — must match ``repro_torch.serve.sampling.SAMPLERS``
#: (kept literal here so importing the config doesn't pull in torch).
SAMPLERS = ("greedy",)

_KV_DTYPES = ("bf16", "f32", "int8")


def _f(default, help_: str, *, type_=None, choices=None, cli: bool = True):
    return dataclasses.field(
        default=default,
        metadata={"help": help_, "type": type_, "choices": choices, "cli": cli},
    )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every serving knob, one place, validated at construction.

    Degenerate-case guarantee: the defaults (``num_shards=1``,
    ``mcast_mode="unicast"``) are the single-host stack — the sharded pool with one shard *is* the old pool.
    """

    # --- engine shape -------------------------------------------------
    max_slots: int = _f(4, "max concurrently decoding requests (batch rows)",
                        type_=int)
    cache_len: int = _f(256, "per-request KV capacity in tokens", type_=int)
    page_size: int = _f(16, "tokens per KV page", type_=int)
    pages: int | None = _f(None, "total pool pages incl. the null page "
                           "(default: 1 + max_slots * cache_len/page_size, "
                           "rounded up to fill whole shards)", type_=int)
    kv_dtype: str = _f("bf16", "KV page storage dtype", type_=str,
                       choices=_KV_DTYPES)
    prompt_bucket: int = _f(16, "prefill length bucket (compile granularity)",
                            type_=int)
    prefill_chunk: int | None = _f(None, "chunked prefill: tokens per "
                                   "suffix chunk (default one-shot)",
                                   type_=int)
    # --- policy -------------------------------------------------------
    watermark: int = _f(2, "free pages reserved per shard at admission",
                        type_=int)
    queue_cap: int | None = _f(None, "ServeLoop bounded queue depth "
                               "(default unbounded)", type_=int)
    # --- robustness ---------------------------------------------------
    kv_guard: bool = _f(False, "arm page fingerprints + pool audits",
                        type_=bool)
    kernel_fallback: bool = _f(False, "retry failed/non-finite kernel "
                               "dispatch on the reference backend",
                               type_=bool)
    chaos: tuple[str, ...] = _f((), "fault spec SITE[:PROB] (repeatable)",
                                type_=str)
    seed: int = _f(0, "seed for params/trace/chaos alike", type_=int)
    # --- mesh sharding ------------------------------------------------
    num_shards: int = _f(1, "page-pool shards over the mesh axis "
                         "(1 = single-host degenerate case)", type_=int)
    mesh_axis: str = _f("data", "mesh axis name the page axis shards over",
                        type_=str)
    mcast_mode: str = _f("unicast", "page-chain broadcast collective",
                         type_=str, choices=MCAST_MODES)
    pages_per_shard: int | None = _f(None, "pool pages owned by each shard "
                                     "(alternative to --pages)", type_=int)
    # --- observability ------------------------------------------------
    trace: str | None = _f(None, "write a Perfetto/Chrome trace-event "
                           "JSON here (.jsonl for a flat event log); the "
                           "analyzer report lands at PATH.report.json",
                           type_=str)
    # --- sampling + speculative decoding -------------------------------
    sampler: str = _f("greedy", "token-selection rule (serve/sampling.py)",
                      type_=str, choices=SAMPLERS)
    spec_k: int = _f(0, "speculative decoding: draft tokens verified per "
                     "decode tick (0 = off)", type_=int)
    draft_model: str | None = _f(None, "draft proposer: a registry arch "
                                 "name, 'ngram' (prompt-lookup), or 'auto' "
                                 "(the target's registered pairing)",
                                 type_=str)

    def __post_init__(self):
        if self.page_size < 1 or self.cache_len < self.page_size:
            raise ValueError(
                f"need page_size >= 1 and cache_len >= page_size: "
                f"page_size={self.page_size} cache_len={self.cache_len}")
        if self.cache_len % self.page_size:
            raise ValueError(
                f"cache_len {self.cache_len} must be a multiple of "
                f"page_size {self.page_size}")
        if self.max_slots < 1:
            raise ValueError(f"need max_slots >= 1: {self.max_slots}")
        if self.kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r} (have {_KV_DTYPES})")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"need prefill_chunk >= 1: {self.prefill_chunk}")
        if self.watermark < 0:
            raise ValueError(f"need watermark >= 0: {self.watermark}")
        if self.num_shards < 1:
            raise ValueError(f"need num_shards >= 1: {self.num_shards}")
        if self.mcast_mode not in MCAST_MODES:
            raise ValueError(
                f"unknown mcast_mode {self.mcast_mode!r} (have {MCAST_MODES})")
        if self.pages_per_shard is not None:
            if self.pages_per_shard < 1:
                raise ValueError(
                    f"need pages_per_shard >= 1: {self.pages_per_shard}")
            implied = 1 + self.num_shards * self.pages_per_shard
            if self.pages is not None and self.pages != implied:
                raise ValueError(
                    f"pages={self.pages} contradicts pages_per_shard="
                    f"{self.pages_per_shard} x num_shards={self.num_shards} "
                    f"(implies {implied})")
        elif self.pages is not None:
            if self.pages < 2:
                raise ValueError(f"need pages >= 2: {self.pages}")
            if (self.pages - 1) % self.num_shards:
                raise ValueError(
                    f"pages-1 ({self.pages - 1}) must divide evenly over "
                    f"num_shards={self.num_shards} (page 0 is the shared "
                    f"null page; every shard owns an equal range)")
        if self.sampler not in SAMPLERS:
            raise ValueError(
                f"unknown sampler {self.sampler!r} (have {SAMPLERS})")
        if self.spec_k < 0:
            raise ValueError(f"need spec_k >= 0: {self.spec_k}")
        if self.spec_k and self.draft_model is None:
            raise ValueError(
                "spec_k > 0 needs a draft: pass draft_model (a registry "
                "arch, 'ngram', or 'auto')")
        if self.draft_model is not None:
            if not self.spec_k:
                raise ValueError(
                    f"draft_model={self.draft_model!r} without spec_k > 0 "
                    f"does nothing; set spec_k")
            if self.draft_model == "auto":
                raise ValueError(
                    "draft_model='auto' must be resolved against the "
                    "target arch before ServeConfig construction "
                    "(configs.registry.draft_for — launch/serve.py does "
                    "this)")
            if self.draft_model != "ngram":
                # typed membership check at config time; the full
                # pairing validation (vocab / width / servability,
                # DraftPairingError) runs against the target config at
                # engine construction (configs.registry
                # .validate_draft_pair via serve.spec.make_draft)
                from repro_torch.configs import registry
                if self.draft_model not in registry.ARCHS:
                    raise registry.DraftPairingError(
                        f"unknown draft_model {self.draft_model!r}: not "
                        f"'ngram' and not a registry arch "
                        f"({list(registry.ARCHS)})")
        for spec in self.chaos:
            site, _, prob = spec.partition(":")
            Fault(site, prob=float(prob) if prob else 0.05)  # validates

    # -- derived -------------------------------------------------------

    @property
    def num_pages(self) -> int | None:
        """Total pool pages (incl. null page), or None for the engine's
        workload-sized default."""
        if self.pages_per_shard is not None:
            return 1 + self.num_shards * self.pages_per_shard
        return self.pages

    def fault_plan(self) -> FaultPlan | None:
        """The armed chaos plan this config describes (None when no
        ``chaos`` specs were given)."""
        if not self.chaos:
            return None
        return FaultPlan(parse_chaos(self.chaos), seed=self.seed)


def parse_chaos(specs) -> list[Fault]:
    """``SITE[:PROB]`` CLI specs -> :class:`Fault` entries (``PROB``
    defaults to probabilistic firing at 0.05; deterministic ``at=``
    plans stay a test-suite tool)."""
    out = []
    for spec in specs:
        site, _, prob = spec.partition(":")
        out.append(Fault(site, prob=float(prob) if prob else 0.05))
    return out


# -- legacy keyword migration ------------------------------------------

#: PagedEngine legacy keyword -> ServeConfig field
_LEGACY_MAP = {
    "max_batch": "max_slots",
    "num_pages": "pages",
    "cache_len": "cache_len",
    "page_size": "page_size",
    "kv_dtype": "kv_dtype",
    "watermark": "watermark",
    "prompt_bucket": "prompt_bucket",
    "prefill_chunk": "prefill_chunk",
    "kv_guard": "kv_guard",
    "kernel_fallback": "kernel_fallback",
}

#: (filename, lineno) call sites already warned.  Keyed per site — not
#: once per process — so a long-lived test session (or a notebook) that
#: grows a *new* legacy call site still hears about it, while a loop
#: hammering one site warns once.
_LEGACY_WARNED: set[tuple[str, int]] = set()


def config_from_legacy(legacy: dict[str, Any], *, _depth: int = 2) -> ServeConfig:
    """Map the legacy ``PagedEngine`` keywords onto a :class:`ServeConfig`.

    Warns once per *call site* (module + lineno, ``_depth`` frames up —
    the default skips this function and ``PagedEngine.__init__``) so
    existing call sites keep working while new code writes
    ``PagedEngine(cfg, params, config=ServeConfig(...))``."""
    unknown = sorted(set(legacy) - set(_LEGACY_MAP))
    if unknown:
        raise TypeError(f"PagedEngine: unknown keyword(s) {unknown}; "
                        f"known legacy keywords: {sorted(_LEGACY_MAP)}")
    if legacy:
        frame = sys._getframe(_depth)
        site = (frame.f_code.co_filename, frame.f_lineno)
        if site not in _LEGACY_WARNED:
            _LEGACY_WARNED.add(site)
            warnings.warn(
                "PagedEngine(**kwargs) keywords are deprecated; pass "
                "config=ServeConfig(...) (serve/config.py). Legacy names map "
                "as max_batch->max_slots, num_pages->pages.",
                DeprecationWarning, stacklevel=_depth + 1)
    return ServeConfig(**{_LEGACY_MAP[k]: v for k, v in legacy.items()})


# -- argparse derivation -----------------------------------------------

def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def add_serve_args(parser, skip=()) -> None:
    """Add one CLI flag per :class:`ServeConfig` field to ``parser``.

    Flags default to *unset* (None / False / empty) so
    :func:`from_args` can distinguish "user asked" from "dataclass
    default" — the dataclass default is the single source of truth."""
    for f in dataclasses.fields(ServeConfig):
        if f.name in skip or not f.metadata.get("cli", True):
            continue
        help_ = f"{f.metadata['help']} (default: {f.default!r})"
        if f.name == "chaos":
            parser.add_argument(_flag(f.name), action="append", default=[],
                                metavar="SITE[:PROB]", help=help_)
        elif f.metadata["type"] is bool:
            parser.add_argument(_flag(f.name), action="store_true",
                                help=help_)
        else:
            parser.add_argument(_flag(f.name), type=f.metadata["type"],
                                default=None, choices=f.metadata["choices"],
                                help=help_)


def from_args(args, **overrides) -> ServeConfig:
    """Build a :class:`ServeConfig` from parsed argparse flags.

    Unset flags (None; False for store_true) fall through to the
    dataclass defaults; ``overrides`` win over both (the launcher uses
    this for the ``--max-slots``/``--max-batch`` interplay)."""
    kw: dict[str, Any] = {}
    for f in dataclasses.fields(ServeConfig):
        if not f.metadata.get("cli", True):
            continue
        v = getattr(args, f.name, None)
        if f.name == "chaos":
            if v:
                kw[f.name] = tuple(v)
        elif f.metadata["type"] is bool:
            if v:
                kw[f.name] = True
        elif v is not None:
            kw[f.name] = v
    kw.update({k: v for k, v in overrides.items() if v is not None})
    return ServeConfig(**kw)
