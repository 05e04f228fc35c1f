"""The kernel layer's entry points: a ``KernelOp`` registry with
schedule dispatch, ``linear`` and ``op(name)``.

The port of the JAX package's ``kernels/api.py`` for the two families
the serving paths run.  Every family registers its schedules as
:class:`Schedule` entries; dispatch picks one the way the JAX package
does — from the problem's shape and dtype under a policy — so a policy
string written for the JAX launcher means the same here::

    matmul           tiled (K1) | mcast (K4) | unicast (K5)
    paged_attention  pallas (K2 decode) | pallas_prefill (K3)

In the port the backend name ``pallas`` means "the hand-written
kernels", and every schedule is one.  Dispatch resolves, in order: the
``policy=`` of :func:`linear` / :func:`resolve`, the global policy
(:func:`set_policy` / :func:`use_policy`), the ``REPRO_KERNEL_POLICY``
environment variable, then the default — the JAX package's default on a
TPU: backend ``pallas``, cheapest available schedule by the cost model
of :mod:`repro_torch.kernels.autotune`.  Ties go to the first schedule
listed, which is why ``tiled`` comes before ``mcast`` and ``unicast``:
their costs tie exactly for M <= 2048.  A pick is memoised on (family,
problem, effective policy): the JAX package resolves once per trace,
and the port, which has no trace, once per distinct key rather than
once per launch.

Every schedule launches its CUDA kernel for CUDA tensors and runs the
kernel's plain PyTorch version for CPU tensors.  The ``reference``
backend (the JAX package's pure-XLA oracle) is not ported: forcing it
raises ``NotImplementedError``.

* :func:`linear` — ``act(x @ w + bias)`` for every projection.  K1
  fuses bias and activation into its epilogue; K4 and K5 return the bare
  product in ``x.dtype`` and the epilogue runs after them, unfused, in
  fp32 — the JAX package's ``_mm_flat``, whose double rounding makes
  ``mcast``/``unicast`` streams differ from ``tiled`` ones.
* :func:`op` — ``op("paged_attention")(q, k_pages, v_pages, table, start,
  lengths, *scales, softcap=...)``, ``op("matmul")(a, b[, bias], ...)``.
* :func:`resolve` — which schedule a call would pick; runs nothing.
  (The JAX package's resolve also reports an autotuned block config;
  the CUDA kernels' tiles are fixed, so the port reports none.)
* :func:`launch_counts` / :func:`reset_launch_counts` — one launch
  counter per kernel; the plain CPU path never moves them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.matmul.matmul import (
    ACTIVATIONS,
    matmul_mcast,
    matmul_tiled,
    matmul_unicast,
)
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)

__all__ = ["ACTIVATIONS", "BACKENDS", "DispatchPolicy", "KERNELS", "KernelOp",
           "POLICY_ENV_VAR", "Problem", "Resolution", "Schedule", "as_policy",
           "get_policy", "launch_counts", "linear", "op", "reset_launch_counts",
           "resolve", "set_policy", "use_policy"]

POLICY_ENV_VAR = "REPRO_KERNEL_POLICY"
BACKENDS = ("pallas", "reference")

#: the port's kernel wrappers, by kernel name (each carries ``.launches``)
KERNELS = {
    "matmul_tiled": matmul_tiled,
    "matmul_mcast": matmul_mcast,
    "matmul_unicast": matmul_unicast,
    "paged_attention_decode": paged_attention_decode,
    "paged_attention_prefill": paged_attention_prefill,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# dispatch policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    """How a kernel call resolves its schedule.

    ``schedule``  force a schedule by registry name (e.g. ``"mcast"``).
    ``backend``   force a backend — the cheapest available schedule of
                  that backend is picked.

    The JAX syntax's ``autotune=`` field is accepted and dropped: the
    CUDA kernels' tiles are compile-time constants, so it picks nothing.
    """

    schedule: str | None = None
    backend: str | None = None

    def __post_init__(self):
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend: {self.backend!r} (have {BACKENDS})")

    @classmethod
    def parse(cls, text: str) -> "DispatchPolicy":
        """Parse ``"tiled"`` / ``"reference"`` shorthands or the full
        ``"schedule=tiled,backend=pallas,autotune=off"`` form (the
        ``REPRO_KERNEL_POLICY`` syntax)."""
        text = text.strip()
        if not text:
            return cls()
        if "=" not in text:
            if text in BACKENDS:
                return cls(backend=text)
            return cls(schedule=text)
        kw: dict[str, Any] = {}
        for item in text.split(","):
            key, _, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if key == "autotune":
                continue
            if key in ("schedule", "backend"):
                kw[key] = val or None
            else:
                raise ValueError(f"unknown policy field: {key!r} in {text!r}")
        return cls(**kw)


@functools.lru_cache(maxsize=64)
def _parse(text: str) -> DispatchPolicy:
    return DispatchPolicy.parse(text)


def as_policy(policy: DispatchPolicy | str | None) -> DispatchPolicy | None:
    if policy is None or isinstance(policy, DispatchPolicy):
        return policy
    return _parse(policy)


_GLOBAL_POLICY: DispatchPolicy | None = None


def set_policy(policy: DispatchPolicy | str | None) -> None:
    """Set the process-wide dispatch policy (None restores the default)."""
    global _GLOBAL_POLICY
    _GLOBAL_POLICY = as_policy(policy)


def get_policy() -> DispatchPolicy:
    """Effective global policy: ``set_policy`` > env var > default."""
    if _GLOBAL_POLICY is not None:
        return _GLOBAL_POLICY
    env = os.environ.get(POLICY_ENV_VAR)
    if env:
        return _parse(env)
    return DispatchPolicy()


@contextlib.contextmanager
def use_policy(policy: DispatchPolicy | str | None):
    """Context manager form of :func:`set_policy`."""
    global _GLOBAL_POLICY
    prev = _GLOBAL_POLICY
    _GLOBAL_POLICY = as_policy(policy)
    try:
        yield
    finally:
        _GLOBAL_POLICY = prev


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static description of one kernel invocation."""

    shape: tuple[int, ...]
    dtype: str  # the JAX package's dtype name, e.g. "bfloat16"


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One way to run a kernel family: ``fn(*tensors, **opts)``."""

    name: str
    fn: Callable[..., torch.Tensor]
    cost: Callable[[Problem], float]  # lower wins
    available: Callable[[Problem], bool] = lambda p: True


def _no_reference(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the reference backend is not ported (ROADMAP Queue 1 item 2, "
        f"with kernel_fallback, which retries on it)")


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """A kernel family: its schedules plus the shape/option plumbing."""

    name: str
    schedules: tuple[Schedule, ...]
    problem: Callable[..., tuple[int, ...]]  # (*tensors) -> shape key
    opt_defaults: tuple[tuple[str, Any], ...] = ()

    def schedule(self, name: str) -> Schedule:
        for s in self.schedules:
            if s.name == name:
                return s
        raise ValueError(
            f"kernel op {self.name!r} has no schedule {name!r} "
            f"(have {[s.name for s in self.schedules]})")

    def resolve(self, problem: Problem, policy: DispatchPolicy | str | None = None) -> Schedule:
        """Pick the schedule for a problem under a policy (memoised)."""
        return _pick(self.name, problem, as_policy(policy) or get_policy())

    def pick(self, problem: Problem, pol: DispatchPolicy) -> Schedule:
        """:meth:`resolve` without the memo."""
        if pol.backend == "reference" or pol.schedule == "reference":
            raise _no_reference(f"kernel op {self.name!r}")
        if pol.schedule is not None:
            return self.schedule(pol.schedule)
        avail = [s for s in self.schedules if s.available(problem)]
        if pol.backend is not None:
            # a forced backend is honoured even when every availability
            # predicate fails (they are conservative models)
            avail = avail or list(self.schedules)
        elif not avail:  # the JAX package falls back to its reference backend
            raise _no_reference(f"kernel op {self.name!r} at {problem}")
        return min(avail, key=lambda s: s.cost(problem))  # ties: the first listed

    def __call__(self, *tensors: torch.Tensor, **opts) -> torch.Tensor:
        full = dict(self.opt_defaults)
        for key, val in opts.items():
            if key not in full:
                raise TypeError(f"{self.name}() got unexpected option {key!r}")
            full[key] = val
        problem = Problem(tuple(self.problem(*tensors)), autotune.dtype_name(tensors[0].dtype))
        return self.resolve(problem).fn(*tensors, **full)


_REGISTRY: dict[str, KernelOp] = {}


def register(kernel_op: KernelOp) -> KernelOp:
    _REGISTRY[kernel_op.name] = kernel_op
    _pick.cache_clear()
    return kernel_op


@functools.lru_cache(maxsize=4096)
def _pick(name: str, problem: Problem, pol: DispatchPolicy) -> Schedule:
    return _REGISTRY[name].pick(problem, pol)


def op(name: str) -> KernelOp:
    """Look up a kernel family: ``op("paged_attention")(...)``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown kernel op: {name!r} (have {sorted(_REGISTRY)})") from None


class Resolution(NamedTuple):
    """What :func:`resolve` reports: the picked schedule and its backend
    (always ``pallas``, the hand-written kernels)."""

    schedule: str
    backend: str


def resolve(name: str, shape: Sequence[int], dtype,
            policy: DispatchPolicy | str | None = None) -> Resolution:
    """Which (schedule, backend) a call would dispatch to; runs nothing."""
    sched = op(name).resolve(
        Problem(tuple(int(s) for s in shape), autotune.dtype_name(dtype)), policy)
    return Resolution(sched.name, "pallas")


def _fits(kernel: str, schedule: str = "default") -> Callable[[Problem], bool]:
    """Availability: some block candidate stays inside the budget."""

    def ok(p: Problem) -> bool:
        cands = autotune.candidates(kernel, p.shape, p.dtype, schedule=schedule)
        return min(c.vmem_bytes for c in cands) <= autotune.VMEM_BUDGET

    return ok


def _model_cost(kernel: str, schedule: str = "default") -> Callable[[Problem], float]:
    """Cost hook: the best candidate's modeled cost."""

    def cost(p: Problem) -> float:
        return autotune.candidates(kernel, p.shape, p.dtype, schedule=schedule)[0].cost

    return cost


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------


def _mm_tiled(a, b, bias=None, *, activation, out_dtype):
    return matmul_tiled(a, b, bias, activation=activation, out_dtype=out_dtype or a.dtype)


def _flat_epilogue(y, bias, activation, out_dtype):
    """K4 and K5 do not fuse the epilogue: bias + activation run after
    the kernel in fp32, then the cast to ``out_dtype`` (JAX ``_mm_flat``)."""
    if bias is not None or activation != "none":
        y = y.float()
        if bias is not None:
            y = y + bias.float()
        y = ACTIVATIONS[activation](y)
    return y.to(out_dtype)


def _mm_mcast(a, b, bias=None, *, activation, out_dtype):
    return _flat_epilogue(matmul_mcast(a, b), bias, activation, out_dtype or a.dtype)


def _mm_unicast(a, b, bias=None, *, activation, out_dtype):
    return _flat_epilogue(matmul_unicast(a, b), bias, activation, out_dtype or a.dtype)


register(KernelOp(
    name="matmul",
    problem=lambda a, b, *rest: (a.shape[0], a.shape[1], b.shape[1]),
    opt_defaults=(("activation", "none"), ("out_dtype", None)),
    # ties go to the first: tiled, mcast, unicast (the JAX package's order)
    schedules=(
        Schedule("tiled", _mm_tiled, _model_cost("matmul", "tiled")),
        Schedule("mcast", _mm_mcast, _model_cost("matmul", "mcast"),
                 available=_fits("matmul", "mcast")),
        Schedule("unicast", _mm_unicast, _model_cost("matmul", "unicast")),
    ),
))


def linear(x: torch.Tensor, w: torch.Tensor, *, bias: torch.Tensor | None = None,
           activation: str | None = None, out_dtype: torch.dtype | None = None,
           contract_dims: int = 1,
           policy: DispatchPolicy | str | None = None) -> torch.Tensor:
    """``act(x @ w + bias)`` through the dispatched matmul schedule:
    ``x`` (..., *k_dims), ``w`` (*k_dims, *out_dims) with
    ``contract_dims`` leading axes contracted; ``bias`` broadcasts over
    ``out_dims``.  Dispatch resolves on the flattened (M, K, N) problem
    and ``x.dtype``; ``out_dtype`` defaults to ``x.dtype``."""
    k_dims, out_dims = w.shape[:contract_dims], w.shape[contract_dims:]
    if tuple(x.shape[x.ndim - contract_dims:]) != tuple(k_dims):
        raise ValueError(f"linear: x {tuple(x.shape)} does not contract with w "
                         f"{tuple(w.shape)} over {contract_dims} dims")
    lead = x.shape[: x.ndim - contract_dims]
    m, k, n = math.prod(lead), math.prod(k_dims), math.prod(out_dims)
    sched = op("matmul").resolve(Problem((m, k, n), autotune.dtype_name(x.dtype)), policy)
    y = sched.fn(x.reshape(m, k), w.reshape(k, n), None if bias is None else bias.reshape(n),
                 activation=activation or "none", out_dtype=out_dtype)
    return y.reshape(*lead, *out_dims)


# ---------------------------------------------------------------------------
# paged attention family
# ---------------------------------------------------------------------------


def _paged_decode(q, k_pages, v_pages, block_table, start, lengths, *scales, softcap):
    if q.shape[1] != 1 or scales:
        # only a by-name forced policy lands here: availability routes
        # multi-token and int8 problems to the prefill schedule
        raise ValueError(
            "paged_attention: schedule 'pallas' is the single-token bf16/fp32 decode "
            "kernel; multi-token and int8 calls run the 'pallas_prefill' schedule "
            "(backend='pallas' picks it automatically)")
    return paged_attention_decode(q[:, 0], k_pages, v_pages, block_table, start, lengths,
                                  softcap=softcap)[:, None]


def _paged_prefill(q, k_pages, v_pages, block_table, start, lengths, *scales, softcap):
    k_scale, v_scale = scales if scales else (None, None)
    return paged_attention_prefill(q, k_pages, v_pages, block_table, start, lengths,
                                   k_scale=k_scale, v_scale=v_scale, softcap=softcap)


_paged_fits = _fits("paged_attention")

register(KernelOp(
    name="paged_attention",
    # q (b, s, h, d); pages (kvh, P, ps, d); table (b, pages_per_seq);
    # trailing: the number of scale arrays (int8 pools pass two)
    problem=lambda q, kp, vp, bt, st, ln, *scales: (
        q.shape[0], q.shape[1], q.shape[2], kp.shape[0],
        bt.shape[1], kp.shape[2], q.shape[3], len(scales),
    ),
    opt_defaults=(("softcap", None),),
    schedules=(
        Schedule("pallas", _paged_decode, _model_cost("paged_attention"),
                 available=lambda p: p.shape[1] == 1 and p.shape[-1] == 0 and _paged_fits(p)),
        Schedule("pallas_prefill", _paged_prefill,
                 _model_cost("paged_attention", "prefill"),
                 available=_fits("paged_attention", "prefill")),
    ),
))
