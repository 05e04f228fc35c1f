"""The kernel layer's entry points: a ``KernelOp`` registry with
schedule dispatch, ``linear`` and ``op(name)``, differentiable both ways.

The port of the JAX package's ``kernels/api.py`` for the families the
port runs.  Every family registers its schedules as :class:`Schedule`
entries; dispatch picks one the way the JAX package does — from the
problem's shape and dtype under a policy — so a policy string written
for the JAX launcher means the same here::

    matmul           tiled (K1) | mcast (K4) | unicast (K5)     vjp
    flash_attention  pallas (K6; backward K7 + K8)               vjp
    paged_attention  pallas (K2 decode) | pallas_prefill (K3)    no vjp
    ssd              pallas (K9; backward K10)                   vjp
    rglru            pallas (K11; backward K12)                  vjp

In the port the backend name ``pallas`` means "the hand-written
kernels".  Every family also registers the JAX package's ``reference``
schedule: its ``ref.py`` oracle in plain PyTorch (``torch.matmul`` and
tensor ops, as JAX's use ``jnp.dot``).  Dispatch resolves, in order: the
``policy=`` of :func:`linear` / :func:`resolve`, the global policy
(:func:`set_policy` / :func:`use_policy`), the ``REPRO_KERNEL_POLICY``
environment variable, then the default — the JAX package's default on a
TPU: backend ``pallas``, cheapest available schedule by the cost model
of :mod:`repro_torch.kernels.autotune`, and the ``reference`` schedule
only where no kernel schedule is available (paged attention under
differentiation).  ``backend=reference``, ``reference`` and
``schedule=reference`` force the oracle.  Ties go to the first schedule
listed, which is why ``tiled`` comes before ``mcast`` and ``unicast``:
their costs tie exactly for M <= 2048.  A pick is memoised on (family,
problem, effective policy, differentiated): the JAX package resolves
once per trace, and the port, which has no trace, once per distinct key
rather than once per launch.

Every kernel schedule launches its CUDA kernel for CUDA tensors and runs
the kernel's plain PyTorch version for CPU tensors.  The reference
schedules run on either device and never on the main path by default:
only a policy that forces them, or an armed fallback's retry
(:func:`call_with_fallback`), reaches them.

**Gradients.**  A call is differentiated when ``torch.is_grad_enabled()``
and one of its inputs ``requires_grad``.  Such a call runs a vjp-capable
schedule through a ``torch.autograd.Function`` whose backward is kernels
too, as the JAX package's custom VJPs are: the matmul backward re-enters
:func:`linear` for the pre-activation ``z`` (only with an activation),
``dA = dz @ B^T`` and ``dB = A^T @ dz`` (strided views, no transposed
copy); the flash backward runs K7 and K8 from the forward's saved
log-sum-exp; the SSD backward runs K10 from the chunk-initial states K9
checkpointed, and the RG-LRU backward K12 from K11's output.  Under
differentiation auto-dispatch skips schedules without a VJP, and forcing
one raises the JAX package's ``ValueError``; a reference schedule is
differentiated natively, by autograd through its tensor ops.
Only the matmul backward dispatches again (the others are each one fixed
kernel), and a forward whose schedule was forced does not force it: the
backward resolves under ``backend=pallas`` (the cheapest kernel for its
own shapes), as JAX's ``_bwd_policy_token`` does.

* :func:`linear` — ``act(x @ w + bias)`` for every projection.  K1
  fuses bias and activation into its epilogue; K4 and K5 return the bare
  product in ``x.dtype`` and the epilogue runs after them, unfused, in
  fp32 — the JAX package's ``_mm_flat``, whose double rounding makes
  ``mcast``/``unicast`` streams differ from ``tiled`` ones.
* :func:`grouped_linear` — one independent ``act(x_g @ w_g)`` per group
  (the MoE expert matmuls): the picked schedule's kernel launched once
  over every group, the group in its grid, as the JAX package's ``vmap``
  of ``linear`` lifts the expert axis into the ``pallas_call``'s grid;
  its backward (z, dA, dB) is grouped launches too.
* :func:`op` — ``op("flash_attention")(q, k, v, causal=..., window=...,
  softcap=...)``, ``op("paged_attention")(q, k_pages, v_pages, table,
  start, lengths, *scales, softcap=...)``, ``op("matmul")(a, b[, bias],
  ...)``, ``op("ssd")(xdt, b, c, log_a)`` -> y fp32, ``op("rglru")(a, b)``
  -> h fp32.
* :func:`resolve` — which schedule a call would pick (``needs_vjp=True``:
  a differentiated call); runs nothing.  (The JAX package's resolve also
  reports an autotuned block config; the CUDA kernels' tiles are fixed,
  so the port reports none.)
* :func:`launch_counts` / :func:`reset_launch_counts` — one launch
  counter per kernel; the plain CPU path never moves them.
* dispatch records — with a recorder armed (:mod:`repro_torch.obs.trace`)
  every dispatched call records one ``dispatch.<op>`` span (schedule,
  backend, shape, dtype, and the design and tile of the kernel that ran;
  :func:`_record_dispatch`); unarmed, the cost is one ``trace.active()``
  check.
* :func:`call_with_fallback` — run a kernel call, and on an exception (or
  a failed output check, :func:`all_finite`) retry it once on the
  reference backend, counted in the process-wide :class:`FallbackStats`
  (:func:`fallback_stats` / :func:`reset_fallback_stats`).
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
from repro_torch.kernels._build import KernelUnavailable
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.matmul.matmul import (
    ACTIVATIONS,
    design_tiles,
    matmul_mcast,
    matmul_tiled,
    matmul_unicast,
)
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.kernels.rglru.rglru import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.ssd.ref import ssd_scan_ref
from repro_torch.kernels.ssd.ssd import SSD_CHUNK, ssd_lcum, ssd_scan, ssd_scan_bwd
from repro_torch.obs import trace

__all__ = ["ACTIVATIONS", "BACKENDS", "DispatchPolicy", "FallbackStats", "KERNELS",
           "KernelOp", "POLICY_ENV_VAR", "Problem", "Resolution", "Schedule", "all_finite",
           "as_policy", "call_with_fallback", "fallback_stats", "get_policy", "grouped_linear",
           "launch_counts", "linear", "op", "reset_fallback_stats", "reset_launch_counts",
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
    "flash_attention": flash_attention,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "ssd_scan": ssd_scan,
    "ssd_scan_bwd": ssd_scan_bwd,
    "rglru_scan": rglru_scan,
    "rglru_scan_bwd": rglru_scan_bwd,
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


def _needs_vjp(*tensors) -> bool:
    """True when the call is being differentiated: autograd is recording
    and some input requires a gradient (the port's counterpart of the JAX
    package's JVP-tracer test)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


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
    """One way to run a kernel family: ``fn(*tensors, **opts)``.

    ``backend``: ``pallas`` (a hand-written kernel) or ``reference`` (the
    plain-PyTorch oracle).  ``cost`` None: a last resort.  ``vjp``: the
    schedule can be differentiated — a kernel schedule through its
    family's autograd function (its backward is kernels too), a reference
    schedule natively.  Under differentiation, dispatch skips schedules
    without one and refuses to force them.  ``kernel``: the wrapper of
    :data:`KERNELS` that a kernel schedule launches forward (its dispatch
    record reads the launch's design from it)."""

    name: str
    fn: Callable[..., torch.Tensor]
    cost: Callable[[Problem], float] | None  # lower wins
    available: Callable[[Problem], bool] = lambda p: True
    vjp: bool = False
    backend: str = "pallas"
    kernel: str | None = None


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

    def resolve(self, problem: Problem, policy: DispatchPolicy | str | None = None, *,
                needs_vjp: bool = False) -> Schedule:
        """Pick the schedule for a problem under a policy (memoised);
        ``needs_vjp`` marks a differentiated call."""
        return _pick(self.name, problem, as_policy(policy) or get_policy(), needs_vjp)

    def pick(self, problem: Problem, pol: DispatchPolicy, needs_vjp: bool = False) -> Schedule:
        """:meth:`resolve` without the memo."""
        if pol.schedule is not None:
            sched = self.schedule(pol.schedule)
            if pol.backend is not None and sched.backend != pol.backend:
                raise ValueError(
                    f"policy forces schedule {pol.schedule!r} (backend "
                    f"{sched.backend}) but also backend {pol.backend!r}")
            if needs_vjp and not sched.vjp:
                raise ValueError(
                    f"kernel op {self.name!r}: schedule {sched.name!r} has no "
                    f"VJP but the call is being differentiated (jax.grad / "
                    f"jax.vjp); force a vjp-capable schedule "
                    f"({[s.name for s in self.schedules if s.vjp]}) or drop "
                    f"the forced policy and let dispatch pick one")
            return sched
        of_backend = [s for s in self.schedules if s.backend == (pol.backend or "pallas")
                      and (s.vjp or not needs_vjp)]
        if not of_backend and pol.backend is not None:
            raise ValueError(f"kernel op {self.name!r}: no {pol.backend!r} schedule "
                             f"has a VJP but the call is being differentiated")
        avail = [s for s in of_backend if s.available(problem)]
        if pol.backend is not None:
            # a forced backend is honoured even when every availability
            # predicate fails (they are conservative models)
            avail = avail or of_backend
        elif not avail:  # no kernel schedule fits: the reference backend
            avail = [s for s in self.schedules
                     if s.backend == "reference" and (s.vjp or not needs_vjp)]
        # ties: the first listed
        return min(avail, key=lambda s: s.cost(problem) if s.cost else math.inf)

    def __call__(self, *tensors: torch.Tensor, **opts) -> torch.Tensor:
        full = dict(self.opt_defaults)
        for key, val in opts.items():
            if key not in full:
                raise TypeError(f"{self.name}() got unexpected option {key!r}")
            full[key] = val
        problem = Problem(tuple(self.problem(*tensors)), autotune.dtype_name(tensors[0].dtype))
        pol = get_policy()
        needs_vjp = _needs_vjp(*tensors)

        def run(sched: Schedule) -> torch.Tensor:
            if needs_vjp and sched.backend == "pallas":  # the oracle differentiates natively
                if self.name == "matmul":  # the one backward that dispatches again
                    return _LinearFunction.apply(sched, linear, _bwd_policy_token(pol), full,
                                                 *tensors)
                return _VJP[self.name].apply(sched, full, *tensors)
            return sched.fn(*tensors, **full)
        return _dispatched(self, problem, pol, needs_vjp, run)


_REGISTRY: dict[str, KernelOp] = {}


def register(kernel_op: KernelOp) -> KernelOp:
    _REGISTRY[kernel_op.name] = kernel_op
    _pick.cache_clear()
    return kernel_op


@functools.lru_cache(maxsize=4096)
def _pick(name: str, problem: Problem, pol: DispatchPolicy, needs_vjp: bool) -> Schedule:
    return _REGISTRY[name].pick(problem, pol, needs_vjp)


def op(name: str) -> KernelOp:
    """Look up a kernel family: ``op("paged_attention")(...)``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown kernel op: {name!r} (have {sorted(_REGISTRY)})") from None


class Resolution(NamedTuple):
    """What :func:`resolve` reports: the picked schedule, its backend
    (``pallas``, the hand-written kernels, or ``reference``) and whether
    it can be differentiated."""

    schedule: str
    backend: str
    vjp: bool


def resolve(name: str, shape: Sequence[int], dtype,
            policy: DispatchPolicy | str | None = None, *,
            needs_vjp: bool = False) -> Resolution:
    """Which (schedule, backend) a call would dispatch to; runs nothing.
    ``needs_vjp=True``: what a differentiated call would pick."""
    sched = op(name).resolve(
        Problem(tuple(int(s) for s in shape), autotune.dtype_name(dtype)), policy,
        needs_vjp=needs_vjp)
    return Resolution(sched.name, sched.backend, sched.vjp)


def _dispatched(kop: KernelOp, problem: Problem, pol: DispatchPolicy, needs_vjp: bool,
                run: Callable[[Schedule], Any]) -> Any:
    """``run`` the schedule that ``kop`` resolves for ``problem`` under
    ``pol``; with a recorder armed, time the resolution and the run and
    record them (:func:`_record_dispatch`).  Unarmed, the cost over the
    call is one ``trace.active()`` check."""
    rec = trace.active()
    if rec is None:
        return run(kop.resolve(problem, pol, needs_vjp=needs_vjp))
    t0 = rec.now()
    sched = kop.resolve(problem, pol, needs_vjp=needs_vjp)
    n0 = KERNELS[sched.kernel].launches if sched.kernel else 0
    out = run(sched)
    _record_dispatch(rec, t0, kop.name, sched, problem, n0)
    return out


def _record_dispatch(rec, t0: float, op_name: str, sched: Schedule, problem: Problem,
                     launches0: int) -> None:
    """Record one ``dispatch.<op>`` complete-span on the armed recorder,
    with the JAX package's args: ``op``, ``schedule``, ``backend``,
    ``shape`` (the problem dispatch resolved), ``dtype``.

    Two differences from the JAX package's ``_record_dispatch``, by design:

    * **One span per call, not per compilation.**  JAX records a span per
      kernel site per jit trace (its dispatch runs at trace time); the
      port runs eagerly, so every call of :meth:`KernelOp.__call__`,
      :func:`linear`, :func:`grouped_linear` and the matmul backward's
      re-dispatch records one.  A run's dispatch counts are calls, JAX's
      are compiled sites.
    * **Tile keys.**  Where JAX records ``gm`` / ``bm`` / ``bn`` / ``bk``
      from its TPU block config, the port records the tile of the CUDA
      design that ran (``kernels.matmul.design_tiles``: rows per group or
      cluster ``gm``, ``bm``, ``bn``, ``bk``) and the design's name
      (``design``, for every family whose kernel launched in the call).
      The plain versions on the CPU launch nothing and record neither, as
      JAX records no block config with its autotuner off.

    The CUDA kernels' tiles are fixed, so there is no autotuner outcome
    (``autotune_cached``) to record."""
    args = {"op": op_name, "schedule": sched.name, "backend": sched.backend,
            "shape": list(problem.shape), "dtype": problem.dtype}
    kname = sched.kernel
    if kname is not None and KERNELS[kname].launches != launches0:
        design = KERNELS[kname].design
        args["design"] = design
        if op_name == "matmul":
            args.update(design_tiles(kname, design, problem.shape[0]))
    rec.complete(f"dispatch.{op_name}", t0, cat="kernel", args=args)


def _bwd_policy_token(pol: DispatchPolicy) -> str | None:
    """How the backward re-dispatches, from the forward's effective
    policy (the JAX package's rule): a forced schedule must not leak to
    the backward problems (dA and dB have other shapes; a forced ``mcast``
    at dB = A^T dz would run with M = the old K), so forcing a schedule
    or the pallas backend pins the backward to the cheapest pallas
    schedule; otherwise the backward resolves under the policy in force
    when it runs."""
    if pol.schedule is not None or pol.backend == "pallas":
        return "backend=pallas"
    return None


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


def _sigmoid_composed(y):
    return 1 / (1 + torch.exp(-y))


def _gelu_tanh_composed(y):
    def const(c):  # the JAX code's constants, cast to y's dtype first
        return torch.tensor(c, dtype=y.dtype, device=y.device)
    inner = const(math.sqrt(2 / math.pi)) * (y + const(0.044715) * (y * y * y))
    return y * (0.5 * (1.0 + torch.tanh(inner)))


#: the activations as ``jax.nn`` composes them — ``sigmoid`` is
#: 1 / (1 + exp(-x)), ``gelu`` the tanh form — op by op in the input's
#: dtype, so a bf16 activation rounds after every step, as the JAX
#: reference's does
REFERENCE_ACTIVATIONS = dict(
    ACTIVATIONS, sigmoid=_sigmoid_composed, silu=lambda y: y * _sigmoid_composed(y),
    gelu=_gelu_tanh_composed, gelu_tanh=_gelu_tanh_composed)


def _reference_epilogue(y, bias, activation, out_dtype):
    """The reference backend's epilogue (JAX ``_reference_epilogue``): the
    cast to ``out_dtype`` (default: the product's own dtype) comes
    *before* the bias add, and the activation runs in that dtype — the
    model layer's pre-kernel rounding points, not the kernels' fp32
    epilogue."""
    y = y.to(out_dtype or y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return REFERENCE_ACTIVATIONS[activation](y)


def _mm_reference(a, b, bias=None, *, activation, out_dtype):
    """``jnp.dot``: the product accumulated in fp32 and returned in the
    operands' promoted dtype — an fp32 x bf16 product (the logits) in
    fp32, a bf16 x bf16 one rounded once to bf16, as XLA's dot does."""
    y = torch.matmul(a.float(), b.float())
    return _reference_epilogue(y.to(torch.promote_types(a.dtype, b.dtype)), bias, activation,
                               out_dtype)


register(KernelOp(
    name="matmul",
    problem=lambda a, b, *rest: (a.shape[0], a.shape[1], b.shape[1]),
    opt_defaults=(("activation", "none"), ("out_dtype", None)),
    # ties go to the first: tiled, mcast, unicast (the JAX package's order)
    schedules=(
        Schedule("tiled", _mm_tiled, _model_cost("matmul", "tiled"), vjp=True,
                 kernel="matmul_tiled"),
        Schedule("mcast", _mm_mcast, _model_cost("matmul", "mcast"),
                 available=_fits("matmul", "mcast"), vjp=True, kernel="matmul_mcast"),
        Schedule("unicast", _mm_unicast, _model_cost("matmul", "unicast"), vjp=True,
                 kernel="matmul_unicast"),
        Schedule("reference", _mm_reference, None, vjp=True, backend="reference"),
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
    and ``x.dtype``; ``out_dtype`` defaults to ``x.dtype`` on the kernels
    and to the product's own dtype on the reference backend, as in the JAX
    package."""
    k_dims, out_dims = w.shape[:contract_dims], w.shape[contract_dims:]
    if tuple(x.shape[x.ndim - contract_dims:]) != tuple(k_dims):
        raise ValueError(f"linear: x {tuple(x.shape)} does not contract with w "
                         f"{tuple(w.shape)} over {contract_dims} dims")
    lead = x.shape[: x.ndim - contract_dims]
    m, k, n = math.prod(lead), math.prod(k_dims), math.prod(out_dims)
    pol = as_policy(policy) or get_policy()
    needs_vjp = _needs_vjp(x, w, bias)
    problem = Problem((m, k, n), autotune.dtype_name(x.dtype))
    opts = dict(activation=activation or "none", out_dtype=out_dtype)
    args = (x.reshape(m, k), w.reshape(k, n)) + (() if bias is None else (bias.reshape(n),))

    def run(sched: Schedule) -> torch.Tensor:
        if needs_vjp and sched.backend == "pallas":
            return _LinearFunction.apply(sched, linear, _bwd_policy_token(pol), opts, *args)
        return sched.fn(*args, **opts)
    return _dispatched(op("matmul"), problem, pol, needs_vjp, run).reshape(*lead, *out_dims)


def grouped_linear(x: torch.Tensor, w: torch.Tensor, *, activation: str | None = None,
                   policy: DispatchPolicy | str | None = None) -> torch.Tensor:
    """Per-group linear (the MoE expert matmul): ``x`` (..., g, m, k),
    ``w`` (g, k, n) -> (..., g, m, n), one independent ``act(x_g @ w_g)``
    per group, in ``x.dtype``.

    It resolves once, on (prod(lead) x m, k, n) and ``x.dtype``, as the
    JAX package does.  The reference backend keeps JAX's einsum: products
    summed in fp32, one rounding to the promoted dtype, then the
    activation composed op by op in that dtype.  A kernel schedule moves
    the lead axes behind the group axis (JAX's transpose, a copy only
    where the lead axes are not 1) and launches its kernel once over all
    groups (K1 with the activation in its epilogue, K4 / K5 with it after
    them in fp32, as :func:`linear`); differentiated, it runs
    :class:`_LinearFunction` over the groups, whose backward is grouped
    launches too."""
    g, k, n = w.shape
    lead, m = x.shape[:-3], x.shape[-2]
    if tuple(x.shape[-3:]) != (g, m, k):
        raise ValueError(f"grouped_linear: x {tuple(x.shape)} does not match w {tuple(w.shape)}")
    act = activation or "none"
    pol = as_policy(policy) or get_policy()
    needs_vjp = _needs_vjp(x, w)
    problem = Problem((max(1, math.prod(lead)) * m, k, n), autotune.dtype_name(x.dtype))

    def run(sched: Schedule) -> torch.Tensor:
        if sched.backend == "reference":
            y = torch.matmul(x.float(), w.float()).to(torch.promote_types(x.dtype, w.dtype))
            return REFERENCE_ACTIVATIONS[act](y)
        xt = x.reshape(-1, g, m, k).transpose(0, 1).reshape(g, -1, k)
        if needs_vjp:
            y = _LinearFunction.apply(sched, _grouped, _bwd_policy_token(pol),
                                      dict(activation=act, out_dtype=None), xt, w)
        else:
            y = sched.fn(xt, w, activation=act, out_dtype=None)
        return y.reshape(g, -1, m, n).transpose(0, 1).reshape(*lead, g, m, n)
    return _dispatched(op("matmul"), problem, pol, needs_vjp, run)


def _grouped(a: torch.Tensor, b: torch.Tensor, *, bias=None, out_dtype=None,
             policy=None) -> torch.Tensor:
    """``a`` (g, m, k) @ ``b`` (g, k, n), one product per group, through
    the schedule dispatch picks for one group's (m, k, n) under
    ``policy``: a kernel schedule's one launch over all groups.  Operands
    are read through their strides (a transposed group operand is a view,
    not a copy).  ``bias`` is :func:`linear`'s keyword, never given here."""
    g, m, k = a.shape
    problem = Problem((m, k, b.shape[2]), autotune.dtype_name(a.dtype))
    return _dispatched(op("matmul"), problem, as_policy(policy) or get_policy(), False,
                       lambda sched: sched.fn(a, b, bias, activation="none",
                                              out_dtype=out_dtype))


class _LinearFunction(torch.autograd.Function):
    """The matmul VJP (JAX ``_matmul_vjp_fwd`` / ``_matmul_vjp_bwd``), for
    :func:`linear` (``product`` = :func:`linear`, 2-D operands) and for
    :func:`grouped_linear` (``product`` = :func:`_grouped`, (g, m, k) x
    (g, k, n): JAX's ``vmap`` of the VJP over the group axis): the forward
    runs the dispatched schedule and saves its inputs; the backward
    re-enters ``product`` — for ``z`` only with an activation, then
    ``dA = dz @ B^T`` and ``dB = A^T @ dz`` (transposed operands as
    strided views), each one launch — under the backward policy token,
    casting where the JAX package casts."""

    @staticmethod
    def forward(ctx, sched, product, bwd_policy, opts, a, b, bias=None):
        ctx.product, ctx.bwd_policy, ctx.activation = product, bwd_policy, opts["activation"]
        ctx.save_for_backward(a, b, bias)
        return sched.fn(a, b, bias, **opts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b, bias = ctx.saved_tensors
        product, pol, g32 = ctx.product, ctx.bwd_policy, g.float()
        if ctx.activation != "none":
            # recompute the pre-activation (one more dispatched matmul)
            # rather than keep an (M, N) fp32 residual from the forward;
            # the bias joins the product's epilogue: K1 adds it to its fp32
            # sum, K4 / K5 add it in fp32 after, so z is JAX's z + bias
            # (one fp32 rounding either way) in one pass fewer
            z = product(a, b, bias=bias, out_dtype=torch.float32, policy=pol)
            with torch.enable_grad():
                z = z.requires_grad_()
                dz, = torch.autograd.grad(ACTIVATIONS[ctx.activation](z), z, g32)
        else:
            dz = g32
        dz_a = dz.to(a.dtype)
        da = product(dz_a, b.mT, policy=pol).to(a.dtype)  # g . B^T
        db = product(a.mT, dz_a, policy=pol).to(b.dtype)  # A^T . g
        dbias = None if bias is None else dz.sum(dim=0).to(bias.dtype)
        return None, None, None, None, da, db, dbias


# ---------------------------------------------------------------------------
# flash attention family
# ---------------------------------------------------------------------------


def _flash_pallas(q, k, v, *, causal, window, softcap, return_lse=False):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                           window=window, softcap=softcap, return_lse=return_lse)


register(KernelOp(
    name="flash_attention",
    # q (b, h, sq, d); k/v (b, kvh, sk, d) -> (b, h, sq, sk, d)
    problem=lambda q, k, v: (*q.shape[:3], k.shape[2], q.shape[3]),
    opt_defaults=(("causal", True), ("window", None), ("softcap", None)),
    # Always available, unlike the JAX schedule, whose blocks must divide
    # the sequence and fit VMEM (JAX falls back to its reference beyond
    # that): the CUDA tiles are fixed and mask ragged edges, so every
    # (sq, sk, d <= 256) runs.  The one schedule's cost decides nothing.
    schedules=(
        Schedule("pallas", _flash_pallas, _model_cost("flash_attention"), vjp=True,
                 kernel="flash_attention"),
        Schedule("reference", attention_ref, None, vjp=True, backend="reference"),
    ),
))


class _FlashFunction(torch.autograd.Function):
    """The flash-attention VJP (JAX ``_flash_vjp_fwd`` /
    ``_flash_vjp_bwd``): K6 with the row log-sum-exp forward; backward
    ``delta = rowsum(dO * O)`` in fp32, K7 for dQ and K8 for dK/dV per
    query head, then the GQA group sum of the rounded per-head values.
    The forward runs the dispatched schedule; the backward dispatches
    nothing (K7 and K8 are the only backward)."""

    @staticmethod
    def forward(ctx, sched, opts, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = sched.fn(q, k, v, return_lse=True, **opts)
        ctx.opts = opts
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        b, h, sq, d = q.shape
        kvh, sk = k.shape[1], k.shape[2]
        g = g.contiguous()
        delta = (g.float() * o.float()).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, **ctx.opts)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, **ctx.opts)
        if h != kvh:  # GQA: the per-query-head gradients sum onto the kv heads
            dk = dk.reshape(b, kvh, h // kvh, sk, d).sum(dim=2)
            dv = dv.reshape(b, kvh, h // kvh, sk, d).sum(dim=2)
        return None, None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _paged_reference(q, k_pages, v_pages, block_table, start, lengths, *scales, softcap):
    k_scale, v_scale = scales if scales else (None, None)
    return paged_attention_ref(q, k_pages, v_pages, block_table, start, lengths,
                               softcap=softcap, k_scale=k_scale, v_scale=v_scale)


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
                 available=lambda p: p.shape[1] == 1 and p.shape[-1] == 0 and _paged_fits(p),
                 kernel="paged_attention_decode"),
        Schedule("pallas_prefill", _paged_prefill,
                 _model_cost("paged_attention", "prefill"),
                 available=_fits("paged_attention", "prefill"), kernel="paged_attention_prefill"),
        # the one differentiable schedule: auto-dispatch under autograd
        # lands here, as in the JAX package
        Schedule("reference", _paged_reference, None, vjp=True, backend="reference"),
    ),
))


# ---------------------------------------------------------------------------
# ssd family
# ---------------------------------------------------------------------------


def _ssd_pallas(xdt, b, c, log_a, *, return_states=False):
    """K9 on fp32 copies of the inputs, at the kernel's chunk; the
    within-chunk cumsum of the log-decays runs outside it, in fp32 (the
    JAX package cumsums in the input dtype)."""
    return ssd_scan(xdt.float().contiguous(), b.float().contiguous(), c.float().contiguous(),
                    ssd_lcum(log_a, SSD_CHUNK), chunk=SSD_CHUNK, return_states=return_states)


register(KernelOp(
    name="ssd",
    # xdt (b, h, s, P); b/c (b, s, N); log_a (b, h, s) -> (b, h, s, P, N)
    problem=lambda xdt, b, c, log_a: (*xdt.shape, b.shape[-1]),
    # Always available, unlike the JAX schedule, whose chunk must divide
    # the sequence and whose (P, N) state must fit VMEM: the CUDA kernels
    # run a short last chunk and stream the state through N tiles.
    schedules=(
        Schedule("pallas", _ssd_pallas, _model_cost("ssd"), vjp=True, kernel="ssd_scan"),
        Schedule("reference", ssd_scan_ref, None, vjp=True, backend="reference"),
    ),
))


class _SsdFunction(torch.autograd.Function):
    """The SSD VJP (JAX ``_ssd_vjp_fwd`` / ``_ssd_vjp_bwd``): K9 forward
    with its chunk-initial states checkpointed; backward K10 on the same
    chunk grid (one state per forward chunk), dB and dC summed over the
    heads (B and C are head-shared), each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, sched, opts, xdt, b, c, log_a):
        y, states = sched.fn(xdt, b, c, log_a, return_states=True, **opts)
        ctx.dtypes = tuple(t.dtype for t in (xdt, b, c, log_a))
        ctx.save_for_backward(xdt, b, c, log_a, states)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xdt, b, c, log_a, states = ctx.saved_tensors
        dx, db, dc, dl = ssd_scan_bwd(
            xdt.float().contiguous(), b.float().contiguous(), c.float().contiguous(),
            ssd_lcum(log_a, SSD_CHUNK), states, g.float().contiguous(), chunk=SSD_CHUNK)
        grads = (dx, db.sum(dim=1), dc.sum(dim=1), dl[..., 0])
        return (None, None, *(d.to(dt) for d, dt in zip(grads, ctx.dtypes)))


# ---------------------------------------------------------------------------
# rglru family
# ---------------------------------------------------------------------------


def _rglru_pallas(a, b):
    """K11 on fp32 copies: the recurrence runs in fp32 whatever the inputs'
    dtype, as the JAX kernel's fp32 state does."""
    return rglru_scan(a.float().contiguous(), b.float().contiguous())


register(KernelOp(
    name="rglru",
    problem=lambda a, b: a.shape,
    # Always available: the JAX schedule is not where its sequence block
    # must be the whole (prime) sequence and overflows VMEM; the CUDA
    # kernels cut any length into 64-step chunks, the last one short.
    schedules=(
        Schedule("pallas", _rglru_pallas, _model_cost("rglru"), vjp=True,
                 kernel="rglru_scan"),
        Schedule("reference", rglru_scan_ref, None, vjp=True, backend="reference"),
    ),
))


class _RglruFunction(torch.autograd.Function):
    """The RG-LRU VJP (JAX ``_rglru_vjp_fwd`` / ``_rglru_vjp_bwd``): K11
    forward, saving ``a`` and h; backward K12 on ``h_prev`` (h shifted
    right one step, zero first).  Both gradients come back in a's dtype,
    as the JAX package returns them (the kernel streams a and b as one
    fp32 recurrence)."""

    @staticmethod
    def forward(ctx, sched, opts, a, b):
        h = sched.fn(a, b, **opts)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        h_prev = torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0))
        da, db = rglru_scan_bwd(a.float().contiguous(), h_prev, g.float().contiguous())
        return None, None, da.to(a.dtype), db.to(a.dtype)


#: the autograd function of each vjp-capable family whose backward is a
#: fixed kernel (JAX ``_VJP_FWD``/``_VJP_BWD``); matmul's is
#: :class:`_LinearFunction`, which also takes the backward policy
_VJP = {"flash_attention": _FlashFunction, "ssd": _SsdFunction, "rglru": _RglruFunction}


# ---------------------------------------------------------------------------
# degradation: retry once on the reference backend
# ---------------------------------------------------------------------------
#
# A kernel call that raises — or, under the opt-in output check, returns
# NaN/Inf — is retried exactly once on the reference backend instead of
# failing the whole batch.  A kernel that cannot be built, loaded or
# launched (``KernelUnavailable``) is not retried: the plain version would
# then serve every step while the kernel never runs.  The mechanism lives here, next to the dispatch
# it guards; when to arm it is the caller's choice
# (``PagedEngine(kernel_fallback=True)``, ``--kernel-fallback``).  Every
# retry is counted, so a degraded server shows in its stats.


@dataclasses.dataclass
class FallbackStats:
    """Cumulative counters of :func:`call_with_fallback` (process-wide)."""

    calls: int = 0  # guarded calls attempted
    fallbacks: int = 0  # calls that completed on the reference retry
    raised: int = 0  # primary raised an exception
    numeric_trips: int = 0  # primary returned non-finite output
    last_error: str | None = None


_FALLBACK_STATS = FallbackStats()


def fallback_stats() -> FallbackStats:
    """Snapshot of the process-wide fallback counters."""
    return dataclasses.replace(_FALLBACK_STATS)


def reset_fallback_stats() -> None:
    global _FALLBACK_STATS
    _FALLBACK_STATS = FallbackStats()


def all_finite(*tensors) -> bool:
    """Opt-in output guard: True iff every floating tensor is NaN/Inf-free.
    Synchronises with the device; callers run it at step boundaries,
    where the engine reads the sampled token anyway."""
    return all(not t.is_floating_point() or bool(torch.isfinite(t).all()) for t in tensors)


def _device_lost() -> bool:
    """True when the CUDA context can run no more work: a sticky error
    (an illegal address, a trap) fails every later call, the retry too."""
    if not torch.cuda.is_initialized():
        return False
    try:
        torch.cuda.synchronize()
    except RuntimeError:
        return True
    return False


def call_with_fallback(primary, reference, *args, check=None):
    """Run ``primary(*args)``; on an exception — or, when ``check`` is
    given, on ``check(out)`` returning False — run ``reference(*args)``
    once and return its result instead.

    Returns ``(out, fell_back)``.  The reference retry is *not* guarded:
    if the oracle also fails, the fault is not the kernel's and the error
    propagates.  So does a kernel that cannot be built, loaded or
    launched (:class:`KernelUnavailable`): serving every step on the
    oracle would hide it.  And so does the primary's error when it left
    the CUDA context unusable (a retry could not run).  A primary that
    writes its inputs in place must write only what the retry rewrites
    before reading it."""
    _FALLBACK_STATS.calls += 1
    try:
        out = primary(*args)
    except KernelUnavailable:
        raise
    except Exception as e:  # noqa: BLE001 — any other kernel failure degrades
        if _device_lost():
            raise
        _FALLBACK_STATS.raised += 1
        _FALLBACK_STATS.last_error = f"{type(e).__name__}: {e}"
    else:
        if check is None or check(out):
            return out, False
        _FALLBACK_STATS.numeric_trips += 1
        _FALLBACK_STATS.last_error = "non-finite kernel output"
    _FALLBACK_STATS.fallbacks += 1
    rec = trace.active()
    if rec is not None:
        rec.instant("kernel.fallback", cat="kernel",
                    args={"error": _FALLBACK_STATS.last_error})
    return reference(*args), True
