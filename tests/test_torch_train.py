"""The training slice's differentiable model against the JAX package:
``lm.loss_fn`` and its gradients, and the backward of
``kernels.grouped_linear``.

* ``loss_fn`` and ``torch.autograd.grad`` (through
  ``dist.step.value_and_grad``) on the port's plain versions against
  ``jax.value_and_grad(lm.loss_fn)`` under ``backend=pallas`` (interpret
  mode; a child process with excess precision off, ``_torch_jax_ref.py``
  mode ``train``), on the reduced qwen1.5-0.5b (dense; its cross entropy
  also in chunks below the sequence, ``loss_chunk``, and with
  ``remat=True``), moonshot-v1-16b-a3b (MoE, with its aux loss) and
  mamba2-780m (SSD); parameters from JAX's ``lm.init`` through
  ``from_jax_params``, JAX's gradients converted the same way.  And the
  audio branch of ``build_train_step`` (``encdec.loss_fn`` over frames)
  on the port alone.
* one ``build_train_step`` step of every reduced decoder arch of the
  registry (finite loss and gradients, the loss lowered by AdamW).
* ``grouped_linear``'s dx and dw, with and without an activation, against
  ``jax.grad`` of JAX's ``grouped_linear`` under each kernel policy, and
  the shape of its backward: one grouped call per product, the transposed
  group operands read as strided views.

Stated tolerances:

* the loss: fp32, rtol = atol = 1e-5 (``TOL``);
* gradients, per leaf: the relative L2 gap to JAX within a quarter of the
  gap that one flipped bf16 ulp in JAX's own layer-0 input opens
  (``WITNESS``, the gate ``tests/test_torch_encdec.py`` states for whole
  runs, ROADMAP Queue 3 entry 23).  The two sides round the same bf16
  activations, but where a forward rounding lands on the other side of
  a tie, the backward carries it through every layer below (measured: at
  most 0.011 of the witness gap on qwen, 0.0004 on moonshot, 0.10 on
  mamba2, whose gated norm and depthwise convolution are bf16);
* ``grouped_linear``: bf16 gradients at 2e-2 (``TOL``), as
  ``tests/test_torch_grad.py`` holds ``linear``'s.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import ENCDEC_ARCH, SEED, TRAIN_RUNS, encdec_case, train_case
from _torch_util import TOL, close, jax_reference, t
from repro.configs import get_config as jax_config
from repro.kernels import api as jax_api
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro_torch import kernels, tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.dist.step import build_train_step, value_and_grad
from repro_torch.kernels import api
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw
from repro_torch.weights import from_jax_encdec_params, from_jax_params

WITNESS = 0.25  # the gap over the flipped-ulp witness's (test_torch_encdec.py)


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("train", tmp_path_factory.mktemp("jax_train"))


def _unflat(ref: dict, prefix: str) -> dict:
    """The arrays under ``prefix`` as the nested dict JAX's tree was."""
    out: dict = {}
    for key in ref:
        if key.startswith(prefix):
            *parents, leaf = key[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = ref[key]
    return out


def _port_params(arch: str):
    params = jax.device_get(jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED)))
    checksum = float(sum(np.abs(np.asarray(x, np.float32)).sum()
                         for x in jax.tree.leaves(params)))
    return from_jax_params(params, device="cpu"), checksum


@pytest.mark.parametrize("arch,variant", [(a, v) for a, runs in TRAIN_RUNS.items() for v in runs])
def test_loss_and_grads_match_jax(ref, arch, variant):
    params, checksum = _port_params(arch)
    assert checksum == pytest.approx(float(ref[f"{arch}/params_checksum"]), rel=1e-6)
    cfg = get_config(arch, reduced=True)
    case = {k: torch.from_numpy(v) for k, v in train_case().items()}
    kw = TRAIN_RUNS[arch][variant]
    kernels.reset_launch_counts()
    loss, grads = value_and_grad(
        lambda p, b: lm.loss_fn(p, cfg, b["tokens"], b["labels"], **kw), params, case)
    assert set(kernels.launch_counts().values()) == {0}  # the plain versions on the CPU
    np.testing.assert_allclose(loss.numpy(), ref[f"{arch}/{variant}/loss"], **TOL[torch.float32])
    want = from_jax_params(_unflat(ref, f"{arch}/{variant}/grad/"), device="cpu")
    flip = from_jax_params(_unflat(ref, f"{arch}/flip/grad/"), device="cpu")
    _hold_grads(grads, want, flip, params)


def _hold_grads(grads, want, flip, params) -> None:
    """Each leaf's gap to JAX within ``WITNESS`` x the witness's gap, in
    the parameter's dtype and shape."""
    got, want, flip, params = (tree.flatten_with_paths(x) for x in (grads, want, flip, params))
    assert got.keys() == want.keys() == flip.keys() == params.keys()
    for path, g in got.items():
        p = params[path]
        assert g.dtype == p.dtype and g.shape == p.shape, path
        w, f = want[path].to(p.dtype).float(), flip[path].to(p.dtype).float()
        gap, witness = float((g.float() - w).norm()), float((f - w).norm())
        assert gap <= WITNESS * witness + 1e-6 * float(w.norm()), (
            f"{path}: |port - jax| {gap:.3g} over the flipped-ulp gap {witness:.3g}")


def test_encdec_step_loss_is_the_cross_entropy_of_forward():
    """The audio branch of ``build_train_step``'s loss: ``encdec.loss_fn``
    over the frames is the mean cross entropy of ``encdec.forward``'s
    logits, and every leaf gets a gradient in its own dtype.  (Held on
    the port alone: against JAX the reduced whisper's loss moves 0.48 and
    its gradients up to 0.29 of the gap a flipped frame ulp opens, past
    ``WITNESS`` — ROADMAP Queue 3, the random-weight attention of entry
    23.)"""
    jparams = jax.device_get(jax_encdec.init(jax_config(ENCDEC_ARCH, reduced=True),
                                             jax.random.PRNGKey(SEED)))
    params = from_jax_encdec_params(jparams, device="cpu")
    case = encdec_case()
    labels = torch.from_numpy(np.random.default_rng(23).integers(0, 512, case["tokens"].shape))
    batch = {"tokens": torch.from_numpy(case["tokens"]), "labels": labels,
             "frames": t(case["frames"])}
    cfg = get_config(ENCDEC_ARCH, reduced=True)
    bundle = build_train_step(cfg, ShapeCfg("case", "train", *case["tokens"].shape[::-1]))
    loss, grads = value_and_grad(bundle.loss_of, params, batch)
    with torch.no_grad():
        logits, _ = encdec.forward(params, cfg, batch["tokens"], batch["frames"])
        want = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                 labels.reshape(-1))
    np.testing.assert_allclose(loss.numpy(), want.numpy(), rtol=1e-6)
    for g, p in zip(tree.leaves(grads), tree.leaves(params)):
        assert g.dtype == p.dtype and g.shape == p.shape and bool(torch.isfinite(g).all())


def test_chunked_and_remat_losses_equal_the_whole_one():
    """On the port alone: the chunked cross entropy (a mean of the chunks'
    means) gives the whole loss to fp32 rounding, and recomputing every
    layer and chunk in the backward (``remat``) gives the chunked run's
    loss and gradients bit for bit."""
    params, _ = _port_params("qwen1.5-0.5b")
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    case = {k: torch.from_numpy(v) for k, v in train_case().items()}
    runs = {name: value_and_grad(lambda p, b, kw=kw: lm.loss_fn(
        p, cfg, b["tokens"], b["labels"], **kw), params, case)
        for name, kw in TRAIN_RUNS["qwen1.5-0.5b"].items()}
    np.testing.assert_allclose(runs["chunked"][0].numpy(), runs["whole"][0].numpy(), rtol=1e-6)
    assert torch.equal(runs["remat"][0], runs["chunked"][0])
    for a, b in zip(tree.leaves(runs["remat"][1]), tree.leaves(runs["chunked"][1])):
        assert torch.equal(a, b)


def test_loss_of_moe_adds_the_weighted_aux_loss():
    params, _ = _port_params("moonshot-v1-16b-a3b")
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    case = {k: torch.from_numpy(v) for k, v in train_case().items()}
    with torch.no_grad():
        logits, aux = lm.forward(params, cfg, case["tokens"])
        ce = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                               case["labels"].reshape(-1).long())
        for w in (0.0, 0.01, 1.0):
            got = lm.loss_fn(params, cfg, case["tokens"], case["labels"], aux_weight=w)
            np.testing.assert_allclose(got.numpy(), (ce + w * aux).numpy(), rtol=1e-6)
    assert float(aux) > 0


# ---- grouped_linear backward ---------------------------------------------------


GROUPED_CASES = [(p, a, (2,)) for p in ("backend=pallas", "tiled", "mcast", "unicast")
                 for a in (None, "silu")] + [("backend=pallas", a, ()) for a in (None, "gelu")]


@pytest.mark.parametrize("policy,activation,lead", GROUPED_CASES, ids=str)
def test_grouped_linear_grad_matches_jax(policy, activation, lead):
    rng = np.random.default_rng(len(lead) + 7)
    g, m, k, n = 4, 5, 32, 24
    x = jnp.asarray(rng.standard_normal((*lead, g, m, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((g, k, n)) / np.sqrt(k), jnp.bfloat16)
    cot = jnp.asarray(rng.standard_normal((*lead, g, m, n)), jnp.float32)

    def jax_loss(x_, w_):
        y = jax_api.grouped_linear(x_, w_, activation=activation, policy=policy)
        return (y.astype(jnp.float32) * cot).sum()

    want_dx, want_dw = jax.grad(jax_loss, argnums=(0, 1))(x, w)
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    kernels.reset_launch_counts()
    y = kernels.grouped_linear(xt, wt, activation=activation, policy=policy)
    dx, dw = torch.autograd.grad((y.float() * t(cot)).sum(), [xt, wt])
    assert set(kernels.launch_counts().values()) == {0}
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert dx.shape == xt.shape and dw.shape == wt.shape
    close(dx, want_dx)
    close(dw, want_dw)


@pytest.mark.parametrize("activation", [None, "silu"], ids=str)
def test_grouped_backward_is_one_grouped_call_per_product(activation):
    """The forward and each backward product (z with an activation, dA,
    dB) reach K1's wrapper once, over all groups, and the transposed group
    operands (Bᵀ of dA, Aᵀ of dB) arrive as strided views, not copies."""
    calls = []
    real = api.matmul_tiled

    def spy(a, b, *rest, **kw):
        calls.append((tuple(a.shape), a.is_contiguous(), tuple(b.shape), b.is_contiguous(),
                      kw.get("out_dtype")))
        return real(a, b, *rest, **kw)

    g, m, k, n = 3, 6, 16, 8
    x = torch.randn(2, g, m, k).bfloat16().requires_grad_()
    w = (torch.randn(g, k, n) / 4).bfloat16().requires_grad_()
    with mock.patch.object(api, "matmul_tiled", spy):
        y = kernels.grouped_linear(x, w, activation=activation, policy="tiled")
        torch.autograd.grad(y.float().sum(), [x, w])
    fwd = [((g, 2 * m, k), True, (g, k, n), True, torch.bfloat16)]
    z = [((g, 2 * m, k), True, (g, k, n), True, torch.float32)] if activation else []
    da = [((g, 2 * m, n), True, (g, n, k), False, torch.bfloat16)]
    db = [((g, k, 2 * m), False, (g, 2 * m, n), True, torch.bfloat16)]
    assert calls == fwd + z + da + db


# ---- every decoder family trains -----------------------------------------------


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_config(a).family != "audio"])
def test_every_decoder_arch_takes_a_train_step(arch):
    """One ``build_train_step`` step of each reduced decoder arch on the
    CPU (pixtral with 4 front-end embeddings before 12 tokens): a finite
    loss and a finite gradient for
    every leaf; then two AdamW steps change the parameters and lower the
    loss on the same batch."""
    cfg = get_config(arch, reduced=True)
    params = lm.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(29)
    n_front = 4 if cfg.frontend else 0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12 + n_front + 1)).astype(np.int32))
    batch = {"tokens": toks[:, n_front:-1], "labels": toks[:, 1:]}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.from_numpy(
            rng.standard_normal((2, n_front, cfg.frontend_dim)).astype(np.float32)).bfloat16()
    shape = ShapeCfg("case", "train", 12 + n_front, 2)
    bundle = build_train_step(cfg, shape, loss_chunk=None)
    loss, grads = value_and_grad(bundle.loss_of, params, batch)
    assert bool(torch.isfinite(loss))
    for g, p in zip(tree.leaves(grads), tree.leaves(params)):
        assert g.dtype == p.dtype and g.shape == p.shape and bool(torch.isfinite(g).all())
    opt_state = adamw.init(params, adamw.AdamWConfig(lr=1e-2, warmup_steps=1))
    before = [p.detach().clone() for p in tree.leaves(params)]
    bundle = build_train_step(cfg, shape, opt_cfg=adamw.AdamWConfig(lr=1e-2, warmup_steps=1),
                              loss_chunk=None)
    for step in (1, 2):
        params, opt_state, step_loss, _ = bundle.fn(params, opt_state, batch, step)
    assert any(not torch.equal(a, b) for a, b in zip(before, tree.leaves(params)))
    with torch.no_grad():
        assert float(bundle.loss_of(params, batch)) < float(loss)
