"""The deprecated ``kernels/*/ops.py`` entry points of the port, after the
JAX package's: each shim is bit-equal to the registry call it forwards to
(its forced schedule), takes the JAX shim's name and arguments, and warns
once per name per process.  CPU tensors, so the kernels' plain versions
run; tolerance: none (``torch.equal``)."""
import importlib
import inspect
import warnings

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import api

FAMILIES = ("matmul", "flash_attention", "ssd", "rglru")
SHIMS = {"matmul": ("mcast_matmul", "tiled_matmul", "unicast_matmul"),
         "flash_attention": ("flash",), "ssd": ("ssd_core",), "rglru": ("lru_scan",)}


def _t(rng, *shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _calls():
    """(shim name, shim call, registry call) on seeded CPU inputs."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    rng = np.random.default_rng(0)
    a, b = _t(rng, 24, 40, dtype=torch.bfloat16), _t(rng, 40, 56, dtype=torch.bfloat16)
    bias = _t(rng, 56, dtype=torch.bfloat16)
    q, k, v = (_t(rng, 1, 2, 16, 32, dtype=torch.bfloat16) for _ in range(3))
    xdt, bm, cm = _t(rng, 1, 2, 70, 8, scale=0.5), _t(rng, 1, 70, 4, scale=0.5), \
        _t(rng, 1, 70, 4, scale=0.5)
    log_a = -torch.nn.functional.softplus(_t(rng, 1, 2, 70))
    la, lb = torch.sigmoid(_t(rng, 2, 70, 16)), _t(rng, 2, 70, 16)

    def pallas(name, *args, **kw):
        with api.use_policy("pallas"):
            return kernels.op(name)(*args, **kw)

    return [
        ("mcast_matmul", lambda: mm.mcast_matmul(a, b, bn=64, bk=32),
         lambda: kernels.linear(a, b, policy="mcast")),
        ("tiled_matmul", lambda: mm.tiled_matmul(a, b, bias, activation="silu", gm=2),
         lambda: kernels.linear(a, b, bias=bias, activation="silu", policy="tiled")),
        ("unicast_matmul", lambda: mm.unicast_matmul(a, b, bm=8),
         lambda: kernels.linear(a, b, policy="unicast")),
        ("flash", lambda: flash_ops.flash(q, k, v, window=8, bq=16),
         lambda: pallas("flash_attention", q, k, v, causal=True, window=8, softcap=None)),
        ("ssd_core", lambda: ssd_ops.ssd_core(xdt, bm, cm, log_a, chunk=64),
         lambda: pallas("ssd", xdt, bm, cm, log_a)),
        ("lru_scan", lambda: lru_ops.lru_scan(la, lb, bd=16),
         lambda: pallas("rglru", la, lb)),
    ]


@pytest.mark.parametrize("name", [c[0] for c in _calls()])
def test_shim_is_bit_equal_to_its_registry_call_and_warns_once(name, monkeypatch):
    shim, want = {c[0]: c[1:] for c in _calls()}[name]
    monkeypatch.setattr(api, "_DEPRECATED_SEEN", set())
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        first, second = shim(), shim()
    msgs = [str(w.message) for w in seen if w.category is DeprecationWarning]
    assert len(msgs) == 1 and msgs[0].startswith(f"repro_torch.kernels: {name} is deprecated")
    ref = want()
    assert first.dtype == ref.dtype and torch.equal(first, ref) and torch.equal(second, ref)


@pytest.mark.parametrize("family", FAMILIES)
def test_shims_take_the_jax_shims_names_and_arguments(family):
    jax_ops = importlib.import_module(f"repro.kernels.{family}.ops")
    port_ops = importlib.import_module(f"repro_torch.kernels.{family}.ops")
    for name in SHIMS[family]:
        assert str(inspect.signature(getattr(port_ops, name))) == \
            str(inspect.signature(getattr(jax_ops, name)))
