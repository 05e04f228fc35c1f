"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

Both packages run in one process; arrays cross between them as numpy
arrays (bf16 through a ``uint16`` view, see ``repro_torch.weights``).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.weights import to_torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

# Stated tolerances.  fp32 outputs: the two sides differ only in the
# order of fp32 sums.  bf16 outputs, compared in fp32: 2e-2 is about two
# bf16 ulps (2**-7 = 7.8e-3 relative per ulp), room for one rounding
# step landing on the other side of a tie after a reordered fp32 sum.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def t(a) -> torch.Tensor:
    """numpy (incl. ml_dtypes bf16) or jax array -> CPU tensor."""
    return to_torch(np.asarray(a), "cpu")


def close(got: torch.Tensor, want, dtype: torch.dtype | None = None) -> None:
    """Compare in fp32 at the tolerance of ``dtype`` (default: got's)."""
    tol = TOL[dtype or got.dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def jax_reference(mode: str, tmp_dir: Path) -> dict:
    """Run ``tests/_torch_jax_ref.py <mode>`` in a child process with XLA's
    excess precision off (see that file) and return its arrays."""
    out = tmp_dir / f"jax_{mode}.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO / "src"), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, str(TESTS / "_torch_jax_ref.py"), mode, str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference ({mode}) failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels themselves run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
