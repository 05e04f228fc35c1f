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
    # the child's autotune picks go to a file of its own: the cache file
    # the whole test run shares (tests/conftest.py) is read by the autotune
    # tests of other workers, which must not see entries a child flushed
    env["REPRO_AUTOTUNE_CACHE"] = str(tmp_dir / f"autotune_{mode}.json")
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


class MarginSampler:
    """Greedy, recording each choice's top-two logit margin and the row's
    largest |logit| under (rid, token index), on the dense ``Server`` it is
    attached to (an admission's row is the request admitted, a decode
    step's rows the server's slots)."""

    def __init__(self):
        from repro_torch.serve import GreedySampler

        self.greedy, self.server, self.admitting, self.margins = GreedySampler(), None, None, {}

    def attach(self, server):
        admit = server._admit

        def admit_one(req):
            self.admitting = req
            try:
                return admit(req)
            finally:
                self.admitting = None

        self.server, server._admit = server, admit_one
        return server

    def select(self, logits):
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        margin, scale = (top2[:, 0] - top2[:, 1]).tolist(), logits[:, -1].abs().amax(-1).tolist()
        rows = {0: self.admitting} if self.admitting is not None else dict(self.server.active)
        for row, req in rows.items():
            self.margins[(req.rid, len(req.out))] = (margin[row], scale[row])
        return self.greedy.select(logits)


#: a launcher stream may leave JAX's where the port's top-two margin at
#: its first differing token is this x the row's largest |logit|
NEAR_TIE = 2e-2


def port_launch(params, args: list[str], sampler: MarginSampler | None = None) -> str:
    """stdout of ``repro_torch.launch.serve`` on the CPU with ``params``;
    ``sampler`` (a :class:`MarginSampler`) is attached to its dense
    ``Server`` when given."""
    import contextlib
    import io
    from unittest import mock

    from repro_torch.launch import serve as launcher

    real = launcher.Server

    def server(*a, **kw):
        return sampler.attach(real(*a, **dict(kw, sampler=sampler)))

    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        if sampler is not None:
            stack.enter_context(mock.patch.object(launcher, "Server", server))
        stack.enter_context(contextlib.redirect_stdout(buf))
        stack.enter_context(contextlib.redirect_stderr(io.StringIO()))
        launcher.main([*args, "--device", "cpu"], params=params)
    return buf.getvalue()


def launcher_streams(stdout: str) -> dict[int, list[int]]:
    """{rid: printed tokens} of the launcher's ``req`` lines."""
    import re

    return {int(m[1]): [int(x) for x in m[2].split(", ")]
            for m in re.finditer(r"^req (\d+): prompt\[\d+\] -> \d+ tokens: \[([\d, ]+)\]",
                                 stdout, re.M)}


def hold_dense_streams(got: str, want: str, margins: dict, n: int = 6) -> int:
    """The port's launcher stdout against JAX's: every stream equal but
    where the port's top-two margin at the first differing token is within
    ``NEAR_TIE`` x max |logit|, at most one such stream; identical stdout
    otherwise.  Returns the number of differing streams."""
    got_s, want_s = launcher_streams(got), launcher_streams(want)
    assert len(want_s) == n and set(got_s) == set(want_s)
    differing = [rid for rid in want_s if got_s[rid] != want_s[rid]]
    for rid in differing:
        j = next(i for i, (a, b) in enumerate(zip(got_s[rid], want_s[rid])) if a != b)
        margin, scale = margins[(rid, j)]
        assert margin <= NEAR_TIE * scale, (rid, j, margin, scale)
    assert len(differing) <= 1, differing
    if not differing:
        assert got == want
    return len(differing)
