"""The launcher on gemma2-9b, command-r-35b and deepseek-7b against the
JAX launcher (pixtral-12b's and whisper-medium's runs are in
``test_torch_families.py``, so that each file's JAX child stays short),
each at its reduced config on the weights of ``repro.models.lm.init``
(seed 0) carried over by ``from_jax_params``.

* ``--kv dense`` (the dense ``Server``): stdout equal to the JAX
  launcher's, line for line, under the default (``backend=pallas``),
  ``mcast`` and ``unicast`` policies, but where the port's top-two margin
  at a stream's first differing token is within ``NEAR_TIE``
  (``_torch_util.py``) x that row's largest |logit| (at most one such
  stream a run: gemma2's request 3
  under the default policy, margin 2.3e-5 at max |logit| 0.49, ROADMAP
  Queue 3 entry 22); prompts bucketed where JAX buckets them (global
  attention only: not gemma2's windows).
* ``--kv paged`` with a 24-token shared prefix (prefix hits, suffix
  prefills) on every arch JAX serves paged: the same stdout; under a forced
  ``mcast`` or ``unicast`` matmul schedule, JAX's error (the paged
  attention op has no such schedule).
* gemma2 on ``--kv paged``: JAX's ``ValueError`` (its local windows have
  no pages).

JAX runs in a child process with excess precision off
(``_torch_jax_ref.py`` mode ``famserve``).
"""
import contextlib
import io
import json

import jax
import pytest
import torch

from _torch_jax_ref import (
    DENSE_POLICIES,
    FAMILY_ARCHS,
    FAMILY_SERVED,
    PAGED_FAMILY_ARCHS,
    SEED,
    family_launch_args,
)
from _torch_util import MarginSampler, hold_dense_streams, jax_reference, port_launch
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.weights import from_jax_params

ARCHS = FAMILY_SERVED["famserve"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    ref = jax_reference("famserve", tmp_path_factory.mktemp("jax_famserve"))
    return json.loads(str(ref["serve_json"]))


_PARAMS = {}


def _params(arch):
    """The JAX launcher's seeded parameters of ``arch``, converted (cached)."""
    if arch not in _PARAMS:
        jparams = jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))
        _PARAMS[arch] = from_jax_params(jax.device_get(jparams), device="cpu")
    return _PARAMS[arch]


@pytest.mark.parametrize("policy", DENSE_POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_server_streams_match_jax_launcher(served, arch, policy):
    """Six requests, 8 new tokens each: the port's stdout equals the JAX
    launcher's line for line, but at one recorded near-tie
    (``hold_dense_streams``)."""
    sampler = MarginSampler()
    got = port_launch(_params(arch), [*family_launch_args(arch), "--kv", "dense",
                                      "--kernel-policy", policy], sampler)
    hold_dense_streams(got, served["runs"][f"{arch} dense {policy}"], sampler.margins)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dense_server_buckets_where_jax_does(arch):
    """Prompts are right-padded to 16-token buckets for global attention
    (every family arch but gemma2, whose windowed rings the padding would
    enter), as in the JAX launcher."""
    cfg = get_config(arch, reduced=True)
    want = None if any(bd.window for bd in cfg.layer_defs) else 16
    assert launcher.Server(cfg, _params(arch), device="cpu")._bucket == want
    assert (want is None) == (arch == "gemma2-9b")


@pytest.mark.parametrize("arch", [a for a in ARCHS if a in PAGED_FAMILY_ARCHS])
def test_paged_streams_match_jax_launcher(served, arch):
    """``--kv paged`` after a 24-token shared prefix: prefix hits and
    suffix prefills (K2 and K3's plain versions here), stdout equal to the
    JAX launcher's.  (Not to the dense run's: on random weights the paged
    and dense paths part at near-ties in JAX too.)"""
    got = port_launch(_params(arch), [*family_launch_args(arch), "--kv", "paged",
                                      "--kernel-policy", "backend=pallas"])
    assert got == served["runs"][f"{arch} paged"]


def _error(arch, args) -> list[str]:
    err = io.StringIO()
    with pytest.raises((ValueError, SystemExit)) as e, \
            contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        launcher.main([*args, "--device", "cpu"], params=_params(arch))
    return [type(e.value).__name__, str(e.value)]


@pytest.mark.parametrize("policy", ["mcast", "unicast"])
def test_paged_refuses_a_forced_matmul_schedule_as_jax_does(served, policy):
    """command-r on ``--kv paged --kernel-policy mcast|unicast``: the paged
    attention op has no such schedule; JAX's ``ValueError``."""
    want = served["errors"][f"command-r-35b paged {policy}"]
    args = [*family_launch_args("command-r-35b"), "--kv", "paged", "--kernel-policy", policy]
    assert _error("command-r-35b", args) == want[:2]


def test_paged_refuses_gemma2_windows_as_jax_does(served):
    """gemma2's local-window layers have no pages: ``--kv paged`` raises
    JAX's ``ValueError``, as ``lm.init_paged_cache`` does."""
    want = served["errors"]["gemma2-9b paged"]
    assert _error("gemma2-9b", [*family_launch_args("gemma2-9b"), "--kv", "paged"]) == want[:2]
    with pytest.raises(ValueError) as e:
        lm.init_paged_cache(get_config("gemma2-9b", reduced=True), 8, 8, device="cpu")
    assert str(e.value) == want[1]
