"""The port's training launcher (``repro_torch.launch.train``) against the
JAX launcher's ``train_loop`` on the reduced qwen1.5-0.5b, both on the
CPU ``reference`` backend (JAX's default off a TPU, the port's
``--kernel-policy reference``), from the same parameters (JAX's, through
``from_jax_params``) and the same seeded batches: ``--batch 4 --seq 32
--steps 12 --ckpt-every 4``, whole, and crashed at step 9
(``--simulate-failure-at``) then resumed (``--resume``).  JAX runs in a
child process with excess precision off (``_torch_jax_ref.py`` mode
``trainloop``).  Then the refusals: a mesh above 1 x 1, ``--fsdp`` and
``--compress`` each raise naming the ROADMAP item they wait for
(``--trace`` is ported: ``tests/test_torch_trace.py``); encoder-decoder
archs exit as the JAX launcher's do.

Stated tolerances:

* steps 0 and 1 at fp32 (rtol = atol = 1e-5): the schedule's lr is 0 at
  step 0, so both steps see the initial parameters;
* from step 2 on, the largest |port - JAX| loss over the run within the
  largest gap the witness opens: JAX's own run with the last bit of every
  layer-0 input element flipped at every step (one bf16 ulp).  The
  reference backend's bf16 activations are composed op by op, and their
  gradients round differently under JAX's VJP rules and torch's autograd
  formulas (1-2 % relative L2 per leaf on this model); AdamW's first
  steps move each parameter by about lr whatever its gradient's size, so
  an element whose small gradient differs in sign moves 2 lr apart.  Such
  gaps grow along the run, as a flipped ulp's do (measured: 0.021 at
  most, against the witness's 0.050);
* the resumed run's first loss equals the whole run's at that step bit
  for bit on each side: the checkpoint restores the parameters exactly.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from _torch_jax_ref import SEED, TRAIN_CRASH_AT, train_loop_runs
from _torch_util import TOL, jax_reference
from repro.configs import get_config as jax_config
from repro.launch import train as jax_train
from repro.models import lm as jax_lm
from repro_torch.launch import train
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("trainloop", tmp_path_factory.mktemp("jax_trainloop"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's runs of ``train_loop_runs``: name -> (result or None,
    stdout, error)."""
    params = jax.device_get(jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True),
                                        jax.random.PRNGKey(SEED)))
    out = {}
    for name, args in train_loop_runs(str(tmp_path_factory.mktemp("ckpt"))).items():
        stdout, res, err = io.StringIO(), None, ""
        try:
            with contextlib.redirect_stdout(stdout):
                res = train.main([*args, "--device", "cpu", "--kernel-policy", "reference"],
                                 params=from_jax_params(params, device="cpu"))
        except RuntimeError as e:
            err = str(e)
        out[name] = (res, stdout.getvalue(), err)
    return out


def _step_lines(text: str) -> list[int]:
    return [int(line.split()[1]) for line in text.splitlines() if line.startswith("step ")]


def test_whole_run_losses_match_jax(ref, port):
    res, text, err = port["whole"]
    assert err == "" and str(ref["whole/error"]) == ""
    got, want = np.asarray(res["losses"]), ref["whole/losses"]
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got[:2], want[:2], **TOL[torch.float32])
    witness = float(np.abs(ref["flip/losses"] - want).max())
    assert float(np.abs(got[2:] - want[2:]).max()) <= witness
    assert np.isfinite(got).all()
    assert _step_lines(text) == _step_lines(str(ref["whole/stdout"])) == list(range(12))
    assert text.splitlines()[-1] == f"done; final loss {got[-1]:.4f}"


def test_crash_and_resume_match_jax(ref, port):
    res, text, err = port["crash"]
    assert res is None and err == str(ref["crash/error"]) \
        == f"simulated node failure at step {TRAIN_CRASH_AT}"
    assert _step_lines(text) == list(range(TRAIN_CRASH_AT))
    res, text, err = port["resume"]
    assert err == "" and res["start"] == 8
    assert text.splitlines()[0] == str(ref["resume/stdout"]).splitlines()[0] \
        == "resuming from checkpoint step 8"
    assert _step_lines(text) == [8, 9, 10, 11]
    got, want = np.asarray(res["losses"]), ref["resume/losses"]
    # the restored parameters are the checkpointed ones, bit for bit
    assert got[0] == port["whole"][0]["losses"][8]
    assert want[0] == ref["whole/losses"][8]
    witness = float(np.abs(ref["flip/losses"] - ref["whole/losses"]).max())
    assert float(np.abs(got - want).max()) <= witness


@pytest.mark.parametrize("flags,item", [
    (["--mesh-data", "2"], "item 7"), (["--mesh-model", "4"], "item 7"),
    (["--fsdp"], "item 7"), (["--compress"], "item 7")])
def test_refusals_name_their_roadmap_item(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        train.main(["--reduced", "--device", "cpu", "--steps", "1", "--batch", "1",
                    "--seq", "8", "--ckpt-dir", str(tmp_path), *flags])
    assert list(tmp_path.iterdir()) == []


def test_audio_archs_exit_as_jax_does(tmp_path):
    args = train.parser().parse_args(["--arch", "whisper-medium", "--reduced", "--device",
                                      "cpu", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as want:
        jax_train.train_loop(args)
    with pytest.raises(SystemExit) as got:
        train.train_loop(args)
    assert str(got.value) == str(want.value) != ""
