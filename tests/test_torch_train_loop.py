"""The port's training launcher (``repro_torch.launch.train``) against the
JAX launcher's ``train_loop`` on the reduced qwen1.5-0.5b, both on the
CPU ``reference`` backend (JAX's default off a TPU, the port's
``--kernel-policy reference``), from the same parameters (JAX's, through
``from_jax_params``) and the same seeded batches: ``--batch 4 --seq 32
--steps 12 --ckpt-every 4``, whole, and crashed at step 9
(``--simulate-failure-at``) then resumed (``--resume``).  JAX runs in a
child process with excess precision off (``_torch_jax_ref.py`` mode
``trainloop``).  Then the flags that raised before the distribution
slice: ``--mesh-data``, ``--mesh-model``, ``--fsdp`` and ``--compress``
train (a mesh on gloo ranks the launcher starts), held to the port's
one-device run, and a 2 x 2 run's checkpoint resumes on 4 x 1 and on one
device (``--trace`` on one device is ``tests/test_torch_trace.py``'s, over
a mesh ``tests/test_torch_mesh_opts.py``'s); encoder-decoder archs exit as
the JAX launcher's do.

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
  for bit on each side: the checkpoint restores the parameters exactly;
* a mesh run against the port's one-device run on the rows the mesh
  draws (each rank's block seeded by its row range, as JAX's
  ``sharded_batch`` seeds it): step 0 at rtol 1e-5 (a mean of per-rank
  means), later steps within that one-device run's own flipped-ulp
  witness; a mesh whose ranks compute the same rows, and FSDP on one
  device, bit for bit.
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
from repro_torch.dist import spawn
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


#: the launcher's mesh runs: the seeded reduced qwen, one device and meshes
MESH_ARGS = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
             "--log-every", "1"]
#: the limits of the ranks those runs start: every collective within 60 s,
#: every run joined within 600 s (the launcher's own have no join deadline)
LIMITS = dict(timeout=spawn.DEFAULT_TIMEOUT, join_timeout=600.0)


def _split_batches(k: int):
    """``pipeline.batch`` replaced by the batch a mesh whose batch splits
    over ``k`` ranks trains on: the ranks' row blocks, each drawn by
    ``_tokens_for(cfg, step, start, n)`` as ``sharded_batch`` draws it,
    stacked in rank order (``k = 1``: the one-device batch)."""
    from unittest import mock

    from repro_torch.data import pipeline

    def batch(cfg, step, device="cpu"):
        n = cfg.global_batch // k
        t = np.concatenate([pipeline._tokens_for(cfg, step, r * n, n) for r in range(k)])
        return {"tokens": torch.from_numpy(np.ascontiguousarray(t[:, :-1])),
                "labels": torch.from_numpy(np.ascontiguousarray(t[:, 1:]))}

    return mock.patch.object(pipeline, "batch", batch)


def _losses(args: list[str], tmp_path, flip: bool = False, split: int = 1) -> list[float]:
    """The launcher's losses (a mesh's ranks started by ``main``); ``flip``:
    the one-device witness, one bf16 ulp flipped in every layer-0 input;
    ``split``: a one-device run on the batch of a mesh whose batch splits
    over that many ranks (``_split_batches``)."""
    from unittest import mock

    from repro_torch.models import lm

    real = lm._embed_inputs

    def flipped(*a, **k):
        return (real(*a, **k).view(torch.int16) ^ 1).view(torch.bfloat16)

    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        if flip:
            stack.enter_context(mock.patch.object(lm, "_embed_inputs", flipped))
        if split > 1:
            stack.enter_context(_split_batches(split))
        return train.main([*MESH_ARGS, "--ckpt-dir", str(tmp_path), *args], **LIMITS)["losses"]


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """One-device runs: on the one-device batch, and (``@2``) on the batch
    of a mesh whose batch splits over two ranks."""
    d = tmp_path_factory.mktemp("one_device")
    return {f"{name}{'@2' if split > 1 else ''}":
            _losses(flags, d / f"{name}{split}", flip=name.endswith("flip"), split=split)
            for split in (1, 2)
            for name, flags in (("plain", []), ("plain flip", []), ("compress", ["--compress"]),
                                ("compress flip", ["--compress"]))}


@pytest.mark.parametrize("flags,ref_name,exact", [
    (["--mesh-data", "2"], "plain@2", False),
    (["--mesh-model", "4"], "plain", False),
    (["--fsdp"], "plain", True),
    (["--mesh-data", "2", "--mesh-model", "2", "--fsdp", "--compress"], "compress@2", False)])
def test_mesh_fsdp_and_compress_train(tmp_path, one_device, flags, ref_name, exact):
    """The flags that raised before the distribution slice now train:
    ``--mesh-data 2`` splits the batch over two gloo ranks, each drawing
    its rows as JAX's ``sharded_batch`` does, so it is held to the
    one-device run on those rows (step 0 within 1e-5 relative, then within
    that run's flipped-ulp witness); ``--mesh-model 4`` computes over the
    model axis on four ranks that hold the same rows, its partial sums
    added in another order, so it is held to the one-device run the same
    way; ``--fsdp`` on one device cuts nothing, the one-device run bit for
    bit; ``--compress`` on a 2 x 2 FSDP mesh (the batch over the data
    axis) holds to the one-device compressed run on its rows as
    ``--mesh-data 2`` does."""
    got, want = np.asarray(_losses(flags, tmp_path)), np.asarray(one_device[ref_name])
    assert len(got) == 4
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    base, at, split = ref_name.partition("@")
    witness = float(np.abs(np.asarray(one_device[f"{base} flip{at}{split}"]) - want).max())
    assert float(np.abs(got - want).max()) <= witness


def test_mesh_resume_restores_another_meshes_checkpoint(tmp_path):
    """A 2 x 2 FSDP run crashes after its step-2 checkpoint; a 4 x 1 run and
    a one-device run on the 4 x 1 mesh's rows resume from copies of it
    (elastic restore): the same first loss, within step 0's 1e-5, and every
    later step run."""
    import shutil

    args = [*MESH_ARGS, "--steps", "6", "--ckpt-every", "2"]
    with pytest.raises(RuntimeError, match="simulated node failure at step 3"):
        train.main([*args, "--ckpt-dir", str(tmp_path / "a"), "--mesh-data", "2",
                    "--mesh-model", "2", "--fsdp", "--simulate-failure-at", "3"], **LIMITS)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    with contextlib.redirect_stdout(io.StringIO()):
        four = train.main([*args, "--ckpt-dir", str(tmp_path / "a"), "--mesh-data", "4",
                           "--fsdp", "--resume"], **LIMITS)
        with _split_batches(4):  # the 4 x 1 mesh's rows, drawn per rank
            one = train.main([*args, "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert four["start"] == one["start"] == 2 and len(four["losses"]) == len(one["losses"]) == 4
    assert four["losses"][0] == pytest.approx(one["losses"][0], rel=1e-5)


def test_launcher_mesh_runs_have_no_join_deadline(tmp_path, monkeypatch):
    """The launcher's own ranks are not bound by the tests' limits: no
    join deadline (a run lasts as long as its steps), and a collective
    timeout of torch's default plus the checkpoint's write time, so the
    ranks waiting on rank 0's save are not timed out."""
    import torch.distributed as dist

    from repro_torch.configs import get_config

    seen = {}

    def fake_run(fn, world, argv, **kw):
        seen.update(kw, world=world)
        return [{"final_loss": 1.0}]

    monkeypatch.setattr(spawn, "run", fake_run)
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--mesh-data", "2",
                    "--mesh-model", "2", "--ckpt-dir", str(tmp_path)])
    want = train.collective_timeout(get_config("qwen1.5-0.5b"))
    assert seen == {"backend": "gloo", "timeout": want, "join_timeout": None, "world": 4}
    n_params = 463_987_712  # qwen1.5-0.5b's, at two bytes or more each
    assert want >= dist.default_pg_timeout.total_seconds() + 2 * n_params / train.CKPT_WRITE_RATE


def test_audio_archs_exit_as_jax_does(tmp_path):
    args = train.parser().parse_args(["--arch", "whisper-medium", "--reduced", "--device",
                                      "cpu", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as want:
        jax_train.train_loop(args)
    with pytest.raises(SystemExit) as got:
        train.train_loop(args)
    assert str(got.value) == str(want.value) != ""
