"""The paged engine's options over a mesh of ranks — speculation, the page
guard, the kernel fallback and fault plans — against the JAX package's
``PagedEngine(mesh=)``, on the reduced qwen1.5-1.8b target with its
reduced 0.5b draft (and the launcher on the reduced qwen1.5-0.5b), JAX's
parameters converted by ``from_jax_params``.

The cases (``meshopt_cases`` of ``_torch_dist_ref.py``) run on both
packages: JAX's in one child process on 4 forced host devices under
``backend=pallas`` with excess precision off (mode ``meshopts``), the
port's in one world of 4 gloo ranks and one of 2, started once for every
test here (``serve_mesh_opts`` of ``_torch_dist_ranks.py``):

* speculation with the n-gram draft (k = 2) and the model draft (k = 4)
  over 4 and 2 ranks, and with the target as its own draft over 2 (the
  one whose proposals are accepted); a model draft runs on every rank and
  each slot's drafts are its owner's, shared before the verify step;
* int8 pools under ``kv_guard`` with a corrupted chain (4 ranks), and over
  2 ranks: a cross-rank fork under speculation, ``page.corrupt`` on rank
  0's chain that rank 1's shard then hits, ``kernel.raise`` on rank 1's
  prefill and ``kernel.nan`` on a decode step under ``kernel_fallback``,
  ``pool.alloc`` exhaustion and ``swap.drop`` under ``kv_guard`` where the
  preempted request comes back on the other rank, and an injected raise
  without the fallback, where JAX's engine raises and so does every rank;
* on every rank the streams, the fired log, the failed requests and the
  flat ``stats()`` equal JAX's mesh engine's and the port's one-device
  engine's; after every run every page each rank holds equals the
  one-device engine's page of the same run, bit for bit; ``check()``
  passes on every rank;
* the launcher's ``--mesh`` with each option, and with all of them through
  ``main``, prints JAX's launcher's stdout with ``--mesh`` and the same
  flags;
* a step that fails on one rank of 2 and is not retried ends both ranks
  with the same ``MeshStepFailed`` in a fraction of the collective
  timeout;
* the training launcher's ``--mesh-data 2 --trace`` writes one trace, rank
  0's, with its step spans, and its losses equal the untraced run's.

Stated tolerance: none — streams, counters and pages are held equal, as
``tests/test_torch_mesh_serve.py`` holds them.
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from _torch_dist_ref import (OPTS_DRAFT, OPTS_FLAGS, OPTS_TARGET, meshopt_cases,
                             opts_launch_args, reference)
from _torch_jax_ref import SEED, params_checksum
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.dist import spawn
from repro_torch.launch import serve as launcher
from repro_torch.launch import train
from repro_torch.weights import from_jax_params

CPU = ["--device", "cpu"]


def _converted(arch: str):
    jparams = jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))
    return jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def model():
    """(the target's JAX and port params, the draft's, the launcher's
    reduced qwen1.5-0.5b's: the draft's own)."""
    torch.set_num_threads(1)  # beside the suite's other workers
    target, draft = _converted(OPTS_TARGET), _converted(OPTS_DRAFT)
    return {"target": target, "draft": draft, "small": draft}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, model):
    out = reference("meshopts", tmp_path_factory.mktemp("jax_mesh_opts"))
    assert float(out["target_checksum"]) == params_checksum(model["target"][0])
    assert float(out["draft_checksum"]) == params_checksum(model["draft"][0])
    return json.loads(str(out["serve_json"]))


def _json(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def ranks4(model):
    argv = {name: [*opts_launch_args(name), *CPU] for name in OPTS_FLAGS if name != "all"}
    return spawn.run(ranks.serve_mesh_opts, 4, 4, model["target"][1], model["draft"][1],
                     model["small"][1], argv)


@pytest.fixture(scope="module")
def ranks2(model):
    return spawn.run(ranks.serve_mesh_opts, 2, 2, model["target"][1], model["draft"][1],
                     model["small"][1], None)


@pytest.fixture(scope="module")
def one_device(model):
    """The same cases on one device: (the cases by rank count, every
    engine built, in order)."""
    cfg = get_config(OPTS_TARGET, reduced=True)
    drafts = {OPTS_DRAFT: (get_config(OPTS_DRAFT, reduced=True), model["draft"][1]),
              OPTS_TARGET: (cfg, model["target"][1])}
    built, out = {}, {}
    for n in (4, 2):
        built[n] = []
        out[n] = _json(meshopt_cases(ranks.port_serve_api(cfg, model["target"][1], None,
                                                          built[n], drafts=drafts), n))
    return out, built


CASES = {4: ("spec_ngram", "spec_model", "int8_guard"),
         2: ("spec_ngram", "spec_model", "spec_self", "spec_fork", "guard_corrupt", "fallback",
             "alloc",
             "swap_drop", "guarded_swap", "raise_unretried")}
PARAMS = [(n, case) for n, cases in CASES.items() for case in cases]


def _group(n, ranks4, ranks2):
    return ranks4 if n == 4 else ranks2


@pytest.mark.parametrize("n,case", PARAMS, ids=[f"{n}ranks-{c}" for n, c in PARAMS])
def test_every_rank_equals_jax_mesh_engine_and_one_device(ref, ranks4, ranks2, one_device,
                                                          n, case):
    want = ref["cases"][f"mesh{n}"][case]
    for r in _group(n, ranks4, ranks2):
        got = _json(r["cases"][case])
        if "stats" in want:  # the port's flat stats have keys JAX's lack
            assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]
        assert {**got, "stats": want.get("stats")} == {**want, "stats": want.get("stats")}
        assert got == one_device[0][n][case]


def test_each_case_ran_its_option(ref):
    """What each case is there for happened in JAX's run (the port's equal
    it, above)."""
    c4, c2 = ref["cases"]["mesh4"], ref["cases"]["mesh2"]
    for cases in (c4, c2):
        # neither the n-gram draft nor the random-weight draft is accepted
        # here: each round commits the verify step's free token, rolls back
        for name in ("spec_ngram", "spec_model"):
            st = cases[name]["stats"]
            assert st["spec_rounds"] > 0 and st["spec_accepted"] == 0 < st["spec_rollbacks"]
    for name in ("spec_self", "spec_fork"):  # the target as its own draft
        st = c2[name]["stats"]
        assert st["spec_accepted"] > st["spec_drafted"] / 2
    assert c4["int8_guard"]["stats"]["quarantined_pages"] > 0
    assert c2["spec_fork"]["stats"]["pool_cow_copies"] >= 1
    assert c2["guard_corrupt"]["fired"] == [["page.corrupt", 0]]
    assert c2["guard_corrupt"]["stats"]["quarantined_pages"] > 0
    assert c2["fallback"]["stats"]["kernel_fallbacks"] == 2
    assert sorted(c2["fallback"]["fired"]) == [["kernel.nan", 4], ["kernel.raise", 1]]
    assert c2["alloc"]["fired"] == [["pool.alloc", 3]]
    assert c2["swap_drop"]["stats"]["swap_dropped"] == 1
    for name in ("alloc", "swap_drop", "guarded_swap"):
        assert c2[name]["stats"]["preempted"] >= 1
    assert c2["raise_unretried"]["error"] == \
        "InjectedFault: injected kernel fault in decode"


def test_every_page_equals_the_one_device_engines(ranks4, ranks2, one_device):
    """After each run, every page a rank holds (its own, not mirrors) is
    the one-device engine's page of the same run, bit for bit."""
    for n, group in ((4, ranks4), (2, ranks2)):
        built = one_device[1][n]
        for i, eng in enumerate(built):
            got = {}
            for r in group:
                got.update(r["pages"][i])
            assert sorted(got) == list(range(1, eng.pool.num_pages))
            for pid in got:
                np.testing.assert_array_equal(got[pid], eng._pack([pid]).numpy(),
                                              err_msg=f"{n} ranks, engine {i}, page {pid}")


@pytest.mark.parametrize("name", [n for n in OPTS_FLAGS if n != "all"])
def test_launcher_mesh_option_stdout_equals_jax(ref, ranks4, name):
    """The launcher's ranks with each option: rank 0's streams print JAX's
    launcher's ``--mesh`` stdout with the same flag."""
    assert ranks4[0]["launch"][name] == ref["launch"][name]


def test_launcher_main_with_every_option_equals_jax(model, ref):
    """Every option at once through ``main``, which starts the ranks: JAX's
    stdout, or the error JAX's launcher raises, raised here."""
    from _torch_dist_ref import launch_or_error

    def launch(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            launcher.main(args, params=model["small"][1], timeout=spawn.DEFAULT_TIMEOUT,
                          join_timeout=600.0)
        return buf.getvalue()

    assert launch_or_error(launch, [*opts_launch_args("all"), *CPU]) == ref["launch"]["all"]


@pytest.mark.parametrize("fallback", [False, True])
def test_unretried_failure_on_one_rank_ends_both(ranks2, fallback):
    """A step that raises on rank 1 only — any error without the fallback,
    a kernel that cannot be launched with it — ends both ranks with one
    named error long before the 60 s collective timeout."""
    errs = [r["unretried"][f"fallback={fallback}"] for r in ranks2]
    want = ("MeshStepFailed: model step 'cold_prefill' failed on mesh rank(s) [1] and is not "
            "retried; every rank stops")
    assert [e["error"] for e in errs] == [want, want]
    assert [e["cause"] for e in errs] == [None, "KernelUnavailable" if fallback else "ValueError"]
    assert max(e["seconds"] for e in errs) < 20.0


def test_train_mesh_trace_records_rank_zero(ranks2, tmp_path):
    """``--mesh-data 2 --trace``: one trace, rank 0's (one ``train.step``
    span per step), its losses the untraced 2-rank run's."""
    from repro_torch.obs import analyze, export

    path = tmp_path / "train.json"
    with contextlib.redirect_stdout(io.StringIO()):
        got = train.main([*ranks.TRACE_TRAIN_ARGS, "--ckpt-dir", str(tmp_path / "ckpt"),
                          "--trace", str(path)], timeout=spawn.DEFAULT_TIMEOUT,
                         join_timeout=600.0)
    assert got["losses"] == ranks2[0]["train_losses"] == ranks2[1]["train_losses"]
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".json"] == ["train.json"]
    trace = export.validate_trace(export.load(str(path)))
    assert trace["metadata"]["mesh"] == {"data": 2, "model": 1}
    steps = [e for e in trace["traceEvents"] if e["name"] == "train.step"]
    assert [(e["args"]["step"], e["args"]["rank"]) for e in steps] == [(0, 0), (1, 0)]
    assert analyze.analyze(trace)["kernel_dispatch_matmul_tiled"] > 0
