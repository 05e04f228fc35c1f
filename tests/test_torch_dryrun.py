"""The port's dry run (``repro_torch.launch.dryrun``) and its step analysis
(``repro_torch.launch.hlo``) on ``meta`` tensors, held to the JAX
package's ``launch/dryrun.py`` and ``launch/hlo.py``.

The JAX side comes from one child process (mode ``dryrun`` of
``_torch_dist_ref.py``, 8 forced host devices): the compiled steps of
the reduced qwen1.5-0.5b's cells (``_torch_dist_tp.DRY_CELLS``: train
plain, FSDP and compressed, prefill, decode) on the 2 x 2 and (2, 2, 2)
debug meshes, their ``memory_summary`` and collective counts, and the
one-device prefill's ``dot_flops`` of the reduced qwen and moonshot.

* per-device argument bytes: the port's ``memory_summary(...)
  ["argument_size_in_bytes"]`` (rank 0's pieces of every input) equals
  XLA's for every cell — exactly;
* dot FLOPs: the port's one-device prefill (``FlopCounterMode``) equals
  JAX's ``analyze_compiled(...)["dot_flops"]`` — exactly;
* FSDP makes more all-gathers than no FSDP, in both packages;
* collectives against XLA's compiled steps: the prefill's all-reduces
  equal XLA's in count and bytes, and the 2 x 2 train step's all-reduces
  are XLA's but for the differences itemised in its test;
* a model function whose leaf the axis cuts along a dimension it does
  not compute over raises;
* every applicable cell of qwen1.5-0.5b at full width on both production
  meshes is ``ok``; the cells ``--all`` runs are JAX's applicable ones;
  a record's keys are JAX's (``trace_s`` in place of ``lower_s`` and
  ``compile_s``; the memory summary without JAX's
  ``generated_code_size_in_bytes`` and ``alias_size_in_bytes``);
* every leaf the model axis cuts for qwen1.5-0.5b on (16, 16) holds at
  most 1/16 of its bytes on a device.

Everything here is exact: no tolerance is stated.
"""

import dataclasses
import json

import pytest

import _torch_dist_tp as tpr
from _torch_dist_ref import reference
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import applicable as jax_applicable
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.dist import sharding
from repro_torch.dist.step import build_step
from repro_torch.launch import dryrun, hlo
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh, seat
from repro_torch.models import lm
from repro_torch.nn.spec import abstract_params


@pytest.fixture(scope="module")
def jax_dry(tmp_path_factory):
    out = reference("dryrun", tmp_path_factory.mktemp("jax_dist_dryrun"))
    return json.loads(str(out["dryrun_json"]))


def _record(cfg, shape_name: str, mesh, kw):
    kind, seq, batch = tpr.DRY_SHAPES[shape_name]
    bundle = build_step(cfg, ShapeCfg(shape_name, kind, seq, batch),
                        mesh=None if mesh is None else seat(mesh), **kw)
    return hlo.record_step(bundle.fn, bundle.local_inputs())


@pytest.fixture(scope="module")
def port_dry():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    out = {}
    for mname, (data, model, pod) in tpr.DRY_MESHES.items():
        mesh = make_debug_mesh(data, model, pod=pod)
        for cname, (shape, kw) in tpr.DRY_CELLS.items():
            out[f"{mname}/{cname}"] = _record(cfg, shape, mesh, kw)
    return out


CELL_IDS = [f"{m}/{c}" for m in tpr.DRY_MESHES for c in tpr.DRY_CELLS]


@pytest.mark.parametrize("cell", CELL_IDS)
def test_argument_bytes_per_device_match_jax(port_dry, jax_dry, cell):
    got = hlo.memory_summary(port_dry[cell])
    want = jax_dry["cells"][cell]["memory"]
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"], cell
    assert got["argument_mb_per_device"] == pytest.approx(want["argument_mb_per_device"])


@pytest.mark.parametrize("mesh", list(tpr.DRY_MESHES))
def test_fsdp_makes_more_all_gathers(port_dry, jax_dry, mesh):
    """JAX's ``scenario_fsdp_weight_gather_collectives``: FSDP's weight
    fetch adds all-gathers, in the compiled HLO and in the port's
    recorded step."""
    def port(cell):
        return hlo.analyze_step(port_dry[cell], 8)["collective_counts"].get("all-gather", 0)

    def jax(cell):
        return jax_dry["cells"][cell]["counts"].get("all-gather", 0)

    for count in (port, jax):
        assert count(f"{mesh}/train_fsdp") > count(f"{mesh}/train"), count.__name__


#: the reduced qwen's layers
N_LAYERS = get_config("qwen1.5-0.5b", reduced=True).n_layers


def _all_reduces(rec, *, axis: str | None = None, site: str | None = None) -> tuple[int, int]:
    """(count, bytes) of the all-reduces recorded over ``axis`` from
    ``site`` (None: any)."""
    n = b = 0
    for op, ax, nbytes, count, s in rec.collectives:
        if op == "all-reduce" and axis in (None, ax) and site in (None, s):
            n, b = n + count, b + nbytes
    return n, b


@pytest.mark.parametrize("mesh", list(tpr.DRY_MESHES))
def test_serving_collectives_match_jax(port_dry, jax_dry, mesh):
    """The prefill's all-reduces — 2 a block (the row-parallel ``wo`` and
    ``w_out``) and the vocab-parallel embedding's — equal XLA's in count
    and bytes.  On (2, 2, 2) XLA also moves the token ids and the embedded
    rows between ranks (2 collective-permutes: GSPMD reshards the batch),
    which the port, whose rank reads its own rows, does not.  The decode
    step runs replicated: no collective in either."""
    got = hlo.analyze_step(port_dry[f"{mesh}/prefill"], 8)
    want = jax_dry["cells"][f"{mesh}/prefill"]
    assert got["collective_counts"] == {"all-reduce": 2 * N_LAYERS + 1}
    assert want["counts"]["all-reduce"] == got["collective_counts"]["all-reduce"]
    assert want["bytes"]["all-reduce"] == got["collective_bytes_by_op"]["all-reduce"]
    assert {k: v for k, v in want["counts"].items() if k != "all-reduce"} == \
        ({} if mesh == "2x2" else {"collective-permute": 2})
    decode = hlo.analyze_step(port_dry[f"{mesh}/decode"], 8)["collective_counts"]
    assert decode == {} == jax_dry["cells"][f"{mesh}/decode"]["counts"]


def test_train_all_reduces_match_jax_itemised(port_dry, jax_dry):
    """The 2 x 2 train step (FSDP off) against XLA's compiled step.

    Counts: the port's model-axis all-reduces are XLA's: per layer 2
    forward (the row-parallel ``wo`` and ``w_out``) and 2 backward (one
    per input of column-parallel projections, q / k / v and gate / in:
    XLA's tuple all-reduces), and 6 more (the embedding; the cross
    entropy's maximum, sum of exponentials and gold logit; the head
    input's gradient; the global norm).  XLA's other ``N_LAYERS + 1`` are
    over the data axis: it means each layer's gradients in that layer's
    backward iteration and the others once, where the port means every
    gradient piece in one collective.

    Bytes: JAX's analysis gives a tuple-shaped collective no bytes (it
    reads the result's array shape), so XLA's figure is the port's
    model-axis bytes less what XLA puts in tuples — the column-parallel
    input gradients, the gold logit (beside the loss's scalars) — and
    less the port's norm, which all-reduces each cut leaf's sum of squares
    (124 bytes) where XLA all-reduces their sum (one fp32 scalar, 4).

    The FSDP, compressed and (2, 2, 2) train cells are not itemised: GSPMD
    partitions those steps otherwise (all-to-alls; collective-permutes
    that reshard activations), so of them only FSDP's extra all-gathers
    are held (:func:`test_fsdp_makes_more_all_gathers`)."""
    rec, want = port_dry["2x2/train"], jax_dry["cells"]["2x2/train"]
    model_n, model_b = _all_reduces(rec, axis="model")
    assert (model_n, _all_reduces(rec, axis="data")[0]) == (4 * N_LAYERS + 6, 1)
    assert want["counts"] == {"all-reduce": model_n + N_LAYERS + 1}
    _, seq, batch = tpr.DRY_SHAPES["dtrain"]
    gold = batch // 2 * seq * 4  # the rank's (rows, seq) fp32
    tuples = _all_reduces(rec, site="tp.col_linears")[1] + gold
    assert want["bytes"] == {"all-reduce": model_b - tuples - _all_reduces(rec, site="step.norm")[1]
                             + 4}


@pytest.mark.parametrize("arch", tpr.FLOP_ARCHS)
def test_one_device_prefill_dot_flops_match_jax(jax_dry, arch):
    rec = _record(get_config(arch, reduced=True), "dprefill", None, {})
    assert hlo.analyze_step(rec, 1)["dot_flops"] == jax_dry["flops"][arch]


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_qwen_full_width_cells_are_ok(multi):
    for shape in JAX_SHAPES:
        rec = dryrun.run_cell("qwen1.5-0.5b", shape, multi_pod=multi, verbose=False)
        ok = jax_applicable(jax_config("qwen1.5-0.5b"), shape)[0]
        assert rec["status"] == ("ok" if ok else "skipped"), (shape, rec)
        if ok:
            assert rec["mesh_shape"] == dict(make_production_mesh(multi_pod=multi).shape)
            mem = rec["memory"]
            assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
            assert rec["hlo"]["dot_flops"] > 0
            if shape != "decode_32k":  # the decode step runs replicated
                assert rec["hlo"]["collective_counts"]["all-reduce"] > 0


def test_all_runs_jax_applicable_cells():
    want = [(a, s) for a in JAX_ARCHS for s in JAX_SHAPES
            if jax_applicable(jax_config(a), s)[0]]
    assert dryrun.cells(True, None, None) == want
    skipped = {(a, s) for a in JAX_ARCHS for s in JAX_SHAPES} - set(want)
    for arch, shape in skipped:
        rec = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
        assert rec["status"] == "skipped"
        assert rec["reason"] == jax_applicable(jax_config(arch), shape)[1]


#: JAX's record keys (``launch/dryrun.py``'s ``run_cell``)
JAX_RECORD = {"arch", "shape", "mesh", "mesh_shape", "status", "lower_s", "compile_s", "fsdp",
              "compress", "memory", "cost", "hlo"}
JAX_HLO = {"dot_flops", "collective_bytes", "collective_counts", "collective_bytes_by_op",
           "result_bytes"}
JAX_ANALYSIS = JAX_HLO | {"unknown_trip_whiles", "n_devices", "global_collective_bytes"}
JAX_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes", "alias_size_in_bytes", "argument_mb_per_device",
              "temp_mb_per_device"}


def test_record_keys_are_jax(port_dry):
    rec = dryrun.run_cell("mamba2-780m", "long_500k", multi_pod=True, verbose=False)
    assert set(rec) == JAX_RECORD - {"lower_s", "compile_s"} | {"trace_s"}
    assert set(rec["hlo"]) == JAX_HLO
    assert set(rec["memory"]) == JAX_MEMORY - {"generated_code_size_in_bytes",
                                               "alias_size_in_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
    assert set(hlo.analyze_step(port_dry["2x2/train"], 4)) == JAX_ANALYSIS


def test_cut_leaves_hold_a_sixteenth_per_device():
    """qwen1.5-0.5b on (16, 16): every leaf the rules cut over the model
    axis holds at most 1/16 of its bytes on each device, FSDP or not."""
    cfg = get_config("qwen1.5-0.5b")
    mesh = make_production_mesh()
    spec = lm.model_spec(cfg)
    full = abstract_params(spec)
    for fsdp in (False, True):
        pl = sharding.param_shardings(cfg, spec, mesh, fsdp=fsdp)
        mine = sharding.local_tree(full, pl, mesh)
        cut = 0
        for x, piece, p in zip(tree.leaves(full), tree.leaves(mine), tree.leaves(pl)):
            if "model" in p.spec:
                cut += 1
                assert 16 * piece.numel() <= x.numel(), p
        assert cut > 0


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-780m"])
def test_a_leaf_cut_where_the_function_does_not_compute_raises(monkeypatch, arch):
    """The rules' repair can move the model axis to a dimension a model
    function does not compute over: 3 experts do not divide 2 ranks, so
    the axis cuts the experts' ``ff``; an SSD block (its ``rnn`` rule let
    through below d_model 2,048) has no model-axis path.  Each function
    raises rather than compute a wrong result."""
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=3))
    else:
        monkeypatch.setattr(sharding, "_RNN_TP_MIN_D_MODEL", cfg.d_model)
    with pytest.raises(NotImplementedError, match="the model axis cuts"):
        _record(cfg, "dtrain", make_debug_mesh(1, 2), {})


def test_a_cell_that_errs_exits_one(monkeypatch, capsys):
    """A failing cell is reported as an error and the run exits 1, as
    JAX's does."""
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "run_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k"])
    assert e.value.code == 1
    assert "0 ok, 0 skipped (documented), 1 errors" in capsys.readouterr().out
