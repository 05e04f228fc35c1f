"""The port's mesh steps computing over the model axis, on gloo ranks on
the CPU, held to the port's one-device steps and to the JAX package.

Each group of ranks starts once per module (``repro_torch.dist.spawn.run``;
the rank functions are ``_torch_dist_tp.py``'s), and the JAX references
come from one child process (mode ``tp`` of ``_torch_dist_ref.py``, 8
forced host devices):

* the reduced qwen1.5-0.5b's train step on 1 x 2 and 2 x 2 meshes, FSDP
  off and on; the reduced gemma2-9b (GQA 4:2), moonshot-v1-16b-a3b
  (experts over the model axis), recurrentgemma-2b (its RG-LRU channels
  over the model axis: the floor of the ``rnn`` rule, d_model 2,048, is
  lowered to the reduced 64 in the ranks that run it) and whisper-medium
  on 2 x 2, FSDP off; and the reduced mamba2-780m on a (2, 2, 2) mesh,
  whose batch spreads over (data, model) — a group over two axes of
  three, which ``BoundMesh.group`` refused before it built such groups;
* the recorder of every collective (``repro_torch.dist.tp``): no leaf the
  rules cut over the model axis is gathered over it, and one forward
  makes the all-reduces the model predicts — 2 a dense block, 4 an
  RG-LRU block with its MLP, 2 an MoE block (attention's, and the routed
  and shared experts' partial sums in one), 1 the vocab-parallel
  embedding and 3 the cross entropy (its maximum, sum of exponentials and
  gold logit); an MoE layer also all-gathers its router's logits;
* the mesh prefill of the reduced qwen on 2 x 2: every rank's pieces
  gathered against the one-device prefill and JAX's ``build_prefill_step``
  on the same debug mesh;
* the decode step over a mesh, with FSDP, runs replicated: each rank's
  logits are the one-device step's, bit for bit;
* the repaired groups over some of a mesh's axes, and the multicast
  modes' collective-permute counts at N = 8 as the recorder counts them:
  JAX's 7 / 3 / 0 (``tests/test_mcast.py``).

Stated tolerances (``tests/test_torch_dist.py``'s gates, unchanged):

* step 0's loss: rtol 1e-5 of the one-device step's and of JAX's (the
  learning rate is 0 at step 0); whisper's one-device loss is further
  from JAX's (ROADMAP Queue 3 entry 23: the encoder-decoder runs differ
  from JAX's beyond the bf16 tolerance), and its mesh step is held to
  JAX's within that gap plus 1e-5 relative;
* steps 1-3: the largest |mesh - one-device| loss gap within the largest
  gap the witness opens (the one-device run with one bf16 ulp flipped in
  every layer-0 input element; for whisper, its decoder's and its
  frames'): the partial sums of row-parallel products, the vocab-parallel
  cross entropy's and the gradients' reductions add in another order,
  which moves a bf16 rounding as a flipped ulp does.  whisper's reduced
  run amplifies any one-ulp flip past step 1 (ROADMAP Queue 3 entry 34:
  flips of different element sets open step-3 loss gaps from 0.001 to
  0.016 on one device), so its witness is the largest gap of twelve
  one-device runs — one ulp flipped in the layer-0 input, or in the
  gradient that reaches it, each over six element sets
  (``tpr.WITNESSES``);
* every final leaf: the largest and the mean |mesh - one-device| element
  gap within the witness's (whisper's: the largest of its twelve);
* the prefill's logits: rtol 2e-2 and atol 2e-2 x max |logit|
  (``tests/test_torch_moe.py``'s whole-model tolerance), the greedy
  argmax equal.

Everything else is exact.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_dist_tp as tpr
from _torch_dist_ref import reference
from _torch_jax_ref import SEED, params_checksum
from repro.configs import get_config as jax_config
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.dist import spawn
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.weights import from_jax_encdec_params, from_jax_params

ALL = (*tpr.ARCHS, tpr.MAMBA)
CASES = [("qwen1.5-0.5b", (1, 2), False), ("qwen1.5-0.5b", (1, 2), True),
         ("qwen1.5-0.5b", (2, 2), False), ("qwen1.5-0.5b", (2, 2), True),
         *[(a, (2, 2), False) for a in tpr.ARCHS[1:]], (tpr.MAMBA, (2, 2, 2), False)]
TP_CASES = CASES[:-1]
MODEL = 2e-2  # whole-model logits: rtol, and atol as a share of max |logit|


def _id(case) -> str:
    arch, mesh, fsdp = case
    return f"{arch}-{'x'.join(map(str, mesh))}{'-fsdp' if fsdp else ''}"


@pytest.fixture(scope="module")
def jparams():
    out = {}
    for arch in ALL:
        cfg = jax_config(arch, reduced=True)
        mod = jax_encdec if cfg.family == "audio" else jax_lm
        out[arch] = mod.init(cfg, jax.random.PRNGKey(SEED))
    return out


@pytest.fixture(scope="module")
def params(jparams):
    return {a: (from_jax_encdec_params if get_config(a, reduced=True).family == "audio"
                else from_jax_params)(jax.device_get(p), device="cpu")
            for a, p in jparams.items()}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, jparams):
    out = reference("tp", tmp_path_factory.mktemp("jax_dist_tp"))
    for arch in ALL:
        assert float(out[f"checksum/{arch}"]) == params_checksum(jparams[arch]), arch
    return out


def _by_key(results: list[dict]) -> dict:
    return {k: [r[k] for r in results] for k in results[0]}


@pytest.fixture(scope="module")
def runs(params):
    """Every mesh case, rank by rank, and the other rank results."""
    out = _by_key(spawn.run(tpr.two_ranks, 2, params))
    out.update(_by_key(spawn.run(tpr.four_ranks, 4, params)))
    eight = _by_key(spawn.run(tpr.eight_ranks, 8, params))
    out[(tpr.MAMBA, (2, 2, 2), False)] = eight.pop("mamba")
    out.update(eight)
    return out


@pytest.fixture(scope="module")
def alone(params):
    """Each arch's one-device run and its witnesses (whisper's twelve:
    ROADMAP Queue 3 entry 34)."""
    torch.set_num_threads(1)  # one thread, as each rank runs
    return {a: {"plain": tpr.alone(a, params[a]),
                "flips": [tpr.alone(a, params[a], flip=f)
                          for f in tpr.WITNESSES.get(a, tpr.WITNESS)]}
            for a in ALL}


# -- the train step ------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_id)
def test_step0_loss_matches_one_device_and_jax(runs, alone, jax_ref, case):
    arch = case[0]
    want, jax_loss = alone[arch]["plain"]["losses"][0], float(jax_ref[f"loss0/{arch}"])
    # whisper's one-device runs sit further from JAX's (ROADMAP Queue 3
    # entry 23): the mesh step may add 1e-5 to that gap, no more
    slack = abs(want - jax_loss) if arch == "whisper-medium" else 0.0
    assert abs(want - jax_loss) <= slack + 1e-5 * abs(jax_loss)
    if arch == tpr.MAMBA:  # JAX's step on the same (2, 2, 2) mesh
        jax_loss = float(jax_ref["mesh_loss0/mamba"])
    for r in runs[case]:
        assert r["losses"][0] == pytest.approx(want, rel=1e-5)
        assert abs(r["losses"][0] - jax_loss) <= slack + 1e-5 * abs(jax_loss)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_four_steps_within_the_flipped_ulp_witness(runs, alone, case):
    a = alone[case[0]]
    ref = np.asarray(a["plain"]["losses"])
    witness = max(float(np.abs(np.asarray(f["losses"]) - ref).max()) for f in a["flips"])
    assert witness > 0
    losses = [np.asarray(r["losses"]) for r in runs[case]]
    for got in losses:
        np.testing.assert_array_equal(got, losses[0])  # every rank reports the same loss
        assert float(np.abs(got - ref).max()) <= witness, (got, ref, witness)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_final_leaves_within_the_flipped_ulp_witness(runs, alone, case):
    a = alone[case[0]]
    plain = a["plain"]["params"]
    got = runs[case][0]["params"]
    assert got.keys() == plain.keys()
    for k in plain:
        witnesses = [np.abs(f["params"][k] - plain[k]) for f in a["flips"]]
        most, mean = max(w.max() for w in witnesses), max(w.mean() for w in witnesses)
        gap = np.abs(got[k] - plain[k])
        assert gap.max() <= most, (k, gap.max(), most)
        assert gap.mean() <= mean, (k, gap.mean(), mean)


@pytest.mark.parametrize("case", TP_CASES, ids=_id)
def test_no_leaf_cut_over_the_model_axis_is_gathered_over_it(runs, case):
    """The step computes over the axis: its leaves cut over ``model`` stay
    cut (FSDP's gathers over ``data`` only), in the forward and in the
    whole step 0."""
    for r in runs[case]:
        assert r["model_axis"] and r["model_cut"] > 0
        for tally in (r["forward"], r["step0"]):
            assert tally.get(("all-gather", "model", "sharding.gather"), 0) == 0
            fsdp = tally.get(("all-gather", "data", "sharding.gather"), 0)
            assert (fsdp > 0) == (case[2] and case[1][0] > 1)


def _predicted(arch: str) -> dict:
    """The forward's collectives over the model axis that the model makes
    on a 2-way axis (every reduced leaf below divides it)."""
    cfg = get_config(arch, reduced=True)
    per = {"attn": 1, "rglru": 3, "mlp": 1, "moe": 1, "none": 0}
    if cfg.family == "audio":
        reduce = 2 * cfg.encoder.n_layers + 3 * cfg.n_layers
    else:
        reduce = sum(per[bd.mixer] + per[bd.ff] for bd in cfg.layer_defs)
    out = {"all-reduce": reduce + 1 + 3}  # + the embedding + the cross entropy
    n_moe = sum(bd.ff == "moe" for bd in cfg.layer_defs)
    if n_moe:
        out["all-gather"] = n_moe  # each router's logits
    return out


@pytest.mark.parametrize("case", TP_CASES, ids=_id)
def test_forward_makes_the_all_reduces_the_model_predicts(runs, case):
    want = _predicted(case[0])
    if case[0] == "qwen1.5-0.5b":  # a dense block: 2
        assert want == {"all-reduce": 2 * get_config(case[0], reduced=True).n_layers + 4}
    for r in runs[case]:
        got = {}
        for (op, axis, _), n in r["forward"].items():
            if axis == "model":
                got[op] = got.get(op, 0) + n
        assert got == want


def test_mamba_spreads_its_batch_over_data_and_model(runs):
    """mamba2 leaves the model axis idle (d_model below the rnn rule's
    floor), so its batch spreads over (data, model) and the step computes
    no leaf over that axis: the one leaf the rules still cut over it, the
    vocabulary table, is gathered on use, as GSPMD gathers it."""
    for r in runs[(tpr.MAMBA, (2, 2, 2), False)]:
        assert r["batch_axes"] == ("data", "model") and not r["model_axis"]
        assert r["model_cut"] == 1
        assert r["step0"][("all-gather", "model", "sharding.gather")] == 1
        assert r["step0"][("all-reduce", "data+model", "step.mean")] == 1


def test_groups_over_some_axes_of_the_mesh(runs):
    """``BoundMesh.group`` over two of (pod, data, model) = (2, 2, 2): the
    ranks that share this rank's coordinate on the third axis."""
    mesh = make_debug_mesh(2, 2, pod=2)
    for rank, groups in enumerate(runs["groups"]):
        me = mesh.coords(rank)
        for axes, members in groups.items():
            (other,) = [a for a in mesh.axis_names if a not in axes]
            assert members == [r for r in range(8) if mesh.coords(r)[other] == me[other]]


# -- the serving steps ----------------------------------------------------------

def test_mesh_prefill_matches_one_device_and_jax(runs, params, jax_ref):
    """The 2 x 2 prefill's logits, gathered over the vocabulary and the
    batch rows, against the one-device prefill and JAX's prefill on the
    same debug mesh; each rank's pieces: its 4 rows, its half of the
    vocabulary, its 2 of the 4 kv heads."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    got = runs["prefill"][0]["logits"]
    with torch.no_grad():
        want = lm.prefill(params["qwen1.5-0.5b"], cfg, tpr.prefill_tokens(cfg))[0].numpy()
    jax_logits = jax_ref["prefill_logits"]
    for ref in (want, jax_logits):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=MODEL, atol=MODEL * np.abs(ref).max())
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    for r in runs["prefill"]:
        assert r["piece"] == (4, 1, cfg.vocab // 2)
        assert r["cache_k"] == (4, 16, cfg.attn.n_kv_heads // 2, cfg.attn.head_dim)


def test_mesh_decode_with_fsdp_runs_replicated(runs, params):
    """``build_decode_step(mesh=, fsdp=True)`` on two ranks: every rank
    holds the whole inputs and returns the one-device step's logits."""
    want = tpr.decode_alone(params["qwen1.5-0.5b"])
    for got in runs["decode"]:
        np.testing.assert_array_equal(got, want)


# -- the collectives ------------------------------------------------------------

@pytest.mark.parametrize("mode,rounds", [("unicast", 7), ("sw_tree", 3), ("hw", 0)])
def test_mcast_collective_permutes_at_eight_ranks(runs, mode, rounds):
    for r in runs["mcast"]:
        for kind in ("bcast", "gather"):
            tally = r[f"{kind}/{mode}"]
            assert tally.get(("collective-permute", "data", "mcast"), 0) == rounds
        if mode == "hw":  # one collective each: JAX's psum, an all-gather
            assert r["bcast/hw"] == {("all-reduce", "data", "mcast"): 1}
            assert r["gather/hw"] == {("all-gather", "data", "mcast"): 1}
