"""The port's distribution on ``torch.distributed`` over gloo ranks on the
CPU: the multicast collectives, the sharded batch, the mesh train step
and elastic restore, held to the JAX package's figures and to the port's
one-device step.

Each group of ranks is started once per module by
``repro_torch.dist.spawn.run`` (a ``FileStore`` in a temporary
directory; every collective times out after ``spawn.DEFAULT_TIMEOUT`` =
60 s, and the ranks are joined within 600 s and killed if one fails), and
the rank functions of ``_torch_dist_ranks.py`` return their results to
the many small tests below:

* the three modes at N = 4, delivering rank 0's payload exactly: the
  broadcast's point-to-point rounds 3 / 2 / 0 (``unicast`` / ``sw_tree``
  / ``hw``), the weight gather equal to ``all_gather`` (ring 3 rounds,
  recursive doubling 2, one collective 0), ``mcast_matmul`` equal to
  ``x @ w``; and once at N = 8 the broadcast hierarchy 7 / 3 / 0, JAX's
  own figures (``tests/test_mcast.py``);
* ``DeviceMesh`` places rank r at the row-major coordinates
  ``Mesh.coords`` gives;
* the broadcast from every source index of the 4 ranks, in its mode's
  rounds;
* ``sharded_batch``: each rank's rows are JAX's draw for its row range,
  ``_tokens_for(cfg, step, start, n)``, bit for bit, and the ranks' blocks
  tile the batch, on 4 x 1 and 2 x 2 meshes, the batch split over the data
  axis, over both axes and over none (the mesh-step tests feed each rank
  its rows of ``global_batch_np`` instead, ``_torch_dist_ranks.global_rows``);
* the reduced qwen1.5-0.5b train step (from JAX's parameters) on meshes
  1 x 1, 2 x 1, 2 x 2 and 4 x 1, with FSDP off and on, and with FSDP and
  ``compress_pod_grads``: step 0's loss within 1e-5 relative of the
  one-device step's and of JAX's ``lm.loss_fn`` (child mode ``train`` of
  ``_torch_dist_ref.py``); all four steps within the flipped-ulp witness;
  on 1 x 1 the one-device step's losses and parameters bit for bit; on
  the other meshes every final parameter leaf within that leaf's
  witness gap, and every quarter of it moved as the one-device run's;
* elastic restore: the 2 x 2 FSDP run's checkpoint restored onto 4 x 1
  and onto one device, every leaf bit-equal to what the 2 x 2 run held;
* the reduced moonshot-v1-16b-a3b's step (from JAX's parameters) with its
  batch split over 2 x 1, 2 x 2 and 4 x 1 meshes, each MoE layer's
  routing fractions all-reduced over the batch ranks: step 0's loss and
  aux loss within 1e-5 relative of the one-device step's and of JAX's
  (child mode ``meshtrain``), four steps within the flipped-ulp witness;
  on 1 x 1 the one-device step bit for bit, the all-reduce still made;
* the training launcher on a 2-rank gloo mesh (JAX's parameters, the
  ``reference`` policy): step 0's loss within 1e-5 of JAX's launcher on a
  2-device mesh, both drawing each shard's rows by its row range;
* a failing rank ends its group at once, with a join deadline or none
  (the training launcher's), and with none a rank runs to its end.

Stated tolerances:

* step 0's loss: rtol 1e-5 — the sharded step averages per-rank means
  of the cross entropy where one device takes one mean over all tokens
  (the schedule's lr is 0 at step 0, so all parameters are the initial
  ones);
* steps 1-3: the largest |sharded - one-device| loss gap within the
  largest gap the witness opens (the one-device run with one bf16 ulp
  flipped in every layer-0 input element; ``tests/test_torch_train_loop.py``'s
  witness, ROADMAP Queue 3 entry 26): the sharded backward sums partial
  gradients in another order and rounds bf16 leaves once after an fp32
  all-reduce, which AdamW's first steps carry as a flipped ulp does;
* the final parameters: per leaf, the largest and the mean
  |sharded - one-device| element gap within the witness's; the fraction
  of elements that moved from the start in each quarter of each
  dimension at least half the one-device run's.

Everything else is exact.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from _torch_dist_ref import MESH_TRAIN_ARGS, reference
from _torch_jax_ref import SEED, params_checksum
from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import global_batch_np as jax_global_batch_np
from repro.models import lm as jax_lm
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.dist import spawn
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.nn.spec import abstract_params
from repro_torch.weights import from_jax_params

MESHES = [(1, 1), (2, 1), (2, 2), (4, 1)]
RUNS = [f"fsdp={f},compress={c}" for f, c in ranks.TRAIN_RUNS]


@pytest.fixture(scope="module")
def jparams():
    return jax_lm.init(jax_config(ranks.ARCH, reduced=True), jax.random.PRNGKey(SEED))


@pytest.fixture(scope="module")
def params(jparams):
    return from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def moe_jparams():
    return jax_lm.init(jax_config(ranks.MOE_TRAIN["arch"], reduced=True),
                       jax.random.PRNGKey(SEED))


@pytest.fixture(scope="module")
def moe_params(moe_jparams):
    return from_jax_params(jax.device_get(moe_jparams), device="cpu")


@pytest.fixture(scope="module")
def moe_alone(moe_params):
    torch.set_num_threads(1)
    return {"plain": ranks.moe_alone(moe_params), "flip": ranks.moe_alone(moe_params, flip=True)}


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory, moe_jparams):
    out = reference("meshtrain", tmp_path_factory.mktemp("jax_dist_meshtrain"))
    assert float(out["moe_params_checksum"]) == params_checksum(moe_jparams)
    return out


@pytest.fixture(scope="module")
def four():
    return spawn.run(ranks.four_ranks, 4)


@pytest.fixture(scope="module")
def eight():
    return spawn.run(ranks.collectives, 8, 8)


@pytest.fixture(scope="module")
def trained(params, moe_params, tmp_path_factory):
    """Every mesh's runs, rank by rank, and the 2 x 2 checkpoint's dir;
    ``("moe", mesh)``: the MoE runs."""
    ckpt = str(tmp_path_factory.mktemp("ckpt_2x2"))
    one = spawn.run(ranks.one_rank, 1, params, moe_params)
    out = {(1, 1): [r["train"] for r in one], ("moe", (1, 1)): [r["moe"] for r in one]}
    two = spawn.run(ranks.two_ranks, 2, params, moe_params)
    out[(2, 1)] = [r["train"] for r in two]
    out[("moe", (2, 1))] = [r["moe"] for r in two]
    four = spawn.run(ranks.train_then_restore, 4, params, ckpt, moe_params)
    out[(2, 2)], out[(4, 1)] = [r[0] for r in four], [r[1] for r in four]
    for m in ("2x2", "4x1"):
        out[("moe", (int(m[0]), int(m[2])))] = [r[2][m] for r in four]
    out["ckpt"] = ckpt
    return out


@pytest.fixture(scope="module")
def alone(params):
    torch.set_num_threads(1)
    return {"plain": ranks.train_alone(params, False),
            "compress": ranks.train_alone(params, True),
            "flip": ranks.train_alone(params, False, flip=True)}


@pytest.fixture(scope="module")
def jax_loss(tmp_path_factory, jparams):
    out = reference("train", tmp_path_factory.mktemp("jax_dist_train"))
    assert float(out["params_checksum"]) == params_checksum(jparams)
    return float(out["loss0"])


# -- collectives -------------------------------------------------------------

@pytest.mark.parametrize("mode,rounds", [("unicast", 3), ("sw_tree", 2), ("hw", 0)])
def test_broadcast_delivers_the_source_payload_in_its_rounds(four, mode, rounds):
    for r in four:
        c = r["collectives"]
        assert c[f"{mode}/bcast_exact"] and c[f"{mode}/bcast_rounds"] == rounds


@pytest.mark.parametrize("mode,rounds", [("unicast", 3), ("sw_tree", 2), ("hw", 0)])
def test_weight_gather_equals_all_gather(four, mode, rounds):
    for r in four:
        c = r["collectives"]
        assert c[f"{mode}/gather_exact"] and c[f"{mode}/gather_rounds"] == rounds


@pytest.mark.parametrize("mode", ["unicast", "sw_tree", "hw"])
def test_mcast_matmul_equals_x_at_w(four, mode):
    assert all(r["collectives"][f"{mode}/matmul_exact"] for r in four)


@pytest.mark.parametrize("mode,rounds", [("unicast", 7), ("sw_tree", 3), ("hw", 0)])
def test_eight_rank_hierarchy(eight, mode, rounds):
    for r in eight:
        assert r[f"{mode}/bcast_exact"] and r[f"{mode}/bcast_rounds"] == rounds
        assert r[f"{mode}/gather_exact"]


def test_device_mesh_places_ranks_row_major(four):
    mesh = make_debug_mesh(2, 2)
    for rank, r in enumerate(four):
        assert r["device_mesh 2x2"] == tuple(mesh.coords(rank).values())
        assert r["batches 2x2"]["coords"] == mesh.coords(rank)
        assert r["collectives"]["coords"] == {"data": rank, "model": 0}


@pytest.mark.parametrize("mode,rounds", [("unicast", 3), ("sw_tree", 2), ("hw", 0)])
def test_broadcast_from_every_source_index(four, mode, rounds):
    """The sourced delivery the mesh engine's chain broadcast uses: each
    of the 4 ranks as the source, its payload everywhere, in its mode's
    rounds."""
    for r in four:
        for s in range(4):
            assert r["collectives"][f"{mode}/from{s}"] == (True, rounds), (s, mode)


@pytest.mark.parametrize("mesh", ["batches 4x1", "batches 2x2"])
@pytest.mark.parametrize("ba", [("data",), ("data", "model"), ()])
def test_sharded_batch_union_is_the_global_batch(four, mesh, ba):
    """Each rank's rows are JAX's ``sharded_batch`` rows: ``_tokens_for``
    drawn for the rank's row range, bit for bit; the ranks' blocks tile
    the batch (ranks off the batch axes repeat theirs), and with the batch
    over no axis every rank holds ``global_batch_np``."""
    from repro.data.pipeline import _tokens_for as jax_tokens_for

    cfg = ranks.BATCH_DATA
    jcfg = JaxDataConfig(vocab=cfg.vocab, seq_len=cfg.seq_len, global_batch=cfg.global_batch,
                         seed=cfg.seed)
    covered = np.zeros(cfg.global_batch, int)
    for r in four:
        (start, n), toks, labels = r[mesh][ba]
        want = jax_tokens_for(jcfg, 3, start, n)
        np.testing.assert_array_equal(toks, want[:, :-1])
        np.testing.assert_array_equal(labels, want[:, 1:])
        covered[start:start + n] += 1
        if not ba:
            np.testing.assert_array_equal(toks, jax_global_batch_np(jcfg, 3)["tokens"])
    sizes = {"batches 4x1": {"data": 4, "model": 1}, "batches 2x2": {"data": 2, "model": 2}}
    split = int(np.prod([sizes[mesh][a] for a in ba]))
    assert (covered == 4 // split).all()  # ranks off the batch axes repeat rows


# -- the train step ----------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_step0_loss_matches_one_device_and_jax(trained, alone, jax_loss, mesh, run):
    want = alone["compress" if "compress=True" in run else "plain"]["losses"][0]
    for r in trained[mesh]:
        got = r[f"{run}/losses"][0]
        assert got == pytest.approx(want, rel=1e-5)
        assert got == pytest.approx(jax_loss, rel=1e-5)
    assert alone["plain"]["losses"][0] == pytest.approx(jax_loss, rel=1e-5)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_four_steps_within_the_flipped_ulp_witness(trained, alone, mesh, run):
    ref = np.asarray(alone["compress" if "compress=True" in run else "plain"]["losses"])
    witness = float(np.abs(np.asarray(alone["flip"]["losses"]) - alone["plain"]["losses"]).max())
    assert witness > 0
    losses = [np.asarray(r[f"{run}/losses"]) for r in trained[mesh]]
    for got in losses:
        np.testing.assert_array_equal(got, losses[0])  # every rank reports the same loss
        assert float(np.abs(got - ref).max()) <= witness, (got, ref, witness)
    if mesh == (1, 1):  # one rank: the one-device step, bit for bit
        np.testing.assert_array_equal(losses[0], ref)
        want = alone["compress" if "compress=True" in run else "plain"]["params"]
        got = trained[mesh][0][f"{run}/params"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("mesh", MESHES[1:], ids=lambda m: f"{m[0]}x{m[1]}")
def test_final_parameters_within_the_flipped_ulp_witness(trained, alone, params, mesh, run):
    """Every leaf the multi-rank run gathers after four steps lies within
    that leaf's gap between the witness and the plain one-device run, in
    its largest and in its mean element; and every quarter of every leaf,
    along each dimension, moved from the start as the one-device run's
    did.  The quarters see a piece that one model-axis or FSDP shard left
    without its update, which the gaps alone cannot: a missing update is
    smaller than the gap a flipped ulp opens under AdamW's first steps."""
    want = alone["compress" if "compress=True" in run else "plain"]["params"]
    plain, flip = alone["plain"]["params"], alone["flip"]["params"]
    got = trained[mesh][0][f"{run}/params"]
    start = {k: v.float().numpy() for k, v in tree.flatten_with_paths(params).items()}
    assert got.keys() == want.keys()
    for k in want:
        witness, gap = np.abs(flip[k] - plain[k]), np.abs(got[k] - want[k])
        assert gap.max() <= witness.max(), (k, gap.max(), witness.max())
        assert gap.mean() <= witness.mean(), (k, gap.mean(), witness.mean())
        for d, size in enumerate(want[k].shape):
            for q in range(4):
                idx = (slice(None),) * d + (slice(q * size // 4, (q + 1) * size // 4),)
                moved = (got[k][idx] != start[k][idx]).mean()
                assert moved >= 0.5 * (want[k][idx] != start[k][idx]).mean(), (k, d, q)


@pytest.mark.parametrize("mesh", MESHES[1:], ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_runs_place_and_split_as_the_rules_say(trained, mesh):
    r = trained[mesh][0]
    assert r["fsdp=False,compress=False/batch_axes"] == ("data",)
    tp, fsdp = r["fsdp=False,compress=False/cut_leaves"], r["fsdp=True,compress=False/cut_leaves"]
    assert tp["data"] == 0 and fsdp["data"] > 0  # only FSDP cuts over the data axis
    if mesh[1] > 1:  # model-axis storage, with or without FSDP
        assert tp["model"] == fsdp["model"] > 0


def test_elastic_restore_2x2_onto_4x1_and_one_device(trained, params):
    saved = trained[(2, 2)][0]["saved_full"]
    restored = trained[(4, 1)][0]["restored_full"]
    cfg = get_config(ranks.ARCH, reduced=True)
    template = abstract_params(lm.model_spec(cfg))
    mgr = CheckpointManager(trained["ckpt"])
    assert mgr.manifest(ranks.TRAIN["steps"])["meta"]["mesh"] == {"data": 2, "model": 2}
    one = tree.flatten_with_paths(mgr.restore(ranks.TRAIN["steps"], template, device="cpu"))
    assert saved.keys() == restored.keys() == one.keys()
    for k in one:
        assert restored[k].dtype == one[k].dtype
        assert torch.equal(restored[k], one[k]), k
        np.testing.assert_array_equal(one[k].float().numpy(), saved[k], err_msg=k)
    # every 4 x 1 rank restored its own piece, not the whole leaf
    shapes = [r["restored_shapes"] for r in trained[(4, 1)]]
    assert shapes[0] == shapes[3]
    assert any(shapes[0][k] != tuple(one[k].shape) for k in one)


MOE_MESHES = [(2, 1), (2, 2), (4, 1)]


@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_step0_loss_matches_one_device_and_jax(trained, moe_alone, jax_mesh, mesh):
    want, jax_loss = moe_alone["plain"]["losses"][0], float(jax_mesh["moe_loss0"])
    assert want == pytest.approx(jax_loss, rel=1e-5)
    for r in trained[("moe", mesh)]:
        assert r["n_batch"] > 1  # the batch splits over ranks
        assert r["losses"][0] == pytest.approx(want, rel=1e-5)
        assert r["losses"][0] == pytest.approx(jax_loss, rel=1e-5)


@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_aux_loss_over_the_batch_ranks(trained, moe_alone, jax_mesh, mesh):
    """The aux term on its own: the ranks' aux losses, each taking the
    routing fractions averaged over the batch ranks, average to the whole
    batch's (one device and JAX's); one ``ce`` all-reduce per MoE layer."""
    want, jax_aux = moe_alone["plain"]["aux0"], float(jax_mesh["moe_aux0"])
    assert want == pytest.approx(jax_aux, rel=1e-5) and want > 0
    n_moe = sum(bd.ff == "moe" for bd in get_config(ranks.MOE_TRAIN["arch"],
                                                      reduced=True).layer_defs)
    for r in trained[("moe", mesh)]:
        assert r["aux0"] == pytest.approx(want, rel=1e-5)
        assert r["aux0"] == pytest.approx(jax_aux, rel=1e-5)
        assert r["ce_reduce_calls"] == n_moe


@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_four_steps_within_the_flipped_ulp_witness(trained, moe_alone, mesh):
    ref = np.asarray(moe_alone["plain"]["losses"])
    witness = float(np.abs(np.asarray(moe_alone["flip"]["losses"]) - ref).max())
    assert witness > 0
    losses = [np.asarray(r["losses"]) for r in trained[("moe", mesh)]]
    for got in losses:
        np.testing.assert_array_equal(got, losses[0])  # every rank reports the same loss
        assert float(np.abs(got - ref).max()) <= witness, (got, ref, witness)


def test_moe_one_rank_mesh_is_the_one_device_step(trained, moe_alone):
    """On a 1 x 1 mesh the MoE step makes its ``ce`` all-reduces over the
    one rank and is the one-device step, bit for bit."""
    (r,) = trained[("moe", (1, 1))]
    assert r["n_batch"] == 1 and r["ce_reduce_calls"] > 0
    np.testing.assert_array_equal(r["losses"], moe_alone["plain"]["losses"])
    assert r["aux0"] == moe_alone["plain"]["aux0"]


def test_launcher_mesh_step0_matches_the_jax_launcher(jparams, jax_mesh, tmp_path):
    """``--mesh-data 2`` on two gloo ranks from JAX's parameters: each rank
    draws its rows as JAX's launcher's ``sharded_batch`` does, so step 0's
    loss (the learning rate is 0 there) is JAX's 2-device launcher's."""
    import contextlib
    import io

    from repro_torch.launch import train

    with contextlib.redirect_stdout(io.StringIO()):
        got = train.main([*MESH_TRAIN_ARGS, "--device", "cpu", "--kernel-policy", "reference",
                          "--ckpt-dir", str(tmp_path)],
                         params=from_jax_params(jax.device_get(jparams), device="cpu"),
                         timeout=spawn.DEFAULT_TIMEOUT, join_timeout=600.0)["losses"]
    want = jax_mesh["launch_losses"]
    assert len(got) == len(want) == 2
    assert got[0] == pytest.approx(float(want[0]), rel=1e-5)


def test_a_failing_rank_ends_the_group_without_waiting_for_the_timeout():
    """Rank 1 raises while rank 0 waits in a barrier: the parent reports
    rank 1's error and kills rank 0 well before the 60 s collective
    timeout would end it."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        spawn.run(ranks.fail_on_rank_one, 2)
    assert time.monotonic() - t0 < 30


def test_without_a_join_deadline_ranks_run_to_their_end_and_failures_still_end_them():
    """``join_timeout=None`` (the training launcher's) lets a rank run past
    what a 1 s deadline allows, where the deadline kills it; and a failing
    rank still ends the group at once (rank 0 waits in a barrier bounded
    by the 60 s collective timeout)."""
    import time

    with pytest.raises(RuntimeError, match="no result .*killed"):
        spawn.run(ranks.sleep_then_return, 1, 3.0, join_timeout=1.0)
    assert spawn.run(ranks.sleep_then_return, 1, 3.0, join_timeout=None) == [3.0]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        spawn.run(ranks.fail_on_rank_one, 2, join_timeout=None)
    assert time.monotonic() - t0 < 30


def test_nccl_mesh_above_the_card_count_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 NCCL ranks need 2 cards; 1 visible"):
        spawn.run(ranks.fail_on_rank_one, 2, backend="nccl")
