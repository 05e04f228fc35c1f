"""The training slice's parts against the JAX package, in process: AdamW
(``optim/adamw.py``), the synthetic data (``data/pipeline.py``), the
checkpoint manager (``checkpoint/manager.py``), the input specs
(``configs/shapes.py``) and the step builders' abstract inputs
(``dist/step.py``, against JAX's builders on a 1 x 1 mesh); and the
prefill and decode steps against the model functions they wrap.

Stated tolerances:

* the schedule: fp32, rtol 1e-6 (the two ``cos`` may differ in the
  last bit);
* ``global_norm``: rtol 1e-6 — both sum per-leaf fp32 sums of squares,
  JAX in sorted-key order, the port in its tree's order, and the trees
  here are built so the two orders differ;
* ``update``, three steps on the same gradients: fp32 leaves and moments
  at rtol 1e-5 (the other summation order moves ``grad_norm``, so the
  clip factor, in its last bits); bf16 leaves and moments within one
  bf16 ulp (rtol 2**-7), where such a last bit can round the other way;
* batches bit-equal; checkpoints bit-equal across the two packages;
* abstract inputs: equal shapes and dtypes, parameter, moment and cache
  trees by their bytes of each dtype (the layouts differ); the prefill
  and decode steps bit-equal to the calls they wrap.
"""
import collections

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import shapes as jax_shapes
from repro.data import pipeline as jax_pipeline
from repro.dist import step as jax_step
from repro.launch.mesh import make_debug_mesh
from repro.optim import adamw as jax_adamw
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes
from repro_torch.data import pipeline
from repro_torch.dist import step
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw

ULP_BF16 = 2.0 ** -7  # one bf16 ulp is at most this share of the value


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- AdamW -------------------------------------------------------------------


#: (key, shape, dtype); inserted out of sorted order, so the port's leaf
#: order (insertion) and JAX's (sorted keys) differ
LEAVES = (("w_out", (24, 16), "bf16"), ("bias", (16,), "f32"),
          ("a_w", (16, 40), "bf16"), ("norm", (40,), "f32"))
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _trees(seed: int, scale: float = 1.0):
    """(JAX tree, port tree) of one seeded draw, the port's a dict with a
    nested list, like its parameters' ``layers``."""
    rng = np.random.default_rng(seed)
    np_tree = {k: (rng.standard_normal(shape) * scale).astype(np.float32)
               for k, shape, _ in LEAVES}
    dt = {k: d for k, _, d in LEAVES}
    jtree = {k: jnp.asarray(v, DTYPES[dt[k]][1]) for k, v in np_tree.items()}
    ptree = {"w_out": t(jtree["w_out"]), "layers": [{"bias": t(jtree["bias"])},
                                                    {"a_w": t(jtree["a_w"]),
                                                     "norm": t(jtree["norm"])}]}
    return jtree, ptree


def _port_view(ptree) -> dict:
    return {"w_out": ptree["w_out"], "bias": ptree["layers"][0]["bias"],
            "a_w": ptree["layers"][1]["a_w"], "norm": ptree["layers"][1]["norm"]}


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=ULP_BF16, atol=0)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_schedule_matches_jax():
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=40)
    jcfg, pcfg = jax_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in range(0, 46):
        want = np.asarray(jax_adamw.schedule(jnp.int32(step), jcfg))
        got = adamw.schedule(step, pcfg, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_global_norm_matches_jax_in_another_summation_order():
    jtree, ptree = _trees(1, scale=3.0)
    want = np.asarray(jax_adamw.global_norm(jtree))
    got = adamw.global_norm(ptree)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("clip", ["on", "off"])
def test_update_matches_jax(moments, clip):
    """Three steps (lr 0 at step 0 under warmup, then rising) on seeded
    gradients; with ``clip`` on the gradients' norm (about 20) is above
    ``grad_clip``, so every gradient is scaled."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0 if clip == "on" else 1e9)
    jcfg = jax_adamw.AdamWConfig(**kw, moment_dtype=DTYPES[moments][1])
    pcfg = adamw.AdamWConfig(**kw, moment_dtype=DTYPES[moments][0])
    jparams, pparams = _trees(2)
    jstate, pstate = jax_adamw.init(jparams, jcfg), adamw.init(pparams, pcfg)
    for step in range(3):
        jgrads, pgrads = _trees(10 + step, scale=2.0)
        jparams, jstate, jm = jax_adamw.update(jgrads, jstate, jparams, jnp.int32(step), jcfg)
        pparams, pstate, pm = adamw.update(pgrads, pstate, pparams, step, pcfg)
        np.testing.assert_allclose(pm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pm["lr"].numpy(), np.asarray(jm["lr"]), rtol=1e-6)
        if clip == "on":
            assert float(pm["grad_norm"]) > kw["grad_clip"]
        for got_tree, want_tree in ((pparams, jparams), (pstate.m, jstate.m),
                                    (pstate.v, jstate.v)):
            for k, got in _port_view(got_tree).items():
                assert got.dtype == (DTYPES[moments][0] if got_tree is not pparams
                                     else DTYPES[dict((a, d) for a, _, d in LEAVES)[k]][0])
                _close(got, want_tree[k])


def test_update_writes_in_place_and_leaves_the_graph():
    pcfg = adamw.AdamWConfig(warmup_steps=1)
    _, params = _trees(3)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    before = [p.data_ptr() for p in tree.leaves(params)]
    state = adamw.init(params, pcfg)
    _, grads = _trees(4)
    out, state2, _ = adamw.update(grads, state, params, 1, pcfg)
    assert out is params and state2 is state
    assert [p.data_ptr() for p in tree.leaves(out)] == before
    assert all(p.requires_grad and p.grad_fn is None for p in tree.leaves(out))


# ---- data --------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 4, 32), (0, 7, 4, 32), (3, 1, 8, 128),
                                                 (1, 12, 2, 17), (5, 0, 1, 513)])
def test_batches_bit_equal_jax(seed, step, batch, seq):
    jcfg = jax_pipeline.DataConfig(vocab=151936, seq_len=seq, global_batch=batch, seed=seed)
    pcfg = pipeline.DataConfig(vocab=151936, seq_len=seq, global_batch=batch, seed=seed)
    want = jax_pipeline.global_batch_np(jcfg, step)
    got_np = pipeline.global_batch_np(pcfg, step)
    got = pipeline.batch(pcfg, step, device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got_np[k], want[k])
        assert got[k].dtype == torch.int32 and got[k].shape == (batch, seq)
        np.testing.assert_array_equal(got[k].numpy(), want[k])


# ---- checkpoints ---------------------------------------------------------------


def test_roundtrip_nested_tree(tmp_path):
    t_ = {"a": {"w": torch.arange(6.0).reshape(2, 3)},
          "b": (torch.ones(4), {"c": torch.randn(2, 2).bfloat16()}), "d": [torch.tensor(7)]}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, t_, meta={"note": "x"})
    out = mgr.restore(3, t_, device="cpu")
    assert isinstance(out["b"], tuple) and isinstance(out["d"], list)
    for a, b in zip(tree.leaves(t_), tree.leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert mgr.manifest(3)["meta"]["note"] == "x"


def test_keep_last_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(3)})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4


def test_atomic_publish_never_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(3)})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000001"]
    assert sorted(p.name for p in (tmp_path / names[0]).iterdir()) == ["arrays.npz",
                                                                         "manifest.json"]


def test_restore_validates_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(KeyError, match="'y'"):
        mgr.restore(1, {"y": torch.zeros(3)}, device="cpu")


def _np_tree():
    """A numpy tree with bf16 (ml_dtypes, through JAX), fp32 and int32 leaves."""
    rng = np.random.default_rng(5)
    return {"emb": np.asarray(jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16)),
            "layers": {"0": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
                       "1": {"w": rng.standard_normal((3, 4)).astype(np.float32)}},
            "step": np.asarray(11, np.int32)}


def _flat(tr, prefix=""):
    out = {}
    for k, v in tr.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_the_port_reads_a_jax_checkpoint(tmp_path):
    src = _np_tree()
    JaxCheckpointManager(str(tmp_path), keep=1).save(2, src, meta={"arch": "x"})
    out = CheckpointManager(str(tmp_path)).restore(2, src, device="cpu")
    for path, want in _flat(src).items():
        got = _flat(out)[path]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_jax_reads_a_port_checkpoint(tmp_path):
    src = _np_tree()
    port_tree = {"emb": t(src["emb"]), "layers": {k: {"w": t(v["w"])}
                                                  for k, v in src["layers"].items()},
                 "step": t(src["step"])}
    CheckpointManager(str(tmp_path), keep=1).save(4, port_tree, meta={"arch": "x"})
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["dtypes"] == {"emb": "bfloat16", "layers/0/w": "float32",
                                  "layers/1/w": "float32", "step": "int32"}
    out = JaxCheckpointManager(str(tmp_path)).restore(4, src)
    for path, want in _flat(src).items():
        got = np.asarray(_flat(out)[path])
        assert got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path


# ---- input specs ---------------------------------------------------------------


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_nbytes(v) for v in tree.leaves(x)) if isinstance(x, (dict, list, tuple)) \
        else int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize


def test_shapes_table_matches_jax():
    assert shapes.VISION_PATCHES == jax_shapes.VISION_PATCHES
    assert {k: tuple(vars(v).values()) for k, v in shapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jax_shapes.SHAPES.items()}
    assert set(ARCHS) == set(JAX_ARCHS)
    for arch in ARCHS:
        assert shapes.cells(get_config(arch)) == jax_shapes.cells(jax_config(arch))
        for name in shapes.SHAPES:
            assert shapes.applicable(get_config(arch), name) \
                == jax_shapes.applicable(jax_config(arch), name)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """Every applicable cell: each input's shape and dtype; the decode
    cache by total bytes (the JAX package stacks it by stage, the port
    keeps one entry per layer)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in shapes.cells(cfg):
        got, want = shapes.input_specs(cfg, name), jax_shapes.input_specs(jcfg, name)
        assert set(got) == set(want), (arch, name)
        for k, w in want.items():
            if k == "cache":
                assert all(x.device.type == "meta" for x in tree.leaves(got[k]))
                assert _nbytes(got[k]) == _nbytes(jax.tree.leaves(w)), (arch, name)
                continue
            g = got[k]
            assert g.device.type == "meta", (arch, name, k)
            assert tuple(g.shape) == tuple(w.shape), (arch, name, k)
            assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name, (arch, name, k)
    skipped = [n for n in shapes.SHAPES if n not in shapes.cells(cfg)]
    for name in skipped:
        with pytest.raises(ValueError, match="skipped"):
            shapes.input_specs(cfg, name)


# ---- step builders -------------------------------------------------------------


def _bytes_by_dtype(x) -> dict[str, int]:
    """A tree's bytes per dtype name, either package's leaves."""
    out = collections.Counter()
    for leaf in (tree.leaves(x) if isinstance(x, (dict, list, tuple)) else jax.tree.leaves(x)):
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "meta"
            out[str(leaf.dtype).removeprefix("torch.")] += leaf.numel() * leaf.element_size()
        else:
            out[jnp.dtype(leaf.dtype).name] += int(np.prod(leaf.shape)) * jnp.dtype(
                leaf.dtype).itemsize
    return dict(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_builders_match_jax(arch):
    """``build_step`` for every applicable cell against JAX's
    ``build_step`` on a 1 x 1 mesh: the bundle's name, and each abstract
    input — a tensor by shape and dtype, a batch by its keys and their
    shapes and dtypes, the parameters, the AdamW moments and the decode
    cache by their bytes of each dtype."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = make_debug_mesh(1, 1)
    for name in shapes.cells(cfg):
        got, want = step.build_step(cfg, name), jax_step.build_step(jcfg, mesh, name)
        assert got.name == want.name
        assert len(got.abstract_inputs) == len(want.abstract_inputs), (arch, name)
        for g, w in zip(got.abstract_inputs, want.abstract_inputs):
            if isinstance(g, torch.Tensor):
                assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape), (arch, name)
                assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
            elif isinstance(g, adamw.AdamWState):
                assert _bytes_by_dtype(g.m) == _bytes_by_dtype(w.m), (arch, name)
                assert _bytes_by_dtype(g.v) == _bytes_by_dtype(w.v), (arch, name)
            elif set(g) <= {"tokens", "labels", "frames", "frontend_embeds"}:  # a batch
                assert set(g) == set(w), (arch, name)
                for k in w:
                    assert tuple(g[k].shape) == tuple(w[k].shape), (arch, name, k)
                    assert str(g[k].dtype).removeprefix("torch.") == jnp.dtype(w[k].dtype).name
            else:  # the parameters, a decode cache
                assert _bytes_by_dtype(g) == _bytes_by_dtype(w), (arch, name)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-medium"])
def test_prefill_and_decode_steps_run_the_model(arch):
    """The prefill and decode bundles of a reduced arch call the model's
    ``prefill`` and ``decode_step``: the same logits, bit for bit, on the
    same parameters and tokens (whisper's over its frames)."""
    cfg = get_config(arch, reduced=True)
    mod = encdec if cfg.family == "audio" else lm
    params = mod.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(31)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32))
    batch, args = {"tokens": tokens[:, :8]}, ()
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.frontend_dim)).astype(np.float32)).bfloat16()
        batch["frames"], args = frames, (frames,)
    shape = shapes.ShapeCfg("case", "prefill", 8, 2)
    with torch.no_grad():
        logits, caches = step.build_prefill_step(cfg, shape).fn(params, batch)
        want, want_caches = mod.prefill(params, cfg, tokens[:, :8], *args)
        assert torch.equal(logits, want)
        decode = step.build_step(cfg, shapes.ShapeCfg("case", "decode", 8, 2))
        got = decode.fn(params, caches, tokens[:, 8:], 8)[0]
        assert torch.equal(got, mod.decode_step(params, cfg, want_caches, tokens[:, 8:], 8)[0])


def test_prefill_caches_own_their_rows():
    """A prefill whose ring holds exactly the prompt gives each sequence a
    position row of its own: a ragged decode writes one row's positions
    without touching another's."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = lm.init(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(37).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    with torch.no_grad():
        _, caches = lm.prefill(params, cfg, tokens)
    pos = caches[0].pos
    pos[0, 0] = 99
    assert int(pos[1, 0]) == 0
