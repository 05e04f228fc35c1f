"""The port's pure distribution rules against the JAX package's, in one
process, with no device mesh and no process group:

* ``dist/sharding.py``: ``param_pspecs`` and the FSDP specs
  (``param_shardings(fsdp=True)``) equal JAX's ``param_pspecs`` /
  ``_add_fsdp`` leaf for leaf, for all 11 archs at full size on the
  production meshes (16, 16) and (2, 16, 16) and the debug meshes (2, 2)
  and (4, 2), built as fake meshes (shapes and axis names only).  The
  JAX package stacks a stage's layers into one leaf, so a layer's spec is
  held to its stage leaf's spec without the leading "layers" entry;
* ``batch_axes`` equal to JAX's, including the small-recurrent spread
  over the model axis and the uneven-batch fallback;
* ``launch/mesh.py``: the builders' shapes and axis names, and rank ->
  coordinates row-major;
* ``dist/compression.py``: ``compress_grads`` bit-equal to JAX's over
  three error-feedback steps on bf16 and fp32 leaves, sizes not a
  multiple of 256 and an all-zero block;
* ``dist/mcast.py``: ``bytes_model`` equal to JAX's for n = 1 ... 16, both
  forms, and the ``MODES``;
* the sharded placement of every leaf (``shard``) against numpy slicing
  of the logical view, on one process (coordinates given by hand).

Stated tolerance: none — every comparison is exact.
"""
import itertools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.dist import compression as jax_comp
from repro.dist import mcast as jax_mcast
from repro.dist import sharding as jax_shd
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.dist import compression, mcast, sharding
from repro_torch.launch import mesh as meshes
from repro_torch.models import encdec, lm
from repro_torch.nn.spec import ParamSpec
from repro_torch.weights import to_torch

MESHES = {
    "prod(16,16)": meshes.make_production_mesh(),
    "prod(2,16,16)": meshes.make_production_mesh(multi_pod=True),
    "debug(2,2)": meshes.make_debug_mesh(2, 2),
    "debug(4,2)": meshes.make_debug_mesh(4, 2),
}


def _fake(mesh):
    """The JAX rules read only ``shape`` and ``axis_names``."""
    return SimpleNamespace(shape=dict(mesh.shape), axis_names=mesh.axis_names)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _jax_path(cfg, path: str) -> tuple[str, bool]:
    """The JAX leaf a port leaf lives in, and whether it is stacked."""
    parts = path.split("/")
    if "layers" not in parts:
        return path, False
    i = parts.index("layers")
    k = int(parts[i + 1])
    if cfg.family == "audio":  # encoder.stage / decoder.stage, one block
        return "/".join(parts[:i] + ["stage"] + parts[i + 2:]), True
    for s, (pattern, repeats) in enumerate(cfg.stages):
        if k < len(pattern) * repeats:
            return "/".join([f"stage{s}", f"b{k % len(pattern)}"] + parts[i + 2:]), True
        k -= len(pattern) * repeats
    raise AssertionError(path)


def _jax_specs(arch, mesh, fsdp):
    cfg = jax_config(arch)
    spec = (jax_encdec if cfg.family == "audio" else jax_lm).model_spec(cfg)
    fake = _fake(mesh)
    ps = jax_shd.param_pspecs(cfg, spec, fake)
    if fsdp:
        sizes = dict(fake.shape)
        ps = jax.tree.map(lambda s, p: jax_shd._add_fsdp(s, p, sizes), spec, ps,
                          is_leaf=lambda x: isinstance(x, jax_shd.ParamSpec))
    leaves = {}
    for path, p in jax.tree_util.tree_flatten_with_path(
            ps, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        leaves["/".join(str(getattr(k, "key", k)) for k in path)] = tuple(p)
    return leaves


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_leaf_for_leaf(arch, mesh_name, fsdp):
    mesh = MESHES[mesh_name]
    cfg = get_config(arch)
    spec_tree = (encdec if cfg.family == "audio" else lm).model_spec(cfg)
    want = _jax_specs(arch, mesh, fsdp)
    got = _flat(_pspecs(cfg, spec_tree, mesh, fsdp))
    placed = _flat(sharding.param_shardings(cfg, spec_tree, mesh, fsdp=fsdp))
    seen = set()
    for path, ps in got.items():
        jpath, stacked = _jax_path(cfg, path)
        assert jpath in want, (path, jpath)
        assert ps == (want[jpath][1:] if stacked else want[jpath]), (path, ps, want[jpath])
        assert placed[path].spec == ps
        seen.add(jpath)
    assert seen == set(want)  # every JAX leaf has its port leaves
    if mesh_name == "debug(2,2)" and fsdp:
        assert any("data" in ps for ps in got.values())  # FSDP shards something


def _pspecs(cfg, spec_tree, mesh, fsdp):
    """``param_pspecs`` is the tp spec; FSDP's is ``param_shardings``'."""
    if not fsdp:
        return sharding.param_pspecs(cfg, spec_tree, mesh)
    return _map(lambda pl: pl.spec, sharding.param_shardings(cfg, spec_tree, mesh, fsdp=True))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


BATCH_CASES = [  # (arch, mesh, global batch)
    ("mamba2-780m", "prod(16,16)", 256), ("deepseek-7b", "prod(16,16)", 256),
    ("mamba2-780m", "prod(16,16)", 48), ("recurrentgemma-2b", "prod(16,16)", 256),
    ("mamba2-780m", "debug(4,2)", 8), ("mamba2-780m", "debug(4,2)", 4),
    ("qwen1.5-0.5b", "debug(2,2)", 3), ("qwen1.5-0.5b", "prod(2,16,16)", 64),
    ("mamba2-780m", "prod(2,16,16)", 512), ("whisper-medium", "debug(2,2)", 8),
]


@pytest.mark.parametrize("arch,mesh_name,batch", BATCH_CASES)
def test_batch_axes_equal_jax(arch, mesh_name, batch):
    mesh = MESHES[mesh_name]
    want = jax_shd.batch_axes(_fake(mesh), batch, jax_config(arch))
    assert sharding.batch_axes(mesh, batch, get_config(arch)) == tuple(want)
    assert sharding.batch_axes(mesh, batch) == tuple(jax_shd.batch_axes(_fake(mesh), batch))


def test_small_recurrent_batch_spreads_over_model_axis():
    """JAX's tests/test_shapes_and_sharding.py cases: mamba2 has no TP and
    spreads its batch over the idle model axis; a dense arch does not."""
    fake = MESHES["prod(16,16)"]
    assert sharding.logical_rules(get_config("mamba2-780m"), fake)["rnn"] is None
    assert sharding.logical_rules(get_config("recurrentgemma-2b"), fake)["rnn"] == "model"
    assert sharding.batch_axes(fake, 256, get_config("mamba2-780m")) == ("data", "model")
    assert sharding.batch_axes(fake, 256, get_config("deepseek-7b")) == ("data",)


def test_mesh_builders_and_row_major_coords():
    assert meshes.make_production_mesh().shape == {"data": 16, "model": 16}
    assert meshes.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert meshes.make_debug_mesh(4, 2).axis_names == ("data", "model")
    assert meshes.make_debug_mesh(1, 2, pod=2).shape == {"pod": 2, "data": 1, "model": 2}
    assert meshes.make_serve_mesh(4, axis="x").shape == {"x": 4}
    m = meshes.make_debug_mesh(2, 3, pod=2)
    want = list(itertools.product(range(2), range(2), range(3)))  # numpy's row-major order
    assert [tuple(m.coords(r).values()) for r in range(m.size)] == want
    with pytest.raises(ValueError):
        m.coords(12)


def _grad_leaves(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((3, 300)).astype(np.float32),  # 900: not x256
         "b": rng.standard_normal((7, 37)).astype(np.float32) * 1e-3,
         "c": (rng.standard_normal((2, 256, 3)) * 4).astype(jnp.bfloat16),
         "d": rng.standard_normal(1000).astype(jnp.bfloat16)}
    g["a"][1, 56:] = 0.0  # [256, 512) of the flattened leaf: an all-zero block
    g["a"][2, :212] = 0.0
    return g


def test_compress_grads_bit_equal_to_jax_over_three_steps():
    jerr = jax_comp.init_error_state({k: jnp.asarray(v) for k, v in _grad_leaves(0).items()})
    terr = compression.init_error_state({k: to_torch(v, "cpu")
                                         for k, v in _grad_leaves(0).items()})
    for step in range(3):
        g = _grad_leaves(step)
        jq, jerr = jax_comp.compress_grads({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tq, terr = compression.compress_grads({k: to_torch(v, "cpu") for k, v in g.items()},
                                              terr)
        for k in g:
            assert tq[k].dtype == to_torch(np.asarray(jq[k]), "cpu").dtype
            assert torch.equal(tq[k], to_torch(np.asarray(jq[k]), "cpu")), (step, k)
            assert torch.equal(terr[k], torch.from_numpy(np.array(jerr[k]))), (step, k)
    assert float(terr["a"].abs().sum()) > 0  # the residual is carried


@pytest.mark.parametrize("n", range(1, 17))
def test_bytes_model_equal_jax(n):
    assert mcast.MODES == jax_mcast.MODES
    for per_device in (False, True):
        assert mcast.bytes_model(4096, n, per_device=per_device) == \
            jax_mcast.bytes_model(4096, n, per_device=per_device)


@pytest.mark.parametrize("fsdp", [False, True])
def test_shard_cuts_the_logical_view(fsdp):
    """Every leaf of the reduced qwen and moonshot on a 2 x 2 mesh: the
    four pieces ``shard`` cuts are numpy's slices of the logical view, and
    laid back together they are the leaf."""
    mesh = meshes.make_debug_mesh(2, 2)
    for arch in ("qwen1.5-0.5b", "moonshot-v1-16b-a3b"):
        cfg = get_config(arch, reduced=True)
        spec = lm.model_spec(cfg)
        full = lm.init(cfg, seed=1, device="cpu")
        places = _flat(sharding.param_shardings(cfg, spec, mesh, fsdp=fsdp))
        for path, x in _flat(full).items():
            pl = places[path]
            logical = x.float().numpy().reshape(pl.dims)
            back = np.zeros_like(logical)
            for r in range(mesh.size):
                where = SimpleNamespace(shape=mesh.shape, coords=mesh.coords(r))
                piece = sharding.shard(x, pl, where)
                assert tuple(piece.shape) == pl.local_shape(mesh.shape)
                idx = tuple(slice(None) if a is None else
                            slice(mesh.coords(r)[a] * (n // 2), (mesh.coords(r)[a] + 1) * (n // 2))
                            for n, a in zip(pl.dims, pl.spec))
                np.testing.assert_array_equal(
                    piece.float().numpy().reshape(pl.local_dims(mesh.shape)), logical[idx])
                back[idx] = piece.float().numpy().reshape(pl.local_dims(mesh.shape))
            np.testing.assert_array_equal(back, logical)


def test_param_spec_checks_its_logical_view():
    with pytest.raises(ValueError):
        ParamSpec((4, 6), dims=(4, 2, 2))
    with pytest.raises(ValueError):
        ParamSpec((4, 6), axes=("embed",))
    s = ParamSpec((4, 6), dims=(4, 2, 3), axes=("embed", "heads", None))
    assert s.logical_shape == (4, 2, 3) and math.prod(s.shape) == 24
