"""Rules of the port's package: it imports neither JAX nor the JAX
package, its entry points run on CUDA unless asked for the CPU (and say
so clearly when there is no GPU), and its plain CPU path never moves the
kernel launch counters."""
import ast
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.serve import PagedEngine, Request
from repro_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
# ml_dtypes too: the card's machine has no such package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "ml_dtypes")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                roots.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and arg.values:
                head = arg.values[0]
                if isinstance(head, ast.Constant):
                    roots.add(head.value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_reference_package_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_scan_covers_every_port_module():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("kernels/api.py", "kernels/autotune.py", "kernels/_operands.py",
                "kernels/matmul/matmul.py",
                "kernels/flash_attention/flash_attention.py", "kernels/flash_attention/ref.py",
                "kernels/ssd/ssd.py", "kernels/ssd/ref.py", "kernels/rglru/rglru.py",
                "kernels/rglru/ref.py", "nn/attention.py", "models/lm.py", "launch/serve.py",
                "launch/train.py", "optim/adamw.py", "data/pipeline.py",
                "checkpoint/manager.py", "configs/shapes.py", "dist/step.py", "tree.py",
                "obs/trace.py", "obs/export.py", "obs/analyze.py", "core/__init__.py",
                "core/encoding.py", "core/xbar.py", "core/timing.py", "core/noc.py",
                "core/occamy.py", "core/area.py"):
        assert f"src/repro_torch/{rel}" in names, rel


#: what the host-side copies may import: ``core/`` numpy and the standard
#: library, ``obs/`` the standard library (``analyze`` reaches the port's
#: metrics histogram lazily, inside a function)
HOST_ONLY = {"core": {"numpy"}, "obs": set()}


@pytest.mark.parametrize("pkg", sorted(HOST_ONLY))
def test_host_copies_import_only_numpy_and_the_standard_library(pkg):
    import sys

    files = sorted((REPO / "src" / "repro_torch" / pkg).glob("*.py"))
    assert files
    for path in files:
        roots = _imported_roots(path) - {"repro_torch", "__future__"}
        assert roots <= set(sys.stdlib_module_names) | HOST_ONLY[pkg], (path.name, roots)


def test_every_kernel_source_is_built_and_counted():
    """Each CUDA source has a build entry, and each built kernel a wrapper
    with a launch counter in the dispatch layer."""
    from repro_torch.kernels import _build

    sources = {p.name for p in _build.CSRC.glob("*.cu")}
    assert sources == {src for src, _, _ in _build.KERNELS.values()}
    assert set(_build.KERNELS) == set(kernels.KERNELS)
    for name, wrapper in kernels.KERNELS.items():
        assert (_build.CSRC / _build.KERNELS[name][0]).is_file(), name
        assert wrapper.launches >= 0, name


def test_scan_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.models import lm\n"
                     "import importlib\nimportlib.import_module(f'repro.configs.{x}')\n")
    assert _imported_roots(probe) >= {"jax", "repro"}


ENTRY_POINTS = [
    lambda cfg: lm.init(cfg),
    lambda cfg: lm.init_paged_cache(cfg, 4, 8),
    lambda cfg: lm.init_cache(cfg, 2, 8),
    lambda cfg: launcher.Server(cfg, lm.init(cfg, device="cpu")),
    lambda cfg: from_jax_params({}),
    lambda cfg: PagedEngine(cfg, lm.init(cfg, device="cpu")),
    lambda cfg: launcher.main(["--reduced"]),
    lambda cfg: launcher.main(["--reduced", "--kv", "paged"]),
    lambda cfg: train_launcher.main(["--reduced"]),
    lambda cfg: pipeline.batch(pipeline.DataConfig(cfg.vocab, 8, 2), 0),
    # restore resolves its device before it touches the manager or the disk
    lambda cfg: CheckpointManager.restore(None, 0, {}),
]


@pytest.mark.parametrize("call", range(len(ENTRY_POINTS)))
def test_entry_points_default_to_cuda_and_refuse_without_it(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.*device='cpu'"):
        ENTRY_POINTS[call](cfg)


def test_entry_point_signatures_default_to_cuda():
    for fn in (lm.init, lm.init_paged_cache, lm.init_cache, from_jax_params,
               PagedEngine.__init__, launcher.Server.__init__, pipeline.batch,
               CheckpointManager.restore):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert launcher.parser().parse_args([]).device == "cuda"
    assert train_launcher.parser().parse_args([]).device == "cuda"


def test_plain_path_leaves_launch_counters_at_zero():
    kernels.reset_launch_counts()
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    eng = PagedEngine(cfg, lm.init(cfg, seed=1, device="cpu"), device="cpu",
                      max_batch=2, cache_len=64, page_size=8)
    prefix = list(range(3, 30))
    done = eng.run([Request(rid=i, prompt=prefix + [40 + i], max_new=3) for i in range(3)])
    assert len(done) == 3 and eng.stats()["prefix_hit_tokens"] > 0
    assert eng.kernel_calls["decode"] and eng.kernel_calls["suffix_prefill"]
    assert kernels.launch_counts() == {
        "matmul_tiled": 0, "matmul_mcast": 0, "matmul_unicast": 0,
        "paged_attention_decode": 0, "paged_attention_prefill": 0, "flash_attention": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0, "ssd_scan": 0,
        "ssd_scan_bwd": 0, "rglru_scan": 0, "rglru_scan_bwd": 0}


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    """A tensor on any other device than the CPU never runs the plain
    version: here (a ``meta`` tensor) the wrappers refuse it."""
    meta = dict(device="meta")
    for policy in ("tiled", "mcast", "unicast"):
        with kernels.use_policy(policy), pytest.raises(ValueError, match="CUDA"):
            kernels.linear(torch.zeros(2, 3, **meta), torch.zeros(3, 4, **meta))
    q = torch.zeros(1, 1, 2, 16, **meta)
    pages = torch.zeros(2, 4, 8, 16, **meta)
    table = torch.zeros(1, 2, dtype=torch.int32, **meta)
    lengths = torch.ones(1, dtype=torch.int32, **meta)
    for s in (1, 3):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.op("paged_attention")(q.expand(1, s, 2, 16), pages, pages, table,
                                          lengths - 1, lengths)
    qf, kv = torch.zeros(1, 2, 8, 16, **meta), torch.zeros(1, 1, 8, 16, **meta)
    rows = torch.zeros(1, 2, 8, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.op("flash_attention")(qf, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_attention_bwd_dq(qf, kv, kv, qf, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_attention_bwd_dkv(qf, kv, kv, qf, rows, rows)
    xdt, bc, la = (torch.zeros(1, 2, 8, 4, **meta), torch.zeros(1, 8, 3, **meta),
                   torch.zeros(1, 2, 8, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.op("ssd")(xdt, bc, bc, la)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ssd_scan_bwd(xdt, bc, bc, la[..., None], torch.zeros(1, 2, 1, 4, 3, **meta), xdt)
    seq = torch.zeros(1, 8, 4, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.op("rglru")(seq, seq)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rglru_scan_bwd(seq, seq, seq)


def test_cpu_autograd_runs_the_plain_versions():
    """Differentiating on the CPU takes the autograd functions through the
    plain versions: gradients flow, and no launch is counted."""
    kernels.reset_launch_counts()
    q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    out = kernels.op("flash_attention")(q, k, v)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    a, b = torch.randn(4, 8, requires_grad=True), torch.randn(8, 3, requires_grad=True)
    grads += torch.autograd.grad(kernels.linear(a, b, activation="relu").sum(), (a, b))
    xdt, bm, cm = (torch.randn(*shape, requires_grad=True) for shape in
                   ((1, 2, 70, 8), (1, 70, 4), (1, 70, 4)))
    log_a = (-torch.rand(1, 2, 70)).requires_grad_()
    grads += torch.autograd.grad(kernels.op("ssd")(xdt, bm, cm, log_a).sum(),
                                 (xdt, bm, cm, log_a))
    a, x = torch.rand(2, 9, 5, requires_grad=True), torch.randn(2, 9, 5, requires_grad=True)
    grads += torch.autograd.grad(kernels.op("rglru")(a, x).sum(), (a, x))
    assert all(torch.isfinite(g).all() for g in grads)
    assert set(kernels.launch_counts().values()) == {0}
