"""The rank functions of the model-axis tests (``tests/test_torch_tp.py``),
started by ``repro_torch.dist.spawn.run`` on gloo ranks: importable by
name, no JAX, results as plain Python and numpy values.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.data import pipeline
from repro_torch.dist import mcast, sharding, tp
from repro_torch.dist.step import build_prefill_step, build_train_step, gather_logits
from repro_torch.launch.mesh import bind, make_debug_mesh
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw

#: the archs whose train step computes over the model axis, and mamba2
#: (which leaves it idle: its batch spreads over data and model)
ARCHS = ("qwen1.5-0.5b", "gemma2-9b", "moonshot-v1-16b-a3b", "recurrentgemma-2b",
         "whisper-medium")
MAMBA = "mamba2-780m"
#: the train steps' shape and schedule, shared with the one-device runs
TRAIN = dict(batch=8, seq=16, steps=4, lr=3e-3, seed=0)
#: the mesh prefill's shape
PREFILL = dict(batch=8, seq=16, seed=11)
#: recurrentgemma's RG-LRU shards over the model axis only at d_model >=
#: 2048; the reduced config's 64 is let through by lowering the floor in
#: the processes that test it (both packages' rule reads the constant)
RNN_FLOOR = 64


#: the dry-run comparisons: reduced cells' shapes (kind, seq, batch), the
#: step variants and the debug meshes ((pod,) data, model)
DRY_SHAPES = {"dtrain": ("train", 32, 8), "dprefill": ("prefill", 32, 8),
              "ddecode": ("decode", 32, 8)}
DRY_CELLS = {"train": ("dtrain", {}), "train_fsdp": ("dtrain", {"fsdp": True}),
             "train_compress": ("dtrain", {"compress_pod_grads": True}),
             "prefill": ("dprefill", {}), "decode": ("ddecode", {})}
DRY_MESHES = {"2x2": (2, 2, None), "2x2x2": (2, 2, 2)}
#: the one-device prefills whose dot FLOPs are held to JAX's
FLOP_ARCHS = ("qwen1.5-0.5b", "moonshot-v1-16b-a3b")


def data_cfg(cfg) -> pipeline.DataConfig:
    return pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                               global_batch=TRAIN["batch"], seed=TRAIN["seed"])


def frames_np(cfg, step: int) -> np.ndarray:
    """whisper's frame embeddings of a train step (fp32; each package
    rounds them to bf16)."""
    rng = np.random.default_rng(1000 + step)
    return rng.standard_normal((TRAIN["batch"], cfg.encoder.n_frames, cfg.frontend_dim)
                               ).astype(np.float32)


def batch_np(cfg, step: int) -> dict:
    """The global batch of a train step: ``global_batch_np``'s rows, and
    frames for whisper."""
    out = dict(pipeline.global_batch_np(data_cfg(cfg), step))
    if cfg.family == "audio":
        out["frames"] = frames_np(cfg, step)
    return out


def rows(cfg, step: int, mesh, batch_axes) -> dict:
    """This rank's rows of the global batch (all of them without a mesh)."""
    full = batch_np(cfg, step)
    start, n = (0, TRAIN["batch"]) if mesh is None else \
        pipeline.shard_rows(TRAIN["batch"], mesh, batch_axes)
    out = {k: torch.from_numpy(np.ascontiguousarray(v[start:start + n])) for k, v in full.items()}
    if "frames" in out:
        out["frames"] = out["frames"].bfloat16()
    return out


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def _shape() -> ShapeCfg:
    return ShapeCfg("tp", "train", TRAIN["seq"], TRAIN["batch"])


def _opt() -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=TRAIN["lr"], warmup_steps=5, total_steps=TRAIN["steps"])


def train_on(arch: str, mesh_shape: tuple, params: dict, fsdp: bool = False) -> dict:
    """``arch``'s reduced train step on a ``mesh_shape`` mesh, ``TRAIN``'s
    steps from ``params`` (full): the losses, on rank 0 the final
    parameters gathered, and what the recorder saw — the collectives of
    step 0 by (op, axis, site), and those of one forward (``loss_of``)."""
    cfg = get_config(arch, reduced=True)
    mesh = bind(make_debug_mesh(*mesh_shape[-2:], pod=mesh_shape[0]
                                if len(mesh_shape) == 3 else None))
    b = build_train_step(cfg, _shape(), mesh=mesh, fsdp=fsdp, opt_cfg=_opt(), loss_chunk=None)
    p = sharding.shard_tree(tree.map_structure(torch.clone, params), b.placements, mesh)
    opt = adamw.init(p, _opt())
    out = {"batch_axes": b.batch_axes, "model_axis": b.model_axis is not None,
           "model_cut": sum("model" in pl.spec for pl in tree.leaves(b.placements))}
    with torch.no_grad(), tp.recording() as fwd:
        mine = sharding.gather_tree(p, b.placements, mesh,
                                    keep=("model",) if b.model_axis else ())
        with tp.model_axis(b.model_axis):
            b.loss_of(mine, rows(cfg, 0, mesh, b.batch_axes))
    out["forward"] = _tally(fwd)
    losses = []
    for step in range(TRAIN["steps"]):
        with tp.recording() as rec:
            p, opt, loss, _ = b.fn(p, opt, rows(cfg, step, mesh, b.batch_axes), step)
        if step == 0:
            out["step0"] = _tally(rec)
        losses.append(float(loss))
    out["losses"] = losses
    full = sharding.gather_tree(p, b.placements, mesh)
    if mesh.rank == 0:
        out["params"] = {k: _np(v) for k, v in tree.flatten_with_paths(full).items()}
    return out


def _tally(rec: tp.Recorder) -> dict:
    out: dict = {}
    for op, axis, _, count, site in rec.events:
        out[(op, axis, site)] = out.get((op, axis, site), 0) + count
    return out


#: the witnesses: one bf16 ulp flipped in the layer-0 input elements
#: whose flat index a pattern selects (``input``), or in those elements
#: of the gradient that reaches that input (``grad``).  Every arch's
#: witness flips every input element; whisper's reduced run amplifies any
#: such flip past step 1 (ROADMAP Queue 3 entry 34), so its witness is
#: the largest gap of all twelve
FLIPS = {"all": lambda i: i >= 0, "even": lambda i: i % 2 == 0, "odd": lambda i: i % 2 == 1,
         "third": lambda i: i % 3 == 0, "third+1": lambda i: i % 3 == 1,
         "first half": lambda i: i < i.numel() // 2}
WITNESSES = {"whisper-medium": [(where, f) for where in ("input", "grad") for f in FLIPS]}
WITNESS = [("input", "all")]


def _flip(x: torch.Tensor, pattern: str) -> torch.Tensor:
    mask = FLIPS[pattern](torch.arange(x.numel()).reshape(x.shape)).to(torch.int16)
    return (x.view(torch.int16) ^ mask).view(torch.bfloat16)


class _GradFlip(torch.autograd.Function):
    """Identity forward; backward, the gradient's last bit flipped in the
    elements ``pattern`` selects."""

    @staticmethod
    def forward(ctx, x, pattern):
        ctx.pattern = pattern
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _flip(g, ctx.pattern), None


def alone(arch: str, params: dict, flip: tuple[str, str] | None = None) -> dict:
    """The same steps on one device; ``flip``: a witness (:data:`FLIPS`),
    ``(where, pattern)`` — for whisper the decoder's layer-0 input, and
    for ``input`` its frames too (``tests/test_torch_encdec.py``'s
    witness), since its encoder is a layer stack of its own."""
    cfg = get_config(arch, reduced=True)
    b = build_train_step(cfg, _shape(), opt_cfg=_opt(), loss_chunk=None)
    mod, name = (encdec, "_dec_embed") if cfg.family == "audio" else (lm, "_embed_inputs")
    real = getattr(mod, name)

    where, pattern = flip or (None, None)

    def flipped(*a, **k):
        y = real(*a, **k)
        return _flip(y, pattern) if where == "input" else _GradFlip.apply(y, pattern)

    p = tree.map_structure(torch.clone, params)
    opt = adamw.init(p, _opt())
    losses = []
    with mock.patch.object(mod, name, flipped) if flip else contextlib.nullcontext():
        for step in range(TRAIN["steps"]):
            batch = rows(cfg, step, None, ())
            if where == "input" and "frames" in batch:
                batch["frames"] = _flip(batch["frames"], pattern)
            p, opt, loss, _ = b.fn(p, opt, batch, step)
            losses.append(float(loss))
    return {"losses": losses,
            "params": {k: _np(v) for k, v in tree.flatten_with_paths(p).items()}}


def prefill_tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(PREFILL["seed"])
    return torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL["batch"], PREFILL["seq"]))
                            .astype(np.int32))


def prefill_on(arch: str, mesh_shape: tuple, params: dict, fsdp: bool = False) -> dict:
    """The mesh prefill of ``arch``: rank 0's gathered logits, and the
    shapes of this rank's pieces (logits, the first attention cache)."""
    cfg = get_config(arch, reduced=True)
    mesh = bind(make_debug_mesh(*mesh_shape))
    shape = ShapeCfg("tpprefill", "prefill", PREFILL["seq"], PREFILL["batch"])
    b = build_prefill_step(cfg, shape, mesh=mesh, fsdp=fsdp)
    p = sharding.shard_tree(tree.map_structure(torch.clone, params), b.placements, mesh)
    start, n = pipeline.shard_rows(PREFILL["batch"], mesh, b.batch_axes)
    with torch.no_grad():
        logits, caches = b.fn(p, {"tokens": prefill_tokens(cfg)[start:start + n]})
        full = gather_logits(b, logits, mesh, cfg.vocab)
    k = next(c.k for c in caches if hasattr(c, "k"))
    return {"logits": _np(full) if mesh.rank == 0 else None,
            "piece": tuple(logits.shape), "cache_k": tuple(k.shape)}


def _decode(params: dict, mesh=None) -> np.ndarray:
    """The reduced qwen's decode step at position 8, after a one-device
    prefill of 8 tokens (2 rows): its logits, through a bundle built over
    ``mesh`` with FSDP asked for (None: the one-device bundle)."""
    from repro_torch.dist.step import build_decode_step

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    tokens = prefill_tokens(cfg)[:2, :9]
    shape = ShapeCfg("tpdecode", "decode", 8, 2)
    b = build_decode_step(cfg, shape, mesh=mesh, fsdp=mesh is not None)
    with torch.no_grad():
        _, caches = lm.prefill(params, cfg, tokens[:, :8])
        return _np(b.fn(params, caches, tokens[:, 8:], 8)[0])


def decode_alone(params: dict) -> np.ndarray:
    return _decode(params)


def mcast_counts(n: int) -> dict:
    """Each mode's broadcast and weight gather over ``n`` ranks, as the
    recorder counts their collectives."""
    mesh = bind(make_debug_mesh(n, 1))
    out = {}
    x = torch.arange(32.0).reshape(4, 8)
    for mode in mcast.MODES:
        with tp.recording() as rec:
            mcast.make_broadcast_fn(mesh, x.shape, x.dtype, mode)(x)
        out[f"bcast/{mode}"] = _tally(rec)
        w = torch.ones(2, 3)
        with tp.recording() as rec:
            mcast.make_weight_gather_fn(mesh, (2 * n, 3), w.dtype, mode)(w)
        out[f"gather/{mode}"] = _tally(rec)
    return out


def subgroup_ranks() -> dict:
    """On a (2, 2, 2) mesh: the ranks of this rank's group over (data,
    model) and over (pod, model) — groups over some axes of a mesh whose
    other axes hold more than one rank."""
    import torch.distributed as dist

    mesh = bind(make_debug_mesh(2, 2, pod=2))
    return {axes: dist.get_process_group_ranks(mesh.group(axes))
            for axes in (("data", "model"), ("pod", "model"), ("pod", "data"))}


def two_ranks(params: dict) -> dict:
    """The 1 x 2 cases: the reduced qwen, FSDP off and on (FSDP on a data
    axis of one rank cuts nothing), and its decode step over the mesh."""
    q = params["qwen1.5-0.5b"]
    out = {("qwen1.5-0.5b", (1, 2), f): train_on("qwen1.5-0.5b", (1, 2), q, f)
           for f in (False, True)}
    out["decode"] = _decode(q, bind(make_debug_mesh(1, 2)))
    return out


def four_ranks(params: dict) -> dict:
    """The 2 x 2 cases: qwen with FSDP off and on, the other archs with
    it off, and qwen's mesh prefill."""
    from repro_torch.dist import sharding as port_sharding

    port_sharding._RNN_TP_MIN_D_MODEL = RNN_FLOOR
    out = {("qwen1.5-0.5b", (2, 2), True): train_on("qwen1.5-0.5b", (2, 2),
                                                    params["qwen1.5-0.5b"], True)}
    for arch in ARCHS:
        out[(arch, (2, 2), False)] = train_on(arch, (2, 2), params[arch], False)
    out["prefill"] = prefill_on("qwen1.5-0.5b", (2, 2), params["qwen1.5-0.5b"])
    return out


def eight_ranks(params: dict) -> dict:
    """The 8-rank cases: mamba2's step on (2, 2, 2), the subgroups the
    repaired ``BoundMesh.group`` gives, and the mcast modes at N = 8."""
    return {"mamba": train_on(MAMBA, (2, 2, 2), params[MAMBA]),
            "groups": subgroup_ranks(), "mcast": mcast_counts(8)}


__all__ = ["ARCHS", "DRY_CELLS", "DRY_MESHES", "DRY_SHAPES", "FLIPS", "FLOP_ARCHS", "MAMBA",
           "TRAIN", "WITNESS", "WITNESSES",
           "alone", "batch_np", "decode_alone", "eight_ranks", "four_ranks", "frames_np",
           "prefill_tokens", "rows", "two_ranks"]
