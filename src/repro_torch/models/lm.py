"""Decoder-only LM — dense, MoE, SSM, hybrid and vision-language
families: the port of the JAX package's ``models/lm.py``.

Parameters are a dict: ``embed``, ``pos`` (learned absolute positions,
where ``cfg.attn.learned_pos``), ``frontend_proj`` (the front end's
projection, where ``cfg.frontend``), ``layers`` (a list with one dict per
layer — the JAX package's stacked ``stage{i}/b{j}`` leaves, split, in
the JAX order: stage by stage, repeat by repeat, block by block, which is
``cfg.layer_defs``) and ``final_norm``.  The JAX ``lax.scan`` over each
stage becomes a Python loop over its layers.  A layer's mixer is
attention (global, or a local window), the Griffin RG-LRU block
(``nn/rglru.py``) or the Mamba-2 SSD block (``nn/ssd.py``), as its
``BlockDef`` says; its feed-forward is the dense MLP, the MoE
(``nn/moe.py``) or none.  Norms are ``cfg.norm``'s (rmsnorm or
layernorm); with ``cfg.post_block_norm`` (gemma2) the mixer's and the
feed-forward's outputs are normed again before their residual adds.
The MoE's aux losses are summed in fp32 per stage, then over stages, as
JAX's ``_run_stage`` does.  Caches are one entry per layer in the same
order: a :class:`KvCache` ring of ``min(window, cache_len)`` slots for
attention (a local window's ring wraps), an ``RglruState`` /
``SsdState`` for the recurrent mixers.  Entry points:

* :func:`forward`     — full-sequence forward (no caches),
* :func:`loss_fn`     — the training loss (next-token cross entropy plus
  the MoE aux loss), differentiable by ``torch.autograd``; ``forward``
  and it share one layer stack (``_trunk``),
* :func:`prefill`     — full-sequence forward that also returns the
  per-layer caches (``logit_index`` picks the row whose logits are
  returned, for bucket-padded prompts),
* :func:`prefill_to_pages` — scatter a batch-1 prefill cache into the
  page pools (in place),
* :func:`init_cache` / :func:`mask_cache_after` /
  :func:`mask_cache_rows_after` — dense ring-buffer caches and recurrent
  states for the dense ``Server`` and the speculative draft model,
* :func:`init_paged_cache` — the page pools, bf16 or int8
  (``kv_dtype``; ``"f32"`` gives bf16 pools, as in the JAX package),
* :func:`decode_step` — one (or a few) tokens against dense caches or
  the page pools, bf16 or int8 (dispatch on the cache type).

``forward`` and ``prefill`` take ``frontend_embeds`` (batch, n, frontend
dim): projected by ``frontend_proj`` and prepended to the token
embeddings, before the positions are added.  Learned positions are added
as the JAX package adds them: rows ``0 .. s-1`` of the table for a call of
``s`` tokens, whatever the tokens' absolute positions, so a decode step
or a paged suffix prefill adds the rows of its own call (ROADMAP Queue 3
entry 20).  An encoder-decoder config (whisper-medium) runs here as the
JAX launcher serves it, its encoder unused; ``models/encdec.py`` runs it
whole.  The page pools refuse MoE, recurrent mixers and local windows
with JAX's ``ValueError``: expert capacity scales with the padded call
length, so the bucketed and suffix-only prefills of paged serving would
route real tokens differently, and a recurrent state or a ring has no
pages (serve these with the dense ``Server``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch import kernels
from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.device import DEFAULT, resolve
from repro_torch.dist import tp
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import kvquant
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import rglru as rglru_mod
from repro_torch.nn import ssd as ssd_mod
from repro_torch.nn.attention import KvCache, PagedKvCache
from repro_torch.nn.module import (
    dense,
    dense_spec,
    embed,
    embed_spec,
    head,
    layernorm,
    layernorm_spec,
    positional_embed_spec,
    rmsnorm,
    rmsnorm_spec,
    softcap,
    unembed,
)
from repro_torch.nn.spec import ParamSpec, init_params, stacked


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block the JAX package cannot build
    either: an unknown mixer or feed-forward, or one without its
    sub-config."""
    need = {"attn": ("attn", cfg.attn), "ssd": ("ssm", cfg.ssm), "rglru": ("rglru", cfg.rglru)}
    bad = []
    for i, bd in enumerate(cfg.layer_defs):
        field, sub = need.get(bd.mixer, (None, None))
        if field is None:
            bad.append(f"layer {i} mixer={bd.mixer}")
        elif sub is None:
            bad.append(f"layer {i} mixer={bd.mixer} without cfg.{field}")
        if bd.ff not in ("mlp", "moe", "none"):
            bad.append(f"layer {i} ff={bd.ff}")
        elif bd.ff == "moe" and cfg.moe is None:
            bad.append(f"layer {i} ff=moe without cfg.moe")
    if bad:
        raise ValueError(f"{cfg.name}: unsupported blocks: {', '.join(bad)}")


def _norm_spec(cfg: ModelConfig):
    return rmsnorm_spec(cfg.d_model) if cfg.norm == "rmsnorm" else layernorm_spec(cfg.d_model)


def _norm(cfg: ModelConfig, params, x):
    return rmsnorm(params, x) if cfg.norm == "rmsnorm" else layernorm(params, x)


def _post(cfg: ModelConfig, p, name: str, y):
    """``y`` normed by the layer's post-block norm ``name``, where it has one."""
    return _norm(cfg, p[name], y) if name in p else y


def mlp_spec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    spec = {"w_in": ParamSpec((d, f), axes=("embed", "ff")),
            "w_out": ParamSpec((f, d), axes=("ff", "embed"))}
    if cfg.glu:
        spec["w_gate"] = ParamSpec((d, f), axes=("embed", "ff"))
    return spec


def mlp(params, x, cfg: ModelConfig):
    """The activation rides K1's epilogue.  Where the model axis holds
    this rank's ff columns (:mod:`repro_torch.dist.tp`), ``w_gate`` /
    ``w_in`` are column-parallel (one all-reduce of their input's fp32
    gradient) and ``w_out`` row-parallel: one all-reduce of the fp32
    partial sums, one rounding."""
    tp_ff = tp.split(params["w_in"], 1, cfg.d_ff)
    projs = [(params["w_gate"], None, cfg.act), (params["w_in"], None, None)] if cfg.glu \
        else [(params["w_in"], None, cfg.act)]
    hs = tp.col_linears(x, projs) if tp_ff else \
        [kernels.linear(x, w, activation=act) for w, _, act in projs]
    h = hs[0] * hs[1] if cfg.glu else hs[0]
    return (tp.row_linear if tp_ff else kernels.linear)(h, params["w_out"])


def block_spec(cfg: ModelConfig, bd: BlockDef):
    spec: dict[str, Any] = {"norm1": _norm_spec(cfg)}
    if bd.mixer == "attn":
        spec["attn"] = attn_mod.attn_spec(cfg.d_model, cfg.attn)
    elif bd.mixer == "rglru":
        spec["rglru"] = rglru_mod.rglru_spec(cfg.d_model, cfg.rglru)
    else:
        spec["ssd"] = ssd_mod.ssd_spec(cfg.d_model, cfg.ssm)
    if cfg.post_block_norm:
        spec["norm1_post"] = _norm_spec(cfg)
    if bd.ff == "mlp":
        spec["norm2"] = _norm_spec(cfg)
        spec["mlp"] = mlp_spec(cfg)
    elif bd.ff == "moe":
        spec["norm2"] = _norm_spec(cfg)
        spec["moe"] = moe_mod.moe_spec(cfg.d_model, cfg.moe, glu=cfg.glu)
    if bd.ff != "none" and cfg.post_block_norm:
        spec["norm2_post"] = _norm_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig):
    check_supported(cfg)
    spec: dict[str, Any] = {"embed": embed_spec(cfg.vocab, cfg.d_model)}
    if cfg.attn is not None and cfg.attn.learned_pos:
        spec["pos"] = positional_embed_spec(cfg.max_position, cfg.d_model)
    if cfg.frontend:
        spec["frontend_proj"] = dense_spec(cfg.frontend_dim, cfg.d_model, axes=(None, "embed"))
    # one dict per layer, stage by stage, repeat by repeat, block by block
    # (``cfg.layer_defs``' order), each marked with its stage's repeats
    spec["layers"] = [stacked(block_spec(cfg, bd), repeats)
                      for pattern, repeats in cfg.stages for _ in range(repeats)
                      for bd in pattern]
    spec["final_norm"] = _norm_spec(cfg)
    if not cfg.tie_embeddings:
        spec["unembed"] = {"w": ParamSpec((cfg.d_model, cfg.vocab), axes=("embed", "vocab"))}
    return spec


def init(cfg: ModelConfig, *, seed: int = 0, device: str | torch.device = DEFAULT):
    """Random parameters from ``seed`` (one ``torch.Generator`` per leaf)."""
    return init_params(model_spec(cfg), seed=seed, device=resolve(device))


KV_DTYPES = ("bf16", "f32", "int8")
_DENSE_CACHES = (KvCache, kvquant.QuantKvCache)
_PAGED_CACHES = (PagedKvCache, kvquant.QuantPagedKvCache)


def _check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} (have {KV_DTYPES})")


def _slots(bd: BlockDef, cache_len: int) -> int:
    return min(bd.window, cache_len) if bd.window else cache_len


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, kv_dtype: str = "bf16", *,
               device: str | torch.device = DEFAULT):
    """Dense decode caches, one per layer (the JAX package stacks them by
    layer; here axis 0 of each tensor is the batch): for attention a ring
    of ``min(window, cache_len)`` slots, :class:`KvCache` in bf16 or
    :class:`QuantKvCache` for ``kv_dtype="int8"`` (``"f32"`` gives bf16,
    as in the JAX package); for the recurrent mixers a zero
    ``RglruState`` / ``SsdState``."""
    check_supported(cfg)
    _check_kv_dtype(kv_dtype)
    dev = resolve(device)
    out = []
    for bd in cfg.layer_defs:
        if bd.mixer == "rglru":
            out.append(rglru_mod.init_rglru_state(batch, cfg.d_model, cfg.rglru, device=dev))
        elif bd.mixer == "ssd":
            out.append(ssd_mod.init_ssd_state(batch, cfg.d_model, cfg.ssm, device=dev))
        elif kv_dtype == "int8":
            out.append(kvquant.init_quant_cache(batch, _slots(bd, cache_len), cfg.attn,
                                                device=dev))
        else:
            out.append(attn_mod.init_cache(batch, _slots(bd, cache_len), cfg.attn, device=dev))
    return out


def mask_cache_after(caches, length):
    """Mark every cache position at or past ``length`` empty (pos = -1):
    the fix-up that makes right-padded bucket prefills exact — the padded
    tail's K/V rows stay in the ring but can never be attended to.
    Returns new cache tuples; page pools and recurrent states pass
    through."""
    return [c._replace(pos=torch.where(c.pos >= length, -1, c.pos))
            if isinstance(c, _DENSE_CACHES) else c for c in caches]


def mask_cache_rows_after(caches, lengths: torch.Tensor):
    """Per-row :func:`mask_cache_after`, in place: ``lengths`` is (batch,)
    and row ``b``'s positions at or past ``lengths[b]`` are marked empty.
    The speculative draft needs it after every verify round: it wrote K/V
    for all k proposals, but only the accepted prefix is history.
    Recurrent states pass through untouched."""
    for c in caches:
        if isinstance(c, _DENSE_CACHES):
            bound = lengths.to(device=c.pos.device, dtype=c.pos.dtype)[:, None]
            c.pos.masked_fill_(c.pos >= bound, -1)
    return caches


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     kv_dtype: str = "bf16", *, device: str | torch.device = DEFAULT):
    """One page pool per layer, all indexed by the same host-managed
    block tables: bf16 :class:`PagedKvCache`, or
    :class:`QuantPagedKvCache` for ``kv_dtype="int8"`` (the JAX package
    special-cases int8 only, so ``"f32"`` gives bf16 pools).  An MoE
    block raises JAX's ``ValueError``: expert capacity scales with the
    padded call length, so the bucketed and suffix-only prefills this
    cache implies would route, and drop, real tokens differently than the
    dense path."""
    check_supported(cfg)
    for i, (pattern, _) in enumerate(cfg.stages):
        for j, bd in enumerate(pattern):
            if bd.mixer != "attn" or bd.window is not None or bd.ff == "moe":
                raise ValueError(
                    f"paged KV serving needs global-attention non-MoE blocks; "
                    f"stage {i} block {j} has mixer={bd.mixer!r}, "
                    f"window={bd.window!r}, ff={bd.ff!r} — serve this arch "
                    f"with the dense fallback (--kv dense)"
                )
    _check_kv_dtype(kv_dtype)
    dev = resolve(device)
    if kv_dtype == "int8":
        return [kvquant.init_quant_paged_cache(num_pages, page_size, cfg.attn, device=dev)
                for _ in range(cfg.n_layers)]
    return [attn_mod.init_paged_cache(num_pages, page_size, cfg.attn, device=dev)
            for _ in range(cfg.n_layers)]


def _embed_inputs(params, cfg: ModelConfig, tokens, frontend_embeds=None):
    """Token embeddings (scaled by sqrt(d) where ``cfg.embed_scale``), the
    projected front-end embeddings prepended, then rows ``0 .. s-1`` of the
    position table added, whatever positions the call's tokens hold."""
    x = embed(params["embed"], tokens, vocab=cfg.vocab)
    if cfg.embed_scale:
        x = (x.float() * float(cfg.d_model) ** 0.5).to(x.dtype)
    if frontend_embeds is not None:
        fe = dense(params["frontend_proj"], frontend_embeds).to(x.dtype)
        x = torch.cat([fe, x], dim=1)
    if cfg.attn is not None and cfg.attn.learned_pos:
        x = x + params["pos"]["table"][:x.shape[1]][None].to(x.dtype)
    return x


def _logits(params, cfg: ModelConfig, x):
    """fp32 logits.  The untied head's ``w`` (d, vocab) stays bf16: the JAX
    package widens it to fp32 first, and K1 widens each element in
    registers instead — the same products, exact either way, without an
    fp32 copy of the head.  Dispatch keys on the fp32 activations, as
    the JAX package's does.  Inside a model axis that cuts the
    vocabulary, the logits of this rank's vocabulary rows."""
    if cfg.tie_embeddings:
        out = unembed(params["embed"], x, vocab=cfg.vocab)
    else:
        out = head(x, params["unembed"]["w"], vocab=cfg.vocab)
    return softcap(out, cfg.final_softcap)


def _ff_half(p, cfg, x, ce_reduce=None):
    """x + the layer's feed-forward (dense MLP, MoE or none) -> (x, aux
    loss or None); ``ce_reduce`` as :func:`repro_torch.nn.moe.moe` takes it."""
    if "norm2" not in p:  # ff="none"
        return x, None
    h = _norm(cfg, p["norm2"], x)
    if "moe" in p:
        f, aux = moe_mod.moe(p["moe"], h, cfg.moe, act=cfg.act, glu=cfg.glu,
                             ce_reduce=ce_reduce)
        return x + _post(cfg, p, "norm2_post", f), aux
    return x + _post(cfg, p, "norm2_post", mlp(p["mlp"], h, cfg)), None


def _kv_from_full(k, v, bd: BlockDef, cache_slots: int | None) -> KvCache:
    """The decode cache of a prefill's keys and values (positions 0 ..
    s-1): ``min(window, max(cache_slots, s))`` slots; where the ring is
    shorter than the prompt it keeps the last ``slots`` positions, each at
    slot ``position % slots``."""
    b, s = k.shape[0], k.shape[1]
    slots = _slots(bd, max(cache_slots or s, s))
    # a row of its own per sequence: decode writes each row's positions
    positions = torch.arange(s, device=k.device, dtype=torch.int32).repeat(b, 1)
    if slots >= s:
        pad = slots - s
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            positions = torch.nn.functional.pad(positions, (0, pad), value=-1)
        return KvCache(k=k, v=v, pos=positions)
    idx = torch.arange(s - slots, s, device=k.device)  # the absolute positions kept
    ring = idx % slots
    k_r = torch.zeros((b, slots, *k.shape[2:]), dtype=k.dtype, device=k.device)
    v_r = torch.zeros_like(k_r)
    pos = torch.full((b, slots), -1, dtype=torch.int32, device=k.device)
    k_r[:, ring] = k[:, s - slots:]
    v_r[:, ring] = v[:, s - slots:]
    pos[:, ring] = idx.to(torch.int32)
    return KvCache(k=k_r, v=v_r, pos=pos)


def _mixer(p, bd: BlockDef, cfg: ModelConfig, h, *, cache_slots=None, want_cache=False):
    """A layer's mixer over a full sequence -> (out, its decode cache: the
    recurrent state, or with ``want_cache`` the attention ring)."""
    if bd.mixer == "rglru":
        return rglru_mod.rglru(p["rglru"], h, cfg.rglru)
    if bd.mixer == "ssd":
        return ssd_mod.ssd(p["ssd"], h, cfg.ssm)
    m, (k, v) = attn_mod.attention(p["attn"], h, cfg.attn, window=bd.window)
    return m, (_kv_from_full(k, v, bd, cache_slots) if want_cache else None)


def _stage_ends(cfg: ModelConfig) -> set[int]:
    """The index of each stage's last layer in ``params["layers"]``."""
    ends, n = set(), 0
    for pattern, repeats in cfg.stages:
        n += len(pattern) * repeats
        ends.add(n - 1)
    return ends


def _layer(p, bd: BlockDef, cfg: ModelConfig, x, ce_reduce=None):
    """One layer over a full sequence -> (x, its fp32 aux loss: 0 without
    MoE)."""
    m, _ = _mixer(p, bd, cfg, _norm(cfg, p["norm1"], x))
    x, aux = _ff_half(p, cfg, x + _post(cfg, p, "norm1_post", m), ce_reduce)
    return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux


def _trunk(params, cfg: ModelConfig, x, *, remat: bool = False, ce_reduce=None):
    """The layer stack over a full sequence, then the final norm -> (x,
    fp32 aux loss): the MoE layers' aux losses summed within each stage,
    then the stages' sums, in JAX's order (0 without MoE).  ``remat``
    recomputes each layer in the backward instead of keeping its
    activations (``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps
    JAX's stage body).  ``ce_reduce`` reaches every MoE layer
    (:func:`repro_torch.nn.moe.moe`)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_total, aux_stage = zero, zero
    ends = _stage_ends(cfg)
    for i, (p, bd) in enumerate(zip(params["layers"], cfg.layer_defs)):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(_layer, p, bd, cfg, x, ce_reduce,
                                                       use_reentrant=False)
        else:
            x, aux = _layer(p, bd, cfg, x, ce_reduce)
        aux_stage = aux_stage + aux
        if i in ends:
            aux_total, aux_stage = aux_total + aux_stage, zero
    return _norm(cfg, params["final_norm"], x), aux_total


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend_embeds: torch.Tensor | None = None, ce_reduce=None):
    """(batch, seq) tokens -> ((batch, [n +] seq, vocab) fp32 logits, fp32
    aux loss, see :func:`_trunk`).  ``frontend_embeds`` (batch, n,
    frontend dim) are projected and prepended; ``ce_reduce`` as
    :func:`loss_fn` takes it."""
    x, aux_total = _trunk(params, cfg, _embed_inputs(params, cfg, tokens, frontend_embeds),
                          ce_reduce=ce_reduce)
    return _logits(params, cfg, x), aux_total


def loss_fn(params, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor, *,
            frontend_embeds: torch.Tensor | None = None, remat: bool = False,
            loss_chunk: int | None = 512, aux_weight: float = 0.01,
            ce_reduce=None) -> torch.Tensor:
    """Mean next-token cross entropy on the fp32 logits, plus
    ``aux_weight`` x the MoE aux loss.  ``ce_reduce``: over a mesh whose
    batch splits over ranks, the mean over the batch ranks of each MoE
    layer's routing fractions (:func:`repro_torch.nn.moe.moe`), which the
    mesh step supplies; None on one device.

    Above ``loss_chunk`` positions the cross entropy runs over sequence
    chunks of that length (the sequence must divide into them, as JAX's
    reshape requires), each chunk's (batch, chunk, vocab) logits
    recomputed in the backward instead of kept (``torch.utils.checkpoint``,
    as JAX's ``jax.checkpoint`` of its scan body): the full fp32 logits
    never exist at once."""
    x, aux_total = _trunk(params, cfg, _embed_inputs(params, cfg, tokens, frontend_embeds),
                          remat=remat, ce_reduce=ce_reduce)
    b, s, d = x.shape
    if loss_chunk is None or s <= loss_chunk:
        ce = _ce(params, cfg, x, labels)
    else:
        n = s // loss_chunk
        xc = x.reshape(b, n, loss_chunk, d)
        lc = labels.reshape(b, n, loss_chunk)
        if x.is_meta:  # the dry run: one chunk, counted n times
            return _meta_chunks(params, cfg, xc, lc) + aux_weight * aux_total
        ce = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            ce = ce + torch.utils.checkpoint.checkpoint(
                _ce, params, cfg, xc[:, i], lc[:, i], use_reentrant=False) * (1.0 / n)
    return ce + aux_weight * aux_total


def _meta_chunks(params, cfg: ModelConfig, xc, lc) -> torch.Tensor:
    """The chunked cross entropy on ``meta`` tensors (the dry run): the
    first chunk's, recomputed in its backward as each chunk is, counted
    as every chunk's (``tp.repeated``)."""
    head_key = ("embed", "table") if cfg.tie_embeddings else ("unembed", "w")

    def one(xi, li, w):
        p = {head_key[0]: {head_key[1]: w}}
        return torch.utils.checkpoint.checkpoint(_ce, p, cfg, xi, li, use_reentrant=False)

    return tp.repeated(xc.shape[1], one, xc[:, 0], lc[:, 0], params[head_key[0]][head_key[1]])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  vocab: int | None = None) -> torch.Tensor:
    """Mean of logsumexp(logits) - the labels' logits, over every position.
    Where the model axis holds this rank's columns of ``vocab`` logits,
    vocab-parallel, in fp32: the maximum, the sum of exponentials and the
    gold logit each all-reduced over the axis."""
    if vocab is None or not tp.split(logits, -1, vocab):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - gold)
    start, n = tp.active().piece(vocab)
    m = tp.all_max(logits.amax(dim=-1))
    sumexp = tp.reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = labels.long() - start
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(mine, local, torch.zeros_like(local))[..., None])
    gold = tp.reduce_out(torch.where(mine, gold[..., 0], torch.zeros_like(gold[..., 0])))
    return torch.mean(torch.log(sumexp) + m - gold)


def _ce(params, cfg: ModelConfig, x, labels):
    return cross_entropy(_logits(params, cfg, x), labels, vocab=cfg.vocab)  # fp32 logits


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend_embeds: torch.Tensor | None = None,
            cache_slots: int | None = None, logit_index=None):
    """Forward over the prompt -> (logits (b, 1, vocab), per-layer caches:
    :class:`KvCache` rings, recurrent states).  ``cache_slots`` sizes the
    rings (a global layer's ring holds at least the prompt; a local one
    ``min(window, max(cache_slots, s))`` slots, keeping the last
    positions where the prompt is longer); ``logit_index`` (scalar or
    (b,)) picks the position whose logits are returned instead of the
    last — right-padded bucketed prompts read their true last token.
    ``frontend_embeds`` (batch, n, frontend dim) are projected and
    prepended: the caches then hold ``n + seq`` positions."""
    b = tokens.shape[0]
    x = _embed_inputs(params, cfg, tokens, frontend_embeds)
    caches = []
    for p, bd in zip(params["layers"], cfg.layer_defs):
        m, cache = _mixer(p, bd, cfg, _norm(cfg, p["norm1"], x), cache_slots=cache_slots,
                          want_cache=True)
        caches.append(cache)
        x, _ = _ff_half(p, cfg, x + _post(cfg, p, "norm1_post", m))
    x = _norm(cfg, params["final_norm"], x)
    if logit_index is None:
        sel = x[:, -1:, :]
    else:
        li = torch.as_tensor(logit_index, device=x.device).reshape(-1).long().expand(b)
        sel = x[torch.arange(b, device=x.device), li][:, None, :]
    return _logits(params, cfg, sel), caches


def prefill_to_pages(dense_caches, paged_caches, block_table: torch.Tensor, length: int):
    """Scatter a batch-1 dense prefill cache into the page pools, in place.

    ``block_table``: (pages,) page ids covering ``[0, pages * page_size)``;
    rows past ``length`` (bucket padding) go to the null page 0, so the
    page bytes equal what the dense cache holds for the real tokens.
    int8 pools take the rows quantised (:func:`kvquant.quantize_kv`)."""
    for dense_c, paged_c in zip(dense_caches, paged_caches):
        ps = paged_c.k_pages.shape[2]
        s_pad = dense_c.k.shape[1]
        pos = torch.arange(s_pad, device=block_table.device)
        valid = pos < length
        pidx = torch.clamp(pos // ps, 0, block_table.shape[0] - 1)
        ids = torch.where(valid, block_table.long()[pidx], torch.zeros_like(pos))
        rows = torch.where(valid, pos % ps, torch.zeros_like(pos))
        # (1, s_pad, kv, hd) -> (kv, s_pad, hd)
        k = dense_c.k[0].transpose(0, 1)
        v = dense_c.v[0].transpose(0, 1)
        if isinstance(paged_c, kvquant.QuantPagedKvCache):
            kq, ks = kvquant.quantize_kv(k)
            vq, vs = kvquant.quantize_kv(v)
            paged_c.k_pages[:, ids, rows] = kq
            paged_c.v_pages[:, ids, rows] = vq
            paged_c.k_scale[:, ids, rows] = ks
            paged_c.v_scale[:, ids, rows] = vs
        else:
            paged_c.k_pages[:, ids, rows] = k.to(paged_c.k_pages.dtype)
            paged_c.v_pages[:, ids, rows] = v.to(paged_c.v_pages.dtype)
    return paged_caches


def decode_step(params, cfg: ModelConfig, caches, tokens: torch.Tensor, index, *,
                block_table: torch.Tensor | None = None,
                lengths: torch.Tensor | None = None):
    """One decode step (or a few: suffix prefills and verify steps pass
    s_new > 1; the recurrent mixers take one token) against dense caches
    or the page pools, bf16 or int8 (dispatch on the cache type).  Rings
    and pools are updated in place; recurrent states are replaced, so the
    returned list is a new one and ``caches`` keeps the states it had.

    tokens: (batch, s_new); index: absolute position of the first new
    token (scalar or (batch,)).  Page pools also take ``block_table``
    (batch, pages) and ``lengths`` (batch,) = valid tokens after this
    call's writes.  Returns (logits (batch, s_new, vocab), caches)."""
    x = _embed_inputs(params, cfg, tokens)
    new_caches = []
    for p, bd, cache in zip(params["layers"], cfg.layer_defs, caches):
        h = _norm(cfg, p["norm1"], x)
        if bd.mixer == "rglru":
            m, cache = rglru_mod.rglru_step(p["rglru"], h, cache, cfg.rglru)
        elif bd.mixer == "ssd":
            m, cache = ssd_mod.ssd_step(p["ssd"], h, cache, cfg.ssm)
        elif isinstance(cache, _PAGED_CACHES):
            paged_fn = (kvquant.quant_paged_decode_attention
                        if isinstance(cache, kvquant.QuantPagedKvCache)
                        else attn_mod.paged_decode_attention)
            m, _ = paged_fn(p["attn"], h, cache, cfg.attn, index=index,
                            block_table=block_table, lengths=lengths)
        else:
            decode_fn = (kvquant.quant_decode_attention
                         if isinstance(cache, kvquant.QuantKvCache)
                         else attn_mod.decode_attention)
            m, _ = decode_fn(p["attn"], h, cache, cfg.attn, index=index, window=bd.window)
        new_caches.append(cache)
        x, _ = _ff_half(p, cfg, x + _post(cfg, p, "norm1_post", m))
    x = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, x), new_caches
