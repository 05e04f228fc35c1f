"""Draft-token proposers for speculative decoding: the port of the JAX
package's ``serve/spec.py``.

The engine's verify-accept loop (``PagedEngine._step_spec``) is
draft-agnostic: each round it asks a proposer for ``k`` tokens per live
slot, scores all of them in ONE chunked ``decode_step`` on the target
model (K3 at ``s = k + 1``: one fetch of each KV page for the whole
burst), and commits the accepted prefix.  Two proposers:

* :class:`ModelDraft` — a second, small model of the same tokenizer
  (``configs.registry.draft_for``) on a dense ring-buffer KV cache on the
  engine's device, through the same kernel dispatch as every other model
  call.  It keeps one cache row per engine slot and resyncs a row by a
  bucketed prefill whenever the slot's (rid, committed length) no longer
  matches — so forks, preemption and slot reuse all reduce to "the draft
  re-reads history", never trusted;
* :class:`NgramDraft` — prompt-lookup decoding: propose the continuation
  of the most recent earlier occurrence of the stream's trailing n-gram.
  No parameters and no cache.

Draft-cache invariant (ModelDraft): after ``observe``, row ``slot`` holds
K/V for exactly the committed tokens ``tokens[:length]`` — rejected rows
are masked unattendable (``lm.mask_cache_rows_after``, pos = -1), not
rewritten, as the paged engine leaves stale page rows past ``lengths``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DEFAULT, resolve
from repro_torch.models import lm
from repro_torch.obs import trace
from repro_torch.serve.sampling import Sampler
from repro_torch.serve.scheduler import pad_to_bucket


@dataclasses.dataclass(frozen=True)
class SlotView:
    """What a proposer may know about a live slot: the request id, the
    visible token history (committed prefix + the one pending token), and
    the committed K/V length (= ``len(tokens) - 1``)."""

    rid: int
    tokens: tuple[int, ...]
    length: int


class DraftModel:
    """Proposer interface for the engine's verify-accept loop."""

    def propose(self, views: dict[int, SlotView], k: int) -> np.ndarray:
        """Propose ``k`` tokens per slot -> (max_slots, k) int32.  Rows
        without a live view are ignored by the engine."""
        raise NotImplementedError

    def observe(self, new_lengths: dict[int, int]) -> None:
        """Post-commit notification: slot -> new committed length.
        Stateful drafts roll their caches back here."""

    def forget(self, slot: int) -> None:
        """The slot finished; drop draft state."""

    def warmup(self, bucket_lens, k: int) -> int:
        """Run each draft program once; returns how many ran."""
        return 0


class NgramDraft(DraftModel):
    """Prompt-lookup drafting: continue the most recent earlier occurrence
    of the stream's trailing n-gram (longest first, searched from the
    end).  The token history is the whole state."""

    def __init__(self, max_slots: int, *, max_ngram: int = 3):
        self.max_slots = max_slots
        self.max_ngram = max_ngram

    def _lookup(self, toks: tuple[int, ...], k: int) -> list[int]:
        n = len(toks)
        for nlen in range(min(self.max_ngram, n - 1), 0, -1):
            pat = toks[n - nlen:]
            for start in range(n - nlen - 1, -1, -1):
                if toks[start:start + nlen] == pat:
                    cont = list(toks[start + nlen:start + nlen + k])
                    if cont:
                        return cont + [toks[-1]] * (k - len(cont))
        return [toks[-1]] * k  # no repeat found: guess a constant stream

    def propose(self, views, k):
        out = np.zeros((self.max_slots, k), np.int32)
        for slot, view in views.items():
            out[slot] = self._lookup(tuple(view.tokens), k)
        return out


class ModelDraft(DraftModel):
    """A second, small model proposing greedily from its own dense
    ring-buffer KV cache (one row per engine slot, on ``device``).

    ``propose`` resyncs any row whose tracked (rid, length) disagrees with
    the engine's view by a bucketed prefill over the committed tokens;
    ``observe`` masks the rejected rows after a verify round, leaving
    every row exactly ``new_length`` long."""

    def __init__(self, cfg, params, *, max_slots: int, cache_len: int,
                 prompt_bucket: int = 16, sampler: Sampler,
                 kernel_calls: Optional[Counter] = None,
                 device: str | torch.device = DEFAULT):
        if not all(bd.mixer == "attn" and bd.window is None and bd.ff != "moe"
                   for bd in cfg.layer_defs):
            raise ValueError(
                f"ModelDraft needs a bucket-servable draft (attention-only, "
                f"global windows, non-MoE): {cfg.name}")
        self.device = resolve(device)
        if params["embed"]["table"].device != self.device:
            raise ValueError(f"draft params live on {params['embed']['table'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.sampler = sampler
        self.kernel_calls = kernel_calls if kernel_calls is not None else Counter()
        self._bucket = prompt_bucket
        self.caches = lm.init_cache(cfg, max_slots, cache_len, device=self.device)
        self._rid = np.full(max_slots, -1, np.int64)
        self._len = np.zeros(max_slots, np.int32)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _span(self, name, t0, rec, **args):
        if rec is not None:
            rec.complete(f"engine.{name}", t0, cat="kernel", args=args)

    def _prefill_into(self, slot: int, ctx: list[int]) -> None:
        """Bucketed prefill of ``ctx`` into row ``slot``, its padded tail
        masked."""
        toks = self._tensor(pad_to_bucket(ctx, self._bucket)).long()
        _, one = lm.prefill(self.params, self.cfg, toks, cache_slots=self.cache_len,
                            logit_index=len(ctx) - 1)
        for full, c in zip(self.caches, lm.mask_cache_after(one, len(ctx))):
            for dst, src in zip(full, c):  # axis 0 is the batch
                dst[slot:slot + 1] = src

    def _resync(self, slot: int, view: SlotView) -> None:
        ctx = list(view.tokens[:view.length])
        rec = trace.active()
        t0 = rec.now() if rec is not None else 0.0
        self.kernel_calls["draft_prefill"] += 1
        self._prefill_into(slot, ctx)
        self._span("draft_prefill", t0, rec, slot=slot, len=len(ctx))
        self._rid[slot] = view.rid
        self._len[slot] = view.length

    def _decode(self, toks: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        logits, _ = lm.decode_step(self.params, self.cfg, self.caches,
                                   self._tensor(toks).long()[:, None],
                                   self._tensor(idx).long())
        return logits

    def propose(self, views, k):
        for slot, view in views.items():
            if self._rid[slot] != view.rid or self._len[slot] != view.length:
                self._resync(slot, view)
        toks = np.zeros(self.max_slots, np.int32)
        idx = np.zeros(self.max_slots, np.int32)
        for slot, view in views.items():
            toks[slot] = view.tokens[-1]
            idx[slot] = view.length
        drafts = np.zeros((self.max_slots, k), np.int32)
        rec = trace.active()
        for j in range(k):
            t0 = rec.now() if rec is not None else 0.0
            self.kernel_calls["draft_decode"] += 1
            logits = self._decode(toks, idx)
            self._span("draft_decode", t0, rec, step=j, n_slots=len(views))
            toks = self.sampler.select(logits)[:, -1]
            drafts[:, j] = toks
            idx += 1
        for slot in views:
            self._len[slot] += k
        return drafts

    def observe(self, new_lengths):
        if not new_lengths:
            return
        # mask the rejected rows; untouched slots get a bound no cache
        # position reaches
        bound = np.full(self.max_slots, self.cache_len, np.int32)
        for slot, n in new_lengths.items():
            bound[slot] = n
            self._len[slot] = n
        lm.mask_cache_rows_after(self.caches, self._tensor(bound))

    def forget(self, slot):
        self._rid[slot] = -1
        self._len[slot] = 0

    def warmup(self, bucket_lens, k: int) -> int:
        """Run each draft program once — a prefill per bucket length, a
        decode step and a mask — on scratch caches, leaving the live rows
        untouched; returns how many ran.  (The JAX package compiles them
        here; eager PyTorch has nothing to compile, but the first calls
        load the kernels.)"""
        live, self.caches = self.caches, lm.init_cache(
            self.cfg, self.max_slots, self.cache_len, device=self.device)
        try:
            buckets = sorted(set(bucket_lens))
            for blen in buckets:
                self._prefill_into(0, [0] * blen)
            self._decode(np.zeros(self.max_slots, np.int32), np.zeros(self.max_slots, np.int32))
            lm.mask_cache_rows_after(self.caches, self._tensor(
                np.full(self.max_slots, self.cache_len, np.int32)))
        finally:
            self.caches = live
        return len(buckets) + 2


def make_draft(serve_cfg, target_cfg, *, draft=None, max_slots: int, cache_len: int,
               sampler: Sampler, kernel_calls: Optional[Counter] = None,
               device: str | torch.device = DEFAULT) -> Optional[DraftModel]:
    """Build the proposer a :class:`~repro_torch.serve.config.ServeConfig`
    asks for (None when speculative decoding is off).

    ``draft`` is the ``(draft_cfg, draft_params)`` pair of a model draft;
    the registry pairing is validated here, so an incompatible pair fails
    at engine construction, not mid-stream."""
    if not serve_cfg.spec_k:
        return None
    name = serve_cfg.draft_model
    if name == "ngram":
        return NgramDraft(max_slots)
    from repro_torch.configs import registry
    if draft is None:
        raise registry.DraftPairingError(
            f"draft_model={name!r} needs draft=(cfg, params) at engine "
            f"construction (launch/serve.py initialises it from the "
            f"registry)")
    dcfg, dparams = draft
    registry.validate_draft_pair(target_cfg, dcfg)
    return ModelDraft(dcfg, dparams, max_slots=max_slots, cache_len=cache_len,
                      prompt_bucket=serve_cfg.prompt_bucket, sampler=sampler,
                      kernel_calls=kernel_calls, device=device)
