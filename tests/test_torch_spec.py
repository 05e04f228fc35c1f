"""Speculative decoding and int8 page pools on the port's ``PagedEngine``
(``serve/spec.py``, ``Sampler.verify``, the registry's draft pairing),
ported from ``tests/test_spec_decode.py`` where the port has the
features, and held to the JAX package's ``PagedEngine``.

* Token identity with JAX: on the reduced ``qwen1.5-1.8b`` target and
  its registered ``qwen1.5-0.5b`` draft (both from the same seed, as the
  launchers initialise them, converted by ``weights.from_jax_params``),
  every run of ``SPEC_RUNS`` — ``spec_k=4`` under the n-gram and the
  model draft, on bf16 and on int8 pools — gives JAX's streams and JAX's
  speculative counters, and the launcher's stdout for the slice's
  command equals the JAX launcher's.  The JAX side runs in a child
  process with XLA's excess precision off, every kernel under
  ``backend=pallas`` (``_torch_jax_ref.py spec``).  The plain int8 runs
  are held to JAX's in ``test_torch_kvquant.py``.
* Token identity with plain greedy: whatever the draft proposes, a
  speculative stream is the plain stream on the same pools (bf16 and
  int8).
* The rest on the port alone: full acceptance of a self-draft, fork /
  copy-on-write under a verify burst, page rollback, the draft cache's
  masking, ``Sampler.verify``, the deprecated ``greedy_token``, the
  registry pairing, ``make_draft`` and ``ServeConfig``'s validation.

The JAX file's ``kv_guard`` and chaos cases are held in
``test_torch_chaos.py``; its sharded case is
``test_spec_matches_plain_greedy_sharded``."""
import contextlib
import dataclasses
import io
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_jax_ref import (
    DRAFT,
    SEED,
    SPEC_LAUNCH_ARGS,
    SPEC_RUNS,
    SPEC_SHAPE,
    SPEC_STATS,
    TARGET,
    params_checksum,
    serve_requests,
)
from _torch_util import jax_reference
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.configs.registry import DraftPairingError, draft_for, validate_draft_pair
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.serve import PagedEngine, Request, ServeConfig, sampling
from repro_torch.serve.spec import ModelDraft, NgramDraft, SlotView, make_draft
from repro_torch.weights import from_jax_params

CHUNKS = pytest.mark.parametrize("chunk", [None, 4], ids=["one-shot", "chunked4"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine runs here are thousands of tiny ops: beside the suite's
    other workers, torch's default of one thread per core oversubscribes
    the CPU (a run that takes 1.4 s alone took 95 s in a whole run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _convert(arch):
    jparams = jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))
    return jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The registry pair, on the JAX package's parameters."""
    tj, tparams = _convert(TARGET)
    dj, dparams = _convert(DRAFT)
    return (get_config(TARGET, reduced=True), tparams, tj,
            get_config(DRAFT, reduced=True), dparams, dj)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, pair):
    out = jax_reference("spec", tmp_path_factory.mktemp("jax_spec"))
    assert float(out["params_checksum"]) == params_checksum(pair[2])
    assert float(out["draft_checksum"]) == params_checksum(pair[5])
    return json.loads(str(out["spec_json"]))


@pytest.fixture(scope="module")
def small():
    """The reduced qwen1.5-0.5b on the port's own seeded parameters."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    return cfg, lm.init(cfg, seed=0, device="cpu")


def _requests(**kw):
    return [Request(rid=r, prompt=p, max_new=m) for r, p, m in serve_requests(**kw)]


def _run(cfg, params, reqs, *, draft=None, **cfg_kw):
    eng = PagedEngine(cfg, params, device="cpu", config=ServeConfig(**cfg_kw), draft=draft)
    done = {r.rid: r.out for r in eng.run([Request(rid=r.rid, prompt=list(r.prompt),
                                                   max_new=r.max_new) for r in reqs])}
    eng.check()
    return done, eng


# ---------------------------------------------------------------------------
# token identity with the JAX engine and launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", list(SPEC_RUNS))
def test_streams_token_identical_to_jax_engine(pair, ref, run):
    tcfg, tparams, _, dcfg, dparams, _ = pair
    req_kw, eng_kw = SPEC_RUNS[run]
    conf = ServeConfig(**{**SPEC_SHAPE, **eng_kw})
    draft = (dcfg, dparams) if conf.draft_model == DRAFT else None
    eng = PagedEngine(tcfg, tparams, device="cpu", config=conf, draft=draft)
    done = eng.run(_requests(**req_kw))
    eng.check()  # refcount / free-list audit after rollbacks and swaps
    assert {str(r.rid): r.out for r in done} == ref[run]["out"]
    assert all(len(r.out) == r.max_new for r in done)
    st = eng.stats()
    assert {k: st[k] for k in SPEC_STATS} == ref[run]["stats"]
    assert st["spec_rounds"] > 0 and st["spec_rollbacks"] > 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # plain path


@pytest.mark.parametrize("run", list(SPEC_RUNS))
def test_spec_streams_equal_the_plain_streams_on_the_same_pools(pair, ref, run):
    """JAX's speculative streams are the plain greedy streams of the same
    pools, and so are the port's (the test above): the port's plain run,
    without a draft, gives them too."""
    tcfg, tparams = pair[:2]
    req_kw, eng_kw = SPEC_RUNS[run]
    plain = {k: v for k, v in eng_kw.items() if k not in ("spec_k", "draft_model")}
    eng = PagedEngine(tcfg, tparams, device="cpu", config=ServeConfig(**{**SPEC_SHAPE, **plain}))
    done = eng.run(_requests(**req_kw))
    assert {str(r.rid): r.out for r in done} == ref[run]["out"]


def test_launcher_stdout_matches_jax_launcher(pair, ref):
    """``python -m repro_torch.launch.serve --arch qwen1.5-1.8b --reduced
    --kv paged --kv-dtype int8 --spec-k 4 --draft-model auto`` prints the
    JAX launcher's lines on the same weights, draft included, and drains
    every request."""
    _, tparams, _, _, dparams, _ = pair
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        done = launcher.main([*SPEC_LAUNCH_ARGS, "--device", "cpu"], params=tparams,
                             draft_params=dparams)
    want = ref["launcher_stdout"].splitlines()
    assert len([ln for ln in want if ln.startswith("req ")]) == 4
    assert buf.getvalue().splitlines() == want
    assert all(len(r.out) == r.max_new for r in done)


def test_launcher_auto_draft_needs_a_pairing():
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        launcher.main(["--arch", "qwen1.5-0.5b", "--reduced", "--kv", "paged",
                       "--spec-k", "2", "--draft-model", "auto", "--device", "cpu"])


# ---------------------------------------------------------------------------
# token identity with plain greedy, on the port alone
# ---------------------------------------------------------------------------

SHAPE = dict(max_slots=2, cache_len=64, page_size=8)


@CHUNKS
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_ngram_matches_plain_greedy(small, chunk, kv_dtype):
    cfg, params = small
    reqs = _requests(n=4, max_new=8)  # a shared prefix: the suffixes run chunked
    plain, _ = _run(cfg, params, reqs, prefill_chunk=chunk, kv_dtype=kv_dtype, **SHAPE)
    spec, eng = _run(cfg, params, reqs, prefill_chunk=chunk, kv_dtype=kv_dtype,
                     spec_k=4, draft_model="ngram", **SHAPE)
    assert spec == plain
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["spec_drafted"] > 0
    assert st["spec_rollbacks"] > 0  # rejections happened, and their pages came back
    assert st["prefix_hit_tokens"] > 0


def test_spec_matches_plain_greedy_sharded(small):
    """Speculation over a 4-shard pool (the prefix broadcast across shards)
    serves the plain one-shard streams."""
    cfg, params = small
    reqs = _requests(n=4, shared_prefix=16, max_new=8)
    plain, _ = _run(cfg, params, reqs, **SHAPE)
    spec, eng = _run(cfg, params, reqs, spec_k=4, draft_model="ngram", max_slots=2,
                     cache_len=64, page_size=8, num_shards=4, pages_per_shard=8)
    assert spec == plain
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["broadcast_chains"] > 0


def test_self_draft_full_acceptance(small):
    """Draft == target: every proposal verifies, accept_rate is exactly
    1.0, and no round rejects — the case that pins the verify indexing."""
    cfg, params = small
    reqs = _requests(n=3, shared_prefix=0, max_new=10)
    plain, _ = _run(cfg, params, reqs, **SHAPE)
    spec, eng = _run(cfg, params, reqs, draft=(cfg, params), spec_k=3,
                     draft_model="qwen1.5-0.5b", **SHAPE)
    assert spec == plain
    st = eng.stats()
    assert st["accept_rate"] == 1.0 and st["spec_rollbacks"] == 0
    assert st["kernel_calls"]["draft_prefill"] == 3  # one resync per request


def test_registry_paired_model_draft_matches_plain():
    """A distinct draft (other depth, width and seed) through the registry
    pairing: partial acceptance, identical tokens, on int8 pools too."""
    tcfg = get_config(TARGET, reduced=True)
    dcfg = get_config(draft_for(TARGET), reduced=True)
    tparams = lm.init(tcfg, seed=0, device="cpu")
    dparams = lm.init(dcfg, seed=1, device="cpu")
    reqs = _requests(n=3, shared_prefix=0, max_new=8)
    for kv_dtype in ("bf16", "int8"):
        plain, _ = _run(tcfg, tparams, reqs, kv_dtype=kv_dtype, **SHAPE)
        spec, eng = _run(tcfg, tparams, reqs, draft=(dcfg, dparams), kv_dtype=kv_dtype,
                         spec_k=3, draft_model=draft_for(TARGET), **SHAPE)
        assert spec == plain, kv_dtype
        assert eng.stats()["spec_rounds"] > 0


def test_rejected_pages_rolled_back(small):
    """Pages of 4 tokens: nearly every verify burst allocates a page the
    rejected tail then releases; the audit stays exact, and nothing is
    held beyond what the prefix cache keeps."""
    cfg, params = small
    reqs = _requests(n=3, shared_prefix=0, max_new=10, seed=3)
    plain, _ = _run(cfg, params, reqs, max_slots=2, cache_len=64, page_size=4)
    spec, eng = _run(cfg, params, reqs, spec_k=4, draft_model="ngram", max_slots=2,
                     cache_len=64, page_size=4)
    assert spec == plain
    st = eng.stats()
    assert st["spec_rollback_pages"] > 0
    assert st["pool"]["allocated"] - st["pool"]["freed"] == st["prefix_pages"]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_fork_cow(small, kv_dtype):
    """A forked child shares every parent page; the first verify burst
    writes k+1 positions into the shared tail, so the copy must happen
    before the draft rows land (scales too, on int8 pools)."""
    cfg, params = small
    eng = PagedEngine(cfg, params, device="cpu", config=ServeConfig(
        spec_k=3, draft_model="ngram", kv_dtype=kv_dtype, **SHAPE))
    parent = Request(rid=0, prompt=[5, 9, 2, 7, 11, 3], max_new=8)
    assert eng._admit(parent) is True
    child = Request(rid=1, prompt=list(parent.prompt), max_new=8)
    slot = eng.fork(0, child)
    assert slot is not None
    tail = eng.slots[0].pages[-1]
    assert eng.pool.refcount(tail) >= 2
    done = {}
    while len(done) < 2:
        for r in eng.step():
            done[r.rid] = r.out
    assert eng.n_cow >= 1
    assert done[0] == done[1]
    assert eng.stats()["spec_rounds"] > 0
    eng.check()


def test_model_draft_observe_masks_rejected_rows(small):
    """After a round the draft's row holds exactly the committed tokens:
    the rows of rejected proposals are masked (pos = -1), not trusted."""
    cfg, params = small
    draft = ModelDraft(cfg, params, max_slots=2, cache_len=32, sampler=sampling.GreedySampler(),
                       device="cpu")
    view = SlotView(rid=7, tokens=(3, 1, 4, 1, 5, 9), length=5)
    drafts = draft.propose({1: view}, 3)
    assert drafts.shape == (2, 3) and draft.kernel_calls["draft_decode"] == 3
    assert all(c.pos[1].tolist()[:8] == list(range(8)) for c in draft.caches)
    draft.observe({1: 6})  # one proposal accepted: positions 0..5 stay
    for c in draft.caches:
        assert c.pos[1].tolist()[:9] == list(range(6)) + [-1] * 3
        assert c.k.device.type == "cpu"
    # the row is in sync: the next round decodes without a resync
    draft.propose({1: SlotView(rid=7, tokens=(3, 1, 4, 1, 5, 9, 2), length=6)}, 2)
    assert draft.kernel_calls["draft_prefill"] == 1
    draft.forget(1)
    draft.propose({1: SlotView(rid=7, tokens=(3, 1, 4, 1, 5, 9, 2), length=6)}, 2)
    assert draft.kernel_calls["draft_prefill"] == 2
    before = [t.clone() for c in draft.caches for t in c]
    assert draft.warmup([16, 16, 32], 2) == 4  # two buckets, a decode, a mask
    assert all(torch.equal(a, b) for a, b in zip(before, (t for c in draft.caches for t in c)))


def test_spec_stats_keys_are_jax_keys(small):
    cfg, params = small
    eng = PagedEngine(cfg, params, device="cpu", config=ServeConfig(**SHAPE))
    st = eng.stats()
    for key in SPEC_STATS:
        assert key in st
    assert st["accept_rate"] == 0.0 and eng.spec is None


# ---------------------------------------------------------------------------
# Sampler, registry and config surface
# ---------------------------------------------------------------------------


def test_verify_accepts_longest_prefix():
    s = sampling.GreedySampler()
    target = np.array([[7, 8, 9, 1], [7, 8, 9, 1], [0, 8, 9, 1]], np.int32)
    drafts = np.array([[7, 8, 9], [7, 8, 0], [7, 8, 9]], np.int32)
    assert s.verify(drafts, target).tolist() == [3, 2, 0]
    with pytest.raises(ValueError, match="k\\+1"):
        s.verify(drafts, target[:, :3])


def test_greedy_token_shim_warns_once_per_call_site():
    sampling._LEGACY_WARNED.clear()
    logits = torch.zeros((1, 1, 8))
    logits[0, 0, 3] = 1.0

    def legacy_site():
        return sampling.greedy_token(logits)

    with pytest.warns(DeprecationWarning, match="Sampler"):
        assert legacy_site() == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the same site again: silent
        assert legacy_site() == 3
    with pytest.warns(DeprecationWarning):  # another site warns afresh
        sampling.greedy_token(logits)


def test_draft_for_registry_pairing():
    assert draft_for("qwen1.5-1.8b") == "qwen1.5-0.5b"
    assert draft_for("qwen1.5-0.5b") is None  # a leaf model pairs nothing


def test_validate_draft_pair_ok():
    tcfg, dcfg = validate_draft_pair("qwen1.5-1.8b", "qwen1.5-0.5b", reduced=True)
    assert tcfg.vocab == dcfg.vocab and dcfg.d_model <= tcfg.d_model
    full_t, full_d = validate_draft_pair("qwen1.5-1.8b", "qwen1.5-0.5b")
    assert (full_t.d_model, full_t.attn.head_dim, full_t.tie_embeddings) == (2048, 128, False)
    assert full_d.d_model == 1024


def test_validate_draft_pair_vocab_mismatch():
    tcfg = get_config("qwen1.5-1.8b", reduced=True)
    bad = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True), vocab=tcfg.vocab + 1)
    with pytest.raises(DraftPairingError, match="vocab"):
        validate_draft_pair(tcfg, bad)
    with pytest.raises(DraftPairingError, match="wider"):
        validate_draft_pair(get_config("qwen1.5-0.5b", reduced=True), tcfg)


def test_make_draft_model_requires_params(small):
    cfg, _ = small
    scfg = ServeConfig(spec_k=2, draft_model="qwen1.5-0.5b", **SHAPE)
    with pytest.raises(DraftPairingError):
        make_draft(scfg, cfg, draft=None, max_slots=2, cache_len=64,
                   sampler=sampling.get_sampler("greedy"), device="cpu")
    with pytest.raises(DraftPairingError):
        PagedEngine(cfg, small[1], device="cpu", config=scfg)


def test_make_draft_ngram(small):
    cfg, _ = small
    scfg = ServeConfig(spec_k=2, draft_model="ngram", **SHAPE)
    d = make_draft(scfg, cfg, max_slots=2, cache_len=64,
                   sampler=sampling.get_sampler("greedy"), device="cpu")
    assert isinstance(d, NgramDraft)
    assert d.propose({0: SlotView(rid=0, tokens=(1, 2, 3, 1, 2), length=4)}, 3)[0].tolist() \
        == [3, 1, 2]
    assert make_draft(ServeConfig(**SHAPE), cfg, max_slots=2, cache_len=64,
                      sampler=sampling.get_sampler("greedy")) is None


def test_serve_config_spec_validation():
    with pytest.raises(ValueError):
        ServeConfig(spec_k=2)  # spec needs a draft proposer
    with pytest.raises(ValueError):
        ServeConfig(draft_model="ngram")  # a draft needs spec_k
    with pytest.raises(ValueError):
        ServeConfig(spec_k=2, draft_model="auto")  # the launcher resolves auto
    with pytest.raises(DraftPairingError):
        ServeConfig(spec_k=2, draft_model="not-an-arch")
    assert ServeConfig(spec_k=2, draft_model="qwen1.5-0.5b").draft_model == "qwen1.5-0.5b"
