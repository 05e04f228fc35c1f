"""The arithmetic of K2's split-kv design and K3's wgmma design, emulated
in plain PyTorch, against the JAX package's Pallas kernels (interpret
mode) under the tolerance ``chip_smoke.check_close`` holds K2 and K3 to on
the card: |got - want| <= 2e-2 + 2e-2 |want|.

K2 split-kv (``csrc/paged_attention_decode.cu``) cuts each sequence's live
pages into contiguous runs (its splits), deals each run's pages in turn to
four warps, walks each warp's pages in order with the reference's fp32
online softmax — p rounded to bf16 against that walk's own running max, l
summing p unrounded — and merges the (m, l, acc) of the walks in order in
fp32.  The JAX kernel walks all pages in one run.  The emulation takes
contiguous runs of 1, 2 and 3, one run per page, and one run dealt to
four warps.

K3 wgmma (``csrc/paged_attention_prefill.cu``) holds 64 query rows a CTA
(64 // group tokens x group heads), walks key tiles of 64 keys (several
pages) up to the chunk's causal and length bound, computes S = Q K^T and
P V from bf16 operands in fp32 — exact products, so only the order of the
sums departs from JAX — with P rounded to bf16 against the running max of
the tile, and merges its splits (runs of tiles) as K2 does.  The JAX
kernel walks page by page over one chunk of all s tokens.

The inputs are numpy-seeded bf16 pools (or int8 pools with bf16 scales,
dequantised on gather as int8 x scale in fp32 rounded to bf16), the same
on both sides.  Cases: MHA, GQA and MQA; ragged lengths; null-page tails;
a length-1 sequence; softcap; int8 pools; bucket-padding rows."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.paged_attention import paged_attention_decode as jax_decode
from repro.kernels.paged_attention import paged_attention_prefill as jax_prefill
from repro.nn.kvquant import quantize_kv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-2  # chip_smoke.TOL_BF16: rtol = atol
NEG_INF = -(2.0**30)
PS, D, ROWS, TILE_KEYS = 16, 64, 64, 64
# distinct pages per sequence, the null page 0 in the unused tail
TABLE = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 0, 0], [11, 12, 13, 0, 0, 0]], np.int32)
NUM_PAGES = 14


def _pools(kvh, seed, quant=False):
    rng = np.random.default_rng(seed)
    raw = [jnp.asarray(rng.standard_normal((kvh, NUM_PAGES, PS, D)), jnp.float32)
           for _ in range(2)]
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(raw[0]), quantize_kv(raw[1])
        return kq, vq, ks, vs
    return raw[0].astype(jnp.bfloat16), raw[1].astype(jnp.bfloat16), None, None


def _q(shape, seed):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.bfloat16)


def _kv(k_pages, v_pages, k_scale, v_scale, table_row):
    """(kvh, n * ps, d) fp32 K and V of one sequence's pages, as the
    products see them (int8 dequantised to bf16)."""
    ids = table_row.long()
    k, v = k_pages[:, ids].float(), v_pages[:, ids].float()
    if k_scale is not None:
        k = (k * k_scale[:, ids].float()).to(torch.bfloat16).float()
        v = (v * v_scale[:, ids].float()).to(torch.bfloat16).float()
    kvh = k.shape[0]
    return k.reshape(kvh, -1, D), v.reshape(kvh, -1, D)


def _run(qf, k, v, qpos, length, tiles, softcap):
    """One run's (m, l, acc) over ``tiles`` (key ranges), the fp32 online
    softmax with p rounded to bf16 before P V.  qf (kvh, R, d), qpos (R,)."""
    kvh, rows, _ = qf.shape
    m = torch.full((kvh, rows, 1), NEG_INF)
    l = torch.zeros((kvh, rows, 1))
    acc = torch.zeros((kvh, rows, D))
    for k0, k1 in tiles:
        s = (qf @ k[:, k0:k1].transpose(-1, -2)) / math.sqrt(D)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k1)
        mask = (kpos[None, :] < length) & (kpos[None, :] <= qpos[:, None])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ v[:, k0:k1]
        m = m_new
    return m, l, acc


def _merge(parts):
    """The runs' partials merged in run order in fp32."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    l_sum, a_sum = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - mx)
        l_sum, a_sum = l_sum + l * f, a_sum + acc * f
    return a_sum / torch.clamp(l_sum, min=1e-30)


def _cut(n, runs):
    """Items 0..n-1 as the lists each walk takes: ``runs`` contiguous runs
    (ceil division), one per item ("page"), or all dealt in turn to four
    warps ("warps"); empty walks are dropped, as their (m, l, acc) =
    (NEG_INF, 0, 0) adds nothing."""
    if runs == "page":
        return [[i] for i in range(n)]
    if runs == "warps":
        return [list(range(w, n, 4)) for w in range(min(4, n))]
    per = max(1, -(-n // runs))
    return [list(range(i, min(n, i + per))) for i in range(0, n, per)]


def decode_split_kv(q, k_pages, v_pages, table, start, lengths, runs, softcap=None):
    """K2's split-kv arithmetic: q (b, h, d) -> (b, h, d) bf16."""
    b, h, _ = q.shape
    kvh = k_pages.shape[0]
    out = torch.zeros((b, h, D))
    for i in range(b):
        length = int(lengths[i])
        n_pages = min(table.shape[1], -(-length // PS)) if length > 0 else 0
        k, v = _kv(k_pages, v_pages, None, None, table[i])
        qf = q[i].float().reshape(kvh, h // kvh, D)
        qpos = torch.full((h // kvh,), int(start[i]))
        parts = [_run(qf, k, v, qpos, length, [(p * PS, (p + 1) * PS) for p in pages],
                      softcap) for pages in _cut(n_pages, runs)]
        if parts:
            out[i] = _merge(parts).reshape(h, D)
    return out.to(torch.bfloat16)


def prefill_wgmma(q, k_pages, v_pages, table, start, lengths, splits, *, k_scale=None,
                  v_scale=None, softcap=None):
    """K3's wgmma arithmetic: q (b, s, h, d) -> (b, s, h, d) bf16."""
    b, s, h, _ = q.shape
    kvh = k_pages.shape[0]
    group = h // kvh
    qc = max(1, min(s, ROWS // group))  # tokens a CTA: 64 rows
    out = torch.zeros((b, s, h, D))
    for i in range(b):
        length = int(lengths[i])
        k, v = _kv(k_pages, v_pages, k_scale, v_scale, table[i])
        for t0 in range(0, s, qc):
            t1 = min(s, t0 + qc)
            n_pages = min(table.shape[1], -(-length // PS)) if length > 0 else 0
            n_pages = min(n_pages, (int(start[i]) + t1 - 1) // PS + 1)  # the causal bound
            kend = n_pages * PS
            n_tiles = -(-kend // TILE_KEYS)
            qf = q[i, t0:t1].float().reshape(t1 - t0, kvh, group, D).permute(1, 0, 2, 3)
            qf = qf.reshape(kvh, (t1 - t0) * group, D)  # row r: token r // group
            qpos = int(start[i]) + t0 + torch.arange((t1 - t0) * group) // group
            parts = [_run(qf, k, v, qpos, length,
                          [(j * TILE_KEYS, min(kend, (j + 1) * TILE_KEYS)) for j in tiles],
                          softcap) for tiles in _cut(n_tiles, splits)]
            if parts:
                o = _merge(parts).reshape(kvh, t1 - t0, group, D).permute(1, 0, 2, 3)
                out[i, t0:t1] = o.reshape(t1 - t0, h, D)
    return out.to(torch.bfloat16)


def _close(got, want):
    g, w = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= TOL + TOL * w.abs()).all(), float((g - w).abs().max())


# (h, kvh, lengths, softcap)
DECODE_CASES = [
    (4, 4, (90, 61, 16), None),   # MHA; ragged; null-page tails
    (4, 2, (96, 50, 1), None),    # GQA; a length-1 sequence
    (4, 1, (77, 64, 9), 8.0),     # MQA; softcap
]


@pytest.mark.parametrize("runs", [1, 2, 3, "page", "warps"], ids=str)
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_split_kv_decode_matches_pallas(case, runs):
    h, kvh, lengths, softcap = case
    kp, vp, _, _ = _pools(kvh, seed=kvh)
    q = _q((3, h, D), seed=h + kvh)
    lengths = jnp.asarray(lengths, jnp.int32)
    table = jnp.asarray(TABLE)
    want = jax_decode(q, kp, vp, table, lengths - 1, lengths, softcap=softcap, interpret=True)
    got = decode_split_kv(t(q), t(kp), t(vp), t(table), t(lengths - 1), t(lengths), runs,
                          softcap=softcap)
    _close(got, want)


# (s, h, kvh, lengths, softcap, int8, padded): padded rows sit past lengths
PREFILL_CASES = [
    (16, 4, 4, (90, 61, 16), None, False, False),   # MHA, one chunk of 16 tokens
    (40, 4, 2, (96, 50, 41), None, False, False),   # GQA, 32-token chunks
    (24, 4, 1, (77, 64, 24), 8.0, False, False),    # MQA, 16-token chunks, softcap
    (5, 4, 2, (93, 60, 7), None, True, False),      # int8 pools
    (16, 4, 2, (85, 21, 6), 20.0, False, True),     # bucket padding: 5 real tokens of 16
]


@pytest.mark.parametrize("splits", [1, 2], ids=str)
@pytest.mark.parametrize("case", PREFILL_CASES, ids=str)
def test_wgmma_prefill_matches_pallas(case, splits):
    s, h, kvh, lengths, softcap, quant, padded = case
    kp, vp, ks, vs = _pools(kvh, seed=s + kvh, quant=quant)
    q = _q((3, s, h, D), seed=s + h)
    lengths = jnp.asarray(lengths, jnp.int32)
    start = lengths - (5 if padded else s)
    table = jnp.asarray(TABLE)
    want = jax_prefill(q, kp, vp, table, start, lengths, k_scale=ks, v_scale=vs,
                       softcap=softcap, interpret=True)
    got = prefill_wgmma(t(q), t(kp), t(vp), t(table), t(start), t(lengths), splits,
                        k_scale=None if ks is None else t(ks),
                        v_scale=None if vs is None else t(vs), softcap=softcap)
    _close(got, want)
