"""K2 (paged decode) and K3 (chunked-prefill supertile) of the port
against the JAX package's Pallas kernels, run in interpret mode, on the
same numpy-seeded pools, block tables and lengths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import close, t
from repro.kernels.paged_attention import paged_attention_decode as jax_decode
from repro.kernels.paged_attention import paged_attention_prefill as jax_prefill
from repro.nn.kvquant import quantize_kv
from repro_torch import kernels
from repro_torch.kernels.paged_attention import (
    gather_pages,
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_prefill,
    paged_attention_prefill_plain,
    paged_attention_ref,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# distinct pages per sequence, the null page 0 in the unused tail
TABLE = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 0, 0]], np.int32)


def _pools(kvh, *, d=16, ps=8, num_pages=16, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    kp = jnp.asarray(rng.standard_normal((kvh, num_pages, ps, d)), JNP[dtype])
    vp = jnp.asarray(rng.standard_normal((kvh, num_pages, ps, d)), JNP[dtype])
    return kp, vp


def _q(shape, dtype, seed=1):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape), JNP[dtype])


@pytest.mark.parametrize("kvh", [1, 2, 4])  # MQA / GQA / MHA over 4 query heads
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plain_matches_pallas(kvh, dtype):
    kp, vp = _pools(kvh, dtype=dtype)
    q = _q((3, 4, 16), dtype)
    lengths = jnp.asarray([29, 23, 9], jnp.int32)  # ragged tails, null-page tails
    table = jnp.asarray(TABLE)
    want = jax_decode(q, kp, vp, table, lengths - 1, lengths, interpret=True)
    got = paged_attention_decode(t(q), t(kp), t(vp), t(table), t(lengths - 1), t(lengths))
    assert got.dtype == dtype and got.shape == (3, 4, 16)
    close(got, want)


def test_decode_plain_matches_pallas_softcap_and_short_sequences():
    kp, vp = _pools(2)
    q = _q((3, 4, 16), torch.float32, seed=2)
    lengths = jnp.asarray([25, 17, 1], jnp.int32)  # incl. a 1-token sequence
    table = jnp.asarray(TABLE)
    want = jax_decode(q, kp, vp, table, lengths - 1, lengths, softcap=8.0, interpret=True)
    got = paged_attention_decode(t(q), t(kp), t(vp), t(table), t(lengths - 1), t(lengths),
                                 softcap=8.0)
    close(got, want)


@pytest.mark.parametrize("s", [1, 5, 16])
@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_prefill_plain_matches_pallas(s, kvh):
    kp, vp = _pools(kvh, seed=3)
    q = _q((3, s, 4, 16), torch.float32, seed=4)
    lengths = jnp.asarray([29, 23, 9], jnp.int32)
    start = lengths - min(s, 9)  # suffix rows at their true positions
    table = jnp.asarray(TABLE)
    want = jax_prefill(q, kp, vp, table, start, lengths, interpret=True)
    got = paged_attention_prefill(t(q), t(kp), t(vp), t(table), t(start), t(lengths))
    assert got.shape == (3, s, 4, 16)
    close(got, want)


def test_prefill_bucket_padding_rows_are_finite_and_match():
    """A 5-token suffix padded to a 16-row bucket: the padded rows sit
    past ``lengths``, still attend to the whole sequence, and come out
    finite, as in the TPU kernel."""
    kp, vp = _pools(2, dtype=torch.bfloat16, seed=5)
    q = _q((2, 16, 4, 16), torch.bfloat16, seed=6)
    start = jnp.asarray([16, 3], jnp.int32)
    lengths = start + 5
    table = jnp.asarray(TABLE[:2])
    want = jax_prefill(q, kp, vp, table, start, lengths, softcap=20.0, interpret=True)
    got = paged_attention_prefill(t(q), t(kp), t(vp), t(table), t(start), t(lengths),
                                  softcap=20.0)
    assert torch.isfinite(got.float()).all()
    close(got, want)


@pytest.mark.parametrize("s", [1, 5])
def test_prefill_int8_pools_dequantise_on_gather(s):
    rng = np.random.default_rng(7)
    raw_k = jnp.asarray(rng.standard_normal((2, 16, 8, 16)), jnp.float32)
    raw_v = jnp.asarray(rng.standard_normal((2, 16, 8, 16)), jnp.float32)
    kq, ks = quantize_kv(raw_k)
    vq, vs = quantize_kv(raw_v)
    q = _q((3, s, 4, 16), torch.bfloat16, seed=8)
    lengths = jnp.asarray([29, 23, 9], jnp.int32)
    start = lengths - s
    table = jnp.asarray(TABLE)
    want = jax_prefill(q, kq, vq, table, start, lengths, k_scale=ks, v_scale=vs,
                       interpret=True)
    got = kernels.op("paged_attention")(t(q), t(kq), t(vq), t(table), t(start), t(lengths),
                                        t(ks), t(vs))
    assert got.dtype == torch.bfloat16
    close(got, want)


@pytest.mark.parametrize("kvh", [1, 4])
def test_plain_versions_match_the_gather_oracle(kvh):
    """The online page walk and the one-shot gathered softmax agree."""
    kp, vp = _pools(kvh, seed=9)
    kp, vp = t(kp), t(vp)
    table = torch.from_numpy(TABLE)
    lengths = torch.tensor([29, 23, 9], dtype=torch.int32)
    q = t(_q((3, 5, 4, 16), torch.float32, seed=10))
    start = lengths - 5
    want = paged_attention_ref(q, kp, vp, table, start, lengths)
    close(paged_attention_prefill_plain(q, kp, vp, table, start, lengths), want.numpy())
    q1 = q[:, :1]
    want1 = paged_attention_ref(q1, kp, vp, table, lengths - 1, lengths)[:, 0]
    close(paged_attention_decode_plain(q1[:, 0], kp, vp, table, lengths - 1, lengths),
          want1.numpy())


def test_op_routes_single_token_to_decode_and_suffixes_to_prefill():
    kp, vp = _pools(2)
    kp, vp = t(kp), t(vp)
    table = torch.from_numpy(TABLE)
    lengths = torch.tensor([29, 23, 9], dtype=torch.int32)
    q = t(_q((3, 1, 4, 16), torch.float32))
    got = kernels.op("paged_attention")(q, kp, vp, table, lengths - 1, lengths)
    want = paged_attention_decode_plain(q[:, 0], kp, vp, table, lengths - 1, lengths)
    assert torch.equal(got[:, 0], want)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_gather_pages_layout():
    kp = torch.arange(2 * 4 * 3 * 2, dtype=torch.float32).reshape(2, 4, 3, 2)
    table = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)
    g = gather_pages(kp, table)
    assert g.shape == (2, 6, 2, 2)  # (b, n*ps, kvh, d)
    assert torch.equal(g[0, 0, 0], kp[0, 2, 0]) and torch.equal(g[1, 4, 1], kp[1, 3, 1])
