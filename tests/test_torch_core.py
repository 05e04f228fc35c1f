"""The port's copy of the paper's crossbar model (``repro_torch.core``)
against the JAX package's (``repro.core``): the same inputs, drawn from
a numpy seed, through both give equal outputs — the address encoding and
decoder, the crossbar's transactions, the timing model, the NoC
microbenchmark (fig. 3b), the Occamy matmul study (fig. 3c) and the area
model (fig. 3a).  Both are host code in numpy and the standard library,
so equal means equal: no tolerance.  Then the paper-number gates of
``tests/test_paper_numbers.py``, each run as written against the port's
modules."""
import dataclasses
import inspect
import itertools

import numpy as np
import pytest

import test_paper_numbers as gates
from repro.core import area as j_area
from repro.core import encoding as j_enc
from repro.core import noc as j_noc
from repro.core import occamy as j_occamy
from repro.core import timing as j_timing
from repro.core import xbar as j_xbar
from repro_torch import core
from repro_torch.core import area, encoding, noc, occamy, timing, xbar

RNG_SEED = 27
PAIRS = ((j_enc, encoding), (j_xbar, xbar), (j_timing, timing), (j_noc, noc),
         (j_occamy, occamy), (j_area, area))


def _plain(x):
    """A result of either package as plain data: dataclasses by their
    fields, enums by name, containers element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "name") and hasattr(type(x), "__members__"):
        return x.name
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [_plain(v) for v in (sorted(x) if isinstance(x, (set, frozenset)) else x)]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


@pytest.mark.parametrize("jax_mod,port_mod", PAIRS, ids=lambda m: m.__name__)
def test_modules_keep_the_reference_public_names(jax_mod, port_mod):
    public = lambda m: {n for n in vars(m) if not n.startswith("_")  # noqa: E731
                        and getattr(getattr(m, n), "__module__", m.__name__) == m.__name__}
    assert public(port_mod) == public(jax_mod)


def test_package_exports_the_reference_names():
    import repro.core as jax_core

    assert core.__all__ == jax_core.__all__


def _rules(pkg, n):
    return [pkg.AddrRule(idx=i, start=pkg.cluster_window(i).start, end=pkg.cluster_window(i).end)
            for i in range(n)]


def test_encoding_matches_on_seeded_requests():
    rng = np.random.default_rng(RNG_SEED)
    decoders = [pkg.AddressDecoder(_rules(pkg, 32)) for pkg in (j_enc, encoding)]
    for _ in range(300):
        cid, off = int(rng.integers(0, 32)), int(rng.integers(0, 0x40000))
        mask = int(rng.integers(0, 32)) << 18 | int(rng.integers(0, 16))
        addr = j_enc.cluster_window(cid).start + off
        got = [_plain(d.decode(addr, mask)) for d in decoders]
        assert got[0] == got[1]
        log = int(rng.integers(0, 21))
        k = int(rng.integers(0, (1 << (j_enc.ADDR_WIDTH - log)) - 1))
        ifes = [pkg.Ife(start=k << log, end=(k + 1) << log) for pkg in (j_enc, encoding)]
        mfes = [j_enc.ife_to_mfe(ifes[0]), encoding.ife_to_mfe(ifes[1])]
        assert _plain(mfes[0]) == _plain(mfes[1])
        assert _plain(j_enc.mfe_to_ife(mfes[0])) == _plain(encoding.mfe_to_ife(mfes[1]))
        ids = sorted({int(i) for i in rng.integers(0, 32, size=rng.integers(1, 9))})
        assert _plain(j_enc.mcast_request_for_clusters(ids, offset=off)) == \
            _plain(encoding.mcast_request_for_clusters(ids, offset=off))
        assert _plain(j_enc.mfe_for_address_set(ids)) == \
            _plain(encoding.mfe_for_address_set(ids))
    addrs = rng.integers(0, j_enc.ADDR_MASK, size=64)
    masks = rng.integers(0, 1 << 10, size=64)
    rule_addrs = np.array([r.start for r in _rules(j_enc, 32)])
    rule_masks = np.full(32, j_enc.cluster_window(0).size - 1)
    np.testing.assert_array_equal(j_enc.decode_bulk(addrs, masks, rule_addrs, rule_masks),
                                  encoding.decode_bulk(addrs, masks, rule_addrs, rule_masks))


def _xbar_run(pkg_enc, pkg_xbar, txns, **kw):
    xb = pkg_xbar.McastXbar(4, _rules(pkg_enc, 4), **kw)
    submitted = []
    for master, ids, beats, axi_id in txns:
        if len(ids) > 1:
            req = pkg_enc.mcast_request_for_clusters(ids)
            txn = pkg_xbar.WriteTxn(master=master, addr=req.addr, mask=req.mask,
                                    n_beats=beats, axi_id=axi_id)
        else:
            txn = pkg_xbar.WriteTxn(master=master, addr=pkg_enc.cluster_window(ids[0]).start,
                                    n_beats=beats, axi_id=axi_id)
        submitted.append(xb.submit(txn))
    try:
        cycles = xb.run(max_cycles=200_000, watchdog=300)
    except pkg_xbar.DeadlockError as e:
        return ("deadlock", str(e), xb.cycle)
    return (cycles, _plain(submitted), xb.slave_w_order,
            [(t.master, t.addr) for t in xb.completed])


@pytest.mark.parametrize("commit_protocol", (True, False))
def test_xbar_transactions_match_on_seeded_mixes(commit_protocol):
    rng = np.random.default_rng(RNG_SEED)
    sets = [(0,), (1,), (2,), (3,), (0, 1), (2, 3), (0, 1, 2, 3), (0, 2), (1, 3)]
    for _ in range(12):
        txns = [(int(rng.integers(0, 4)), sets[int(rng.integers(0, len(sets)))],
                 int(rng.integers(1, 7)), int(rng.integers(0, 4)))
                for _ in range(int(rng.integers(1, 25)))]
        kw = dict(max_mcast_outstanding=2, resp_latency=2, commit_protocol=commit_protocol)
        assert _xbar_run(j_enc, j_xbar, txns, **kw) == _xbar_run(encoding, xbar, txns, **kw)


def test_timing_model_matches():
    tj, tp = j_timing.TimingModel(), timing.TimingModel()
    assert _plain(tj) == _plain(tp)
    for size, n in itertools.product((64, 1000, 4096, 32768, 1 << 20), (1, 2, 3, 7, 31)):
        for fn in ("stream_cycles", "unicast_transfer"):
            args = (size, n) if fn == "stream_cycles" else (size,)
            assert getattr(tj, fn)(*args) == getattr(tp, fn)(*args), (fn, size, n)
        for fn in ("multi_unicast", "hw_multicast"):
            assert getattr(tj, fn)(size, n) == getattr(tp, fn)(size, n), (fn, size, n)
        assert tj.join_cycles(n) == tp.join_cycles(n)


def test_noc_microbenchmark_matches():
    nj, np_ = j_noc.OccamyNoc(), noc.OccamyNoc()
    assert j_noc.microbenchmark_table(nj) == noc.microbenchmark_table(np_)
    for size, n, mode in itertools.product((4096, 12288, 32768), (2, 5, 8, 17, 32),
                                           ("multi_unicast", "hw_mcast", "sw_tree")):
        assert _plain(nj.one_to_all(size, n, mode)) == _plain(np_.one_to_all(size, n, mode))
        assert nj.speedup(size, n, mode) == np_.speedup(size, n, mode)
    cfg, counts = dict(n_clusters=16, clusters_per_group=2), (2, 4, 8, 16)
    assert j_noc.microbenchmark_table(j_noc.OccamyNoc(j_noc.NocConfig(**cfg)),
                                      cluster_counts=counts) == \
        noc.microbenchmark_table(noc.OccamyNoc(noc.NocConfig(**cfg)), cluster_counts=counts)


@pytest.mark.parametrize("n", (64, 128, 256))
def test_occamy_matmul_matches(n):
    sj, sp = j_occamy.OccamySystem(), occamy.OccamySystem()
    assert _plain(sj.matmul_study(n)) == _plain(sp.matmul_study(n))
    for mode in ("baseline", "sw_mcast", "hw_mcast"):
        rj, rp = sj.matmul(n=n, mode=mode), sp.matmul(n=n, mode=mode)
        assert (rj.attainable_gflops, rj.frac_of_attainable) == \
            (rp.attainable_gflops, rp.frac_of_attainable)
    assert sj.largest_llc_tile() == sp.largest_llc_tile()
    for gm, bm in ((1024, 8), (1024, 128), (256, 64)):
        assert sj.kernel_schedule_analogy(gm, bm) == sp.kernel_schedule_analogy(gm, bm)
    with pytest.raises(ValueError, match="unknown mode"):
        sp.matmul(mode="torus")


def test_area_matches():
    for n in range(2, 33):
        aj, ap = j_area.xbar_area(n), area.xbar_area(n)
        assert _plain(aj) == _plain(ap)
        assert (aj.overhead_kge, aj.overhead_frac, aj.freq_ghz_base, aj.freq_ghz_mcast) == \
            (ap.overhead_kge, ap.overhead_frac, ap.freq_ghz_base, ap.freq_ghz_mcast)
    assert _plain(j_area.area_table()) == _plain(area.area_table())


GATES = sorted(n for n, f in vars(gates).items() if n.startswith("test_") and callable(f))


@pytest.mark.parametrize("name", GATES)
def test_paper_number_gates_hold_on_the_port(name, monkeypatch):
    """Each gate of ``tests/test_paper_numbers.py``, as written, with its
    module's names and its fixtures bound to the port's copy."""
    monkeypatch.setattr(gates, "xbar_area", area.xbar_area)
    monkeypatch.setattr(gates, "OccamyNoc", noc.OccamyNoc)
    monkeypatch.setattr(gates, "OccamySystem", occamy.OccamySystem)
    fixtures = {"noc": noc.OccamyNoc(), "system": occamy.OccamySystem()}
    fn = getattr(gates, name)
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})
