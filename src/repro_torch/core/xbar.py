"""Cycle-stepped, protocol-faithful model of the multicast AXI crossbar.

Models the write path (AW/W/B channels) of the ``axi_demux`` / ``axi_mux``
pair from section II-A, including:

* the multicast/unicast *ordering stalls* (a multicast AW is blocked until
  all outstanding unicasts drained and vice versa; multiple outstanding
  multicasts allowed only when directed to the same master-port set, up to
  a configurable maximum),
* the AXI-ID table rule for unicasts (same-ID transactions must target the
  same slave while outstanding),
* the *atomic-acquisition commit protocol* that breaks Coffman's "wait-for"
  condition: every mux uses the same priority order (lzc — lowest master
  index first) so selections are consistent across muxes, and a demux only
  asserts ``aw.commit`` once **all** addressed muxes are ready; the muxes
  are released to stream W in the following cycle,
* ``stream_join_dynamic`` B-response joining: one B is returned to the
  master only after every addressed slave responded; ``resp`` fields are
  OR-reduced (any SLVERR/DECERR -> SLVERR); the ID is taken from the first
  addressed slave (priority encoder); EXOKAY (exclusive) is disallowed for
  multicast,
* an optional ``commit_protocol=False`` mode with per-mux independent
  (round-robin) arbiters that reproduces the figure-2e deadlock, used by
  the tests to demonstrate why the commit protocol is necessary.

This model is for *semantic* validation (deadlock freedom, ordering,
join/error behaviour).  Performance numbers come from the resource-booking
model in ``repro_torch.core.noc`` / ``repro_torch.core.timing``.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Sequence

from repro_torch.core.encoding import AddressDecoder, AddrRule, DecodeResult


class Resp(enum.IntEnum):
    OKAY = 0
    EXOKAY = 1
    SLVERR = 2
    DECERR = 3


def join_resps(resps: Sequence[Resp]) -> Resp:
    """OR-reduction per the paper: any SLVERR/DECERR -> SLVERR."""
    return Resp.SLVERR if any(r in (Resp.SLVERR, Resp.DECERR) for r in resps) else Resp.OKAY


@dataclasses.dataclass
class WriteTxn:
    """One AXI write transaction as issued by a master."""

    master: int
    addr: int
    mask: int = 0  # aw_user multicast mask (0 => unicast)
    n_beats: int = 1
    axi_id: int = 0
    exclusive: bool = False

    # -- filled by the simulator ------------------------------------------
    decode: DecodeResult | None = None
    issue_cycle: int | None = None  # AW accepted by demux (granted+committed)
    done_cycle: int | None = None  # joined B returned to master
    resp: Resp | None = None
    resp_id: int | None = None  # slave index whose ID was propagated

    @property
    def is_mcast(self) -> bool:
        assert self.decode is not None
        return self.decode.is_mcast

    @property
    def targets(self) -> frozenset[int]:
        assert self.decode is not None
        return frozenset(self.decode.subsets)


class DeadlockError(RuntimeError):
    def __init__(self, cycle: int, pending: list[WriteTxn]):
        super().__init__(
            f"no forward progress by cycle {cycle}; {len(pending)} txns stuck"
        )
        self.cycle = cycle
        self.pending = pending


@dataclasses.dataclass
class _MuxState:
    """Per-slave mux: current W-stream owner + round-robin pointer."""

    owner: tuple[int, int] | None = None  # (master, txn_seq) holding the port
    rr_ptr: int = 0  # used only when commit_protocol=False


@dataclasses.dataclass
class _DemuxState:
    """Per-master demux: outstanding table + multicast bookkeeping."""

    # axi_id -> set of slave indices with outstanding unicast txns
    id_table: dict[int, set[int]] = dataclasses.field(default_factory=dict)
    outstanding_unicast: int = 0
    outstanding_mcast: int = 0
    mcast_port_set: frozenset[int] | None = None  # port set of in-flight mcasts


@dataclasses.dataclass
class _Stream:
    """An in-flight W stream (post-commit)."""

    txn: WriteTxn
    seq: int
    beats_left: int
    targets: frozenset[int]


class McastXbar:
    """N-master x N-slave multicast-capable crossbar (write path)."""

    def __init__(
        self,
        n_masters: int,
        rules: Sequence[AddrRule],
        *,
        max_mcast_outstanding: int = 2,
        resp_latency: int = 2,
        commit_protocol: bool = True,
        err_slaves: frozenset[int] = frozenset(),
    ):
        self.n_masters = n_masters
        self.decoder = AddressDecoder(rules)
        self.n_slaves = 1 + max(r.idx for r in rules)
        self.max_mcast_outstanding = max_mcast_outstanding
        self.resp_latency = resp_latency
        self.commit_protocol = commit_protocol
        self.err_slaves = err_slaves

        self.cycle = 0
        self._seq = 0
        self.queues: list[deque[WriteTxn]] = [deque() for _ in range(n_masters)]
        self.demux = [_DemuxState() for _ in range(n_masters)]
        # Independent mux arbiters start desynchronised (rr_ptr = slave idx);
        # irrelevant under the commit protocol (which uses lzc priority) but
        # reproduces the figure-2e inconsistent-selection deadlock without it.
        self.mux = [
            _MuxState(rr_ptr=s % n_masters) for s in range(self.n_slaves)
        ]
        self.streams: list[_Stream] = []
        # (ready_cycle, master, txn_seq, slave, resp) B responses in flight
        self.b_inflight: list[tuple[int, int, int, int, Resp]] = []
        # (master, seq) -> {slave: resp} join buffers, per paper's stream_join
        self.b_join: dict[tuple[int, int], dict[int, Resp]] = {}
        self._txn_by_seq: dict[tuple[int, int], WriteTxn] = {}
        self.completed: list[WriteTxn] = []
        # per-slave observed stream order (for W-ordering assertions)
        self.slave_w_order: list[list[tuple[int, int]]] = [
            [] for _ in range(self.n_slaves)
        ]

    # ------------------------------------------------------------------
    def submit(self, txn: WriteTxn) -> WriteTxn:
        if txn.exclusive and txn.mask:
            # Exclusive multicast transactions are disallowed by design.
            raise ValueError("exclusive multicast transactions are disallowed")
        txn.decode = self.decoder.decode(txn.addr, txn.mask)
        if not txn.decode.subsets:
            raise ValueError(f"address {txn.addr:#x} decodes to no slave")
        self.queues[txn.master].append(txn)
        return txn

    # ------------------------------------------------------------------
    def _demux_blocked(self, m: int, txn: WriteTxn) -> bool:
        """AW-channel stall conditions at the demux (paper, section II-A)."""
        d = self.demux[m]
        if txn.is_mcast:
            if d.outstanding_unicast:
                return True  # mcast waits for all unicasts to complete
            if d.outstanding_mcast >= self.max_mcast_outstanding:
                return True
            if d.mcast_port_set is not None and d.mcast_port_set != txn.targets:
                return True  # concurrent mcasts only to the *same* port set
            return False
        # unicast:
        if d.outstanding_mcast:
            return True  # unicast waits for all mcasts to complete
        tgt = next(iter(txn.targets))
        occupied = d.id_table.get(txn.axi_id)
        if occupied and occupied != {tgt}:
            return True  # same-ID outstanding txn to a different slave
        return False

    def _head_requests(self) -> dict[int, WriteTxn]:
        """Masters' head-of-line AW requests that pass the demux stalls."""
        reqs: dict[int, WriteTxn] = {}
        for m in range(self.n_masters):
            if self.queues[m]:
                txn = self.queues[m][0]
                if not self._demux_blocked(m, txn):
                    reqs[m] = txn
        return reqs

    def _grant_with_commit(self, reqs: dict[int, WriteTxn]) -> list[int]:
        """Atomic acquisition: consistent lzc priority + all-ready commit."""
        granted: list[int] = []
        busy = {s for s in range(self.n_slaves) if self.mux[s].owner is not None}
        # Multicast transactions are prioritized over unicast ones.
        mcast_reqs = sorted(m for m, t in reqs.items() if t.is_mcast)
        uni_reqs = sorted(m for m, t in reqs.items() if not t.is_mcast)
        # Every mux would pick the lowest-index mcast requester targeting it
        # (lzc) — grant that master iff *all* of its targets are ready.
        claimed: set[int] = set()
        for m in mcast_reqs:
            t = reqs[m]
            if t.targets & (busy | claimed):
                continue  # some addressed mux not ready -> no commit
            # consistent priority: a lower-index mcast master contending for
            # any shared target wins; we iterate in ascending order so all
            # of m's targets are free of lower-priority claims by now.
            claimed |= t.targets
            granted.append(m)
        # Unicast grants fill remaining free slaves (lowest master first).
        for m in uni_reqs:
            t = reqs[m]
            (s,) = t.targets
            if s in busy or s in claimed:
                continue
            claimed.add(s)
            granted.append(m)
        return granted

    def _grant_no_commit(self, reqs: dict[int, WriteTxn]) -> list[int]:
        """Broken mode: each mux locks independently via round-robin.

        A multicast master holds whatever subset of its targets its muxes
        granted and *waits* for the rest — Coffman's hold-and-wait.  Used to
        reproduce the figure-2e deadlock in the tests.
        """
        # Per-mux independent choice among requesters (rotating priority).
        waiting: dict[int, set[int]] = {}
        for m, t in reqs.items():
            for s in t.targets:
                waiting.setdefault(s, set()).add(m)
        picks: dict[int, int] = {}
        for s, masters in waiting.items():
            mux = self.mux[s]
            if mux.owner is not None:
                continue
            order = sorted(masters, key=lambda m: (m - mux.rr_ptr) % self.n_masters)
            picks[s] = order[0]
            mux.rr_ptr = (order[0] + 1) % self.n_masters
            # lock immediately (hold) — this is the bug the commit fixes
            mux.owner = (order[0], -1)
        # A master may start streaming only when it holds ALL its targets.
        granted = []
        for m, t in reqs.items():
            held = {s for s in t.targets if self.mux[s].owner == (m, -1)}
            if held == set(t.targets):
                granted.append(m)
        return granted

    # ------------------------------------------------------------------
    def step(self) -> None:
        self.cycle += 1

        # 1. B responses arriving at demuxes: join / complete.
        still: list[tuple[int, int, int, int, Resp]] = []
        for ready, m, seq, s, resp in self.b_inflight:
            if ready > self.cycle:
                still.append((ready, m, seq, s, resp))
                continue
            key = (m, seq)
            self.b_join.setdefault(key, {})[s] = resp
            txn = self._txn_by_seq[key]
            if set(self.b_join[key]) == set(txn.targets):
                # stream_join_dynamic fires: all addressed slaves responded.
                txn.resp = (
                    join_resps(list(self.b_join[key].values()))
                    if txn.is_mcast
                    else self.b_join[key][min(txn.targets)]
                )
                # ID propagated from the first addressed slave (lzc).
                txn.resp_id = min(txn.targets)
                txn.done_cycle = self.cycle
                d = self.demux[m]
                if txn.is_mcast:
                    d.outstanding_mcast -= 1
                    if d.outstanding_mcast == 0:
                        d.mcast_port_set = None
                else:
                    d.outstanding_unicast -= 1
                    (tgt,) = txn.targets
                    ids = d.id_table.get(txn.axi_id)
                    if ids is not None:
                        ids.discard(tgt)
                        if not ids:
                            del d.id_table[txn.axi_id]
                del self.b_join[key]
                self.completed.append(txn)
        self.b_inflight = still

        # 2. W beats for in-flight streams (1 beat/cycle to all targets).
        done_streams = []
        for st in self.streams:
            st.beats_left -= 1
            if st.beats_left == 0:
                done_streams.append(st)
        for st in done_streams:
            self.streams.remove(st)
            for s in st.targets:
                self.mux[s].owner = None
                resp = Resp.SLVERR if s in self.err_slaves else Resp.OKAY
                self.b_inflight.append(
                    (self.cycle + self.resp_latency, st.txn.master, st.seq, s, resp)
                )

        # 3. AW arbitration (commit protocol or the broken mode).
        reqs = self._head_requests()
        granted = (
            self._grant_with_commit(reqs)
            if self.commit_protocol
            else self._grant_no_commit(reqs)
        )
        for m in granted:
            txn = self.queues[m].popleft()
            self._seq += 1
            seq = self._seq
            txn.issue_cycle = self.cycle
            self._txn_by_seq[(m, seq)] = txn
            d = self.demux[m]
            if txn.is_mcast:
                d.outstanding_mcast += 1
                d.mcast_port_set = txn.targets
            else:
                d.outstanding_unicast += 1
                (tgt,) = txn.targets
                d.id_table.setdefault(txn.axi_id, set()).add(tgt)
            for s in txn.targets:
                self.mux[s].owner = (m, seq)
                self.slave_w_order[s].append((m, seq))
            self.streams.append(
                _Stream(txn=txn, seq=seq, beats_left=txn.n_beats, targets=txn.targets)
            )

    # ------------------------------------------------------------------
    def run(self, max_cycles: int = 100_000, watchdog: int = 1_000) -> int:
        """Run until all submitted txns complete.  Raises DeadlockError."""
        last_progress = self.cycle
        last_done = len(self.completed)
        while any(self.queues) or self.streams or self.b_inflight or self.b_join:
            self.step()
            if len(self.completed) != last_done or self.streams:
                last_done = len(self.completed)
                last_progress = self.cycle
            if self.cycle - last_progress > watchdog:
                pending = [t for q in self.queues for t in q]
                raise DeadlockError(self.cycle, pending)
            if self.cycle > max_cycles:
                raise RuntimeError(f"simulation exceeded {max_cycles} cycles")
        return self.cycle
