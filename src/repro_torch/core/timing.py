"""Calibrated timing/bandwidth model of the Occamy-class system.

The paper does not disclose internal latencies, so the handful of free
constants below are *calibrated* against the paper's reported observables
and then frozen.  Every constant documents which observable pins it down:

* ``round_trip``, ``txn_overhead`` — microbenchmark small-transfer
  behaviour (speedup 13.5x at the smallest size on 32 clusters).
* ``mcast_stream_alpha`` — the multicast W-stream throughput degradation
  with fanout (commit/all-ready stalls across the fabric).  Calibrated so
  the 32-cluster, 32 KiB multicast speedup lands at 16.2x (paper fig. 3b),
  jointly with the 13.5x point: alpha = 0.1728.
* ``b_join_per_target`` — B-response join cost, sub-cycle per target.
* ``sw_stage_overhead`` — software-multicast per-stage cost (interrupt +
  DMA reprogramming); calibrated to the 5.6x geomean hw-vs-sw gap.
* ``llc_efficiency`` — LLC port utilisation under 32-way contention;
  calibrated to the baseline matmul's 114.4 GFLOPS (92% of its OI-bound).
* ``mcast_sync_overhead`` — per-tile-iteration cost of the multicast
  ordering rules (a multicast stalls until outstanding unicast C-tile
  writebacks drain, plus commit + B-join round trip); calibrated to the
  hw-multicast matmul's 391.4 GFLOPS, and *cross-validated* (not refit) on
  the sw-multicast point 297.4 GFLOPS (2.6x).

Hardware facts taken directly from the paper / Occamy references (not
calibrated): 64 B/cycle wide network and LLC port (512-bit @ 1 GHz),
8 B/cycle narrow network, 8 compute cores per cluster, 2 DP flops/cycle
per core (FMA), 128 KiB L1, 1 GHz target clock.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TimingModel:
    # --- hardware facts (paper / Occamy) ---------------------------------
    wide_bytes_per_cycle: int = 64  # 512-bit wide network & LLC port
    narrow_bytes_per_cycle: int = 8  # 64-bit narrow network
    freq_ghz: float = 1.0

    # --- calibrated constants (see module docstring) ----------------------
    round_trip: int = 25  # AW->B round trip through 2 XBAR levels
    txn_overhead: int = 2  # per-DMA-transfer issue overhead (cycles)
    mcast_stream_alpha: float = 0.1728  # W throughput penalty ~ log2(fanout)
    b_join_per_target: float = 0.3  # stream_join cost per joined B
    sw_stage_overhead: int = 100  # software multicast per-stage cost
    llc_efficiency: float = 0.945  # LLC port utilisation under contention
    mcast_sync_overhead: int = 712  # per-iteration mcast/unicast drain+join

    # ------------------------------------------------------------------
    def stream_cycles(self, n_bytes: int, fanout: int = 1) -> float:
        """Cycles to stream ``n_bytes`` of W beats to ``fanout`` targets.

        Unicast streams at the full 64 B/cycle.  A multicast stream must
        have *all* destinations ready every beat (the commit protocol
        acquires them atomically, but per-beat backpressure still ORs
        across targets), degrading throughput with the tree depth:
        ``1 + alpha * log2(fanout)`` cycles per beat.
        """
        beats = math.ceil(n_bytes / self.wide_bytes_per_cycle)
        k = 1.0 + (self.mcast_stream_alpha * math.log2(fanout) if fanout > 1 else 0.0)
        return beats * k

    def join_cycles(self, fanout: int) -> float:
        """stream_join_dynamic: B responses joined from ``fanout`` slaves."""
        return self.b_join_per_target * fanout

    def unicast_transfer(self, n_bytes: int) -> float:
        """Latency of a single unicast DMA transfer (issue -> B)."""
        return self.round_trip + self.txn_overhead + self.stream_cycles(n_bytes)

    def multi_unicast(self, n_bytes: int, n_dest: int) -> float:
        """Back-to-back unicasts to ``n_dest`` targets (source-port bound).

        The DMA pipelines transfers, so the steady state is limited by the
        source's single wide port: one payload + issue overhead per
        destination, plus one round trip.
        """
        per_dest = self.stream_cycles(n_bytes) + self.txn_overhead
        return self.round_trip + n_dest * per_dest

    def hw_multicast(self, n_bytes: int, n_dest: int) -> float:
        """One multicast transfer forked in the fabric to ``n_dest``."""
        return (
            self.round_trip
            + self.txn_overhead
            + self.stream_cycles(n_bytes, fanout=n_dest)
            + self.join_cycles(n_dest)
        )
