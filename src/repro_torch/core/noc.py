"""Occamy two-level NoC model + the paper's 1-to-N DMA microbenchmark.

Topology (section II-B, evaluated configuration): 32 Snitch clusters in
8 groups of 4; a wide 512-bit network (DMA + i-cache) and a narrow 64-bit
network (LSU / synchronisation), each a two-level hierarchy of multicast-
capable crossbars; a 4 MiB LLC on the wide network.

The microbenchmark (fig. 3b): one cluster sends the same ``size``-byte
buffer to all other clusters.  Three strategies:

* ``multi_unicast`` — one unicast DMA transfer per destination,
  serialised through the source cluster's single wide port;
* ``sw_tree``      — hierarchical software multicast: the source sends to
  one *leader* cluster in every other group, then every leader (and the
  source) forwards to the remaining clusters of its own group, in
  parallel across groups.  Each stage pays a software overhead
  (interrupt + DMA reprogram) on top of the transfer time;
* ``hw_mcast``     — a single multicast transfer forked by the XBARs.

All times are cycles at 1 GHz, derived from the resource model in
``repro_torch.core.timing``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

from repro_torch.core.timing import TimingModel

Mode = Literal["multi_unicast", "sw_tree", "hw_mcast"]


@dataclasses.dataclass(frozen=True)
class NocConfig:
    n_clusters: int = 32
    clusters_per_group: int = 4

    @property
    def n_groups(self) -> int:
        return math.ceil(self.n_clusters / self.clusters_per_group)


@dataclasses.dataclass(frozen=True)
class TransferResult:
    mode: str
    n_clusters: int  # total clusters involved (source + destinations)
    size: int  # bytes per destination
    cycles: float

    @property
    def effective_bw_bytes_per_cycle(self) -> float:
        """Aggregate delivered bandwidth (all destinations)."""
        return (self.n_clusters - 1) * self.size / self.cycles


class OccamyNoc:
    """Resource model of Occamy's wide network for 1-to-N transfers."""

    def __init__(self, cfg: NocConfig | None = None, timing: TimingModel | None = None):
        self.cfg = cfg or NocConfig()
        self.timing = timing or TimingModel()

    # ------------------------------------------------------------------
    def one_to_all(self, size: int, n_clusters: int | None = None, mode: Mode = "hw_mcast") -> TransferResult:
        n = n_clusters if n_clusters is not None else self.cfg.n_clusters
        if not 2 <= n <= self.cfg.n_clusters:
            raise ValueError(f"n_clusters must be in [2, {self.cfg.n_clusters}]")
        t = self.timing
        n_dest = n - 1

        if mode == "multi_unicast":
            cycles = t.multi_unicast(size, n_dest)

        elif mode == "hw_mcast":
            cycles = t.hw_multicast(size, n_dest)

        elif mode == "sw_tree":
            # Stage 1: source unicasts to one leader per *other* group.
            g = self.cfg.clusters_per_group
            n_groups = math.ceil(n / g)
            stage1_dests = n_groups - 1
            cycles = t.sw_stage_overhead + (
                t.multi_unicast(size, stage1_dests) if stage1_dests else 0.0
            )
            # Stage 2: every leader (incl. the source) forwards to the
            # remaining clusters of its group — parallel across groups, so
            # the stage cost is the slowest (= fullest) group.
            stage2_dests = min(g, n) - 1
            if stage2_dests:
                cycles += t.sw_stage_overhead + t.multi_unicast(size, stage2_dests)
        else:
            raise ValueError(f"unknown mode: {mode}")

        return TransferResult(mode=mode, n_clusters=n, size=size, cycles=cycles)

    # ------------------------------------------------------------------
    def speedup(self, size: int, n_clusters: int, mode: Mode = "hw_mcast") -> float:
        """Speedup of ``mode`` over the multiple-unicast baseline."""
        base = self.one_to_all(size, n_clusters, "multi_unicast").cycles
        return base / self.one_to_all(size, n_clusters, mode).cycles

    @staticmethod
    def amdahl_parallel_fraction(speedup: float, n: int) -> float:
        """Equivalent parallel fraction p s.t. 1/((1-p)+p/n) == speedup."""
        return (1.0 - 1.0 / speedup) / (1.0 - 1.0 / n)


def microbenchmark_table(
    noc: OccamyNoc | None = None,
    sizes: tuple[int, ...] = (4096, 8192, 16384, 32768),
    cluster_counts: tuple[int, ...] = (2, 4, 8, 16, 32),
) -> list[dict]:
    """Reproduces figure 3b: speedups of hw multicast (and, for >=8
    clusters, the software tree) over the multiple-unicast baseline."""
    noc = noc or OccamyNoc()
    rows = []
    for n in cluster_counts:
        for size in sizes:
            base = noc.one_to_all(size, n, "multi_unicast")
            hw = noc.one_to_all(size, n, "hw_mcast")
            row = {
                "n_clusters": n,
                "size": size,
                "cycles_unicast": base.cycles,
                "cycles_hw": hw.cycles,
                "speedup_hw": base.cycles / hw.cycles,
                "amdahl_p": OccamyNoc.amdahl_parallel_fraction(
                    base.cycles / hw.cycles, n
                ),
            }
            if n > noc.cfg.clusters_per_group:
                sw = noc.one_to_all(size, n, "sw_tree")
                row["cycles_sw"] = sw.cycles
                row["speedup_sw"] = base.cycles / sw.cycles
                row["hw_over_sw"] = sw.cycles / hw.cycles
            rows.append(row)
    return rows
