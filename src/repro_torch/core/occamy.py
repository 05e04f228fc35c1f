"""Occamy system model + the paper's matmul evaluation (fig. 3c).

Reproduces the end-to-end kernel study of section III-B: the largest
square fp64 matmul tile fitting the 4 MiB LLC with double buffering
(256x256), parallelised as in fig. 3d — every cluster owns an 8x256 row
block of C, computed one 8x16 tile at a time; the 8x256 A block is loaded
into L1 once and reused; B column tiles stream from the LLC every
iteration, double-buffered against compute.

The three data-movement strategies for the B tile are:

* ``baseline``  — every cluster unicast-loads the B tile from the LLC
                  (steady-state OI = 1.9 flops/byte, memory bound);
* ``sw_mcast``  — hierarchical software multicast (LLC -> one leader per
                  group -> intra-group forwarding), x3.7 OI;
* ``hw_mcast``  — one multicast DMA forked by the XBARs, x16.5 OI.

Cycle counts come from a per-iteration double-buffered pipeline model:
``tile_time = max(compute, LLC service, distribution path) + sync`` where
``sync`` is the multicast/unicast ordering drain + commit/join overhead
(see ``repro_torch.core.timing.TimingModel.mcast_sync_overhead``).

The port's CUDA matmul kernels mirror this hierarchy on an H100
(``repro_torch.kernels.matmul``): K4 ``mcast``'s ``wgmma-cluster`` design
(each B k-tile fetched once per thread-block cluster and delivered to
every CTA of it by TMA multicast, ``cp.async.bulk.tensor ...
.multicast::cluster``) plays ``hw_mcast``; K1 ``tiled``'s grouped raster
(8 row blocks walk one B column back to back, so one fetch serves the
group through L2) plays the two-stage ``sw_mcast`` hierarchy; and K5
``unicast`` (B re-read for every row block) plays ``baseline``.
``kernel_schedule_analogy`` spells the mapping out and
``repro_torch.kernels.matmul.hbm_traffic_model`` gives the analytic
byte counts for all three.

Every figure here (cycles, GFLOPS, bytes per cycle, OI) belongs to the
paper's modelled Occamy system at 1 GHz: none is a TPU or H100 timing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

from repro_torch.core.noc import NocConfig
from repro_torch.core.timing import TimingModel

MatmulMode = Literal["baseline", "sw_mcast", "hw_mcast"]


@dataclasses.dataclass(frozen=True)
class OccamyConfig:
    noc: NocConfig = dataclasses.field(default_factory=NocConfig)
    cores_per_cluster: int = 8  # compute cores (the 9th is the DMA core)
    flops_per_cycle_per_core: int = 2  # fp64 FMA
    l1_kib: int = 128
    llc_mib: int = 4

    @property
    def n_clusters(self) -> int:
        return self.noc.n_clusters

    @property
    def cluster_flops_per_cycle(self) -> int:
        return self.cores_per_cluster * self.flops_per_cycle_per_core

    @property
    def peak_gflops(self) -> float:
        return self.n_clusters * self.cluster_flops_per_cycle  # @ 1 GHz


@dataclasses.dataclass(frozen=True)
class MatmulResult:
    mode: str
    n: int
    cycles: float
    total_flops: int
    oi: float  # steady-state operational intensity, flops / LLC byte
    gflops: float
    peak_gflops: float
    llc_bw_gbps: float

    @property
    def attainable_gflops(self) -> float:
        """Roofline bound at this OI."""
        return min(self.peak_gflops, self.oi * self.llc_bw_gbps)

    @property
    def frac_of_attainable(self) -> float:
        return self.gflops / self.attainable_gflops


class OccamySystem:
    def __init__(
        self,
        cfg: OccamyConfig | None = None,
        timing: TimingModel | None = None,
    ):
        self.cfg = cfg or OccamyConfig()
        self.timing = timing or TimingModel()

    # ------------------------------------------------------------------
    def matmul(
        self,
        n: int = 256,
        mode: MatmulMode = "baseline",
        dtype_bytes: int = 8,
        tile_n: int = 16,
    ) -> MatmulResult:
        cfg, t = self.cfg, self.timing
        nc = cfg.n_clusters
        m_rows = n // nc  # C row-block height per cluster (8 for 256/32)
        iters = n // tile_n  # 8x16 tiles per row block (16)

        # Per-iteration quantities (per cluster unless noted).
        tile_flops = 2 * m_rows * tile_n * n  # 65536
        compute = tile_flops / cfg.cluster_flops_per_cycle  # 4096 cycles
        bytes_b = n * tile_n * dtype_bytes  # 32 KiB B column tile
        bytes_c = m_rows * tile_n * dtype_bytes  # 1 KiB C writeback

        n_groups = cfg.noc.n_groups
        bw = t.wide_bytes_per_cycle

        # LLC bytes per iteration (all clusters) + distribution path latency.
        if mode == "baseline":
            llc_bytes = nc * (bytes_b + bytes_c)
            dist_path = t.unicast_transfer(bytes_b)
            sync = 0.0  # no multicast ordering constraints
            oi_bytes = bytes_b + bytes_c
        elif mode == "sw_mcast":
            llc_bytes = n_groups * bytes_b + nc * bytes_c
            # LLC -> one leader per group, then leaders fan out in-group.
            stage1 = t.sw_stage_overhead + t.multi_unicast(bytes_b, n_groups)
            stage2 = t.sw_stage_overhead + t.multi_unicast(
                bytes_b, cfg.noc.clusters_per_group - 1
            )
            dist_path = stage1 + stage2
            sync = t.mcast_sync_overhead
            oi_bytes = n_groups * bytes_b / nc + bytes_c
        elif mode == "hw_mcast":
            llc_bytes = bytes_b + nc * bytes_c
            dist_path = t.hw_multicast(bytes_b, nc)
            sync = t.mcast_sync_overhead
            oi_bytes = bytes_b / nc + bytes_c
        else:
            raise ValueError(f"unknown mode: {mode}")

        llc_service = llc_bytes / bw / t.llc_efficiency
        tile_time = max(compute, llc_service, dist_path) + sync

        # Prologue: all clusters load their A row block (LLC-serialised).
        bytes_a = m_rows * n * dtype_bytes
        prologue = nc * bytes_a / bw

        cycles = iters * tile_time + prologue
        total_flops = 2 * n**3
        gflops = total_flops / cycles * t.freq_ghz
        return MatmulResult(
            mode=mode,
            n=n,
            cycles=cycles,
            total_flops=total_flops,
            oi=tile_flops / oi_bytes,
            gflops=gflops,
            peak_gflops=cfg.peak_gflops,
            llc_bw_gbps=bw * t.freq_ghz,
        )

    # ------------------------------------------------------------------
    def kernel_schedule_analogy(self, gm: int = 1024, bm: int = 8) -> dict[str, dict]:
        """Map the hardware B-distribution hierarchy onto the kernel
        schedules (see ``repro_torch.kernels.matmul``).

        The reuse degree is the number of consumers one LLC/HBM fetch of
        a B tile serves: every cluster (``hw_mcast`` / kernel ``mcast``),
        one group of clusters (``sw_mcast`` / kernel ``tiled`` with a
        ``gm``-row supertile = gm/bm row blocks), or a single cluster
        (``baseline`` / kernel ``unicast``).  On the H100 the roles fall
        to K4's ``wgmma-cluster`` design, whose TMA multicast is the
        hardware multicast (one fetch per cluster of 2 or 4 CTAs); K1's
        grouped raster, the group-level multicast (one fetch per group of
        8 row blocks, shared through L2); and K5, the unicast baseline.
        The arguments and the results are the model's, unchanged: the
        kernels' own tiles are ``repro_torch.kernels.matmul.kernel_blocks``.
        """
        nc = self.cfg.n_clusters
        return {
            "hw_mcast": {"kernel": "mcast", "b_reuse": nc,
                         "note": "one fetch serves every cluster/row block"},
            "sw_mcast": {"kernel": "tiled", "b_reuse": gm // bm,
                         "note": f"one fetch per group/supertile of {gm // bm} row blocks"},
            "baseline": {"kernel": "unicast", "b_reuse": 1,
                         "note": "re-fetched per cluster/row block"},
        }

    # ------------------------------------------------------------------
    def matmul_study(self, n: int = 256) -> dict[str, MatmulResult]:
        """The full fig. 3c comparison."""
        return {m: self.matmul(n=n, mode=m) for m in ("baseline", "sw_mcast", "hw_mcast")}

    def largest_llc_tile(self, dtype_bytes: int = 8) -> int:
        """Largest square tile (power of two) fitting the LLC with double
        buffering: 2 copies of (A, B, C) tiles -> 6 * n^2 * 8 B <= LLC."""
        budget = self.cfg.llc_mib * 2**20
        n = 1
        while 6 * (2 * n) ** 2 * dtype_bytes <= budget:
            n *= 2
        return n
