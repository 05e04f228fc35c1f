"""Area/timing model of the multicast XBAR (paper fig. 3a, section III-A).

The paper reports post-synthesis area (GLOBALFOUNDRIES 12LP+, worst case
0.72 V / 125 C, 1 ns clock) for N-to-N crossbars with and without the
multicast extension.  Two anchor points are given explicitly:

* 8-to-8:   +13.1 kGE multicast overhead (= 9% of the baseline XBAR)
* 16-to-16: +45.4 kGE multicast overhead (= 12% of the baseline XBAR)

from which the baseline areas follow: 145.6 kGE and 378.3 kGE.  Area
scales quadratically with N (an N x N array of demux/mux pairs plus
N-proportional channel logic), so we fit ``a*N^2 + b*N`` through the two
anchors for both the baseline and the overhead:

    baseline:  a = 0.6805 kGE, b = 12.756 kGE
    overhead:  d = 0.1500 kGE, e = 0.4375 kGE

Timing: every configuration meets 1 GHz except the multicast 16-to-16,
which degrades by 6%.
"""
from __future__ import annotations

import dataclasses

_BASE_A = 0.6805  # kGE / port^2
_BASE_B = 12.756  # kGE / port
_MC_A = 0.1500
_MC_B = 0.4375


@dataclasses.dataclass(frozen=True)
class XbarArea:
    n_ports: int
    base_kge: float
    mcast_kge: float

    @property
    def overhead_kge(self) -> float:
        return self.mcast_kge - self.base_kge

    @property
    def overhead_frac(self) -> float:
        return self.overhead_kge / self.base_kge

    @property
    def freq_ghz_base(self) -> float:
        return 1.0

    @property
    def freq_ghz_mcast(self) -> float:
        # Only the largest physically-implementable configuration (16x16)
        # misses the 1 GHz target, by 6%.
        return 0.94 if self.n_ports >= 16 else 1.0


def xbar_area(n_ports: int) -> XbarArea:
    base = _BASE_A * n_ports**2 + _BASE_B * n_ports
    over = _MC_A * n_ports**2 + _MC_B * n_ports
    return XbarArea(n_ports=n_ports, base_kge=base, mcast_kge=base + over)


def area_table(port_counts: tuple[int, ...] = (2, 4, 8, 16)) -> list[XbarArea]:
    return [xbar_area(n) for n in port_counts]
