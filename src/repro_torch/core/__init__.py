"""The paper's contribution: multicast-capable AXI crossbar + Occamy model.

* ``encoding``  — mask-form multi-address encoding + address decoder
* ``xbar``      — protocol-faithful multicast crossbar simulator
* ``timing``    — calibrated latency/bandwidth model
* ``noc``       — Occamy two-level NoC + fig. 3b microbenchmark
* ``occamy``    — system model + fig. 3c matmul evaluation
* ``area``      — fig. 3a area/timing model

A copy of the JAX package's ``core`` (numpy and the standard library
only).  Its figures — cycles, GFLOPS, bytes per cycle, kGE, GHz — are the
paper's modelled Occamy system (and its 12 nm synthesis), not TPU or
H100 timings.
"""
from repro_torch.core.encoding import (
    ADDR_WIDTH,
    AddressDecoder,
    AddrRule,
    Ife,
    Mfe,
    cluster_window,
    ife_to_mfe,
    mcast_request_for_clusters,
    mfe_for_address_set,
    mfe_to_ife,
)
from repro_torch.core.noc import NocConfig, OccamyNoc, microbenchmark_table
from repro_torch.core.occamy import OccamyConfig, OccamySystem
from repro_torch.core.timing import TimingModel
from repro_torch.core.xbar import DeadlockError, McastXbar, Resp, WriteTxn

__all__ = [
    "ADDR_WIDTH",
    "AddressDecoder",
    "AddrRule",
    "DeadlockError",
    "Ife",
    "McastXbar",
    "Mfe",
    "NocConfig",
    "OccamyConfig",
    "OccamyNoc",
    "OccamySystem",
    "Resp",
    "TimingModel",
    "WriteTxn",
    "cluster_window",
    "ife_to_mfe",
    "mcast_request_for_clusters",
    "mfe_for_address_set",
    "mfe_to_ife",
    "microbenchmark_table",
]
