"""Multicast collectives on ``torch.distributed``: the port of the JAX
package's ``dist/mcast.py`` (the paper's fig. 3b adaptation).

The paper's three B-distribution strategies, over the ranks of a bound
mesh's data axis (its first axis where it has none), each keeping its
cost hierarchy:

* ``unicast`` — the source sends the payload to every receiver
  separately: N-1 point-to-point rounds (the multiple-unicast baseline,
  the source's port serialised); the weight gather is a ring, one hop a
  round;
* ``sw_tree`` — recursive doubling: ceil(log2 N) rounds (the
  hierarchical software multicast, source -> leaders -> groups); the
  gather exchanges with partner ``i ^ k`` in round ``k``;
* ``hw`` — one collective (``broadcast`` / ``all_gather``) and no
  point-to-point message: the crossbar-fork hardware multicast, a single
  fabric transaction.

A *round* is one batch of concurrent sends (one ``batch_isend_irecv``),
the port's counterpart of one ``collective-permute`` op, which the JAX
package counts in its compiled HLO.  The ``make_*`` functions return a
:class:`Collective`, whose ``rounds`` is what its last call issued — the
same on every rank, as the compiled program is (a rank with nothing to
send in a round still counts it).  Each round passes the seam of
:mod:`repro_torch.dist.tp` as one ``collective-permute``; ``hw``'s
broadcast as an ``all-reduce`` (JAX's ``psum``) and its gather as an
``all-gather``.  Counting rounds, not messages, is what
separates the modes: at N = 4, ``sw_tree`` sends 3 messages in 2 rounds,
and by messages it ties with ``unicast`` (:func:`bytes_model`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import tp

MODES = ("unicast", "sw_tree", "hw")


def _axis(mesh) -> str:
    return "data" if "data" in mesh.axis_names else mesh.axis_names[0]


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode!r} (have {MODES})")


class Collective:
    """One mode's delivery over ``axis`` of a bound mesh; ``rounds``: the
    point-to-point rounds of its last call."""

    def __init__(self, body, mesh, axis: str, mode: str):
        _check_mode(mode)
        self._body, self.mesh, self.axis, self.mode = body, mesh, axis, mode
        self.n = mesh.shape[axis]
        self.index = mesh.coords[axis]
        self.group = mesh.group(axis)
        if self.group is None:
            self.ranks = [mesh.rank]
        else:
            import torch.distributed as dist

            self.ranks = dist.get_process_group_ranks(self.group)
        self.rounds = 0

    def exchange(self, sends: list[tuple[torch.Tensor, int]],
                 recvs: list[tuple[torch.Tensor, int]], nbytes: int) -> None:
        """One round: this rank's sends and receives (by index along the
        axis), posted together and awaited.  The seam logs it as one
        ``collective-permute`` of ``nbytes``, the round's payload (HLO's
        result shape, the same on every rank, whether or not it sends)."""
        import torch.distributed as dist

        tp.record("collective-permute", self.axis, nbytes, site="mcast")
        ops = [dist.P2POp(dist.isend, t, self.ranks[j], self.group) for t, j in sends]
        ops += [dist.P2POp(dist.irecv, t, self.ranks[j], self.group) for t, j in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self.rounds += 1

    def __call__(self, x: torch.Tensor, **kw) -> torch.Tensor:
        self.rounds = 0
        return self._body(self, x.contiguous(), **kw)


def _from_source(c: Collective, x: torch.Tensor, source: int = 0) -> torch.Tensor:
    """Deliver index ``source``'s ``x`` to every rank along the axis: each
    mode runs on the indices rotated so that the source is 0, so every
    source takes the same rounds."""
    n = c.n
    if not 0 <= source < n:
        raise ValueError(f"source index {source} outside an axis of {n} ranks")
    i = (c.index - source) % n  # this rank's index, counted from the source

    def real(v: int) -> int:
        return (v + source) % n

    y = x.clone()
    nbytes = y.numel() * y.element_size()
    if c.mode == "hw":  # one collective, called on a one-rank axis too
        import torch.distributed as dist

        tp.record("all-reduce", c.axis, nbytes, site="mcast")  # JAX's psum
        dist.broadcast(y, src=c.ranks[source], group=c.group)
        return y
    if c.mode == "unicast":
        for t in range(1, n):  # N-1 separate sends from the source
            c.exchange([(y, real(t))] if i == 0 else [], [(y, real(0))] if i == t else [],
                       nbytes)
        return y
    k = 1
    while k < n:  # doubling rounds: holders forward to +k
        c.exchange([(y, real(i + k))] if i < k and i + k < n else [],
                   [(y, real(i - k))] if k <= i < 2 * k else [], nbytes)
        k *= 2
    return y


def make_broadcast_fn(mesh, shape, dtype, mode: str, *, axis: str | None = None) -> Collective:
    """f(x, source=0): deliver index ``source``'s copy of ``x`` (``shape``,
    ``dtype``) along ``axis`` of the bound ``mesh`` (default: its data
    axis) to every rank via ``mode``."""
    del shape, dtype  # taken from the payload; kept for JAX's signature
    return Collective(_from_source, mesh, axis or _axis(mesh), mode)


def make_weight_gather_fn(mesh, shape, dtype, mode: str) -> Collective:
    """f(w_local): each rank contributes its row shard (``shape[0] / N``
    rows of the full ``shape``); every rank ends with the full weight
    (the FSDP weight-fetch path, per distribution mode).  The JAX
    function takes the replicated weight and slices each device's rows
    itself; here a rank holds only its own rows."""
    del dtype
    axis = _axis(mesh)
    n = mesh.shape[axis]
    if shape[0] % n:
        raise ValueError(f"{shape[0]} rows do not split over {n} ranks")
    if mode == "sw_tree" and n & (n - 1):
        raise ValueError(f"sw_tree's recursive doubling needs a power of two, not {n}")
    rows = shape[0] // n

    def body(c: Collective, w: torch.Tensor) -> torch.Tensor:
        if tuple(w.shape) != (rows, *shape[1:]):
            raise ValueError(f"row shard {tuple(w.shape)}, expected {(rows, *shape[1:])}")
        i = c.index
        buf = torch.empty(tuple(shape), dtype=w.dtype, device=w.device)
        blocks = buf.view(n, rows, *shape[1:])
        if n == 1:
            buf.copy_(w)
        elif c.mode == "hw":
            tp.all_gather_into(buf, w, c.group, c.axis, site="mcast")
        elif c.mode == "sw_tree":
            blocks[i].copy_(w)
            k = 1
            while k < n:  # exchange the aligned k-block group with partner i ^ k
                j = i ^ k
                mine, theirs = (i // k) * k, (j // k) * k
                block = blocks[theirs:theirs + k]
                c.exchange([(blocks[mine:mine + k], j)], [(block, j)],
                           block.numel() * block.element_size())
                k *= 2
        else:
            blocks[i].copy_(w)
            cur = w.clone()
            for r in range(n - 1):  # ring rotation, one hop a round
                nxt = torch.empty_like(cur)
                c.exchange([(cur, (i + 1) % n)], [(nxt, (i - 1) % n)],
                           nxt.numel() * nxt.element_size())
                blocks[(i - 1 - r) % n].copy_(nxt)
                cur = nxt
        return buf

    return Collective(body, mesh, axis, mode)


def mcast_matmul(x: torch.Tensor, w: torch.Tensor, mesh, *, mode: str = "hw") -> torch.Tensor:
    """This rank's rows of ``x`` @ the multicast-distributed ``w`` (index
    0's copy, delivered by ``mode``): one ``w`` fetch serves every row
    shard under ``hw``."""
    wl = make_broadcast_fn(mesh, w.shape, w.dtype, mode)(w)
    return x @ wl


def bytes_model(payload_bytes: int, n: int, *,
                per_device: bool = False) -> dict[str, float]:
    """Analytic fabric-byte counts per mode (mirrors core.noc).

    The default is the *link-total* model: bytes crossing any fabric
    link, summed.  For power-of-two ``n`` unicast and sw_tree tie there
    (``sum(2**k, k<log2 n) == n-1`` — the tree moves the same bytes,
    just not serialised through the source's port), so the hierarchy a
    serving deployment feels is the **per-device** one:

    ``per_device=True`` returns the collective bytes each participant
    *sends* — ``(n-1)·P`` / ``ceil(log2 n)·P`` / ``P`` — the multiplier
    the serving engine's ``broadcast_fabric_bytes`` counter uses.  With
    one device there is no fabric: every mode is 0.
    """
    if per_device:
        if n <= 1:
            return {m: 0.0 for m in MODES}
        return {
            "unicast": float(payload_bytes * (n - 1)),
            "sw_tree": float(payload_bytes * math.ceil(math.log2(n))),
            "hw": float(payload_bytes),
        }
    return {
        "unicast": float(payload_bytes * (n - 1)),
        "sw_tree": float(payload_bytes * sum(2**k for k in range(int(math.log2(n))))),
        "hw": float(payload_bytes),
    }


__all__ = ["MODES", "Collective", "bytes_model", "make_broadcast_fn", "make_weight_gather_fn",
           "mcast_matmul"]
