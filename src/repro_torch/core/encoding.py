"""Mask-form multi-address encoding (MFE) — section II-A of the paper.

A multicast write request carries, besides its address, a *mask* (in
``aw_user``).  Every bit set in the mask marks the corresponding address bit
as a don't-care (X), so a request with ``n`` masked bits addresses ``2**n``
destinations.  The encoding size scales with ``log2(address_space)`` and is
independent of the destination-set size.

Multicast-targetable regions ("multicast rules") must be

  1. a power of two in size, and
  2. aligned to an integer multiple of their size,

which makes the interval-form encoding (IFE) -> mask-form encoding (MFE)
conversion exact::

    mfe.addr = ife.start_addr
    mfe.mask = ife.end_addr - ife.start_addr - 1     # end exclusive

The address decoder computes, for every rule, whether the request's address
set intersects the rule's region (paper, verbatim logic)::

    masked_bits = req.mask | rule.mask
    match_bits  = ~(req.addr ^ rule.addr)
    aw_select[rule.idx] = AND-reduce(masked_bits | match_bits)

and the intersection of the two address sets is obtained by resolving the
request's masked bits against the rule::

    isect.mask = req.mask & rule.mask
    isect.addr = (req.addr & ~req.mask) | (rule.addr & req.mask)

Everything here is plain-integer / numpy bit arithmetic so it can be driven
both by the cycle-approximate simulator and by hypothesis-based property
tests.  A vectorised numpy decoder is provided for bulk evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np

#: Address width used throughout the Occamy-like system model (48-bit AXI).
ADDR_WIDTH = 48
ADDR_MASK = (1 << ADDR_WIDTH) - 1


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mfe:
    """Mask-form encoding: ``addr`` with don't-care bits marked in ``mask``."""

    addr: int
    mask: int = 0

    def __post_init__(self) -> None:
        if not 0 <= self.addr <= ADDR_MASK:
            raise ValueError(f"addr out of range: {self.addr:#x}")
        if not 0 <= self.mask <= ADDR_MASK:
            raise ValueError(f"mask out of range: {self.mask:#x}")

    @property
    def canonical(self) -> "Mfe":
        """Masked address bits are don't-care; canonical form zeroes them."""
        return Mfe(self.addr & ~self.mask & ADDR_MASK, self.mask)

    @property
    def size(self) -> int:
        """Number of addresses represented (2**popcount(mask))."""
        return 1 << int(bin(self.mask).count("1"))

    def addresses(self, limit: int | None = None) -> Iterator[int]:
        """Enumerate the represented address set (ascending)."""
        bits = [i for i in range(ADDR_WIDTH) if (self.mask >> i) & 1]
        if limit is not None and (1 << len(bits)) > limit:
            raise ValueError(f"address set too large to enumerate: 2**{len(bits)}")
        base = self.addr & ~self.mask
        for combo in range(1 << len(bits)):
            a = base
            for j, b in enumerate(bits):
                if (combo >> j) & 1:
                    a |= 1 << b
            yield a

    def contains(self, addr: int) -> bool:
        """Membership: non-masked bits must match."""
        return (addr ^ self.addr) & ~self.mask & ADDR_MASK == 0


@dataclasses.dataclass(frozen=True)
class Ife:
    """Interval-form encoding: ``[start, end)`` with MFE-compatible layout."""

    start: int
    end: int  # exclusive

    def __post_init__(self) -> None:
        size = self.end - self.start
        if size <= 0:
            raise ValueError(f"empty interval [{self.start:#x}, {self.end:#x})")
        if size & (size - 1):
            raise ValueError(f"size {size:#x} is not a power of two")
        if self.start % size:
            raise ValueError(
                f"start {self.start:#x} not aligned to size {size:#x}"
            )

    @property
    def size(self) -> int:
        return self.end - self.start


def ife_to_mfe(ife: Ife) -> Mfe:
    """Paper's conversion: ``mfe.addr = start; mfe.mask = end - start - 1``."""
    return Mfe(addr=ife.start, mask=ife.end - ife.start - 1)


def mfe_to_ife(mfe: Mfe) -> Ife:
    """Inverse conversion — only valid for *contiguous* (low-bit) masks."""
    if mfe.mask & (mfe.mask + 1):
        raise ValueError(f"mask {mfe.mask:#x} is not contiguous-from-LSB")
    start = mfe.addr & ~mfe.mask
    return Ife(start=start, end=start + mfe.mask + 1)


# ---------------------------------------------------------------------------
# Address map + decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AddrRule:
    """One address-map entry: ``[start, end)`` routes to slave ``idx``."""

    idx: int
    start: int
    end: int

    def contains(self, addr: int) -> bool:
        return self.start <= addr < self.end


@dataclasses.dataclass(frozen=True)
class DecodeResult:
    """Decoder output: slave-select bitmap + per-slave address subset."""

    select: int  # bitmap over slave indices (aw_select)
    subsets: dict[int, Mfe]  # slave idx -> intersection MFE

    @property
    def slave_indices(self) -> list[int]:
        return sorted(self.subsets)

    @property
    def fanout(self) -> int:
        return len(self.subsets)

    @property
    def is_mcast(self) -> bool:
        return self.fanout > 1


class AddressDecoder:
    """The extended (multicast-capable) address decoder of section II-A.

    Unicast rules may be arbitrary intervals (matched by range compare, as
    in the baseline XBAR); *multicast* rules must satisfy the power-of-two
    size/alignment constraints so they convert to mask form.
    """

    def __init__(self, rules: Sequence[AddrRule]):
        self._rules = list(rules)
        # Convert every multicast-capable rule to mask form once, at
        # elaboration time ("we integrate logic to convert all multicast
        # rules to mask form").
        self._mfe_rules: list[tuple[AddrRule, Mfe]] = []
        for r in self._rules:
            try:
                self._mfe_rules.append((r, ife_to_mfe(Ife(r.start, r.end))))
            except ValueError:
                self._mfe_rules.append((r, Mfe(addr=r.start, mask=0)))

    @property
    def rules(self) -> list[AddrRule]:
        return list(self._rules)

    def decode_unicast(self, addr: int) -> int | None:
        """Baseline decoder: first matching rule's slave index (or None)."""
        for r in self._rules:
            if r.contains(addr):
                return r.idx
        return None

    def decode(self, addr: int, mask: int = 0) -> DecodeResult:
        """Multicast-capable decode of a request ``(addr, mask)``.

        Returns the ``aw_select`` bitmap and, per selected slave, the subset
        of the request's address set that falls within that slave (used by
        downstream XBAR levels and by the slave itself).
        """
        if mask == 0:
            idx = self.decode_unicast(addr)
            if idx is None:
                return DecodeResult(select=0, subsets={})
            return DecodeResult(select=1 << idx, subsets={idx: Mfe(addr, 0)})

        select = 0
        subsets: dict[int, Mfe] = {}
        for rule, rmfe in self._mfe_rules:
            # --- the paper's 3-line decoder -------------------------------
            masked_bits = mask | rmfe.mask
            match_bits = ~(addr ^ rmfe.addr) & ADDR_MASK
            hit = (masked_bits | match_bits) & ADDR_MASK == ADDR_MASK
            # --------------------------------------------------------------
            if not hit or (rule.idx in subsets):
                continue
            select |= 1 << rule.idx
            # Intersection: resolve request's masked bits against the rule.
            isect_mask = mask & rmfe.mask
            isect_addr = (addr & ~mask | rmfe.addr & mask) & ADDR_MASK
            subsets[rule.idx] = Mfe(isect_addr, isect_mask).canonical
        return DecodeResult(select=select, subsets=subsets)


# ---------------------------------------------------------------------------
# Vectorised (numpy) decoder — bulk property testing / simulator fast path
# ---------------------------------------------------------------------------


def decode_bulk(
    addrs: np.ndarray,
    masks: np.ndarray,
    rule_addrs: np.ndarray,
    rule_masks: np.ndarray,
) -> np.ndarray:
    """Vectorised ``aw_select``: (n_req, n_rule) boolean hit matrix.

    Implements exactly ``&(masked_bits | match_bits)`` with uint64 lanes.
    """
    a = addrs.astype(np.uint64)[:, None]
    m = masks.astype(np.uint64)[:, None]
    ra = rule_addrs.astype(np.uint64)[None, :]
    rm = rule_masks.astype(np.uint64)[None, :]
    full = np.uint64(ADDR_MASK)
    masked_bits = m | rm
    match_bits = ~(a ^ ra) & full
    return (masked_bits | match_bits) & full == full


# ---------------------------------------------------------------------------
# Helpers for building multicast requests over cluster windows
# ---------------------------------------------------------------------------


def mfe_for_address_set(addrs: Iterable[int]) -> Mfe | None:
    """Smallest-mask MFE covering ``addrs`` exactly, or None if none exists.

    An address set is exactly representable iff it equals the full
    ``2**popcount(mask)`` expansion of some (addr, mask) pair.
    """
    alist = sorted(set(addrs))
    if not alist:
        return None
    base = alist[0]
    diff = 0
    for a in alist:
        diff |= a ^ base
    cand = Mfe(base, diff)
    if cand.size != len(alist):
        return None
    # Verify exactness (cheap for the cluster-count scale we target).
    if list(cand.addresses(limit=1 << 20)) != alist:
        return None
    return cand


def cluster_window(cluster_id: int, base: int = 0x0100_0000, size: int = 0x4_0000) -> Ife:
    """Occamy cluster address window: consecutive, size-aligned (paper II-B)."""
    start = base + cluster_id * size
    return Ife(start=start, end=start + size)


def mcast_request_for_clusters(
    cluster_ids: Iterable[int],
    offset: int = 0,
    base: int = 0x0100_0000,
    size: int = 0x4_0000,
) -> Mfe | None:
    """Build the (addr, mask) pair multicasting to ``cluster_ids``.

    ``offset`` is the intra-cluster target offset (e.g. L1 destination).
    Returns None when the cluster set is not mask-expressible (the paper's
    encoding cannot represent *all* sets — e.g. {0, 1, 2}).
    """
    ids = sorted(set(cluster_ids))
    id_mfe = mfe_for_address_set(ids)
    if id_mfe is None:
        return None
    return Mfe(
        addr=(base + id_mfe.addr * size + offset) & ADDR_MASK,
        mask=id_mfe.mask * size,  # shift the id mask into the window bits
    )
