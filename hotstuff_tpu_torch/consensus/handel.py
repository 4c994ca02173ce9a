"""Handel-style multi-level vote aggregation (arXiv:1906.05132).

A copy of ``hotstuff_tpu.consensus.handel``.  The merges are host G1
additions (``crypto/bls/curve.G1Point``), as in the reference, which has
no device function for them.

The compact certificate (messages.py) makes the QC O(1) on the
wire, but the LEADER still receives n individual votes.  Handel removes
that last O(n): validators are arranged into log2(n) levels over a
seeded permutation, every node exchanges *partial aggregates* (one
aggregate G1 signature + a signer bitmap — exactly the compact-QC
payload) with its mirror block at each level, and the top of the tree
holds a full-coverage aggregate after each node merged O(log n)
partials.  Merging is one G1 point add plus a bitmap OR; disjointness
of the operand bitmaps is checked structurally (bit i set in both =
the same signature counted twice = an invalid aggregate), so a
Byzantine peer cannot inflate weight by replaying coverage.

This module is the protocol plane: deterministic topology, partial
merge rules, and an in-process driver (``simulate``) used by the bench
(``bench/verifier.py`` ``bench_agg_qc``) and the tests.  Network dissemination of partials rides the existing vote
channels unchanged — a partial is just (agg sig, bitmap), the same
material a compact QC carries, and the leader's QCMaker accepts the
final aggregate exactly as it accepts its own running sum.

Trust base: identical to compact-QC verification — bitmaps resolve
against the committee's sorted key order, aggregation is only over
PoP-checked members, and every receiver re-verifies the final aggregate
with one pairing (``BlsVerifier.verify_aggregate_msg``).
"""

from __future__ import annotations

import hashlib

from .errors import ConsensusError
from .messages import _popcount, bitmap_indices

__all__ = [
    "HandelTopology",
    "PartialAggregate",
    "PartialOverlap",
    "simulate",
]


class PartialOverlap(ConsensusError):
    """Two partials claim the same signer bit — merging would double-
    count a signature (weight inflation)."""

    def __init__(self):
        super().__init__("overlapping signer bitmaps in partial aggregates")


class PartialAggregate:
    """A Handel partial: Σ sig over the signers named by ``bitmap``.

    ``point`` is the running G1 sum (None = empty).  Wire form is
    (48-byte compressed aggregate, bitmap) — the compact-QC payload.
    """

    __slots__ = ("point", "bitmap")

    def __init__(self, point, bitmap: bytes):
        self.point = point
        self.bitmap = bitmap

    @classmethod
    def empty(cls, nbytes: int) -> "PartialAggregate":
        return cls(None, bytes(nbytes))

    @classmethod
    def single(
        cls, sig_bytes: bytes, index: int, nbytes: int
    ) -> "PartialAggregate":
        """One validator's own signature as a level-0 partial."""
        from ..crypto.bls.curve import G1Point

        pt = G1Point.from_bytes(sig_bytes, subgroup_check=False)
        if pt is None:
            raise ConsensusError("undecodable signature in Handel partial")
        bm = bytearray(nbytes)
        bm[index // 8] |= 1 << (index % 8)
        return cls(pt, bytes(bm))

    @property
    def weight(self) -> int:
        return _popcount(self.bitmap)

    def signers(self) -> list[int]:
        return list(bitmap_indices(self.bitmap))

    def merge(self, other: "PartialAggregate") -> "PartialAggregate":
        """Disjoint union: one point add + bitmap OR.  Raises
        ``PartialOverlap`` when any signer bit appears in both."""
        a = int.from_bytes(self.bitmap, "little")
        b = int.from_bytes(other.bitmap, "little")
        if a & b:
            raise PartialOverlap()
        if self.point is None:
            point = other.point
        elif other.point is None:
            point = self.point
        else:
            point = self.point + other.point
        n = max(len(self.bitmap), len(other.bitmap))
        return PartialAggregate(point, (a | b).to_bytes(n, "little"))

    def to_wire(self) -> tuple[bytes, bytes]:
        """(aggregate signature bytes, signer bitmap) — the compact-
        certificate payload.  Raises on the empty partial."""
        if self.point is None:
            raise ConsensusError("empty Handel partial has no aggregate")
        return self.point.to_bytes(), self.bitmap


class HandelTopology:
    """Seeded level structure over n validators.

    A seeded Fisher-Yates permutation maps validator index (committee
    sorted-key order) -> tree position; the permutation reshuffles every
    round (seed = H(domain ‖ round)), so a fixed Byzantine coalition
    cannot permanently occupy one subtree.  At level l (1-based), the
    tree positions split into blocks of 2^l; a node's PARTNER BLOCK is
    the sibling half of its own block — the positions whose partial it
    must obtain to double its coverage.  ceil(log2 n) levels take every
    node from its own signature to full coverage, so a leader merges
    O(log n) partials instead of touching n votes.
    """

    def __init__(self, n: int, seed: bytes):
        if n <= 0:
            raise ValueError("topology needs at least one validator")
        self.n = n
        self.seed = seed
        self.levels = max(1, (n - 1).bit_length())
        # Fisher-Yates driven by a hash counter — deterministic across
        # nodes given (n, seed), no RNG state to share
        perm = list(range(n))
        for i in range(n - 1, 0, -1):
            h = hashlib.blake2b(
                seed + i.to_bytes(4, "little"), digest_size=8
            ).digest()
            j = int.from_bytes(h, "little") % (i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        # validator index -> position, and the inverse
        self.position = {v: p for p, v in enumerate(perm)}
        self.validator_at = perm

    @classmethod
    def for_round(
        cls, n: int, round_: int, domain: bytes = b"hotstuff-handel"
    ) -> "HandelTopology":
        seed = hashlib.blake2b(
            domain + round_.to_bytes(8, "little"), digest_size=16
        ).digest()
        return cls(n, seed)

    def block(self, index: int, level: int) -> range:
        """Tree positions of ``index``'s own block at ``level`` (size
        2^level, clipped to n)."""
        pos = self.position[index]
        size = 1 << level
        start = (pos // size) * size
        return range(start, min(start + size, self.n))

    def partner_block(self, index: int, level: int) -> range:
        """Tree positions whose partial ``index`` needs at ``level``:
        the sibling half of its level block (possibly empty at the
        ragged top of a non-power-of-two committee)."""
        pos = self.position[index]
        size = 1 << level
        half = size >> 1
        start = (pos // size) * size
        if (pos - start) < half:
            lo, hi = start + half, start + size
        else:
            lo, hi = start, start + half
        return range(min(lo, self.n), min(hi, self.n))

    def validators_in(self, positions: range) -> list[int]:
        return [self.validator_at[p] for p in positions]


def simulate(
    topology: HandelTopology,
    signatures: dict[int, bytes],
    nbytes: int | None = None,
) -> tuple[PartialAggregate, int, int]:
    """In-process Handel run: every contributing validator (index ->
    48-byte signature) builds its level-0 partial, partials combine up
    the levels, and the aggregate covering position 0's top block is
    returned — (final partial, merges the top node performed, total
    merges network-wide).  Missing validators simply leave their bits
    clear; the caller checks ``weight`` against its quorum rule.

    The per-node merge count is the headline: it is <= topology.levels
    — O(log n) — however large the committee.
    """
    n = topology.n
    if nbytes is None:
        nbytes = (n + 7) // 8
    # per-position level-0 partials (skip non-contributors)
    partials: dict[int, PartialAggregate | None] = {}
    for pos in range(n):
        v = topology.validator_at[pos]
        sig = signatures.get(v)
        partials[pos] = (
            None
            if sig is None
            else PartialAggregate.single(sig, v, nbytes)
        )
    total_merges = 0
    top_merges = 0
    # combine block pairs bottom-up: after level l every surviving
    # partial covers one 2^l block — exactly the exchange each node
    # performs with its partner block at that level
    for level in range(1, topology.levels + 1):
        size = 1 << level
        half = size >> 1
        nxt: dict[int, PartialAggregate | None] = {}
        for start in range(0, n, size):
            left = partials.get(start)
            right = partials.get(start + half)
            if left is None:
                merged = right
            elif right is None:
                merged = left
            else:
                merged = left.merge(right)
                total_merges += 1
                if start == 0:
                    top_merges += 1
            nxt[start] = merged
        partials = nxt
    final = partials.get(0)
    if final is None:
        raise ConsensusError("no contributions reached the Handel root")
    return final, top_merges, total_merges
