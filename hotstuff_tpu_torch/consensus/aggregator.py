"""Vote/timeout aggregation into certificates — accumulate-then-dispatch.

Parity target: reference ``Aggregator``/``QCMaker``/``TCMaker``
(consensus/src/aggregator.rs:13-139), restructured per the BASELINE.json
north star: votes are accumulated *unverified* and the whole signature set
ships to the ``VerifierBackend`` as ONE batch when a quorum's stake has
arrived — one batched kernel call per certificate instead of 2f+1
sequential verifies on the hot path.

Hardening beyond the reference (messages arrive over unauthenticated TCP,
so deferred verification must not open spoofing holes):

- If the batch fails at quorum, invalid entries are identified
  per-signature and evicted, their authors are *released* (so the honest
  authority's real vote can still land — a spoofed garbage vote cannot
  suppress it) and marked suspect: subsequent votes naming a suspect
  author are verified eagerly on entry, so garbage floods cost the
  attacker a rejected verify instead of aggregator state.
- Aggregation state is bounded: votes/timeouts further than
  ``ROUND_LOOKAHEAD`` past the node's current round are rejected, and at
  most ``MAX_DIGEST_CELLS`` distinct block digests are tracked per round
  (the reference's unbounded maps are a known DoS, aggregator.rs:29-30).

Timeouts are verified on entry by the core (like the reference,
core.rs:288), so ``TCMaker`` accumulates pre-verified entries and emits
the TC without re-verification.

A copy of ``hotstuff_tpu.consensus.aggregator``, whole.  The running G1
signature sum of a BLS committee (``_SigAccumulator``) runs on the card
(``gpu/bls.py`` ``G1RunningSum``) when one is there, chosen as the JAX
package chooses its device; once chosen, a failure to build or launch
raises instead of falling back to the host sum.
"""

from __future__ import annotations

import logging
import os
import sys

from ..crypto import Digest, PublicKey, Signature
from ..crypto.service import VerifierBackend
from .config import Committee
from .errors import AuthorityReuse, ConsensusError, InvalidSignature, UnknownAuthority
from .messages import QC, TC, Round, Timeout, Vote, make_signer_bitmap

log = logging.getLogger(__name__)

# How far past the current round aggregation state may be created.
ROUND_LOOKAHEAD = 64
# Distinct block digests tracked per round (honest case: exactly one).
MAX_DIGEST_CELLS = 8


def _compact_enabled(committee: Committee) -> bool:
    """Compact (one-agg-sig + signer-bitmap) certificate emission:
    default ON for BLS committees — their G1 signatures aggregate —
    HOTSTUFF_COMPACT_QC=0 reverts to the vote-list form.  Ed25519
    committees always emit vote lists (no aggregate form; the wire
    layer rejects compact certificates for them outright)."""
    return (
        getattr(committee, "scheme", "ed25519") == "bls"
        and os.environ.get("HOTSTUFF_COMPACT_QC", "1").strip() != "0"
    )


class _SigAccumulator:
    """Running Σ sig_i over a cell's vote list: one G1 add per
    arriving vote, so the aggregate signature already exists when quorum
    lands — O(1) marginal work per vote instead of an O(n) sum at QC
    formation.

    The sum runs on the card (``gpu.bls.G1RunningSum``, one kernel launch
    per vote) when HOTSTUFF_AGG_DEVICE_SUM=1 forces it (raising without a
    card), or, with the variable unset, when ``torch`` is loaded and a
    CUDA device is there; HOTSTUFF_AGG_DEVICE_SUM=0, or no card, takes an
    incremental host Jacobian add.  Once the device is chosen, a failure
    to build or launch raises: the JAX package drops to the host sum
    quietly.  Per-signature decompress skips the r-torsion
    ladder — the emitted aggregate is subgroup-checked by every verifier
    (the same soundness argument as ``BlsVerifier.verify_shared_msg``).

    ``count`` mirrors the number of accumulated signatures; the owning
    cell compares it against its vote list to detect evict/replace
    divergence and rebuilds from the surviving votes (rare, adversarial
    path)."""

    def __init__(self):
        self.count = 0
        self._device = None
        self._host = None
        if self._want_device():
            from ..gpu.bls import G1RunningSum

            self._device = G1RunningSum(device="cuda")
        if self._device is None:
            from ..crypto.bls.curve import G1Point

            self._host = G1Point.identity()

    @staticmethod
    def _want_device() -> bool:
        env = os.environ.get("HOTSTUFF_AGG_DEVICE_SUM", "").strip().lower()
        if env:
            return env not in ("0", "off", "no", "false")
        # unset: a process that never loaded torch has no card in use
        if "torch" not in sys.modules:
            return False
        import torch

        return torch.cuda.is_available()

    def add(self, sig: Signature) -> bool:
        """Accumulate one signature; False when it doesn't decompress
        (a spoofed blob — the cell falls back to rebuild-at-quorum)."""
        from ..crypto.bls.curve import G1Point

        pt = G1Point.from_bytes(sig.to_bytes(), subgroup_check=False)
        if pt is None:
            return False
        if self._device is not None:
            self._device.add(pt)
        else:
            self._host = self._host + pt
        self.count += 1
        return True

    def aggregate(self) -> bytes | None:
        """The compressed 48-byte aggregate, or None for the empty sum."""
        pt = (
            self._device.snapshot()
            if self._device is not None
            else self._host
        )
        if pt.inf:
            return None
        return pt.to_bytes()


class AggregationBounds(ConsensusError):
    def __init__(self, what: str):
        super().__init__(f"Rejected {what}: aggregation bounds exceeded")


class QCMaker:
    """Accumulates votes over one (round, block-digest) cell into a QC."""

    def __init__(self):
        self.weight = 0
        self.votes: list[tuple[PublicKey, Signature]] = []
        self.used: set[PublicKey] = set()
        self.suspect: set[PublicKey] = set()  # authors with an evicted sig
        # owning Aggregator (set at cell admission) — rejected-signature
        # accounting rolls up there so it survives round cleanup
        self.owner: "Aggregator | None" = None
        # True once the cell holds at least one signature that passed
        # verification.  Cells that never earn this are evictable when the
        # per-round digest-cell budget fills up (ADVICE r1: otherwise 8
        # spoofed votes with random digests suppress honest votes for the
        # real block all round).
        self.verified = False
        # Protected cells (the digest this node itself voted for) are
        # never evicted.
        self.protected = False
        # Entries whose signature was NOT individually pre-verified on
        # entry (async-preverify path, core._preverify_burst).  When
        # empty at quorum, the batch dispatch is skipped — every
        # signature in the certificate already passed.
        self.unverified: set[PublicKey] = set()
        # Running Σ sig for compact-QC emission (BLS committees only;
        # built lazily on the first vote).  None when the committee
        # scheme has no aggregate form or compact emission is off.
        self._acc: _SigAccumulator | None = None

    def append(
        self,
        vote: Vote,
        committee: Committee,
        verifier: VerifierBackend,
        stake: int | None = None,
        sig_verified: bool = False,
    ) -> QC | None:
        author = vote.author
        if author in self.used:
            # A second vote naming an already-counted author. Since votes
            # are unauthenticated on entry, the FIRST one may have been an
            # attacker's spoof racing the honest vote — if this one carries
            # a different, eagerly-verified-valid signature and the stored
            # one is invalid, swap it in (weight is unchanged: the author
            # was already counted). Without the swap, whichever message
            # wins the race would decide whether the honest vote ever
            # counts (vote-suppression attack).
            self._maybe_replace(vote, verifier, incoming_verified=sig_verified)
            raise AuthorityReuse(author)
        if stake is None:
            stake = committee.stake(author)
        if stake <= 0:
            raise UnknownAuthority(author)
        if sig_verified:
            self.verified = True
        elif author in self.suspect:
            # this author's slot was already poisoned once — pay one eager
            # verify instead of trusting the deferred batch again
            if not verifier.verify_one(vote.digest(), author, vote.signature):
                if self.owner is not None:
                    self.owner.qc_rejects += 1
                raise InvalidSignature(f"bad signature on vote {vote!r}")
            self.verified = True
        else:
            self.unverified.add(author)
        self.used.add(author)
        self.votes.append((author, vote.signature))
        if _compact_enabled(committee):
            # O(1) marginal work per vote: the aggregate signature is
            # ready the moment quorum lands
            if self._acc is None:
                self._acc = _SigAccumulator()
            self._acc.add(vote.signature)  # failure -> count diverges,
            # _compact_qc rebuilds from the (verified) survivors
        self.weight += stake
        if self.weight < committee.quorum_threshold():
            return None

        # Quorum reached: dispatch the whole set as one batch — unless
        # every entry was already individually pre-verified (the async
        # preverify path), in which case the certificate is proven.
        if self.unverified and not verifier.verify_shared_msg(
            vote.digest(), self.votes
        ):
            self._evict_invalid(vote.digest(), committee, verifier)
            if self.weight < committee.quorum_threshold():
                return None  # keep accumulating

        self.verified = True
        self.weight = 0  # a QC is made at most once
        if _compact_enabled(committee):
            qc = self._compact_qc(vote, committee)
            if qc is not None:
                return qc
        return QC(hash=vote.hash, round=vote.round, votes=list(self.votes))

    def _compact_qc(self, vote: Vote, committee: Committee) -> QC | None:
        """Emit the constant-size form: one aggregate signature + signer
        bitmap.  None (vote-list fallback) when the signer set doesn't
        map onto the committee bitmap or no aggregate can be formed —
        correctness never depends on the compact path."""
        try:
            bitmap = make_signer_bitmap(
                [pk for pk, _ in self.votes], committee.sorted_keys()
            )
        except (UnknownAuthority, ValueError):
            return None
        if self._acc is None or self._acc.count != len(self.votes):
            # evict/replace (or a non-decompressing spoof) diverged the
            # running sum from the vote list: rebuild from the survivors
            # — all of them just passed verification
            acc = _SigAccumulator()
            if not all(acc.add(sig) for _, sig in self.votes):
                return None
            self._acc = acc
        agg = self._acc.aggregate()
        if agg is None:
            return None
        if self.owner is not None:
            self.owner.compact_qcs += 1
        return QC(
            hash=vote.hash,
            round=vote.round,
            votes=[],
            agg_sig=Signature(agg),
            signers=bitmap,
        )

    def check_any_valid(self, digest: Digest, verifier: VerifierBackend) -> bool:
        """Verify the stored signatures against the cell's vote digest;
        mark the cell verified (and report True) if any is genuine."""
        if not self.votes:
            return False
        ok = verifier.verify_many(
            [digest.to_bytes()] * len(self.votes),
            [pk.to_bytes() for pk, _ in self.votes],
            [sig.to_bytes() for _, sig in self.votes],
        )
        if any(ok):
            self.verified = True
            return True
        return False

    def _maybe_replace(
        self, vote: Vote, verifier: VerifierBackend,
        incoming_verified: bool = False,
    ) -> None:
        for i, (pk, sig) in enumerate(self.votes):
            if pk != vote.author:
                continue
            if sig == vote.signature:
                return  # true duplicate
            if (
                incoming_verified
                or verifier.verify_one(vote.digest(), vote.author, vote.signature)
            ) and not verifier.verify_one(vote.digest(), pk, sig):
                log.warning(
                    "Replacing spoofed vote signature naming %s with the "
                    "authenticated one",
                    pk,
                )
                self.votes[i] = (vote.author, vote.signature)
                self.unverified.discard(pk)
                self._acc = None  # running sum diverged; rebuilt on emit
            return

    def _evict_invalid(
        self, digest: Digest, committee: Committee, verifier: VerifierBackend
    ) -> None:
        ok = verifier.verify_many(
            [digest.to_bytes()] * len(self.votes),
            [pk.to_bytes() for pk, _ in self.votes],
            [sig.to_bytes() for _, sig in self.votes],
        )
        for (pk, _), valid in zip(self.votes, ok):
            if not valid:
                log.warning("Evicting invalid vote signature naming %s", pk)
                if self.owner is not None:
                    self.owner.qc_rejects += 1
                # release the author — the signature was never authenticated,
                # so this may be a spoof and the real vote must still count —
                # but demand eager verification from now on
                self.used.discard(pk)
                self.suspect.add(pk)
        self.votes = [v for v, valid in zip(self.votes, ok) if valid]
        self._acc = None  # running sum diverged; rebuilt on emit
        # every survivor just passed a per-signature check
        self.unverified.clear()
        self.weight = sum(committee.stake(pk) for pk, _ in self.votes)
        if self.votes:
            self.verified = True  # survivors passed per-signature checks


class TCMaker:
    """Accumulates timeouts for one round into a TC.

    Entries are verified by the core before they reach this accumulator
    (core._handle_timeout, mirroring reference core.rs:288), so the TC is
    emitted without re-verification — same shape as the reference's
    TCMaker (aggregator.rs:97-139).
    """

    def __init__(self):
        self.weight = 0
        self.votes: list[tuple[PublicKey, Signature, Round]] = []
        self.used: set[PublicKey] = set()
        self.owner: "Aggregator | None" = None

    def append(self, timeout: Timeout, committee: Committee) -> TC | None:
        author = timeout.author
        if author in self.used:
            raise AuthorityReuse(author)
        stake = committee.stake(author)
        if stake <= 0:
            raise UnknownAuthority(author)
        self.used.add(author)
        self.votes.append((author, timeout.signature, timeout.high_qc.round))
        self.weight += stake
        if self.weight < committee.quorum_threshold():
            return None
        self.weight = 0  # a TC is made at most once
        if _compact_enabled(committee):
            tc = self._compact_tc(timeout.round, committee)
            if tc is not None:
                return tc
        return TC(round=timeout.round, votes=list(self.votes))

    def _compact_tc(self, round_: Round, committee: Committee) -> TC | None:
        """Compact TC: one (agg sig, signer bitmap) per distinct high-QC
        round.  Honest storms collapse to one or two groups, so the wire
        form is ~groups x (48 + bitmap) bytes instead of n x 144.
        Entries here were verified on entry by the core, so the host
        aggregation is over genuine signatures.  Vote-list fallback on
        any mapping/decompress failure, as with the QC path."""
        from ..crypto.bls.curve import G1Point

        ordered = committee.sorted_keys()
        by_hq: dict[Round, list[tuple[PublicKey, Signature]]] = {}
        for pk, sig, hq in self.votes:
            by_hq.setdefault(hq, []).append((pk, sig))
        groups: list[tuple[Round, Signature, bytes]] = []
        for hq in sorted(by_hq):
            members = by_hq[hq]
            try:
                bitmap = make_signer_bitmap(
                    [pk for pk, _ in members], ordered
                )
            except (UnknownAuthority, ValueError):
                return None
            pts = []
            for _, sig in members:
                pt = G1Point.from_bytes(sig.to_bytes(), subgroup_check=False)
                if pt is None:
                    return None
                pts.append(pt)
            agg = G1Point.sum(pts)
            if agg.inf:
                return None
            groups.append((hq, Signature(agg.to_bytes()), bitmap))
        if self.owner is not None:
            self.owner.compact_tcs += 1
        return TC(round=round_, votes=[], groups=groups)


class Aggregator:
    """Per-round certificate accumulators with cleanup and DoS bounds.

    ``self_key`` (the node's own public key) powers the liveness
    guarantee: QC formation only ever matters for the block this node
    itself voted for (voters address votes to the next leader, and the
    leader votes for its own proposal), so the digest cell matching a
    self-authored vote is admitted unconditionally — evicting a
    non-protected cell at the cap — and can never be evicted itself.
    """

    def __init__(
        self,
        committee: Committee,
        verifier: VerifierBackend,
        self_key: PublicKey | None = None,
    ):
        self.committee = committee
        self.verifier = verifier
        self.self_key = self_key
        self.votes_aggregators: dict[Round, dict[Digest, QCMaker]] = {}
        self.timeouts_aggregators: dict[Round, TCMaker] = {}
        # Authors whose valid signature already paid for an extra digest
        # cell this round: a second paid cell from the same author is
        # proof of equivocation and is refused (one Byzantine member must
        # not consume the whole cell budget with validly-signed votes for
        # random digests).
        self.cell_payers: dict[Round, set[PublicKey]] = {}
        # Verified votes that found the cell budget exhausted before this
        # node's own (protected) cell existed — replayed into the
        # protected cell when it is admitted, so a coalition racing its
        # equivocations ahead of the real proposal can't permanently drop
        # honest votes.  Bounded: one vote per author per round.
        self.parked: dict[Round, dict[PublicKey, Vote]] = {}
        # Cumulative accounting (plain ints, always on — telemetry reads
        # them through Core's snapshot section when enabled).
        self.cells_evicted = 0
        self.votes_parked = 0
        # Honest-side Byzantine defense counters: signatures rejected in
        # certificate verification (vote evictions, suspect-path
        # rejects, and invalid timeout certificates counted by the
        # core) and equivocation evidence (a second paid digest cell
        # from one author — conflicting validly-signed votes).
        self.qc_rejects = 0
        self.vote_conflicts = 0
        # Compact-certificate accounting: certificates emitted
        # in the aggregated form, and the wire size of the most recent
        # QC (compact or vote-list — the scaling SUMMARY's qc_bytes
        # column reads this to show the O(1)-vs-O(n) gap).
        self.compact_qcs = 0
        self.compact_tcs = 0
        self.qc_wire_bytes = 0

    def add_vote(
        self,
        vote: Vote,
        current_round: Round | None = None,
        sig_verified: bool = False,
    ) -> QC | None:
        """``sig_verified=True``: the vote's signature was individually
        pre-verified (async burst preverify or a self-signed vote) — the
        cell skips deferred-batch bookkeeping for it and, when every
        entry arrived pre-verified, emits the QC without a quorum batch."""
        if (
            current_round is not None
            and vote.round > current_round + ROUND_LOOKAHEAD
        ):
            raise AggregationBounds(f"vote for far-future round {vote.round}")
        # Authority check before any aggregation state is created, so
        # UnknownAuthority rejections cannot leave empty cells behind.
        # Epoch seam: stake/quorum come from the VOTE round's committee.
        com = self.committee.for_round(vote.round)
        stake = com.stake(vote.author)
        if stake <= 0:
            raise UnknownAuthority(vote.author)
        makers = self.votes_aggregators.setdefault(vote.round, {})
        digest = vote.digest()
        maker = makers.get(digest)
        created = maker is None
        if created:
            maker = self._admit_cell(
                vote, digest, makers, sig_verified=sig_verified
            )
        qc = maker.append(
            vote, com, self.verifier, stake=stake, sig_verified=sig_verified
        )
        if created and maker.protected:
            qc = self._replay_parked(vote.round, digest, maker) or qc
        if qc is not None:
            self.qc_wire_bytes = qc.wire_size()
        return qc

    def _park(self, vote: Vote) -> None:
        """Remember a verified-but-unplaceable vote (one per author/round)."""
        self.parked.setdefault(vote.round, {}).setdefault(vote.author, vote)
        self.votes_parked += 1

    def _replay_parked(
        self, round_: Round, digest: Digest, maker: QCMaker
    ) -> QC | None:
        """Feed parked votes matching the protected cell's digest back in."""
        parked = self.parked.get(round_)
        if not parked:
            return None
        qc = None
        for author in [a for a, v in parked.items() if v.digest() == digest]:
            vote = parked.pop(author)
            try:
                got = maker.append(
                    vote, self.committee.for_round(round_), self.verifier
                )
            except ConsensusError:
                continue
            qc = got or qc
        return qc

    def _admit_cell(
        self,
        vote: Vote,
        digest: Digest,
        makers: dict[Digest, QCMaker],
        sig_verified: bool = False,
    ) -> QCMaker:
        """Create a new digest cell, charging for it when it isn't the first.

        The honest case is exactly one digest per round, so every
        ADDITIONAL cell must be paid for with a valid signature — spoofed
        votes carrying random digests cost the attacker a rejected verify
        instead of a slot in the cell budget (per-round vote-suppression
        DoS otherwise: 8 garbage digests would exhaust MAX_DIGEST_CELLS
        and honest votes for the real block would bounce).  Each author
        may pay for at most one cell per round (a second one is proof of
        equivocation), and a self-authored vote's cell is admitted
        unconditionally and marked protected (see class docstring).
        """
        own = self.self_key is not None and vote.author == self.self_key
        verified = False
        if makers and not own:
            if not sig_verified and not self.verifier.verify_one(
                digest, vote.author, vote.signature
            ):
                raise InvalidSignature(f"bad signature on vote {vote!r}")
            payers = self.cell_payers.setdefault(vote.round, set())
            if vote.author in payers:
                # One paid cell per author per round.  The vote itself is
                # genuine though — votes may legitimately join an
                # EXISTING cell regardless of the author's history — so
                # park it for replay in case its digest gets the
                # protected cell later.  Two validly-signed conflicting
                # votes from one author = equivocation evidence.
                self.vote_conflicts += 1
                self._park(vote)
                raise AggregationBounds(
                    f"second digest cell paid by {vote.author} in round "
                    f"{vote.round} (vote parked)"
                )
            if any(
                vote.author in m.used
                for d, m in makers.items()
                if d != digest
            ):
                # The payment signature verified AND another cell already
                # counts this author for a different digest this round:
                # equivocation evidence (a double-voter's second digest).
                # Accounting only — the paid cell is still admitted, the
                # protocol math is untouched.
                self.vote_conflicts += 1
                log.info(
                    "second digest cell paid by %s in round %d "
                    "(conflicting double-vote evidence)",
                    vote.author,
                    vote.round,
                )
            verified = True
        if len(makers) >= MAX_DIGEST_CELLS and not self._evict_for(
            vote, makers, own
        ):
            # Verified vote, but the budget is full of verified cells and
            # this node's own (protected) cell doesn't exist yet: PARK it
            # for replay when the protected cell lands — a coalition
            # racing equivocations ahead of the real proposal must not
            # permanently drop honest votes.
            self._park(vote)
            raise AggregationBounds(
                f"vote digest cell #{len(makers)} in round {vote.round} "
                f"(vote parked)"
            )
        if verified:
            # charge the payer only once the cell actually exists
            self.cell_payers.setdefault(vote.round, set()).add(vote.author)
        maker = makers[digest] = QCMaker()
        maker.owner = self
        maker.verified = verified or own
        maker.protected = own
        return maker

    def _evict_for(
        self, vote: Vote, makers: dict[Digest, QCMaker], own: bool
    ) -> bool:
        """Make room at the cell cap; False if no cell may be evicted.

        A cell is only evictable if NONE of its stored signatures verify —
        an unverified cell may be the honest block's cell whose batch check
        is simply deferred until quorum, and evicting it would destroy
        accumulated honest votes (per-round liveness loss a Byzantine
        insider could trigger at will).  Checking promotes genuinely
        honest cells to verified, so each cell pays the check at most
        once.  For a SELF-authored vote the cell must be admitted even if
        every other cell is verified: all other cells are by definition
        not this node's block, so evict any non-protected one.
        """
        victim = None
        for d, m in makers.items():
            if m.protected:
                continue
            if not m.verified and not m.check_any_valid(d, self.verifier):
                victim = d
                break
        if victim is None and own:
            victim = next(
                (d for d, m in makers.items() if not m.protected), None
            )
        if victim is None:
            return False
        log.warning("Evicting digest cell to admit %s",
                    "own-vote cell" if own else "a verified one")
        del makers[victim]
        self.cells_evicted += 1
        return True

    def add_timeout(
        self, timeout: Timeout, current_round: Round | None = None
    ) -> TC | None:
        if (
            current_round is not None
            and timeout.round > current_round + ROUND_LOOKAHEAD
        ):
            raise AggregationBounds(
                f"timeout for far-future round {timeout.round}"
            )
        maker = self.timeouts_aggregators.get(timeout.round)
        if maker is None:
            maker = self.timeouts_aggregators[timeout.round] = TCMaker()
            maker.owner = self
        return maker.append(
            timeout, self.committee.for_round(timeout.round)
        )

    def timeout_weight(self, round_: Round) -> int:
        """Stake currently accumulated toward a TC for ``round_`` (0 once
        the TC was emitted, or if no timeout arrived).  The core's
        round-sync rule reads this to join a round the rest of the
        committee is provably timing out."""
        maker = self.timeouts_aggregators.get(round_)
        return maker.weight if maker is not None else 0

    def cleanup(self, round_: Round) -> None:
        self.votes_aggregators = {
            r: v for r, v in self.votes_aggregators.items() if r >= round_
        }
        self.timeouts_aggregators = {
            r: v for r, v in self.timeouts_aggregators.items() if r >= round_
        }
        self.cell_payers = {
            r: v for r, v in self.cell_payers.items() if r >= round_
        }
        self.parked = {r: v for r, v in self.parked.items() if r >= round_}

    def stats(self) -> dict:
        """Snapshot of aggregation pressure (telemetry pull section)."""
        return {
            "vote_rounds": len(self.votes_aggregators),
            "vote_cells": sum(
                len(m) for m in self.votes_aggregators.values()
            ),
            "pending_votes": sum(
                len(maker.votes)
                for makers in self.votes_aggregators.values()
                for maker in makers.values()
            ),
            "timeout_rounds": len(self.timeouts_aggregators),
            "parked_votes": sum(len(p) for p in self.parked.values()),
            "votes_parked_total": self.votes_parked,
            "cells_evicted_total": self.cells_evicted,
            "qc_rejects_total": self.qc_rejects,
            "vote_conflicts_total": self.vote_conflicts,
            "compact_qcs_total": self.compact_qcs,
            "compact_tcs_total": self.compact_tcs,
            "qc_wire_bytes": self.qc_wire_bytes,
        }
