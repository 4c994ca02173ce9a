"""Proposer: payload buffering, block creation, quorum-ACK back-pressure.

Parity target: reference ``Proposer`` (consensus/src/proposer.rs:17-186),
the fork's producer payload path: producer digests arriving from external
parties are buffered; on ``Make(round, qc, tc)`` one buffered digest
becomes the payload of a signed block that is reliable-broadcast to the
committee, looped back to the core, and ACK-awaited until 2f+1 stake —
the leader back-pressure control system (proposer.rs:115-131).

Redesigned buffering (round-2 fix for the burst-and-stall dynamics the
reference's scheme produces):

- The reference buffers payloads in per-round buckets keyed by the
  store's ``latest_round + 1`` *at arrival time* (proposer.rs:164-173) and
  drops whole buckets as rounds are processed.  Under load, rounds race
  ahead of payload arrival, each round discards an entire bucket after
  consuming one digest, the buffer empties, and the next leader
  "proposes nothing" (proposer.rs:74-78) — wedging the round for the
  full 5 s view-change timeout.  Measured effect in round 1: commits in
  ~5 ms bursts separated by 5 s stalls, 87 ms mean consensus latency.
  The bucket scheme also costs one store round-trip per arriving payload
  (the ``latest_round`` read), 50k queue hops/s at the target rate.
- Here: one FIFO (ordered map) with digest dedup and O(1) removal of
  committed payloads (core cleanup).  ``Make`` pops the oldest
  payload; if the buffer is empty the make is DEFERRED and fires the
  moment the next payload arrives (superseded by newer makes, dropped by
  cleanups for later rounds).  No store reads at all on the payload
  path; consensus paces itself to the payload arrival rate instead of
  spinning empty rounds into view changes.

A copy of ``hotstuff_tpu.consensus.proposer`` with its telemetry seams
(payload wait, deferred makes, the buffer gauges and the ``propose`` /
``payload.first`` journal records) and its adversary seams (the forged
reconfiguration and the equivocation in ``_make_block``).
"""

from __future__ import annotations

import asyncio
import logging
import os
from collections import OrderedDict

from ..crypto import Digest, PublicKey, SignatureService
from ..network import ReliableSender
from ..utils.clock import default_clock
from .config import Committee
from .core import ProposerMessage
from .messages import MAX_BLOCK_PAYLOADS, QC, TC, Block, Round
from .reconfig import ReconfigOp, newest_epoch
from .wire import encode_propose

log = logging.getLogger(__name__)

# Payload buffer bound: newest arrivals are dropped when full (the
# reference's bounded channel has the same drop-newest semantics).
MAX_PENDING = 100_000
# Dedup window: digests remembered (buffered or already proposed).
SEEN_CAP = 200_000
# In-flight proposal bound (rounds whose fate is undecided).  When commit
# signals stall past this many proposals, the OLDEST one's payloads are
# conservatively re-buffered (treated as orphaned).  The bound keeps
# inflight memory finite through arbitrarily long partitions; the
# eager re-buffer can duplicate a payload only if its commit signal is
# still unseen AFTER this many newer proposals resolved — and the
# committed_seen LRU (SEEN_CAP deep) still filters those on resolution.
MAX_INFLIGHT = 1_024


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        return default


class Proposer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        signature_service: SignatureService,
        rx_producer: asyncio.Queue,
        rx_message: asyncio.Queue,
        tx_loopback: asyncio.Queue,
        network: ReliableSender | None = None,
        admission=None,
        telemetry=None,
        adversary=None,
    ):
        self.name = name
        # Ingest admission controller (ingest/admission.py): fed the
        # committed-payload counts from Cleanup messages — the drain
        # signal its credit window is derived from.  None = no ingest
        # plane (component tests construct the proposer bare).
        self.admission = admission
        # Buffer bound, overridable per run (HOTSTUFF_MAX_PENDING) so
        # load tests can shrink the buffer and reach the admission
        # watermark without queuing 100k payloads first.
        self.max_pending = _env_int("HOTSTUFF_MAX_PENDING", MAX_PENDING)
        # Payloads silently dropped at the full buffer — with admission
        # control active this staying at ZERO under overload is the
        # acceptance signal (sheds happen at the ingest door instead).
        self.drop_newest = 0
        # Byzantine adversary plane (faults/adversary.py): None on
        # honest nodes; the equivocation seam in _make_block consults it
        self.adversary = adversary
        self.committee = committee
        self.signature_service = signature_service
        self.rx_producer = rx_producer
        self.rx_message = rx_message
        self.tx_loopback = tx_loopback
        # FIFO with O(1) membership/removal: committed payloads are
        # pruned by digest on every commit (Core._commit cleanup).
        self.pending: OrderedDict[Digest, None] = OrderedDict()
        self.seen: OrderedDict[Digest, None] = OrderedDict()
        # Our proposals whose fate is undecided: round -> payloads.
        # With single-homed clients (node/client.py round-robin) only WE
        # hold these digests — if the block orphans (a view change built
        # the chain past it), they must return to the buffer or they are
        # lost for good.  Resolved by commit signals (cleanup messages
        # carrying committed_round).
        self.inflight: dict[Round, tuple] = {}
        # Recently COMMITTED digests (bounded LRU): orphan recovery must
        # not re-buffer a payload that committed in an EARLIER walk via
        # another node's block (multi-homed producers) — the per-walk
        # payload set alone cannot show that.
        self.committed_seen: OrderedDict[Digest, None] = OrderedDict()
        self.deferred: ProposerMessage | None = None
        # A core-validated reconfiguration op awaiting our next leader
        # slot (docs/RECONFIG.md); dropped once its epoch is scheduled
        # (another leader's block carried it first).
        self.pending_reconfig: ReconfigOp | None = None
        # Highest round a block was actually created for: re-issued Makes
        # for the same round are dropped, so (a) the core may safely
        # re-send a Make when allow_empty conditions change, and (b) this
        # node can never produce two blocks for one round (leader
        # equivocation guard).
        self.last_made_round: Round = 0
        self.network = network if network is not None else ReliableSender()
        self._task: asyncio.Task | None = None
        self.log = logging.getLogger(f"{__name__}.{str(name)[:8]}")
        # Telemetry (optional): payload buffer dwell time + buffer
        # occupancy.  With telemetry on, `pending` values hold the
        # arrival timestamp (read at make time); off, they stay None —
        # no per-payload float allocation.
        self.telemetry = telemetry
        self._payload_wait = None
        self._deferred_makes = None
        self._journal = telemetry.journal if telemetry is not None else None
        if telemetry is not None:
            self._payload_wait = telemetry.trace.payload_wait
            self._deferred_makes = telemetry.counter(
                "proposer_deferred_makes",
                "Makes deferred for lack of buffered payloads",
            )
            telemetry.gauge(
                "proposer_pending_payloads",
                "Payload digests buffered for proposal",
                fn=lambda: len(self.pending),
            )
            telemetry.gauge(
                "proposer_inflight_proposals",
                "Own proposals whose commit/orphan fate is undecided",
                fn=lambda: len(self.inflight),
            )
            telemetry.gauge(
                "proposer_drop_newest",
                "Payloads silently dropped at the full buffer "
                "(admission control should keep this at zero)",
                fn=lambda: self.drop_newest,
            )

    def _buffer_payload(self, digest: Digest) -> None:
        if digest in self.seen:
            return  # duplicate of a buffered or recently proposed payload
        if len(self.pending) >= self.max_pending:
            self.drop_newest += 1
            return  # drop newest under overload (bounded like reference)
        self.seen[digest] = None
        while len(self.seen) > SEEN_CAP:
            self.seen.popitem(last=False)
        if self._payload_wait is not None:
            self.pending[digest] = default_clock().monotonic()
        else:
            self.pending[digest] = None

    async def _make_block(
        self, round_: Round, qc: QC, tc: TC | None, allow_empty: bool = False
    ) -> None:
        if round_ <= self.last_made_round:
            return  # already proposed for this round (equivocation guard)
        op = self.pending_reconfig
        if op is not None and newest_epoch(self.committee) >= op.new_committee.epoch:
            # the epoch change is already scheduled (committed via
            # another leader's block, or a competing op won): drop ours
            self.pending_reconfig = None
            op = None
        snipes = (
            self.adversary.wants("reconfig", round_)
            if op is None and self.adversary is not None else False
        )
        if snipes:
            # reconfig policy (forge half): attach a forged epoch change
            # — well-formed wire, hostile committee / bad sponsor — that
            # MUST die in every honest voter's Block.verify.  The
            # reconfig-sniper mounts the same forgery, but only inside
            # the epoch-activation margin (wants returns its token).
            op = self.adversary.forged_reconfig(self.committee, round_)
            if op is not None:
                self.adversary.mark_adaptive(snipes, round_, self.log)
                self.adversary.count("byz_forged_reconfigs")
                self.adversary.record("reconfig-forge", round_)
                self.log.info("byz reconfig-forge round %d", round_)
        if not self.pending and not allow_empty and op is None:
            # Defer: fire the moment the next payload arrives instead of
            # wedging the round until the view-change timer (see module
            # docstring).  A newer Make supersedes this one.
            self.deferred = ProposerMessage.make(round_, qc, tc)
            if self._deferred_makes is not None:
                self._deferred_makes.inc()
            self.log.info("Round: %d, no payloads yet - proposal deferred", round_)
            return
        # allow_empty: the core signalled that uncommitted payload blocks
        # are in flight — an empty block advances the 2-chain so they
        # commit now rather than on the producer's next burst.
        self.last_made_round = round_
        take = min(len(self.pending), MAX_BLOCK_PAYLOADS)
        if self._payload_wait is not None and take:
            now = default_clock().monotonic()
            popped = [self.pending.popitem(last=False) for _ in range(take)]
            for _, arrived in popped:
                if arrived:  # re-buffered orphans may carry None
                    self._payload_wait.observe(now - arrived)
            payloads = tuple(d for d, _ in popped)
        else:
            payloads = tuple(
                self.pending.popitem(last=False)[0] for _ in range(take)
            )
        if payloads:
            self.inflight[round_] = payloads
            while len(self.inflight) > MAX_INFLIGHT:
                self._requeue_oldest_inflight()

        if op is not None and op is self.pending_reconfig:
            self.pending_reconfig = None  # it rides in this block
        block = Block(
            qc=qc, tc=tc, author=self.name, round=round_, payloads=payloads,
            reconfig=op,
        )
        block.signature = await self.signature_service.request_signature(
            block.digest()
        )
        if op is not None:
            self.log.info(
                "Proposing reconfig in block %d: epoch %d (margin %d)",
                round_, op.new_committee.epoch, op.margin,
            )
        # NOTE: this log entry is used to compute performance — the harness
        # maps each payload -> block digest from it (benchmark/logs.py
        # contract).
        self.log.info(
            "Created block %d (payloads %s) -> %s",
            block.round,
            ",".join(str(p) for p in block.payloads),
            block.digest(),
        )
        if self._journal is not None:
            # the propose record is the timeline anchor traces.py hangs
            # every recv.propose edge off — journaled just before the
            # broadcast leaves this node
            self._journal.record("propose", block.round, block.digest())
            if block.payloads:
                # producer-channel edge: pairs with the receiver's
                # recv.producer record so traces can measure payload
                # wait (client frame -> proposed) and tell payload
                # starvation from a consensus stall
                self._journal.record(
                    "payload.first", block.round, block.payloads[0]
                )
        # Broadcast to the union of epochs (committee.broadcast_addresses
        # is the union on a CommitteeSchedule — members of the adjacent
        # epoch need boundary blocks too); ACK stake counts only under
        # the BLOCK round's committee.
        com = self.committee.for_round(round_)
        names_addresses = self.committee.broadcast_addresses(self.name)
        message = encode_propose(block)
        # ReliableSender.broadcast enqueues per address in list order,
        # so handles pair with names exactly as a per-peer loop would.
        handles = list(
            zip(
                (name for name, _ in names_addresses),
                await self.network.broadcast(
                    [address for _, address in names_addresses], message
                ),
            )
        )

        await self.tx_loopback.put(block)

        ambushes = (
            self.adversary.wants("equivocate", block.round)
            if self.adversary is not None else False
        )
        if ambushes:
            # schedule-driven equivocation, or the ambush-leader trigger
            # (faults/adaptive.py): equivocate exactly when we lead a
            # round seated by a fresh TC
            self.adversary.mark_adaptive(
                ambushes, block.round, self.log, block.digest()
            )
            await self._byz_equivocate(block, names_addresses)

        # Control system: wait for 2f+1 total stake (ours included) to ACK
        # the block before making the next one.
        total_stake = com.stake(self.name)
        threshold = com.quorum_threshold()
        # tasks is an ordered LIST (committee order), not a set:
        # cancelling a waiter propagates into its ACK handle, which the
        # reliable sender reads as "give up retransmitting this frame" —
        # id()-ordered set iteration would make the surviving retransmit
        # set depend on heap layout.
        tasks = [
            asyncio.ensure_future(self._ack_stake(handle, com.stake(name)))
            for name, handle in handles
        ]
        pending = set(tasks)
        try:
            while pending and total_stake < threshold:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for t in done:
                    # lint: allow(no-blocking-in-async) -- t is in the
                    # done set asyncio.wait just returned: result() is
                    # an immediate read, never a block
                    total_stake += t.result()
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()

    async def _byz_equivocate(self, block: Block, names_addresses) -> None:
        """equivocate policy (adversary plane): sign the deterministic
        shadow twin of the block just proposed — same round, same QC,
        conflicting payloads — and ship it to a deterministic peer
        subset (fellow colluders when colluding, else the first half of
        the peer set).  Honest receivers vote at most once per round,
        so the main branch keeps committing; the checker attributes the
        equivocations to this authority."""
        adversary = self.adversary
        shadow = adversary.shadow_block(block)
        shadow.signature = await self.signature_service.request_signature(
            shadow.digest()
        )
        targets = adversary.equivocation_targets(names_addresses)
        message = encode_propose(shadow)
        for _, address in targets:
            await self.network.send(address, message)
        adversary.count("byz_equivocations")
        adversary.record(
            "equivocate", block.round, shadow.digest(), f"{len(targets)}p"
        )
        self.log.info(
            "byz equivocate round %d -> %s | %s (%d peers)",
            block.round, block.digest(), shadow.digest(), len(targets),
        )

    def _requeue_orphans(
        self, round_: Round, payloads: tuple, committed=frozenset(), note: str = ""
    ) -> None:
        """Re-buffer a resolved/abandoned proposal's payloads at the
        FRONT of the queue (oldest-first order preserved by callers
        iterating newest-round-first), skipping anything known
        committed or already buffered."""
        orphaned = [
            d for d in payloads
            if d not in committed
            and d not in self.committed_seen
            and d not in self.pending
        ]
        if orphaned:
            self.log.info(
                "Re-buffering %d payloads from %s block %d",
                len(orphaned),
                note or "orphaned",
                round_,
            )
        for digest in reversed(orphaned):
            self.pending[digest] = None
            self.pending.move_to_end(digest, last=False)

    def _requeue_oldest_inflight(self) -> None:
        """Inflight overflow (MAX_INFLIGHT): re-buffer the oldest
        undecided proposal's payloads as if orphaned.  Single-homed
        payloads survive the stall; the committed_seen/pending filters
        keep the duplicate window bounded (see MAX_INFLIGHT note)."""
        round_ = min(self.inflight)
        self._requeue_orphans(
            round_, self.inflight.pop(round_), note="unresolved"
        )

    def _resolve_inflight(self, message: ProposerMessage) -> None:
        """Orphan recovery: once the chain is committed through round R,
        every proposal of ours at round <= R either committed (its
        payloads are in the accumulated committed sets) or was orphaned
        by a view change — re-buffer the orphans at the FRONT of the
        queue (oldest first) so single-homed payloads are never lost."""
        if not message.committed_round:
            return
        for round_ in sorted(
            (r for r in self.inflight if r <= message.committed_round),
            reverse=True,  # re-insert newest first so oldest ends up in front
        ):
            self._requeue_orphans(
                round_, self.inflight.pop(round_), committed=message.payloads
            )

    @staticmethod
    async def _ack_stake(handle: asyncio.Future, stake: int) -> int:
        # handle resolves with the peer's ACK; deliver that peer's stake
        await handle
        return stake

    async def run(self) -> None:
        prod_task = asyncio.ensure_future(self.rx_producer.get())
        msg_task = asyncio.ensure_future(self.rx_message.get())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {prod_task, msg_task}, return_when=asyncio.FIRST_COMPLETED
                )
                if prod_task in done:
                    # lint: allow(no-blocking-in-async) -- guarded by
                    # membership in asyncio.wait's done set
                    digest = prod_task.result()
                    self._buffer_payload(digest)
                    # drain any burst backlog without extra loop passes
                    while not self.rx_producer.empty():
                        self._buffer_payload(self.rx_producer.get_nowait())
                    prod_task = asyncio.ensure_future(self.rx_producer.get())
                    if self.deferred is not None and self.pending:
                        make = self.deferred
                        self.deferred = None
                        await self._make_block(make.round, make.qc, make.tc)
                if msg_task in done:
                    # lint: allow(no-blocking-in-async) -- guarded by
                    # membership in asyncio.wait's done set
                    message: ProposerMessage = msg_task.result()
                    if message.kind == ProposerMessage.MAKE:
                        self.deferred = None  # superseded
                        await self._make_block(
                            message.round,
                            message.qc,
                            message.tc,
                            message.allow_empty,
                        )
                    elif message.kind == ProposerMessage.RECONFIG:
                        self.pending_reconfig = message.op
                        self.log.info(
                            "Reconfig op buffered for the next leader "
                            "slot: epoch %d",
                            message.op.new_committee.epoch,
                        )
                        if self.deferred is not None:
                            # an empty-buffer make was parked waiting
                            # for payloads — the op is reason enough to
                            # propose now
                            make = self.deferred
                            self.deferred = None
                            await self._make_block(make.round, make.qc, make.tc)
                    else:
                        # Cleanup(rounds): the chain advanced through these
                        # rounds — a deferred make for an older round is
                        # stale (the core will issue a fresh Make when this
                        # node next leads).
                        if (
                            self.deferred is not None
                            and message.rounds
                            and self.deferred.round <= max(message.rounds)
                        ):
                            self.deferred = None
                        # Cleanup(payloads): these digests committed (in
                        # anyone's block) — proposing them again would
                        # waste block capacity on duplicates.  They stay
                        # in `seen` so a re-delivered copy is not
                        # re-buffered either.
                        if self.admission is not None and message.payloads:
                            # drain signal for the ingest credit window
                            self.admission.on_committed(len(message.payloads))
                        for digest in message.payloads:
                            self.pending.pop(digest, None)
                            self.committed_seen[digest] = None
                        while len(self.committed_seen) > SEEN_CAP:
                            self.committed_seen.popitem(last=False)
                        self._resolve_inflight(message)
                    msg_task = asyncio.ensure_future(self.rx_message.get())
        finally:
            prod_task.cancel()
            msg_task.cancel()

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.get_running_loop().create_task(
            self.run(), name="proposer"
        )
        return self._task

    def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.network.close()
