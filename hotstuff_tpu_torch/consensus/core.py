"""The consensus core: the 2-chain HotStuff state machine.

Parity target: reference ``Core`` (consensus/src/core.rs:31-495) — one
actor selecting over {network messages, loopback blocks, round timer},
holding {round, last_voted_round, last_committed_round, high_qc}, with:

- the Jolteon voting rule (safety_rule_1: round > last_voted_round;
  safety_rule_2: extends the previous round's QC, or extends a TC for the
  previous round while qc.round >= max(tc.high_qc_rounds)) — core.rs:160-177;
- the 2-chain commit rule: committing b0 when b0 <- b1 <- block and
  b0.round + 1 == b1.round — core.rs:384-386;
- view change via Timeout/TC aggregation — core.rs:220-318;
- crash-recovery persistence of ConsensusState after every state-changing
  iteration (the fork's addition, core.rs:52-58, 484-492);
- the per-round payload index + latest-round bookkeeping the fork's
  proposer feeds on (core.rs:112-148).

Verification is accumulate-then-dispatch (BASELINE.json): votes/timeouts
enter the aggregator unverified and each certificate's signature set is
batch-verified once at quorum, on the pluggable VerifierBackend (CPU or
the CUDA kernel behind ``make_verifier("cuda")``).

A copy of ``hotstuff_tpu.consensus.core`` with its telemetry seams (the
trace ring's marks, the flight-recorder journal's records and the core's
gauges, each behind one ``is not None`` test) and its adversary seams
(faults/adversary.py: withhold, vote-delay, double-vote and forge-qc in
the vote path, the collude policy's shadow commits and the reconfig
policy's shadow epochs), each behind one ``is not None`` test.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..crypto import Digest, PublicKey, SignatureService
from ..crypto.async_service import AsyncVerifyService
from ..crypto.service import VerifierBackend
from ..network import SimpleSender
from ..store import Store
from ..utils.clock import default_clock
from ..utils.codec import Decoder, Encoder
from .aggregator import ROUND_LOOKAHEAD, Aggregator
from .config import Committee, InvalidCommittee
from .errors import ConsensusError, SerializationError, WrongLeader
from .leader import LeaderElector
from .messages import MAX_BLOCK_PAYLOADS, QC, TC, Block, Round, Timeout, Vote
from .reconfig import ReconfigOp, validate_reconfig
from .synchronizer import Synchronizer
from .timer import Timer
from .wire import (
    MAX_SCHEDULE_LINKS,
    TAG_PROPOSE,
    TAG_RECONFIG,
    TAG_TC,
    TAG_TIMEOUT,
    TAG_VOTE,
    decode_schedule_links,
    encode_schedule_links,
    encode_tc,
    encode_timeout,
    encode_vote,
)

log = logging.getLogger(__name__)

CONSENSUS_STATE_KEY = b"consensus_state"
LATEST_ROUND_KEY = b"latest_round"
#: certified schedule links: one (committed reconfig block, certifying
#: QC) pair per applied epoch change — replayed into the schedule at
#: boot and served to joiners via the state-sync manifest
SCHEDULE_LINKS_KEY = b"schedule_links"

# Core event-queue kinds.  The reference selects over three channels
# (core.rs:466-477); this build merges them into ONE queue of tagged
# events: a ready item then costs a plain ``await queue.get()`` (no
# waiter future, no Task) instead of an ``asyncio.wait`` over three
# branch tasks with per-iteration callback add/remove — measured ~1 ms
# of loop machinery per committed block at 4 nodes.  Arrival order
# across kinds is preserved (one FIFO).
EV_MSG = 0  # network message: (tag, payload) from the receiver handler
EV_LOOP = 1  # loopback Block from the proposer/synchronizer
EV_TIMER = 2  # round-timer expiry (from the core's own pump task)


class TaggedEventQueue:
    """Facade presenting one kind-tagged view of the core's merged
    event queue — producers keep the plain ``put`` interface the
    reference's channel topology gives them."""

    __slots__ = ("_inner", "_kind")

    def __init__(self, inner: asyncio.Queue, kind: int):
        self._inner = inner
        self._kind = kind

    async def put(self, item) -> None:
        await self._inner.put((self._kind, item))

    def put_nowait(self, item) -> None:
        self._inner.put_nowait((self._kind, item))

    def qsize(self) -> int:
        return self._inner.qsize()


class LoopbackChannel:
    """The proposer/synchronizer -> core loopback: its OWN bounded
    queue, drained at the top of every core iteration, plus a
    non-blocking wake token into the merged queue for the idle case.

    Why not a tagged slot in the merged FIFO: a message flood would put
    the node's own proposed block (and sync-resumed orphans) behind the
    whole attacker backlog, and the producer would block awaiting a
    slot on a queue shared with hostile traffic — the reference's
    select loop services the loopback branch every wake-up regardless
    of message pressure, and this preserves that bound (<= one batch)."""

    __slots__ = ("_q", "_events")

    def __init__(self, events: asyncio.Queue, capacity: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=capacity)
        self._events = events

    async def put(self, block) -> None:
        await self._q.put(block)
        self._wake()

    def put_nowait(self, block) -> None:
        self._q.put_nowait(block)
        self._wake()

    def _wake(self) -> None:
        # wake an idle core; droppable when the merged queue is full —
        # an actively-iterating core drains us every iteration anyway
        try:
            self._events.put_nowait((EV_LOOP, None))
        except asyncio.QueueFull:
            pass

    def get_nowait(self):
        return self._q.get_nowait()

    def qsize(self) -> int:
        return self._q.qsize()


def make_event_channels(
    capacity: int,
) -> tuple[asyncio.Queue, TaggedEventQueue, LoopbackChannel]:
    """(rx_events, tx_consensus, tx_loopback): the merged core queue,
    the network-message facade, and the priority loopback channel."""
    rx_events: asyncio.Queue = asyncio.Queue(maxsize=capacity)
    return (
        rx_events,
        TaggedEventQueue(rx_events, EV_MSG),
        LoopbackChannel(rx_events, capacity),
    )


def round_key(round_: Round) -> bytes:
    """Store key of the per-round payload-digest index (big-endian, like
    the reference's ``to_be_bytes`` keys, core.rs:117-146)."""
    return round_.to_bytes(8, "big")


def encode_payload_index(digests: list) -> bytes:
    enc = Encoder().u32(len(digests))
    for d in digests:
        enc.raw(d.to_bytes())
    return enc.finish()


def decode_payload_index(data: bytes) -> list:
    from ..crypto import Digest

    dec = Decoder(data)
    n = dec.u32()
    out = [Digest(dec.raw(Digest.SIZE)) for _ in range(n)]
    dec.finish()
    return out


class ConsensusState:
    """The persisted crash-recovery snapshot (core.rs:52-58)."""

    __slots__ = ("round", "last_voted_round", "last_committed_round", "high_qc")

    def __init__(
        self,
        round_: Round = 1,
        last_voted_round: Round = 0,
        last_committed_round: Round = 0,
        high_qc: QC | None = None,
    ):
        self.round = round_
        self.last_voted_round = last_voted_round
        self.last_committed_round = last_committed_round
        self.high_qc = high_qc if high_qc is not None else QC.genesis()

    def serialize(self) -> bytes:
        enc = (
            Encoder()
            .u64(self.round)
            .u64(self.last_voted_round)
            .u64(self.last_committed_round)
        )
        self.high_qc.encode(enc)
        return enc.finish()

    @classmethod
    def deserialize(cls, data: bytes) -> "ConsensusState":
        dec = Decoder(data)
        state = cls(dec.u64(), dec.u64(), dec.u64(), QC.decode(dec))
        dec.finish()
        return state


class ProposerMessage:
    """Core -> Proposer commands (reference proposer.rs:17-21).

    ``allow_empty`` (this build's addition): the core sets it when the
    commit pipeline still holds uncommitted payload-carrying blocks — a
    leader with an empty payload buffer may then propose an EMPTY block
    so the 2-chain rule can commit the in-flight payloads within two
    fast rounds, instead of parking their commit until the producer's
    next burst arrives (bursty clients otherwise couple commit latency
    to their burst interval)."""

    __slots__ = (
        "kind", "round", "qc", "tc", "rounds", "allow_empty", "payloads",
        "committed_round", "op",
    )

    MAKE = "make"
    CLEANUP = "cleanup"
    RECONFIG = "reconfig"

    def __init__(
        self,
        kind,
        round_=0,
        qc=None,
        tc=None,
        rounds=(),
        allow_empty=False,
        payloads=frozenset(),
        committed_round=0,
        op=None,
    ):
        self.kind = kind
        self.round = round_
        self.qc = qc
        self.tc = tc
        self.rounds = list(rounds)
        self.allow_empty = allow_empty
        # a validated ReconfigOp awaiting our next leader slot (RECONFIG)
        self.op = op
        # committed payload digests the proposer must drop from its
        # buffer, and the round the chain is committed through — any of
        # our in-flight proposals at <= committed_round whose payloads
        # are not in the set are orphaned for good and get re-buffered
        # (see Core._commit / Proposer orphan recovery)
        self.payloads = payloads
        self.committed_round = committed_round

    @classmethod
    def make(
        cls, round_: Round, qc: QC, tc: TC | None, allow_empty: bool = False
    ) -> "ProposerMessage":
        return cls(cls.MAKE, round_=round_, qc=qc, tc=tc, allow_empty=allow_empty)

    @classmethod
    def cleanup(
        cls, rounds: list[Round], payloads=frozenset(), committed_round=0
    ) -> "ProposerMessage":
        return cls(
            cls.CLEANUP,
            rounds=rounds,
            payloads=payloads,
            committed_round=committed_round,
        )

    @classmethod
    def reconfig(cls, op: ReconfigOp) -> "ProposerMessage":
        return cls(cls.RECONFIG, op=op)


class Core:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        signature_service: SignatureService,
        verifier: VerifierBackend,
        store: Store,
        leader_elector: LeaderElector,
        synchronizer: Synchronizer,
        timeout_delay_ms: int,
        rx_events: asyncio.Queue,
        rx_loopback: "LoopbackChannel",
        tx_proposer: asyncio.Queue,
        tx_commit: asyncio.Queue,
        network: SimpleSender | None = None,
        timeout_backoff: float = 2.0,
        timeout_cap_ms: int = 60_000,
        payload_bodies=None,
        telemetry=None,
        state_machine=None,
        adversary=None,
    ):
        self.name = name
        self.committee = committee
        self.signature_service = signature_service
        self.verifier = verifier
        self.store = store
        self.leader_elector = leader_elector
        self.synchronizer = synchronizer
        self.rx_events = rx_events
        self.rx_loopback = rx_loopback
        self._timer_ack = asyncio.Event()
        self.tx_proposer = tx_proposer
        self.tx_commit = tx_commit
        # consensus.PayloadBodies: committed payload bodies leave the
        # receiver's eviction budget (they became history)
        self.payload_bodies = payload_bodies
        self.round: Round = 1
        self.last_voted_round: Round = 0
        self.last_committed_round: Round = 0
        # Highest payload-carrying block round seen (in-memory latency
        # hint for allow_empty proposals; resets to 0 on crash recovery,
        # which merely restores the reference's defer-until-payload
        # behavior until the next payload block flows through).
        self.last_payload_round: Round = 0
        self.high_qc: QC = QC.genesis()
        self.timer = Timer(timeout_delay_ms)
        # Exponential view-change backoff (config.Parameters docstring):
        # consecutive local timeouts grow the round timer geometrically;
        # observing a NEWER QC (real progress) snaps it back to base.
        self._timeout_base_ms = timeout_delay_ms
        self._timeout_backoff = timeout_backoff
        self._timeout_cap_ms = timeout_cap_ms
        self._timeout_exponent = 0
        # TC advances since the last QC advance (see _advance_round)
        self._consecutive_tcs = 0
        # The round most recently advanced past via a TC — the adaptive
        # adversary's ambush-leader trigger reads this through the
        # state view (faults/adaptive.py); None until the first TC.
        self._last_tc_round: Round | None = None
        # local round timeouts fired (each one broadcast a Timeout): the
        # committee driver reports their sum as view-change timeouts
        self.local_timeouts = 0
        # Did the current round show any sign of life (a proposal for
        # it)?  An IDLE timeout — no proposal seen and no uncommitted
        # payload block in flight — is the committee waiting for
        # payloads (the proposer defers empty makes), NOT a liveness
        # failure: growing the view-change backoff there compounds into
        # multi-second timers before the first transaction arrives
        # (measured: a WAN f=3 committee wedged to zero commits because
        # boot-time idle rounds pushed the timer to 16 s+).
        self._saw_proposal = False
        # Reconfiguration (docs/RECONFIG.md): the epoch the node is
        # operating under.  None until run() sets it AFTER crash
        # recovery and the state-sync bootstrap — initializing earlier
        # would make a restarted node re-log old epoch activations at
        # wrong rounds, breaking the epoch-agreement invariant.
        self._active_epoch: int | None = None
        # Retirement: once an activated epoch excludes this node, it
        # keeps serving (Helper / state-sync / boundary certificates)
        # for a grace window of rounds, then flips ``retired`` — the
        # run loop drains events without processing and node/main.py
        # shuts the process down cleanly.
        self._retire_after: Round | None = None
        self._grace_rounds = int(
            os.environ.get("HOTSTUFF_RECONFIG_GRACE_ROUNDS", "16")
        )
        self.retired = False
        # Byzantine adversary plane (faults/adversary.py): None on
        # honest nodes; on attacking nodes the vote/timeout/commit
        # seams below consult it for the active policy windows.
        self.adversary = adversary
        # Replicated execution layer (store/state.py): committed blocks
        # are applied in commit order and summarized by a state root.
        self.state = state_machine
        # Boot-time snapshot catch-up (statesync.StateSyncClient), set
        # by Consensus.spawn on recovering nodes; run() consults it
        # once, right after load_state.
        self.state_sync = None
        self.aggregator = Aggregator(committee, verifier, self_key=name)
        # Async claim preverifier (crypto/async_service.py): device
        # backends get a coalescing off-loop dispatch service (shared
        # across in-process cores); CPU backends evaluate inline.
        self.averifier = AsyncVerifyService.for_backend(verifier)
        self.network = network if network is not None else SimpleSender()
        # Memo of QC cache-keys that already verified against this
        # committee (messages.QC.verify): under a view-change storm all
        # n timeouts carry the SAME high_qc — without the memo the most
        # expensive check in the protocol runs n times per storm.
        # Bounded: cleared when full (worst case = one re-verification).
        self._verified_qcs: set[bytes] = set()
        self.state_changed = False
        self._task: asyncio.Task | None = None
        # per-node logger so multi-node (in-process) runs are attributable
        self.log = logging.getLogger(f"{__name__}.{str(name)[:8]}")
        # telemetry (telemetry/__init__.py): every hook below is guarded
        # by `if self._trace is not None` — with telemetry off the hot
        # path pays one attribute test and nothing else
        self.telemetry = telemetry
        self._trace = telemetry.trace if telemetry is not None else None
        # flight recorder (telemetry/journal.py): same guard discipline —
        # journaling off means one attribute test per site and no writes
        self._journal = telemetry.journal if telemetry is not None else None
        if telemetry is not None:
            telemetry.gauge(
                "core_round", "Current consensus round", fn=lambda: self.round
            )
            telemetry.gauge(
                "core_epoch",
                "Active committee epoch at the current round",
                fn=lambda: self.committee.for_round(self.round).epoch,
            )
            telemetry.gauge(
                "core_event_queue_depth",
                "Merged core event queue occupancy",
                fn=rx_events.qsize,
            )
            telemetry.gauge(
                "core_loopback_depth",
                "Priority loopback channel occupancy",
                fn=rx_loopback.qsize,
            )
            telemetry.gauge(
                "core_timer_resets",
                "Round timer re-arms (rounds entered + backoff restarts)",
                fn=lambda: self.timer.resets,
            )
            from .messages import QC_CACHE_STATS

            # process-wide (module-level) by design: co-located nodes
            # share the dedup the counter is meant to surface
            telemetry.gauge(
                "qc_verify_cache_hit",
                "QC verifications skipped via the per-digest verify "
                "memo (same QC via Propose / sync reply / TC high-QC)",
                fn=lambda: QC_CACHE_STATS["hits"],
            )
            telemetry.add_section("aggregator", self.aggregator.stats)

    # ---- persistence (fork additions, core.rs:76-86, 112-153) --------------

    async def load_state(self) -> None:
        data = await self.store.read(CONSENSUS_STATE_KEY)
        if data is None:
            return
        state = ConsensusState.deserialize(data)
        self.round = state.round
        self.last_voted_round = state.last_voted_round
        self.last_committed_round = state.last_committed_round
        self.high_qc = state.high_qc
        self.log.info("Recovered consensus state at round %d", self.round)

    async def persist_state(self) -> None:
        state = ConsensusState(
            self.round,
            self.last_voted_round,
            self.last_committed_round,
            self.high_qc,
        )
        await self.store.write(CONSENSUS_STATE_KEY, state.serialize())

    async def store_block(self, block: Block) -> None:
        await self.store.write(block.digest().to_bytes(), block.serialize())

        # Maintain the per-round payload index + latest-round key the
        # proposer's payload buffering feeds on (core.rs:117-148).
        latest_raw = await self.store.read(LATEST_ROUND_KEY)
        latest = int.from_bytes(latest_raw, "big") if latest_raw else 0
        if latest == block.round:
            raw = await self.store.read(round_key(block.round))
            payloads = decode_payload_index(raw) if raw else []
            known = set(payloads)
            for p in block.payloads:
                if p not in known:
                    known.add(p)
                    payloads.append(p)
        elif latest < block.round:
            payloads = list(block.payloads)
        else:
            self.log.warning("The block round is less than the last round")
            return
        await self.store.write(round_key(block.round), encode_payload_index(payloads))
        await self.store.write(LATEST_ROUND_KEY, round_key(block.round))

    # ---- voting and committing ---------------------------------------------

    def _increase_last_voted_round(self, target: Round) -> None:
        self.last_voted_round = max(self.last_voted_round, target)
        self.state_changed = True

    async def _make_vote(self, block: Block) -> Vote | None:
        safety_rule_1 = block.round > self.last_voted_round
        safety_rule_2 = block.qc.round + 1 == block.round
        if block.tc is not None:
            can_extend = block.tc.round + 1 == block.round
            can_extend &= block.qc.round >= max(block.tc.high_qc_rounds())
            safety_rule_2 |= can_extend
        if not (safety_rule_1 and safety_rule_2):
            return None

        # Ensure we won't vote for contradicting blocks.  last_voted_round
        # MUST be durable before the vote can leave this node: a crash
        # between send and persist would recover a stale value and allow
        # an equivocating re-vote for these rounds (a BFT safety
        # violation).  The end-of-loop persist is only a catch-all for
        # non-safety-critical state; this is the safety-critical write.
        self._increase_last_voted_round(block.round)
        await self.persist_state()
        self.state_changed = False
        vote = Vote.for_block(block, self.name)
        vote.signature = await self.signature_service.request_signature(
            vote.digest()
        )
        return vote

    async def _commit(self, block: Block, cert_qc: QC) -> None:
        """Commit ``block`` and its uncommitted ancestors.  ``cert_qc``
        is the QC certifying ``block`` itself (the 2-chain rule's b1.qc)
        — committed reconfig blocks persist it as the certified schedule
        link a joiner verifies the epoch change with."""
        if self.last_committed_round >= block.round:
            return

        # Commit the entire chain up to `block` (needed after view-change),
        # oldest first.
        to_commit = [block]
        parent = block
        while self.last_committed_round + 1 < parent.round:
            ancestor = await self.synchronizer.get_parent_block(
                parent, floor=self.last_committed_round
            )
            if ancestor is None:
                raise SerializationError(
                    "missing ancestor while committing a delivered chain"
                )
            if ancestor.round <= self.last_committed_round:
                # snapshot barrier (genesis stand-in) or an ancestor the
                # cursor already covers: nothing below this point needs
                # (re-)committing
                break
            to_commit.append(ancestor)
            parent = ancestor

        self.last_committed_round = block.round
        self.state_changed = True

        # certifying QC per chain position: to_commit[0] (the head) is
        # certified by the caller's cert_qc; every deeper ancestor by
        # its child's embedded qc (child.qc.hash == parent.digest())
        cert_qcs = [cert_qc] + [b.qc for b in to_commit[:-1]]

        committed_payloads: set = set()
        for b, cqc in zip(reversed(to_commit), reversed(cert_qcs)):
            await self.tx_commit.put(b)
            committed_payloads.update(b.payloads)
            if self._trace is not None:
                self._trace.mark_committed(b.digest().to_bytes(), b.round)
            if self._journal is not None:
                self._journal.record("commit", b.round, b.digest())
            # NOTE: this log entry is used to compute performance.
            # One info line per block in the chain walk — a DELIBERATE
            # divergence from the reference, which info-logs only the
            # head and debug-logs the rest (core.rs:204-209): head-only
            # logging hides the other blocks' payloads from the harness
            # and undercounts TPS after every view change.
            reported = b.digest()
            shadow = None
            adversary = self.adversary
            if (
                adversary is not None
                and adversary.is_shadow_committer
                and adversary.active("collude")
                and b.author in adversary.colluder_names
            ):
                # collude policy: the designated shadow committer
                # reports the shadow branch for colluder-led rounds —
                # a REAL divergent history the safety checker must
                # catch and attribute to the colluding authorities
                shadow = adversary.shadow_block(b).digest()
                reported = shadow
                adversary.count("byz_shadow_commits")
                adversary.record("shadow-commit", b.round, reported)
                self.log.info(
                    "byz shadow-commit round %d -> %s", b.round, reported
                )
            self.log.info("Committed block %d -> %s", b.round, reported)
            if self.state is not None:
                # execution layer: apply in commit order; the REPORTED
                # root chains over the reported (possibly shadow)
                # digests, so a colluder's claimed state diverges
                # exactly where its claimed digest log does
                root = self.state.apply_block(b, reported_digest=shadow)
                if root is not None:
                    if self._journal is not None:
                        self._journal.record("state.apply", b.round, b.digest())
                    # NOTE: this log entry is used to compute performance.
                    self.log.info(
                        "State root %d -> %s (round %d)",
                        self.state.version,
                        Digest(root),
                        b.round,
                    )
            if b.reconfig is not None:
                await self._apply_reconfig(b, cqc)
        # Tell the proposer what committed: (a) it prunes those digests
        # from its buffer — with single-homed clients (node/client.py)
        # queues are disjoint so this is defense-in-depth against
        # producers that DO multi-home a payload (each would otherwise
        # be re-proposed by every node that buffered it); (b) the
        # committed_round lets it resolve its in-flight proposals —
        # payloads of orphaned blocks return to the buffer (orphan
        # recovery; the reference instead drops whole per-round buckets
        # on cleanup, proposer.rs:164-173, losing them entirely).
        if self.payload_bodies is not None:
            self.payload_bodies.mark_committed(committed_payloads)
        await self.tx_proposer.put(
            ProposerMessage.cleanup(
                [],
                payloads=committed_payloads,
                committed_round=self.last_committed_round,
            )
        )

    def _update_high_qc(self, qc: QC) -> None:
        if qc.round > self.high_qc.round:
            self.high_qc = qc
            self.state_changed = True

    # ---- reconfiguration (docs/RECONFIG.md) --------------------------------

    async def _apply_reconfig(self, block: Block, cert_qc: QC) -> None:
        """A committed block carries an epoch change: splice the new
        committee into the shared schedule at ``block.round + margin``
        — deterministic across nodes, so every honest node activates
        the same epoch at the same round — and persist the certified
        link for crash recovery and joiners."""
        op = block.reconfig
        if not hasattr(self.committee, "splice"):
            # a bare (non-schedule) committee cannot rotate — tests
            # spawning Core directly on a plain Committee stay valid
            self.log.warning(
                "Reconfig committed at round %d but the committee is "
                "not a schedule; ignoring", block.round,
            )
            return
        activation = block.round + op.margin
        try:
            spliced = self.committee.splice(activation, op.new_committee)
        except InvalidCommittee as e:
            # defense in depth: Block.verify already ran the full gate,
            # so only a replayed/conflicting splice can land here
            self.log.warning(
                "Reconfig committed at round %d not applied: %s",
                block.round, e,
            )
            return
        if not spliced:
            return  # exact replay (crash-recovery re-commit)
        # NOTE: this log entry is used by the reconfiguration harness.
        self.log.info(
            "Reconfig committed at round %d: epoch %d activates at "
            "round %d (margin %d)",
            block.round, op.new_committee.epoch, activation, op.margin,
        )
        if self._journal is not None:
            self._journal.record("reconfig.commit", block.round, block.digest())
            self._journal.flush()
        # pre-warm native verifier key tables for the incoming epoch so
        # the first boundary certificate pays no key-parsing latency
        pre = getattr(self.verifier, "precompute", None)
        if pre is not None:
            try:
                pre([k.to_bytes() for k in op.new_committee.sorted_keys()])
            except Exception as e:  # noqa: BLE001 — warm-up only
                self.log.debug("verifier precompute failed: %s", e)
        await self._persist_schedule_link(block, cert_qc)

    async def _persist_schedule_link(
        self, block: Block, cert_qc: QC
    ) -> None:
        raw = await self.store.read(SCHEDULE_LINKS_KEY)
        links = decode_schedule_links(raw) if raw else []
        enc = Encoder()
        cert_qc.encode(enc)
        links.append((block.serialize(), enc.finish()))
        if len(links) > MAX_SCHEDULE_LINKS:
            # beyond the wire cap a joiner can no longer verify from
            # genesis — drop the oldest link and say so (joiners must
            # then boot from a committee file of a later epoch)
            self.log.warning(
                "Schedule link list exceeds %d; dropping the oldest "
                "(joiners need a post-genesis committee file)",
                MAX_SCHEDULE_LINKS,
            )
            links = links[-MAX_SCHEDULE_LINKS:]
        await self.store.write(SCHEDULE_LINKS_KEY, encode_schedule_links(links))

    def _maybe_activate_epoch(self) -> None:
        """Epoch-boundary detection at the CURRENT round, run on every
        round advance.  Crossing a boundary also snaps the view-change
        backoff: the backed-off timer measured the OLD committee's
        liveness trouble, and carrying it into a fresh validator set
        costs several idle multi-second views right when the handoff
        gap is being measured (the exponent was previously never reset
        on activation — epoch-boundary bugfix)."""
        if self._active_epoch is None:
            return
        epoch = self.committee.for_round(self.round).epoch
        if epoch == self._active_epoch:
            return
        self._consecutive_tcs = 0
        if self._timeout_exponent:
            self._timeout_exponent = 0
            self.timer.set_duration_ms(self._timeout_base_ms)
            self.timer.reset()
        self._activate_epoch(epoch)

    def _activate_epoch(self, epoch: int) -> None:
        self._active_epoch = epoch
        # Report the SCHEDULE's activation round, not wherever this node
        # happens to be: a joiner (or a state-synced straggler) crosses
        # the boundary mid-catch-up at some later round, and the
        # epoch-agreement invariant compares the activation POINT — the
        # deterministic commit_round + margin every honest node shares.
        reported_round = self.round
        for from_round, com in getattr(self.committee, "entries", ()):
            if com.epoch == epoch:
                reported_round = from_round
                break
        adversary = self.adversary
        snipes = (
            adversary.wants("reconfig", self.round)
            if adversary is not None else False
        )
        if snipes:
            # reconfig policy (shadow half): claim the activation at a
            # skewed round — a divergent epoch history the
            # epoch-agreement invariant must catch and attribute.  The
            # reconfig-sniper fires the same attack, but only inside
            # the epoch-activation margin (wants returns its token).
            adversary.mark_adaptive(snipes, self.round, self.log)
            reported_round = reported_round + 1 + (epoch % 3)
            adversary.count("byz_shadow_epochs")
            adversary.record("reconfig-shadow", self.round)
            self.log.info(
                "byz reconfig-shadow epoch %d round %d -> %d",
                epoch, self.round, reported_round,
            )
        # NOTE: this log entry is used by the epoch-agreement invariant.
        self.log.info("Epoch %d activated at round %d", epoch, reported_round)
        if self._journal is not None:
            self._journal.record("reconfig.activate", self.round)
            self._journal.flush()
        if (
            self._retire_after is None
            and self.committee.for_round(self.round).stake(self.name) <= 0
        ):
            self._retire_after = self.round + self._grace_rounds
            self.log.info(
                "Retiring: epoch %d excludes this node; serving a grace "
                "window through round %d", epoch, self._retire_after,
            )

    # ---- round advancement and proposals -----------------------------------

    def _advance_round(self, round_: Round, *, via_tc: bool = False) -> None:
        if round_ < self.round:
            return
        # View-change backoff policy:
        # - QC advance = real progress: snap timer and TC streak to base.
        # - FIRST TC after progress: retry at base once — with
        #   round-robin leaders a single crashed node deterministically
        #   costs TWO view changes per lap (the preceding round's QC
        #   dies with it: votes route to the dead collector; then its
        #   own round stalls), and paying base + backed-off for a
        #   structural event halves fault throughput for nothing.
        # - CONSECUTIVE TCs (no QC in between): keep the backed-off
        #   timer — under a uniformly slow but live network TCs keep
        #   forming, and resetting on every TC would pin the timer at
        #   base forever (endless view changes, zero commits).  Growth
        #   is delayed by one view change but remains geometric, so
        #   convergence under asynchrony is preserved.
        if via_tc:
            self._consecutive_tcs += 1
            self._last_tc_round = round_
            snap = self._consecutive_tcs == 1
            if self._trace is not None:
                self._trace.mark_tc_advance()
            if self._journal is not None:
                # view change: force-flush so the record survives even if
                # the node wedges in the new view
                self._journal.record("tc", round_)
                self._journal.flush()
        else:
            self._consecutive_tcs = 0
            snap = True
        if snap and self._timeout_exponent:
            self._timeout_exponent = 0
            self.timer.set_duration_ms(self._timeout_base_ms)
        self.timer.reset()
        self.round = round_ + 1
        self._saw_proposal = False
        self._maybe_activate_epoch()
        self.state_changed = True
        if self._journal is not None:
            self._journal.record("round.enter", self.round)
        self.log.debug("Moved to round %d", self.round)
        self.aggregator.cleanup(self.round)
        # Tell the proposer the chain moved on, so a make deferred while
        # the payload buffer was empty can't later fire for a dead round
        # (best effort — a full queue just means the signal is late).
        try:
            self.tx_proposer.put_nowait(
                ProposerMessage.cleanup([self.round - 1])
            )
        except asyncio.QueueFull:
            pass

    async def _generate_proposal(self, tc: TC | None) -> None:
        await self.tx_proposer.put(
            ProposerMessage.make(
                self.round,
                self.high_qc,
                tc,
                allow_empty=self.last_payload_round > self.last_committed_round,
            )
        )

    async def _cleanup_proposer(self, b0: Block, b1: Block, block: Block) -> None:
        await self.tx_proposer.put(
            ProposerMessage.cleanup([b0.round, b1.round, block.round])
        )

    def _process_qc(self, qc: QC) -> None:
        if self._trace is not None and not qc.is_genesis():
            self._trace.mark_qc_formed(qc.hash.to_bytes())
        # journal only NEW high QCs: every proposal/timeout re-carries
        # older QCs and re-recording them would swamp the timeline
        if (
            self._journal is not None
            and not qc.is_genesis()
            and qc.round > self.high_qc.round
        ):
            self._journal.record("qc", qc.round, qc.hash)
        self._advance_round(qc.round)
        self._update_high_qc(qc)

    # ---- message handlers ---------------------------------------------------

    async def _handle_vote(self, vote: Vote, sig_verified: bool = False) -> None:
        self.log.debug("Processing %r", vote)
        if vote.round < self.round:
            return
        # Accumulate-then-dispatch: authority/stake checks happen on entry;
        # signatures were either pre-verified by the burst preverifier
        # (sig_verified) or batch-verified at quorum inside the aggregator.
        qc = self.aggregator.add_vote(vote, self.round, sig_verified=sig_verified)
        if qc is not None:
            self.log.debug("Assembled %r", qc)
            # qc.form marks the FORMATION moment at the assembling node
            # (quorum-th vote folded in), distinct from the ``qc`` edge
            # which marks high-QC adoption
            if self._journal is not None and not qc.is_genesis():
                self._journal.record("qc.form", qc.round, qc.hash)
            self._process_qc(qc)
            if self.name == self.leader_elector.get_leader(self.round):
                await self._generate_proposal(None)

    def _qc_cache(self) -> set:
        if len(self._verified_qcs) > 4_096:
            self._verified_qcs.clear()
        return self._verified_qcs

    async def _handle_timeout(
        self, timeout: Timeout, sig_verified: bool = False
    ) -> None:
        self.log.debug("Processing %r", timeout)
        if timeout.round < self.round:
            return
        # Verify on entry like the reference (core.rs:288): the author's
        # single signature is checked FIRST (cheap), so a spoofed timeout
        # cannot force the expensive embedded-QC batch verify — and the
        # TCMaker can then emit TCs from pre-verified entries.
        # ``sig_verified``: the burst drain already aggregate-verified
        # this timeout's author signature (_preverify_timeout_burst).
        try:
            timeout.verify(
                self.committee,
                self.verifier,
                qc_cache=self._qc_cache(),
                sig_verified=sig_verified,
            )
        except ConsensusError:
            # honest defense seam: a timeout whose author signature or
            # embedded certificate fails verification (forged QCs from
            # the adversary plane land here after the burst preverifier
            # refuses their claims)
            self.aggregator.qc_rejects += 1
            self.log.info(
                "qc reject: invalid certificate in timeout from %s "
                "round %d", str(timeout.author)[:8], timeout.round,
            )
            raise
        self._process_qc(timeout.high_qc)

        tc = self.aggregator.add_timeout(timeout, self.round)
        if tc is not None:
            self.log.debug("Assembled %r", tc)
            self._advance_round(tc.round, via_tc=True)

            addresses = [
                addr for _, addr in self.committee.broadcast_addresses(self.name)
            ]
            await self.network.broadcast(addresses, encode_tc(tc))

            if self.name == self.leader_elector.get_leader(self.round):
                await self._generate_proposal(tc)
        elif (
            timeout.round > self.round
            and self.aggregator.timeout_weight(timeout.round)
            >= self.committee.for_round(timeout.round).validity_threshold()
        ):
            # Round synchronization (timeout-join): f+1 stake — at least
            # one honest authority — is provably timing out a round
            # AHEAD of ours, so that round is legitimate; join it and
            # emit our own timeout so the TC can complete.  Without
            # this, a node that missed a one-shot TC broadcast (e.g. it
            # was inside its state-sync bootstrap when the round
            # turned) wedges one round behind a committee whose TC
            # needs this node's timeout — mutual starvation where every
            # node re-broadcasts timeouts for a round no one else is
            # in.  A snapshot rejoin under partition makes that window
            # routine rather than exotic.
            self.log.info(
                "Joining timeout round %d (round sync, own round %d)",
                timeout.round,
                self.round,
            )
            self.round = timeout.round
            self._saw_proposal = False
            self._maybe_activate_epoch()
            self.state_changed = True
            self.aggregator.cleanup(self.round)
            await self._local_timeout_round()

    async def _local_timeout_round(self) -> None:
        if self.committee.for_round(self.round).stake(self.name) <= 0:
            # not a member of the round's epoch (a joiner before its
            # activation round, a retiree after): our timeout carries
            # no stake and honest receivers would reject it — keep
            # observing, just re-arm the timer
            self.timer.reset()
            return
        self.log.warning("Timeout reached for round %d", self.round)
        self.local_timeouts += 1
        if self._trace is not None:
            self._trace.mark_timeout()
        if self._journal is not None:
            # timeout: a force-flush point (the whole point of a flight
            # recorder is surviving the interesting failures)
            self._journal.record("timeout", self.round)
            self._journal.flush()
        self._increase_last_voted_round(self.round)
        # durable before the Timeout broadcast, same safety argument as
        # in _make_vote
        await self.persist_state()
        self.state_changed = False
        timeout = Timeout(high_qc=self.high_qc, round=self.round, author=self.name)
        timeout.signature = await self.signature_service.request_signature(
            timeout.digest()
        )
        self.log.debug("Created %r", timeout)
        # one more consecutive view change -> stretch the next round's
        # timer (a dead-leader round costs ~one base delay; a genuinely
        # slow network backs off geometrically instead of storming).
        # IDLE timeouts — no proposal seen for the round and nothing
        # uncommitted in flight — keep the base timer: that's the
        # committee pacing itself to payload arrival (deferred makes),
        # not a liveness failure (see _saw_proposal).
        active = (
            self._saw_proposal
            or self.last_payload_round > self.last_committed_round
        )
        if active:
            self._timeout_exponent += 1
            self.timer.set_duration_ms(
                min(
                    self._timeout_base_ms
                    * self._timeout_backoff**self._timeout_exponent,
                    self._timeout_cap_ms,
                )
            )
        self.timer.reset()

        addresses = [
            addr for _, addr in self.committee.broadcast_addresses(self.name)
        ]
        await self.network.broadcast(addresses, encode_timeout(timeout))
        # own timeout: we just signed it; the embedded high_qc is ours
        # (already verified when it was adopted)
        await self._handle_timeout(timeout, sig_verified=True)

    async def _process_block(self, block: Block) -> None:
        self.log.debug("Processing %r", block)
        if block.round >= self.round:
            # a (verified or self-made) proposal for the current round:
            # the committee is live — timeouts from here on are real
            # liveness signals, not idle pacing (_saw_proposal)
            self._saw_proposal = True
        if self._trace is not None:
            self._trace.mark_proposed(block.digest().to_bytes(), block.round)

        # b0 <- |qc0; b1| <- |qc1; block|: suspend if ancestors are missing
        # (the synchronizer will re-inject the block via loopback).  The
        # floor is the snapshot barrier: after a QC-anchored snapshot
        # adoption, ancestry at or below the commit cursor is certified
        # by the block's own verified QC and already covered by the
        # snapshot — it resolves to the genesis stand-in instead of a
        # fetch, so the node can vote (and restore quorum) immediately.
        ancestors = await self.synchronizer.get_ancestors(
            block, floor=self.last_committed_round
        )
        if ancestors is None:
            self.log.debug("Processing of %s suspended: missing parent", block.digest())
            return
        b0, b1 = ancestors

        await self.store_block(block)
        if block.payloads and block.round > self.last_payload_round:
            self.last_payload_round = block.round
            # If we lead the current round and our Make went out before
            # this payload block was processed (votes can overtake the
            # proposal), the proposer may be sitting on a deferred Make
            # with a stale allow_empty=False — with an idle producer the
            # commit would then wait out the full view-change timeout.
            # Re-issue; the proposer drops it if a block for this round
            # was already made.  Skip the TC edge (high_qc not adjacent):
            # re-issuing without the original TC would propose a block
            # followers refuse to vote for.
            if (
                self.name == self.leader_elector.get_leader(self.round)
                and self.high_qc.round + 1 == self.round
                and self.last_payload_round > self.last_committed_round
            ):
                await self._generate_proposal(None)
        await self._cleanup_proposer(b0, b1, block)

        # 2-chain commit rule.
        if b0.round + 1 == b1.round:
            await self._commit(b0, b1.qc)

        # Prevents bad leaders from proposing blocks far in the future.
        if block.round != self.round:
            return

        adversary = self.adversary
        withholds = (
            adversary.wants("withhold", block.round)
            if adversary is not None else False
        )
        if withholds:
            # withhold policy: receive, never vote — the committee must
            # reach quorum without us (timeouts), and recover liveness
            # once the window closes.  Also the reconfig-sniper's
            # withhold half (wants returns its token near an epoch
            # activation boundary).
            adversary.mark_adaptive(withholds, block.round, self.log)
            adversary.count("byz_votes_withheld")
            adversary.record("withhold", block.round, block.digest())
            self.log.info(
                "byz withhold vote round %d -> %s",
                block.round, block.digest(),
            )
            return

        if self.committee.for_round(block.round).stake(self.name) <= 0:
            # not a member of this block's epoch: observe the chain
            # (commits above still ran), never vote
            return

        vote = await self._make_vote(block)
        if vote is not None:
            self.log.debug("Created %r", vote)
            if self._trace is not None:
                self._trace.mark_first_vote(block.digest().to_bytes())
            next_leader = self.leader_elector.get_leader(self.round + 1)
            if self._journal is not None:
                self._journal.record(
                    "vote.send",
                    block.round,
                    block.digest(),
                    str(next_leader)[:8],
                )
            if next_leader == self.name:
                # own vote: we just signed it — no verification needed
                await self._handle_vote(vote, sig_verified=True)
            else:
                surfs = (
                    adversary.wants("vote-delay", block.round)
                    if adversary is not None else False
                )
                if surfs:
                    # timeout-surfer (faults/adaptive.py): hold the vote
                    # to a fraction of the OBSERVED view timer — the
                    # collector reaches quorum just inside the timeout,
                    # stretching every view without firing a TC
                    delay = adversary.surf_delay_s(self.timer.duration)
                    adversary.mark_adaptive(
                        surfs, block.round, self.log, block.digest()
                    )
                    self.log.info(
                        "byz vote-delay round %d: holding %.0f ms of "
                        "%.0f ms timer", block.round, delay * 1e3,
                        self.timer.duration * 1e3,
                    )
                    await default_clock().sleep(delay)
                address = self.committee.address(next_leader)
                await self.network.send(address, encode_vote(vote))
            if adversary is not None and adversary.active("double-vote"):
                await self._byz_double_vote(block, next_leader)
        if adversary is not None and adversary.active("forge-qc"):
            await self._byz_forge_qc()

    # ---- adversary seams (faults/adversary.py) -----------------------------

    async def _byz_double_vote(self, block: Block, next_leader) -> None:
        """double-vote policy: also sign a vote for the deterministic
        shadow twin of ``block`` and ship it to the same next leader —
        a well-formed conflicting vote the honest aggregator must park
        (second digest cell for one payer)."""
        adversary = self.adversary
        shadow = adversary.shadow_block(block)
        vote = Vote(hash=shadow.digest(), round=block.round, author=self.name)
        vote.signature = await self.signature_service.request_signature(
            vote.digest()
        )
        adversary.count("byz_double_votes")
        adversary.record(
            "double-vote", block.round, shadow.digest(), str(next_leader)[:8]
        )
        self.log.info(
            "byz double-vote round %d -> %s", block.round, shadow.digest()
        )
        if next_leader == self.name:
            try:
                await self._handle_vote(vote, sig_verified=True)
            except ConsensusError as e:
                self.log.debug("own conflicting vote rejected: %s", e)
        else:
            address = self.committee.address(next_leader)
            await self.network.send(address, encode_vote(vote))

    async def _byz_forge_qc(self) -> None:
        """forge-qc policy: broadcast a properly-signed timeout whose
        high_qc names real committee authors with quorum-many garbage
        signatures — it passes every structural check (stake, quorum,
        no reuse) and MUST die in honest signature verification.  One
        seeded draw gates each opportunity so the attack volume is
        replayable."""
        adversary = self.adversary
        if adversary.rng.random() >= 0.5:
            return
        qc = adversary.forged_qc(self.committee, max(self.round - 1, 1))
        timeout = Timeout(high_qc=qc, round=self.round, author=self.name)
        timeout.signature = await self.signature_service.request_signature(
            timeout.digest()
        )
        adversary.count("byz_forged_qcs")
        adversary.record("forge-qc", self.round, qc.hash)
        self.log.info(
            "byz forge-qc round %d (authors %d)", self.round, len(qc.votes)
        )
        addresses = [
            addr for _, addr in self.committee.broadcast_addresses(self.name)
        ]
        await self.network.broadcast(addresses, encode_timeout(timeout))

    async def _handle_proposal(
        self, block: Block, sigs_verified: bool = False
    ) -> None:
        digest = block.digest()
        expected = self.leader_elector.get_leader(block.round)
        if block.author != expected:
            raise WrongLeader(digest, block.author, block.round)
        block.verify(
            self.committee,
            self.verifier,
            qc_cache=self._qc_cache(),
            sigs_verified=sigs_verified,
        )
        self._process_qc(block.qc)
        if block.tc is not None:
            self._advance_round(block.tc.round, via_tc=True)
        await self._process_block(block)

    async def _handle_tc(self, tc: TC, sigs_verified: bool = False) -> None:
        # staleness check first: every node broadcasts assembled TCs, so
        # stale copies are routine — drop them before paying the 2f+1
        # batch verify
        if tc.round < self.round:
            return
        tc.verify(self.committee, self.verifier, sigs_verified=sigs_verified)
        self._advance_round(tc.round, via_tc=True)
        if self.name == self.leader_elector.get_leader(self.round):
            await self._generate_proposal(tc)

    async def _handle_reconfig(self, op: ReconfigOp) -> None:
        """An operator-submitted epoch change (wire.encode_reconfig).
        The full verification gate runs at admission — margin bounds,
        epoch succession, carried-over stake, sponsor membership and
        signature (byz-reconfig's forged ops die HERE on honest nodes)
        — then the op waits in the proposer for our next leader slot."""
        validate_reconfig(op, self.committee, self.round, verifier=self.verifier)
        self.log.info(
            "Reconfig op admitted: epoch %d (%d members, margin %d)",
            op.new_committee.epoch,
            len(op.new_committee.authorities),
            op.margin,
        )
        if self._journal is not None:
            self._journal.record("reconfig.submit", self.round)
        await self.tx_proposer.put(ProposerMessage.reconfig(op))

    # ---- the select loop -----------------------------------------------------

    async def _preverify_burst(self, burst: list) -> set[int]:
        """Burst-level accumulate-then-dispatch: collect every signature
        check the burst's messages need as CLAIMS, discharge them in ONE
        awaited call on the async verify service, and return the indices
        of fully-preverified messages.  Messages not in the returned set
        (structurally implausible, or a claim failed) fall back to the
        handler's own synchronous, hardened verification path — a
        garbage message costs the attacker the old per-item price, never
        an amplification.

        Why this exists (VERDICT r3 item 1): on the device backend the
        await runs the whole burst's crypto as one coalesced off-loop
        dispatch — measured 56% of the event loop at a 32-node committee
        moves to the TPU, and the dispatch latency overlaps the other
        nodes' protocol work instead of serializing with it.  On the CPU
        backend the service evaluates inline (one flattened batch call),
        so behavior and timing match the old eager path.

        Trust base for the timeout grouping (shared-digest aggregate):
        identical to TC.verify's grouped path — aggregation is ONLY over
        authors holding stake in their round's committee (PoP-checked
        under BLS; a rogue key pk_E = x*G2 - pk_B that would let an
        attacker forge an honest member's entry inside the aggregate
        cannot carry a valid proof of possession, and non-members never
        enter the sum at all — they fall back to per-item verification,
        where the stake check rejects them).  A certificate formed from
        collectively-certified entries is re-verified by every receiver
        under the same semantics.
        """
        cache = self._qc_cache()
        claims: dict = {}  # claim tuple (hashable) -> position, dedup
        qc_memo: dict = {}  # claim -> QC cache key to memoize on success
        per_msg: list[tuple[int, list]] = []  # (burst idx, [claims])

        def add_qc_claims(qc) -> list:
            # SAFETY: the stake/quorum rules must hold BEFORE this QC
            # can become memoizable — a successful signature claim alone
            # must never put a sub-quorum certificate into the verified
            # cache (QC.verify early-returns on a cache hit, skipping
            # the weight check; see QC.claims docstring).  Raises
            # ConsensusError, which skips this message's claims — the
            # handler then runs the full sync verify and rejects it
            # with the proper error.
            if qc.is_genesis():
                return []
            qc.check_weight(self.committee)
            out = []
            # committee= resolves a compact QC's signer bitmap into the
            # member keys its "agg" claim carries
            for c in qc.claims(cache=cache, committee=self.committee):
                claims.setdefault(c, None)
                qc_memo[c] = qc._cache_key()
                out.append(c)
            return out

        def collect_propose(idx, payload) -> None:
            com = self.committee.for_round(payload.round)
            if (
                com.stake(payload.author) <= 0
                or len(payload.payloads) > MAX_BLOCK_PAYLOADS
            ):
                return  # handler raises the proper error
            keys = [
                (
                    "one",
                    payload.digest().to_bytes(),
                    payload.author.to_bytes(),
                    payload.signature.to_bytes(),
                )
            ]
            claims.setdefault(keys[0], None)
            keys += add_qc_claims(payload.qc)
            if payload.tc is not None:
                for c in payload.tc.claims(committee=self.committee):
                    claims.setdefault(c, None)
                    keys.append(c)
            per_msg.append((idx, keys))

        def collect_vote(idx, payload) -> None:
            if (
                # mirror Aggregator.add_vote's bounds: a far-future vote
                # is rejected there with ZERO crypto (AggregationBounds)
                # — collecting its claim here would convert that free
                # rejection into attacker-priced signature work
                self.round
                <= payload.round
                <= self.round + ROUND_LOOKAHEAD
                and self.committee.for_round(payload.round).stake(
                    payload.author
                )
                > 0
            ):
                c = payload.claim()
                claims.setdefault(c, None)
                per_msg.append((idx, [c]))

        def collect_tc(idx, payload) -> None:
            if payload.round >= self.round:
                keys = []
                for c in payload.claims(committee=self.committee):
                    claims.setdefault(c, None)
                    keys.append(c)
                per_msg.append((idx, keys))

        # timeouts sharing one digest verify as one aggregate claim
        timeout_groups: dict = {}  # Digest -> [(idx, timeout)]
        collectors = {
            TAG_PROPOSE: collect_propose,
            TAG_TC: collect_tc,
        }
        if self.averifier.device:
            # Device backends: fold vote claims into the coalesced wave
            # — marginal signatures in a device dispatch are ~free, and
            # the off-loop await overlaps other nodes' work.  On the CPU
            # inline path votes are deliberately NOT preverified: the
            # aggregator accumulates them unverified and batch-verifies
            # the whole set ONCE at quorum (QCMaker.emit), so eager
            # per-burst checks — typically 1-2 signatures each — would
            # run ~3 small batch equations where quorum time runs one.
            collectors[TAG_VOTE] = collect_vote
        for idx, (tag, payload) in enumerate(burst):
            if tag == TAG_TIMEOUT:
                if (
                    # same lookahead bound as add_timeout: far-future
                    # timeouts are a free rejection, not crypto work
                    self.round
                    <= payload.round
                    <= self.round + ROUND_LOOKAHEAD
                    # committee membership BEFORE aggregation — the
                    # soundness precondition above
                    and self.committee.for_round(payload.round).stake(
                        payload.author
                    )
                    > 0
                ):
                    timeout_groups.setdefault(payload.digest(), []).append(
                        (idx, payload)
                    )
            elif tag in collectors:
                try:
                    collectors[tag](idx, payload)
                except ConsensusError:
                    # a structural rule failed (e.g. a sub-quorum
                    # embedded QC): collect nothing — the handler's
                    # full sync verify rejects it with the proper error
                    continue

        for digest, members in timeout_groups.items():
            if len(members) == 1:
                idx0, t = members[0]
                author_claim = (
                    "one",
                    digest.to_bytes(),
                    t.author.to_bytes(),
                    t.signature.to_bytes(),
                )
            else:
                author_claim = (
                    "shared",
                    digest.to_bytes(),
                    tuple(
                        (t.author.to_bytes(), t.signature.to_bytes())
                        for _, t in members
                    ),
                )
            claims.setdefault(author_claim, None)
            for idx, t in members:
                try:
                    keys = [author_claim] + add_qc_claims(t.high_qc)
                except ConsensusError:
                    continue  # sub-quorum high_qc: leave to the handler
                per_msg.append((idx, keys))

        if not claims:
            return set()
        ordered = list(claims.keys())
        try:
            results = await self.averifier.verify_claims(ordered)
        except Exception as e:  # noqa: BLE001 — any backend failure must
            # degrade to per-item verification, never crash the core; but
            # silently losing the fast path forever is a debugging trap,
            # so say so
            self.log.warning(
                "burst claim preverification failed (%s); falling back to "
                "per-item verification",
                e,
            )
            return set()
        verdict = dict(zip(ordered, results))
        for claim, key in qc_memo.items():
            if verdict.get(claim):
                cache.add(key)
        return {
            idx for idx, keys in per_msg if all(verdict[k] for k in keys)
        }

    async def _dispatch(self, tagged, sig_verified: bool = False) -> None:
        """``sig_verified=True``: every signature claim this message
        carries was discharged by the burst preverifier
        (_preverify_burst) — handlers run structural checks only."""
        tag, payload = tagged
        if tag == TAG_PROPOSE:
            await self._handle_proposal(payload, sigs_verified=sig_verified)
        elif tag == TAG_VOTE:
            await self._handle_vote(payload, sig_verified=sig_verified)
        elif tag == TAG_TIMEOUT:
            await self._handle_timeout(payload, sig_verified=sig_verified)
        elif tag == TAG_TC:
            await self._handle_tc(payload, sigs_verified=sig_verified)
        elif tag == TAG_RECONFIG:
            await self._handle_reconfig(payload)
        else:
            self.log.error("Unexpected protocol message tag %s in core", tag)

    async def _timer_pump(self) -> None:
        """Feeds round-timer expiries into the merged event queue.  The
        ack handshake keeps the pump from re-firing before the core has
        HANDLED the event (the handler resets the deadline — or a
        message did, making the fire stale; either way the next wait()
        sleeps)."""
        while True:
            await self.timer.wait()
            self._timer_ack.clear()
            await self.rx_events.put((EV_TIMER, None))
            await self._timer_ack.wait()

    async def run(self) -> None:
        await self.load_state()

        # Snapshot catch-up BEFORE entering the protocol: adopt a
        # QC-anchored peer snapshot and jump the commit cursor past the
        # missed history, so the first post-rejoin commit's ancestor
        # walk spans only the sync window — never the outage (the
        # "no history replay" half of state-sync; statesync.py).
        if self.state_sync is not None:
            try:
                adopted = await self.state_sync.bootstrap(
                    self.last_committed_round
                )
            except Exception as e:  # noqa: BLE001 — catch-up is an
                # optimization; any failure degrades to normal replay
                self.log.warning("State-sync bootstrap failed: %s", e)
                adopted = 0
            if adopted > self.last_committed_round:
                self.log.info(
                    "State sync advanced commit cursor %d -> %d "
                    "(history replay skipped)",
                    self.last_committed_round,
                    adopted,
                )
                self.last_committed_round = adopted
                self.state_changed = True

        # Epoch tracking starts at the CURRENT round's committee — only
        # now, after recovery and any state-sync schedule splices, so a
        # restart inside a later epoch does not replay old activations.
        com_now = self.committee.for_round(self.round)
        self._active_epoch = com_now.epoch
        if com_now.stake(self.name) <= 0:
            # restarted AFTER a boundary that excluded us (the live
            # crossing in _activate_epoch never fired): retire unless a
            # later scheduled epoch re-admits us (then we are a joiner)
            epochs = self.committee.committees()
            rejoins = any(
                c.stake(self.name) > 0 and c.epoch > com_now.epoch
                for c in epochs
            )
            was_member = any(c.stake(self.name) > 0 for c in epochs)
            if was_member and not rejoins and self._retire_after is None:
                self._retire_after = self.round + self._grace_rounds
                self.log.info(
                    "Retiring: epoch %d excludes this node; serving a "
                    "grace window through round %d",
                    com_now.epoch, self._retire_after,
                )

        # Bootstrap: propose if we lead the (possibly recovered) round.
        self.timer.reset()
        if self.name == self.leader_elector.get_leader(self.round):
            await self._generate_proposal(None)

        timer_pump = asyncio.ensure_future(self._timer_pump())
        try:
            while True:
                event = await self.rx_events.get()
                if self.retired:
                    # retired member: drain events without processing so
                    # the receiver never backpressures, while the Helper
                    # keeps serving boundary blocks
                    while True:
                        try:
                            self.rx_loopback.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                    continue
                # Burst drain: everything already queued is handled in
                # this wake-up.  Network messages are collected FIRST so
                # the whole wave's signature checks discharge as ONE
                # coalesced claim batch (_preverify_burst) — off-loop on
                # the device backend.  Bounded so a flood cannot starve
                # the timer.
                burst: list = []
                timer_fired = False
                while True:
                    kind, payload = event
                    if kind == EV_MSG:
                        burst.append(payload)
                    elif kind == EV_TIMER:
                        timer_fired = True
                    # EV_LOOP events are bare wake tokens — the blocks
                    # live in the priority loopback queue drained below
                    if len(burst) >= 64:
                        break
                    try:
                        event = self.rx_events.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                # Priority drain of the loopback channel EVERY iteration
                # (own proposals, sync-resumed orphans): never behind
                # the network backlog — the reference's select services
                # this branch on every wake-up.
                loops: list = []
                for _ in range(64):
                    try:
                        loops.append(self.rx_loopback.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                else:
                    # capped drain left blocks queued whose wake tokens
                    # this iteration may already have consumed — re-arm
                    # one so an otherwise-idle loop cannot strand them
                    # until the round timer (review finding, r5)
                    if self.rx_loopback.qsize() > 0:
                        try:
                            self.rx_events.put_nowait((EV_LOOP, None))
                        except asyncio.QueueFull:
                            pass
                if burst:
                    preverified = await self._preverify_burst(burst)
                    for idx, message in enumerate(burst):
                        try:
                            await self._dispatch(
                                message, sig_verified=idx in preverified
                            )
                        except ConsensusError as e:
                            self.log.warning("%s", e)
                for block in loops:
                    try:
                        await self._process_block(block)
                    except ConsensusError as e:
                        self.log.warning("%s", e)
                # Timeout check runs EVERY iteration, not only when the
                # pump's EV_TIMER event drains: a message flood filling
                # the merged queue must delay the local timeout by at
                # most one <=64-message batch (the old select loop's
                # bound), never by the whole backlog the pump's event
                # would sit behind.  The pump exists to wake an IDLE
                # loop; expiry detection does not depend on it.
                if self.timer.expired():
                    try:
                        await self._local_timeout_round()
                    except ConsensusError as e:
                        self.log.warning("%s", e)
                if timer_fired:
                    self._timer_ack.set()
                if (
                    self._retire_after is not None
                    and not self.retired
                    and self.round >= self._retire_after
                ):
                    self.retired = True
                    # NOTE: this log entry is used by the reconfig harness.
                    self.log.info(
                        "Retired at round %d (grace window complete)",
                        self.round,
                    )
                    if self._journal is not None:
                        self._journal.record("reconfig.retire", self.round)
                        self._journal.flush()
                if self.state_changed:
                    await self.persist_state()
                    self.state_changed = False
        finally:
            timer_pump.cancel()

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.get_running_loop().create_task(
            self.run(), name="consensus-core"
        )
        return self._task

    def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.network.close()
