"""Consensus wiring: builds the channel topology and spawns all actors.

Parity target: reference ``Consensus::spawn`` + ``ConsensusReceiverHandler``
(consensus/src/consensus.rs:42-169). Topology:

    NetworkReceiver -> {core, helper, producer->proposer}
    Core <-> Proposer (Make/Cleanup, loopback)
    Synchronizer -> Core (loopback)
    Core -> tx_commit (application layer)

Dispatch rules (consensus.rs:133-168): SyncRequest -> helper;
Propose -> ACK on the same socket, then core; Producer -> ACK, then
proposer; Vote/Timeout/TC -> core, no ACK; StateRequest -> the
state-sync server; StateManifest/StateChunk -> the boot-time sync
client; StateRead -> answered inline from the execution layer.

A copy of ``hotstuff_tpu.consensus.consensus`` with the asyncio and
native transports, join mode included (``HOTSTUFF_RECONFIG_LISTEN``: a
key outside the committee listens there and bootstraps through state
sync), and the receiver's native producer-v2 fast path
(``dispatch_producer_v2``), and the telemetry seams: the handler's
per-tag counters, drop counter and journaled receive edges, the
execution layer's, payload store's and admission's gauges, and every
actor's telemetry handle, WAN emulation (``HOTSTUFF_WAN_SPEC`` on the
asyncio transport, ``network/wan.py``), the chaos plane
(``HOTSTUFF_FAULTS`` on both transports, ``faults/plane.py``: every
sender and the receiver get the plane, a ``fault-clock`` task walks its
windows, and with telemetry on the ``fault_*`` gauges and the
``fault_plane`` snapshot section), the adversary plane
(``HOTSTUFF_ADVERSARY`` on both transports, ``faults/adversary.py``: the
core, the proposer and the state-sync server get the plane of a node the
spec names, an ``adversary-clock`` task walks its windows, with telemetry
on the ``byz_*`` gauges and the ``adversary`` snapshot section) and
wire-level flow accounting (on with telemetry unless ``HOTSTUFF_NET=0``,
``telemetry/flows.py``).
Not ported, so cut: the sim transport.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..crypto import Digest, PublicKey, SignatureService
from ..crypto.service import CpuVerifier, VerifierBackend
from ..ingest import AdmissionController, Decision
from ..network import Receiver as NetworkReceiver
from ..network import ReliableSender, SimpleSender, Writer
from ..network.pool import parse_max_conns
from ..store import Store
from ..store.state import StateMachine
from .config import Committee, Parameters
from .core import CONSENSUS_STATE_KEY, Core, make_event_channels
from .errors import SerializationError
from .helper import Helper
from .leader import LeaderElector
from .proposer import Proposer
from .statesync import StateSyncClient, StateSyncServer
from .synchronizer import Synchronizer
from .wire import (
    ACK,
    SCHEME_WIRE_SIZES,
    STATE_READ_LEDGER,
    TAG_PRODUCER,
    TAG_PRODUCER_V2,
    TAG_PROPOSE,
    TAG_RECONFIG,
    TAG_STATE_CHUNK,
    TAG_STATE_MANIFEST,
    TAG_STATE_READ,
    TAG_STATE_REQUEST,
    TAG_SYNC_REQUEST,
    TAG_TC,
    TAG_TIMEOUT,
    TAG_VOTE,
    decode_message,
    encode_ingest_ack,
    encode_state_value,
)

log = logging.getLogger(__name__)

CHANNEL_CAPACITY = 1_000


PAYLOAD_KEY_PREFIX = b"p"  # store namespace for payload bodies


def payload_key(digest) -> bytes:
    """Store key of a payload body (33 bytes — disjoint from the
    32-byte block-digest key space)."""
    return PAYLOAD_KEY_PREFIX + digest.to_bytes()


class PayloadBodies:
    """Budgeted store-backed cache of producer payload bodies.

    Advisor finding (r4): the receiver persisted arbitrary
    unauthenticated bodies with no quota — any peer reaching the open
    consensus port could fill the disk with unique content-addressed
    bodies.  Bodies are now admitted against a byte budget
    (``Parameters.payload_body_budget``); while a body's digest is
    uncommitted it stays evictable (oldest first, FIFO — the shape an
    honest backlog drains in), and once the digest appears in a
    committed block the body is history and leaves the evictable set.
    A restarted node starts with an empty evictable set: bodies
    persisted by a previous process are treated as history (the budget
    bounds what one process lifetime can be tricked into writing).
    """

    def __init__(self, store: Store, budget: int):
        self.store = store
        self.budget = budget
        self._pending: dict[bytes, int] = {}  # digest bytes -> body size
        self._pending_bytes = 0
        self.evicted = 0

    async def admit(self, digest, body: bytes) -> None:
        key = digest.to_bytes()
        if key in self._pending:
            return  # same content, already stored and accounted
        # A body already in the store is history (committed earlier, or
        # persisted by a previous process lifetime): a replayed producer
        # frame must NOT re-enter it into the evictable set — that would
        # let an attacker replay a committed payload and then flood the
        # budget until its committed body was deleted.
        if await self.store.read(payload_key(digest)) is not None:
            return
        if key in self._pending:
            return  # re-check: a concurrent admit won the race
        # Reserve before mutating the store so accounting can never
        # double-count.  (Store operations complete without yielding to
        # the event loop today — the awaits above/below are synchronous
        # — but this ordering stays correct if the store ever parks.)
        self._pending[key] = len(body)
        self._pending_bytes += len(body)
        while self._pending_bytes > self.budget and len(self._pending) > 1:
            oldest = next(iter(self._pending))
            if oldest == key:
                # never evict the body being admitted: the budget floor
                # (>= one maximum body, config validation) makes a sole
                # pending entry always fit
                break
            self._pending_bytes -= self._pending.pop(oldest)
            await self.store.delete(PAYLOAD_KEY_PREFIX + oldest)
            self.evicted += 1
        await self.store.write(payload_key(digest), body)

    def mark_committed(self, digests) -> None:
        """Bodies of committed payloads stop counting against (and being
        evictable under) the budget."""
        for d in digests:
            size = self._pending.pop(d.to_bytes(), None)
            if size is not None:
                self._pending_bytes -= size


class ConsensusReceiverHandler:
    #: wire tag -> label on the received-message counters (index == tag)
    TAG_NAMES = (
        "propose", "vote", "timeout", "tc", "sync_request", "producer",
        "producer_v2", "state_request", "state_manifest", "state_chunk",
        "state_read", "reconfig",
    )

    def __init__(
        self,
        tx_consensus: asyncio.Queue,
        tx_helper: asyncio.Queue,
        tx_producer: asyncio.Queue,
        scheme: str | None = None,
        bodies: PayloadBodies | None = None,
        telemetry=None,
        admission=None,
        tx_state_requests: asyncio.Queue | None = None,
        tx_state_sync: asyncio.Queue | None = None,
        state=None,
        committee=None,
    ):
        self.tx_consensus = tx_consensus
        self.tx_helper = tx_helper
        self.tx_producer = tx_producer
        # Epoch schedule (docs/RECONFIG.md): a committed reconfiguration
        # can widen the set of signature schemes on the wire, so the
        # decode-time scheme narrowing is re-derived whenever the
        # schedule's splice generation moves.
        self._committee = committee
        self._scheme_gen = (
            getattr(committee, "generation", None)
            if committee is not None
            else None
        )
        # State-sync plumbing (consensus/statesync.py): peer snapshot
        # requests go to the server actor; manifest/chunk replies go to
        # the boot-time sync client.  ``state`` is the node's
        # StateMachine, consulted inline for TAG_STATE_READ (the
        # QC-anchored stale-read path — a lagging node answers at its
        # last applied version while it catches up).
        self.tx_state_requests = tx_state_requests
        self.tx_state_sync = tx_state_sync
        self.state = state
        # Ingest admission controller (ingest/admission.py): every
        # producer frame consults it; None keeps the legacy
        # always-accept path (bare component tests).
        self.admission = admission
        # fail at construction (node boot), not per-message in dispatch
        if scheme is not None and scheme not in SCHEME_WIRE_SIZES:
            raise ValueError(f"unknown committee scheme '{scheme}'")
        self.scheme = scheme
        self.bodies = bodies
        # Per-tag received counters, built once at boot (telemetry on) so
        # the dispatch hot path is one tuple index + int add, no lookups.
        self._msg_counters = None
        self._dropped = None
        # flight recorder: receive edges are journaled HERE (post-decode)
        # rather than at the socket, so each record carries the decoded
        # (round, digest, author) — exactly what the cross-node offset
        # estimation in benchmark/traces.py matches against send records
        self._journal = telemetry.journal if telemetry is not None else None
        if telemetry is not None:
            self._msg_counters = tuple(
                telemetry.registry.counter(
                    "net_messages_received",
                    "Consensus messages received, by wire tag",
                    {**telemetry.labels, "tag": tag_name},
                )
                for tag_name in self.TAG_NAMES
            )
            self._dropped = telemetry.counter(
                "net_messages_dropped",
                "Received frames dropped (malformed or poisoned payload)",
            )

    async def dispatch(self, writer: Writer, message: bytes) -> None:
        com = self._committee
        if com is not None:
            gen = getattr(com, "generation", None)
            if gen != self._scheme_gen:
                self._scheme_gen = gen
                self.scheme = com.wire_scheme()
        try:
            tag, payload = decode_message(message, scheme=self.scheme)
        except SerializationError as e:
            log.warning("Dropping malformed message: %s", e)
            if self._dropped is not None:
                self._dropped.inc()
            return
        if self._msg_counters is not None and tag < len(self._msg_counters):
            self._msg_counters[tag].inc()
        j = self._journal
        if j is not None:
            if tag == TAG_PROPOSE:
                j.record(
                    "recv.propose",
                    payload.round,
                    payload.digest(),
                    str(payload.author)[:8],
                )
            elif tag == TAG_VOTE:
                j.record(
                    "recv.vote",
                    payload.round,
                    payload.hash,
                    str(payload.author)[:8],
                )
            elif tag == TAG_TIMEOUT:
                j.record(
                    "recv.timeout",
                    payload.round,
                    None,
                    str(payload.author)[:8],
                )
            elif tag == TAG_TC:
                j.record("recv.tc", payload.round)
            elif tag == TAG_SYNC_REQUEST:
                j.record("recv.sync_req", 0, payload[0], str(payload[1])[:8])
            elif tag == TAG_PRODUCER:
                # producer-channel edge: lets traces attribute payload
                # starvation vs consensus stall
                j.record("recv.producer", 0, payload[0], "client")
            elif tag == TAG_PRODUCER_V2:
                # sampled: the batch's first digest stands for the frame
                j.record("recv.producer", 0, payload[0][0], "client")
            elif tag == TAG_STATE_REQUEST:
                j.record(
                    "recv.state_req",
                    payload.from_round,
                    None,
                    str(payload.origin)[:8],
                )
            elif tag == TAG_RECONFIG:
                j.record(
                    "recv.reconfig",
                    0,
                    None,
                    str(payload.sponsor)[:8],
                )
        if tag == TAG_SYNC_REQUEST:
            await self.tx_helper.put(payload)
        elif tag == TAG_PROPOSE:
            try:
                await writer.send(ACK)
            except (ConnectionError, OSError):
                pass
            await self.tx_consensus.put((tag, payload))
        elif tag == TAG_PRODUCER:
            digest, body = payload
            if body:
                # content addressing: a body that doesn't hash to its
                # digest is a poisoned submission — drop it (no ACK)
                if Digest.of(body) != digest:
                    log.warning(
                        "Dropping producer payload whose body does not "
                        "match its digest"
                    )
                    return
            if self.admission is not None:
                decision = self.admission.admit(1)
                if decision.shed:
                    # typed BUSY instead of a silent drop: the legacy
                    # b"Ack" stays byte-compatible on the accept path,
                    # v1 clients that don't parse the busy frame just
                    # discard it and retry at their own pace
                    try:
                        await writer.send(
                            encode_ingest_ack(
                                0,
                                decision.shed,
                                decision.credit,
                                decision.retry_after_ms,
                            )
                        )
                    except (ConnectionError, OSError):
                        pass
                    return
            if body and self.bodies is not None:
                await self.bodies.admit(digest, body)
            try:
                await writer.send(ACK)
            except (ConnectionError, OSError):
                pass
            await self.tx_producer.put(digest)
        elif tag == TAG_PRODUCER_V2:
            # content addressing first: poisoned items are dropped and
            # never consume admission credit (a client can't burn the
            # committee's window with garbage bodies)
            valid = []
            for digest, body in payload:
                if body and Digest.of(body) != digest:
                    log.warning(
                        "Dropping batched producer payload whose body "
                        "does not match its digest"
                    )
                    if self._dropped is not None:
                        self._dropped.inc()
                    continue
                valid.append((digest, body))
            if self.admission is not None:
                decision = self.admission.admit(len(valid))
            else:
                decision = Decision(len(valid), 0, 0, 0)
            # the accepted prefix enters; the shed suffix is the
            # client's to resubmit after retry_after_ms (order is
            # preserved on the wire, so "first N" is well-defined)
            for digest, body in valid[: decision.accepted]:
                if body and self.bodies is not None:
                    await self.bodies.admit(digest, body)
                await self.tx_producer.put(digest)
            try:
                await writer.send(
                    encode_ingest_ack(
                        decision.accepted,
                        decision.shed,
                        decision.credit,
                        decision.retry_after_ms,
                    )
                )
            except (ConnectionError, OSError):
                pass
        elif tag == TAG_STATE_REQUEST:
            if self.tx_state_requests is not None:
                await self.tx_state_requests.put(payload)
        elif tag in (TAG_STATE_MANIFEST, TAG_STATE_CHUNK):
            # replies matter only while the one-shot boot catch-up is
            # collecting; afterwards nothing drains the queue, so late
            # frames are shed instead of wedging the receiver on a put
            if self.tx_state_sync is not None:
                try:
                    self.tx_state_sync.put_nowait((tag, payload))
                except asyncio.QueueFull:
                    pass
        elif tag == TAG_STATE_READ:
            await self._serve_state_read(writer, payload)
        else:
            await self.tx_consensus.put((tag, payload))

    async def dispatch_producer_v2(
        self, writer: Writer, frame: bytes, digests: bytes, spans: list
    ) -> None:
        """Zero-copy ingest fast path for batched producer frames: the
        native parser already checked the wire bounds and emitted the
        digest column plus ``(offset, length)`` body windows into
        ``frame``, so this mirrors the TAG_PRODUCER_V2 branch of
        ``dispatch`` without building per-item payload tuples — bodies
        stay memoryview windows and only ACCEPTED items materialize
        bytes for the body store.  Any frame the native parser rejects
        takes the normal decode path instead of this one."""
        if self._msg_counters is not None and TAG_PRODUCER_V2 < len(
            self._msg_counters
        ):
            self._msg_counters[TAG_PRODUCER_V2].inc()
        mv = memoryview(frame)
        j = self._journal
        if j is not None and spans:
            # sampled: the batch's first digest stands for the frame
            j.record("recv.producer", 0, Digest(bytes(digests[:32])), "client")
        valid = []
        for i, (off, ln) in enumerate(spans):
            digest = Digest(bytes(digests[i * 32 : (i + 1) * 32]))
            body = mv[off : off + ln]
            if ln and Digest.of(body) != digest:
                log.warning(
                    "Dropping batched producer payload whose body "
                    "does not match its digest"
                )
                if self._dropped is not None:
                    self._dropped.inc()
                continue
            valid.append((digest, body))
        if self.admission is not None:
            decision = self.admission.admit(len(valid))
        else:
            decision = Decision(len(valid), 0, 0, 0)
        for digest, body in valid[: decision.accepted]:
            if len(body) and self.bodies is not None:
                await self.bodies.admit(digest, bytes(body))
            await self.tx_producer.put(digest)
        try:
            await writer.send(
                encode_ingest_ack(
                    decision.accepted,
                    decision.shed,
                    decision.credit,
                    decision.retry_after_ms,
                )
            )
        except (ConnectionError, OSError):
            pass

    async def _serve_state_read(self, writer: Writer, payload) -> None:
        """QC-anchored stale read: answer at the last applied version —
        by construction while catching up, too — with the anchor
        (version, root, last_round) in the reply."""
        space, key = payload
        state = self.state
        if state is None:
            reply = encode_state_value(False, 0, b"\x00" * 32, 0, 0, b"")
        else:
            version, root, last_round = state.anchor()
            found, entry_round, value = False, 0, b""
            if space == STATE_READ_LEDGER:
                hit = state.read_ledger(key)
                if hit is not None:
                    entry_round, seq = hit
                    found, value = True, seq.to_bytes(4, "little")
            else:
                hit = state.read_user(key)
                if hit is not None:
                    entry_round, value = hit
                    found = True
            reply = encode_state_value(
                found, version, root, last_round, entry_round, value
            )
        try:
            await writer.send(reply)
        except (ConnectionError, OSError):
            pass


class Consensus:
    """Owns the spawned actor stack of one node's protocol engine."""

    def __init__(self):
        self.receiver: NetworkReceiver | None = None
        self.core: Core | None = None
        self.proposer: Proposer | None = None
        self.helper: Helper | None = None
        self.synchronizer: Synchronizer | None = None
        self.tx_producer: asyncio.Queue | None = None
        self.admission = None
        self.state_machine = None
        self.state_server = None
        self._tasks: list[asyncio.Task] = []

    @classmethod
    async def spawn(
        cls,
        name: PublicKey,
        committee: Committee,
        parameters: Parameters,
        signature_service: SignatureService,
        store: Store,
        tx_commit: asyncio.Queue,
        verifier: VerifierBackend | None = None,
        bind_host: str = "0.0.0.0",
        transport: str = "asyncio",
        telemetry=None,
    ) -> "Consensus":
        """Spawn one node's stack.  ``transport`` is ``"asyncio"`` or
        ``"native"`` (the C++ reactor of ``network/native.py``: a
        library that cannot build raises here, never a quiet fall back
        to asyncio); the simulator's ``"sim"`` is not ported."""
        if transport not in ("asyncio", "native"):
            raise NotImplementedError(
                f"the '{transport}' transport is not ported yet"
            )
        self = cls()
        # NOTE: this log entry is used to compute performance.
        parameters.log()
        # BLS committees: refuse to run without a valid proof of
        # possession per member — sum-of-keys QC verification is
        # rogue-key forgeable otherwise (see Authority.pop).
        committee.verify_pops()
        if verifier is None:
            verifier = CpuVerifier()

        payload_bodies = PayloadBodies(store, parameters.payload_body_budget)
        # Replicated execution layer (store/state.py): the commit path
        # applies every committed block through it; the receiver serves
        # QC-anchored stale reads from it; the state-sync actors below
        # snapshot it for crash-recovered peers.
        state_machine = StateMachine(store)
        self.state_machine = state_machine
        tx_state_requests: asyncio.Queue = asyncio.Queue(
            maxsize=CHANNEL_CAPACITY
        )
        tx_state_sync: asyncio.Queue = asyncio.Queue(maxsize=CHANNEL_CAPACITY)
        if telemetry is not None:
            telemetry.gauge(
                "state_version",
                "Applied state version (committed blocks folded into "
                "the state root)",
                fn=lambda s=state_machine: s.version,
            )
            telemetry.gauge(
                "state_last_round",
                "Round of the last block applied to the state machine",
                fn=lambda s=state_machine: s.last_round,
            )
            telemetry.gauge(
                "state_applied_payloads",
                "Payload digests folded into the replicated ledger",
                fn=lambda s=state_machine: s.applied_payloads,
            )
            telemetry.gauge(
                "state_typed_ops",
                "Typed user-KV operations materialized from local bodies",
                fn=lambda s=state_machine: s.typed_ops,
            )
            telemetry.gauge(
                "state_snapshots_served",
                "Snapshot manifests served to syncing peers",
                fn=lambda s=state_machine: s.snapshots_served,
            )
            telemetry.add_section("state", state_machine.stats)
        if telemetry is not None:
            telemetry.gauge(
                "payload_pending_bytes",
                "Uncommitted payload bodies held against the byte budget",
                fn=lambda b=payload_bodies: b._pending_bytes,
            )
            telemetry.gauge(
                "payload_evictions",
                "Payload bodies evicted under budget pressure",
                fn=lambda b=payload_bodies: b.evicted,
            )
            telemetry.add_section(
                "payload_bodies",
                lambda b=payload_bodies: {
                    "pending": len(b._pending),
                    "pending_bytes": b._pending_bytes,
                    "evicted": b.evicted,
                },
            )
        # Ingest admission controller (ingest/admission.py): constructed
        # before the receiver so the handler can consult it from the
        # first frame; bound to the proposer's buffer once the proposer
        # exists below (until then occupancy reads 0 — boot window).
        admission = AdmissionController(
            journal=telemetry.journal if telemetry is not None else None,
        )
        tx_producer: asyncio.Queue = asyncio.Queue(maxsize=CHANNEL_CAPACITY)
        # The core's three select sources merge into ONE event queue
        # (core.make_event_channels); producers keep channel-shaped
        # facades, so the topology the reference wires (consensus.rs:
        # 54-58) is unchanged from their side.  Capacity 2x: the merged
        # queue carries what two channels carried.
        rx_events, tx_consensus, tx_loopback = make_event_channels(
            2 * CHANNEL_CAPACITY
        )
        tx_proposer: asyncio.Queue = asyncio.Queue(maxsize=CHANNEL_CAPACITY)
        tx_helper: asyncio.Queue = asyncio.Queue(maxsize=CHANNEL_CAPACITY)
        self.tx_producer = tx_producer

        address = committee.address(name)
        joining = False
        if address is None:
            # Join mode (docs/RECONFIG.md): a node whose key is not yet
            # in any scheduled committee may boot against a peer's
            # committee file, state-sync the certified schedule in, and
            # start voting once a committed reconfiguration admits it.
            listen = os.environ.get("HOTSTUFF_RECONFIG_LISTEN")
            if not listen:
                raise ValueError(
                    "Our public key is not in the committee (set "
                    "HOTSTUFF_RECONFIG_LISTEN=host:port to join via a "
                    "certified reconfiguration)"
                )
            host, _, port = listen.rpartition(":")
            address = (host or "127.0.0.1", int(port))
            joining = True
            log.info(
                "Join mode: key not in the committee yet; listening on "
                "%s:%d and awaiting a certified schedule",
                address[0],
                address[1],
            )
        # WAN emulation (HOTSTUFF_WAN_SPEC, network/wan.py): per-link
        # propagation delay on every node->node sender — the committee
        # experiences the reference's 5-region topology on localhost.
        # asyncio transport only (the native reactor does its own I/O).
        # An unreadable or malformed spec raises here.
        link_delay = None
        wan_spec = os.environ.get("HOTSTUFF_WAN_SPEC")
        if wan_spec and transport != "native":
            from ..network.wan import WanModel

            model = WanModel.load(wan_spec, address)
            log.info(
                "WAN emulation active: region %s", model.self_region
            )

            def link_delay(dst, _model=model):  # noqa: E731 — closure
                return lambda: _model.delay(dst)

        # Chaos plane (HOTSTUFF_FAULTS, faults/plane.py): seeded
        # deterministic fault injection, threaded through every sender
        # the same way link_delay is.  Works on both transports.  An
        # unreadable spec raises here; a spec that does not name this
        # node leaves the plane inert.
        fault_plane = None
        faults_spec = os.environ.get("HOTSTUFF_FAULTS")
        if faults_spec:
            from ..faults import FaultPlane

            fault_plane = FaultPlane.load(faults_spec, address)
            log.info("Fault plane active: %s", fault_plane.describe())

        # Byzantine adversary plane (HOTSTUFF_ADVERSARY, faults/
        # adversary.py): protocol-level attack injection at the
        # proposer/core seams.  The spec is shared committee-wide (the
        # chaos runner points it at the same file as HOTSTUFF_FAULTS);
        # the plane stays inert unless it names this node.  An
        # unreadable spec raises here.
        adversary = None
        adversary_spec = os.environ.get("HOTSTUFF_ADVERSARY")
        if adversary_spec:
            from ..faults import AdversaryPlane

            plane = AdversaryPlane.load(adversary_spec, address)
            if plane.enabled:
                adversary = plane
                adversary.bind(committee, name)
                log.info("Adversary plane active: %s", adversary.describe())

        # Wire-level flow accounting (telemetry/flows.py): one
        # accountant per node, threaded through every sender and the
        # receiver — each frame charged to a (peer, direction, class)
        # flow at its transmit/receive site, surfaced as the snapshot's
        # ``flows`` section.
        flows = None
        if telemetry is not None:
            from ..telemetry.flows import FlowAccounting

            flows = FlowAccounting(node=str(name))
            flows.label_peers(
                (str(peer)[:8], addr)
                for peer, addr in committee.broadcast_addresses(name)
            )
            telemetry.attach_flows(flows)

        if transport == "native":
            from ..network.native import (
                NativeReceiver,
                NativeReliableSender,
                NativeSimpleSender,
            )

            receiver_cls = NativeReceiver

            def make_sender():
                return NativeSimpleSender(fault_plane=fault_plane, flows=flows)

            def make_reliable():
                return NativeReliableSender(
                    fault_plane=fault_plane, flows=flows
                )
        else:
            receiver_cls = NetworkReceiver
            # Bounded per-sender connection pools for big co-located
            # committees (absent/non-positive = reference parity,
            # unbounded)
            max_conns = parse_max_conns(
                os.environ.get("HOTSTUFF_MAX_PEER_CONNS")
            )

            def make_sender():
                return SimpleSender(
                    link_delay=link_delay,
                    max_conns=max_conns,
                    fault_plane=fault_plane,
                    flows=flows,
                )

            def make_reliable():
                return ReliableSender(
                    link_delay=link_delay,
                    max_conns=max_conns,
                    fault_plane=fault_plane,
                    flows=flows,
                )

        # Bind on all interfaces, listen on our committee port
        # (consensus.rs:61-73 rewrites the IP to 0.0.0.0).
        self.receiver = receiver_cls(
            bind_host,
            address[1],
            ConsensusReceiverHandler(
                tx_consensus, tx_helper, tx_producer,
                # mixed-scheme schedules accept the union on the wire
                scheme=committee.wire_scheme(),
                bodies=payload_bodies,
                telemetry=telemetry,
                admission=admission,
                tx_state_requests=tx_state_requests,
                tx_state_sync=tx_state_sync,
                state=state_machine,
                committee=committee,
            ),
            fault_plane=fault_plane,
            flows=flows,
        )
        await self.receiver.spawn()
        log.info(
            "Node %s listening to consensus messages on %s:%d",
            name,
            bind_host,
            address[1],
        )

        if fault_plane is not None:
            from ..faults import run_clock

            journal = telemetry.journal if telemetry is not None else None
            self._tasks.append(
                asyncio.get_running_loop().create_task(
                    run_clock(fault_plane, journal),
                    name="fault-clock",
                )
            )
            if telemetry is not None:
                for count_name, help_text in (
                    ("dropped", "Frames dropped by the fault plane"),
                    ("delayed", "Frames delayed by the fault plane"),
                    ("duplicated", "Frames duplicated by the fault plane"),
                    ("corrupted", "Frames corrupted by the fault plane"),
                    (
                        "inbound_dropped",
                        "Inbound frames swallowed during isolate windows",
                    ),
                ):
                    telemetry.gauge(
                        f"fault_{count_name}",
                        help_text,
                        fn=lambda p=fault_plane, k=count_name: p.counts[k],
                    )
                telemetry.add_section("fault_plane", fault_plane.stats)

        if adversary is not None:
            from ..faults import run_adversary_clock, run_flood

            journal = telemetry.journal if telemetry is not None else None
            adversary.journal = journal
            loop = asyncio.get_running_loop()
            self._tasks.append(
                loop.create_task(
                    run_adversary_clock(adversary, journal),
                    name="adversary-clock",
                )
            )
            if any(r.policy == "flood" for r in adversary.my_rules):
                self._tasks.append(
                    loop.create_task(
                        run_flood(adversary, committee, name),
                        name="adversary-flood",
                    )
                )
            if telemetry is not None:
                for count_name, help_text in (
                    ("byz_equivocations", "Conflicting blocks signed"),
                    ("byz_forged_qcs", "Forged QCs shipped"),
                    ("byz_votes_withheld", "Votes withheld"),
                    ("byz_double_votes", "Conflicting votes cast"),
                    ("byz_floods", "Garbage bursts sent"),
                    ("byz_shadow_commits", "Shadow-branch commits logged"),
                    ("byz_forged_reconfigs", "Forged reconfig ops proposed"),
                    ("byz_shadow_epochs", "Skewed epoch activations logged"),
                    ("byz_flood_accepted", "Flood payloads the victim admitted"),
                    ("byz_flood_shed", "Flood payloads the victim shed"),
                    ("byz_adapt_ambush", "ambush-leader trigger firings"),
                    ("byz_adapt_sync", "sync-predator trigger firings"),
                    ("byz_adapt_surf", "timeout-surfer trigger firings"),
                    ("byz_adapt_snipe", "reconfig-sniper trigger firings"),
                ):
                    telemetry.gauge(
                        count_name,
                        help_text,
                        fn=lambda p=adversary, k=count_name: p.counts[k],
                    )
                telemetry.add_section("adversary", adversary.stats)

        leader_elector = LeaderElector(committee)
        self.synchronizer = Synchronizer(
            name,
            committee,
            store,
            tx_loopback,
            parameters.sync_retry_delay,
            network=make_sender(),
            telemetry=telemetry,
        )
        # Per-peer network gauges at EVERY committee size (no silent
        # caps): register_network caps the registered
        # gauge cardinality at PEER_GAUGE_MAX_COMMITTEE and counts the
        # rest in net_peers_elided — nothing is silently dropped.  All
        # four senders dial the same peer set (the broadcast
        # addresses); works for bare committees and epoch schedules
        # alike (union view).
        peers = None
        if telemetry is not None:
            peers = committee.broadcast_addresses(name)
        if telemetry is not None:
            telemetry.register_store(store)
            telemetry.register_network(
                "sync", self.synchronizer.network, peers=peers
            )
            telemetry.gauge(
                "sync_expired",
                "Parent-sync requests abandoned at the give-up deadline",
                fn=lambda s=self.synchronizer: s.expired,
            )

        self.core = Core(
            name,
            committee,
            signature_service,
            verifier,
            store,
            leader_elector,
            self.synchronizer,
            parameters.timeout_delay,
            timeout_backoff=parameters.timeout_backoff,
            timeout_cap_ms=parameters.timeout_cap_ms,
            rx_events=rx_events,
            rx_loopback=tx_loopback,
            tx_proposer=tx_proposer,
            tx_commit=tx_commit,
            network=make_sender(),
            payload_bodies=payload_bodies,
            telemetry=telemetry,
            state_machine=state_machine,
            adversary=adversary,
        )
        if adversary is not None:
            # Adaptive adversary state view (faults/adaptive.py): pure
            # reads of local protocol state, installed before any task
            # runs so triggers never observe a half-built node.  The
            # committee schedule and timer are read live — reconfig
            # splices and view-change backoff show through.
            adversary.bind_view({
                "round": lambda c=self.core: c.round,
                "leader": lambda r, le=leader_elector: le.get_leader(r),
                "self": lambda n=name: n,
                "last_tc_round": lambda c=self.core: c._last_tc_round,
                "timeout_ms": lambda c=self.core: c.timer.duration * 1000.0,
                "credit": lambda a=admission: a.last_credit,
                "boundaries": lambda c=committee: tuple(
                    r for r, _ in getattr(c, "entries", ()) if r > 0
                ),
            })
        # State-sync plane (statesync.py): every node serves snapshots;
        # a recovering node (surviving consensus state ⇒ this is a
        # restart, not a first boot) additionally runs the one-shot
        # boot catch-up before entering the protocol.  Modes:
        # HOTSTUFF_STATE_SYNC=auto (default: catch up when recovering),
        # always (also on a fresh join), 0/off (never).
        self.state_server = StateSyncServer(
            name,
            committee,
            state_machine,
            rx_requests=tx_state_requests,
            high_qc=lambda c=self.core: c.high_qc,
            network=make_sender(),
            telemetry=telemetry,
            store=store,
            adversary=adversary,
        )
        sync_mode = os.environ.get("HOTSTUFF_STATE_SYNC", "auto").lower()
        if sync_mode not in ("0", "off", "never"):
            recovering = (await store.read(CONSENSUS_STATE_KEY)) is not None
            if (recovering or joining or sync_mode == "always") and (
                committee.broadcast_addresses(name)
            ):
                self.core.state_sync = StateSyncClient(
                    name,
                    committee,
                    state_machine,
                    verifier,
                    rx_replies=tx_state_sync,
                    network=make_sender(),
                    # a joiner adopts whatever certified snapshot is on
                    # offer — its alternative is walking history it may
                    # not be able to fetch at all
                    min_lag=0 if joining else None,
                    telemetry=telemetry,
                    store=store,
                    synchronizer=self.synchronizer,
                )
        self._tasks.append(self.state_server.spawn())
        self._tasks.append(self.core.spawn())

        self.proposer = Proposer(
            name,
            committee,
            signature_service,
            rx_producer=tx_producer,
            rx_message=tx_proposer,
            tx_loopback=tx_loopback,
            network=make_reliable(),
            admission=admission,
            telemetry=telemetry,
            adversary=adversary,
        )
        self._tasks.append(self.proposer.spawn())
        self.admission = admission
        # Credit windows now track the real buffer: occupancy is the
        # proposer's pending map, capacity its (env-tunable) cap.
        admission.bind(
            lambda p=self.proposer: len(p.pending),
            capacity=self.proposer.max_pending,
        )
        if telemetry is not None:
            telemetry.gauge(
                "ingest_credit",
                "Current admission credit window (payloads)",
                fn=lambda a=admission: a.last_credit,
            )
            telemetry.gauge(
                "ingest_accepted",
                "Producer payloads admitted by the ingest plane",
                fn=lambda a=admission: a.accepted_total,
            )
            telemetry.gauge(
                "ingest_shed",
                "Producer payloads shed with a typed BUSY reply",
                fn=lambda a=admission: a.shed_total,
            )
            telemetry.gauge(
                "ingest_busy_frames",
                "Producer frames answered with a BUSY ingest ACK",
                fn=lambda a=admission: a.busy_frames,
            )
            telemetry.gauge(
                "ingest_connections",
                "Live accepted connections on the consensus port",
                fn=lambda r=self.receiver: getattr(r, "connections", 0),
            )
            # one section carries the whole admission story: the
            # controller's own counters plus the buffer's silent-drop
            # count (zero whenever backpressure is doing its job)
            telemetry.add_section(
                "ingest",
                lambda a=admission, p=self.proposer: {
                    **a.stats(),
                    "drop_newest": p.drop_newest,
                },
            )

        self.helper = Helper(
            committee,
            store,
            rx_requests=tx_helper,
            network=make_sender(),
            telemetry=telemetry,
        )
        self._tasks.append(self.helper.spawn())
        if telemetry is not None:
            telemetry.register_network("core", self.core.network, peers=peers)
            telemetry.register_network(
                "proposer", self.proposer.network, peers=peers
            )
            telemetry.register_network(
                "helper", self.helper.network, peers=peers
            )
        return self

    async def shutdown(self) -> None:
        if self.receiver is not None:
            await self.receiver.shutdown()
        for component in (
            self.core, self.proposer, self.helper, self.state_server,
        ):
            if component is not None:
                component.shutdown()
        if self.core is not None and self.core.state_sync is not None:
            # the one-shot catch-up's sender outlives its bootstrap: a
            # stack stopped in a process that goes on must not leave
            # its connections and their tasks behind
            self.core.state_sync.network.close()
        if self.synchronizer is not None:
            self.synchronizer.shutdown()
        for task in self._tasks:
            task.cancel()
        self._tasks.clear()
