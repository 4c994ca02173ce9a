"""State-sync actors: snapshot serving and boot-time catch-up.

The replicated execution layer (store/state.py) gives every node a
versioned, root-summarized state.  This module is the protocol on top:

- ``StateSyncServer`` — a Helper-style actor answering StateRequest
  frames from peers: a manifest (full or delta, anchored by this node's
  current high QC) or one snapshot chunk.

- ``StateSyncClient`` — the boot-time catch-up path.  A crash-recovered
  (or explicitly opted-in fresh) node broadcasts a manifest request,
  adopts the best QC-verified offer that is meaningfully ahead of its
  own cursor, fetches the chunks from that peer, and installs them.
  The core then advances ``last_committed_round`` to the snapshot
  round, so the commit-time ancestor walk never replays the missed
  history — rejoin cost is the snapshot transfer, not the outage
  length.

Trust model: a chained state root summarizes history the snapshot
deliberately omits, so it cannot be recomputed from snapshot content.
The client trusts a manifest only when its embedded QC verifies against
the client's own committee AND ``qc.round >= manifest.last_round`` —
i.e. some quorum certified progress at least as far as the offered
cursor.  A lying peer can still under-report (harmless: the delta apply
path re-derives everything deterministically) but cannot fabricate a
certified future.

Snapshot cuts are best-effort under concurrent commits: entries that
race a commit between manifest and chunk serving may shift chunks or
arrive from a newer version.  Duplicates are idempotent puts; anything
missed at rounds beyond the manifest cursor is re-materialized by the
normal apply path.

A copy of ``hotstuff_tpu.consensus.statesync`` with its flight-recorder
journal records and the adversary plane's seams (the sync-withhold
attack and prey sensing).  Requests, manifests, chunks, the acceptance
rule, the re-ask and the adoption are unchanged.  Added to the copy:
``StateSyncClient.outcome``, what the bootstrap saw and did, for
callers that report it.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..crypto import PublicKey
from ..utils.clock import SYSTEM_CLOCK, default_clock
from ..network import SimpleSender
from ..store.state import SnapshotManifest, StateMachine
from ..utils.codec import CodecError
from .config import Committee
from .errors import ConsensusError, InvalidReconfig
from .reconfig import splice_schedule_links
from .wire import (
    STATE_REQ_CHUNK,
    STATE_REQ_DELTA,
    STATE_REQ_MANIFEST,
    TAG_STATE_CHUNK,
    TAG_STATE_MANIFEST,
    StateRequest,
    decode_schedule_links,
    encode_schedule_links,
    encode_state_chunk,
    encode_state_manifest,
    encode_state_request,
)

log = logging.getLogger(__name__)

#: a manifest must be at least this many rounds ahead of the local
#: commit cursor to be worth adopting — below it, the ordinary commit
#: path catches up faster than a snapshot round-trip
SYNC_MIN_LAG_ROUNDS = 8
#: manifest collection window and chunk-transfer deadline (seconds)
SYNC_MANIFEST_WAIT_S = 1.0
SYNC_CHUNK_WAIT_S = 5.0
#: re-ask cadence for chunks still missing inside the transfer window —
#: a chunk request is a single frame, so one drop on a faulty link must
#: not wedge the whole sync until the deadline
SYNC_CHUNK_RETRY_S = 1.0
#: the reply wait wakes at least this often (seconds) to notice a stall
#: of the event loop, which it gives back to the window (on the system
#: clock only: see ``StateSyncClient._collect``)
SYNC_STALL_SLICE_S = 0.05


class StateSyncServer:
    """Answers peers' StateRequest frames from the local state machine,
    anchoring every manifest with this node's current high QC."""

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        state: StateMachine,
        rx_requests: asyncio.Queue,
        high_qc,
        network: SimpleSender | None = None,
        telemetry=None,
        store=None,
        adversary=None,
    ):
        self.name = name
        self.committee = committee
        self.state = state
        self.rx_requests = rx_requests
        self.high_qc = high_qc  # () -> the core's current high QC
        self.network = network if network is not None else SimpleSender()
        # consensus store (optional): source of the certified schedule
        # links served in the manifest so a joiner can verify epoch
        # changes it never witnessed (docs/RECONFIG.md)
        self.store = store
        # Byzantine adversary plane (faults/adversary.py): None on
        # honest nodes; the chunk-serving path below is the
        # sync-predator's attack seam (faults/adaptive.py)
        self.adversary = adversary
        self._journal = telemetry.journal if telemetry is not None else None
        self._task: asyncio.Task | None = None
        # per-node logger suffix: multi-node harnesses (sim, local
        # bench) route records to the right node-*.log by logger name
        self.log = logging.getLogger(f"{__name__}.{str(name)[:8]}")

    async def _schedule_links(self) -> tuple:
        if self.store is None:
            return ()
        from .core import SCHEDULE_LINKS_KEY

        raw = await self.store.read(SCHEDULE_LINKS_KEY)
        if not raw:
            return ()
        try:
            return tuple(decode_schedule_links(raw))
        except CodecError as e:
            log.warning("Corrupt schedule links in store: %s", e)
            return ()

    async def run(self) -> None:
        while True:
            req: StateRequest = await self.rx_requests.get()
            address = self.committee.address(req.origin)
            if address is None or req.origin == self.name:
                log.warning(
                    "Dropping state request from unknown origin %s",
                    req.origin,
                )
                continue
            if req.kind == STATE_REQ_CHUNK:
                adversary = self.adversary
                preys = (
                    adversary.wants("sync-withhold")
                    if adversary is not None else False
                )
                if preys:
                    # sync-predator (faults/adaptive.py): withhold
                    # exactly the chunks this bootstrapping peer needs —
                    # manifests still flow, so the victim commits to a
                    # sync it cannot finish until the window closes
                    adversary.mark_adaptive(
                        preys, req.from_round, self.log,
                    )
                    adversary.record(
                        "sync-withhold", req.from_round, None,
                        str(req.origin)[:8],
                    )
                    self.log.info(
                        "byz sync-withhold chunk %d from %s",
                        req.index, str(req.origin)[:8],
                    )
                    continue
                entries = self.state.chunk(req.index, req.from_round)
                reply = encode_state_chunk(
                    self.state.version, req.index, req.from_round, entries
                )
            else:
                from_round = (
                    req.from_round if req.kind == STATE_REQ_DELTA else 0
                )
                m = self.state.manifest(from_round)
                reply = encode_state_manifest(
                    m.version,
                    m.root,
                    m.last_round,
                    m.applied_payloads,
                    m.chunk_count,
                    from_round,
                    self.high_qc(),
                    self.name,
                    links=await self._schedule_links(),
                )
                self.state.snapshots_served += 1
                if self.adversary is not None:
                    # sync-predator prey sensing: this peer just began a
                    # snapshot bootstrap against us
                    self.adversary.note_syncing(req.origin)
                if self._journal is not None:
                    self._journal.record(
                        "sync.serve", m.last_round, None, str(req.origin)[:8]
                    )
            await self.network.send(address, reply)

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.get_running_loop().create_task(
            self.run(), name="state-sync-server"
        )
        return self._task

    def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.network.close()


class StateSyncClient:
    """One-shot boot-time catch-up.  ``bootstrap`` returns the adopted
    snapshot round (0 when nothing was adopted); the caller advances
    the consensus commit cursor past the snapshotted history."""

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        state: StateMachine,
        verifier,
        rx_replies: asyncio.Queue,
        network: SimpleSender | None = None,
        min_lag: int | None = None,
        manifest_wait_s: float | None = None,
        chunk_wait_s: float = SYNC_CHUNK_WAIT_S,
        telemetry=None,
        store=None,
        synchronizer=None,
    ):
        self.name = name
        self.committee = committee
        self.state = state
        self.verifier = verifier
        self.rx_replies = rx_replies
        self.network = network if network is not None else SimpleSender()
        # optional reconfiguration wiring (docs/RECONFIG.md): ``store``
        # persists verified schedule links so a restart re-derives the
        # epoch schedule without re-syncing; ``synchronizer`` gets its
        # join barrier raised to the adopted snapshot round
        self.store = store
        self.synchronizer = synchronizer
        if min_lag is None:
            min_lag = int(
                os.environ.get("HOTSTUFF_STATE_SYNC_LAG", SYNC_MIN_LAG_ROUNDS)
            )
        if manifest_wait_s is None:
            manifest_wait_s = (
                int(os.environ.get("HOTSTUFF_STATE_SYNC_WAIT_MS", 0)) / 1000
                or SYNC_MANIFEST_WAIT_S
            )
        self.min_lag = min_lag
        self.manifest_wait_s = manifest_wait_s
        self.chunk_wait_s = chunk_wait_s
        self._journal = telemetry.journal if telemetry is not None else None
        self._qc_cache: set = set()
        # what the last bootstrap saw and did (None before one ran)
        self.outcome: dict | None = None
        self.log = logging.getLogger(f"{__name__}.{str(name)[:8]}")

    async def _collect(self, deadline: float):
        """The next reply before ``deadline`` (loop time) and the deadline,
        moved on by any stall of the event loop meanwhile; (None, deadline)
        when the window closes first.  A stall — this task's wake-up
        coming late because other callbacks held the loop, as when the
        co-located peers' servers each scan their store for the requested
        manifest — does not count against the window: replies sent inside
        it are still read once the loop runs again.

        Under another ambient clock (the simulator's virtual one, whose
        loop never wakes a task late) the wait is the reference's single
        wait for the whole window: the slices' extra timers would only
        reorder callbacks due at one virtual instant."""
        loop = asyncio.get_running_loop()
        sliced = default_clock() is SYSTEM_CLOCK
        while True:
            now = loop.time()
            if now >= deadline:
                return None, deadline
            step = deadline - now
            if sliced:
                step = min(step, SYNC_STALL_SLICE_S)
            try:
                msg = await asyncio.wait_for(self.rx_replies.get(), timeout=step)
                return msg, deadline
            except asyncio.TimeoutError:
                late = loop.time() - now - step
                if late > SYNC_STALL_SLICE_S:
                    deadline += late

    async def _apply_schedule_links(self, links) -> bool:
        """Verified-successor acceptance (docs/RECONFIG.md): walk the
        certified ``(reconfig block, certifying QC)`` chain served in a
        manifest and splice every epoch change we have not seen yet into
        the local schedule.  Each link is self-certifying — the op is
        re-validated against the schedule *as extended so far* and the
        QC must certify exactly that block under the committee in effect
        at its round — so a joiner that booted with only the genesis
        committee file ends up with the same schedule a live witness
        holds, or rejects the manifest outright.  Returns False when any
        link fails verification (the offer is then discarded whole)."""
        if not links:
            return True
        if not hasattr(self.committee, "splice"):
            self.log.warning(
                "Ignoring %d schedule links: static committee", len(links)
            )
            return True
        try:
            splice_schedule_links(
                links,
                self.committee,
                self.verifier,
                qc_cache=self._qc_cache,
                journal=self._journal,
                log=self.log,
            )
        except InvalidReconfig as e:
            self.log.warning("Rejecting schedule links: %s", e)
            return False
        if self.store is not None:
            from .core import SCHEDULE_LINKS_KEY

            raw = await self.store.read(SCHEDULE_LINKS_KEY)
            have_n = 0
            if raw:
                try:
                    have_n = len(decode_schedule_links(raw))
                except CodecError:
                    have_n = 0
            if len(links) > have_n:
                await self.store.write(
                    SCHEDULE_LINKS_KEY, encode_schedule_links(list(links))
                )
        return True

    def _acceptable(self, m, from_round: int, floor: int) -> bool:
        if m.from_round != from_round or m.version <= self.state.version:
            return False
        if m.last_round <= floor + self.min_lag:
            return False
        if m.qc.is_genesis() or m.qc.round < m.last_round:
            return False
        if self.committee.address(m.origin) is None:
            return False
        try:
            m.qc.verify(self.committee, self.verifier, cache=self._qc_cache)
        except ConsensusError as e:
            self.log.warning("Rejecting state manifest with bad QC: %s", e)
            return False
        return True

    async def bootstrap(self, last_committed_round: int) -> int:
        peers = [
            addr for _, addr in self.committee.broadcast_addresses(self.name)
        ]
        if not peers:
            return 0
        started = default_clock().monotonic()
        floor = max(last_committed_round, self.state.last_round)
        # delta when local state survived the crash; full otherwise
        from_round = self.state.last_round
        kind = STATE_REQ_DELTA if from_round else STATE_REQ_MANIFEST
        outcome = self.outcome = {
            "kind": "delta" if from_round else "full",
            "from_round": from_round,
            "offers": 0,
            "adopted": False,
        }
        await self.network.broadcast(
            peers, encode_state_request(kind, self.name, from_round=from_round)
        )
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.manifest_wait_s
        best = None
        seen = 0
        while seen < len(peers):
            msg, deadline = await self._collect(deadline)
            if msg is None:
                break
            tag, payload = msg
            if tag != TAG_STATE_MANIFEST:
                continue  # stray chunk from a previous attempt
            seen += 1
            if self._journal is not None:
                self._journal.record(
                    "sync.manifest",
                    payload.last_round,
                    None,
                    str(payload.origin)[:8],
                )
            # schedule links first: _acceptable resolves the origin and
            # verifies the anchoring QC against the (possibly extended)
            # schedule, so a joiner must splice before judging the offer
            if not await self._apply_schedule_links(payload.links):
                continue
            if self._acceptable(payload, from_round, floor) and (
                best is None or payload.version > best.version
            ):
                best = payload
        outcome["offers"] = seen
        if best is None:
            self.log.info(
                "State sync: no snapshot ahead of round %d (%d offers)",
                floor,
                seen,
            )
            return 0

        address = self.committee.address(best.origin)
        pending = set(range(best.chunk_count))
        for index in pending:
            await self.network.send(
                address,
                encode_state_request(
                    STATE_REQ_CHUNK,
                    self.name,
                    index=index,
                    from_round=from_round,
                ),
            )
        entries: list = []
        outcome["chunk_count"] = best.chunk_count
        outcome["reasks"] = 0
        deadline = loop.time() + self.chunk_wait_s
        retry_at = loop.time() + SYNC_CHUNK_RETRY_S
        while pending:
            msg, _ = await self._collect(min(deadline, retry_at))
            if msg is None:
                now = loop.time()
                if now >= deadline:
                    break
                # a chunk ask is a single frame: when a faulty link eats
                # it, only a re-ask gets the transfer moving again
                for index in sorted(pending):
                    await self.network.send(
                        address,
                        encode_state_request(
                            STATE_REQ_CHUNK,
                            self.name,
                            index=index,
                            from_round=from_round,
                        ),
                    )
                retry_at = now + SYNC_CHUNK_RETRY_S
                outcome["reasks"] += 1
                continue
            tag, payload = msg
            if tag != TAG_STATE_CHUNK:
                continue
            if (
                payload.version < best.version
                or payload.from_round != from_round
                or payload.index not in pending
            ):
                continue
            pending.discard(payload.index)
            entries.extend(payload.entries)
            if self._journal is not None:
                self._journal.record("sync.chunk", payload.index)
        if pending:
            self.log.warning(
                "State sync abandoned: %d/%d chunks missing from %s",
                len(pending),
                best.chunk_count,
                str(best.origin)[:8],
            )
            return 0

        manifest = SnapshotManifest(
            best.version,
            best.root,
            best.last_round,
            best.applied_payloads,
            best.chunk_count,
        )
        self.state.adopt(manifest, entries)
        if self.synchronizer is not None:
            # ancestry at or below the snapshot is covered by the adopted
            # state; never walk it (critical on a join: the pre-snapshot
            # chain may predate this node's first reachable epoch)
            self.synchronizer.join_floor = max(
                self.synchronizer.join_floor, best.last_round
            )
        elapsed = default_clock().monotonic() - started
        if self._journal is not None:
            self._journal.record("sync.adopt", best.last_round)
        outcome.update(
            adopted=True,
            version=best.version,
            round=best.last_round,
            entries=len(entries),
            seconds=elapsed,
        )
        # NOTE: this log entry is used to compute performance.
        self.log.info(
            "Adopted state snapshot version %d at round %d from %s "
            "(%d entries, %.3f s)",
            best.version,
            best.last_round,
            str(best.origin)[:8],
            len(entries),
            elapsed,
        )
        return best.last_round
