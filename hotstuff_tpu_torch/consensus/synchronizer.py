"""Synchronizer: parent-block fetch and re-injection.

Parity target: reference ``Synchronizer`` (consensus/src/synchronizer.rs:
24-149). ``get_parent_block`` answers from the store, or — on a miss —
hands the orphan block to an inner task that (a) sends a SyncRequest to the
block's author, (b) parks a waiter on ``store.notify_read(parent)``, and
(c) re-broadcasts requests older than ``sync_retry_delay`` to the whole
committee every TIMER_ACCURACY tick (the "perfect point-to-point link"
retry, synchronizer.rs:84-105). When the parent is finally written, the
suspended child block is re-sent to the core via the loopback channel.

Beyond the reference: requests EXPIRE.  A parent digest that never
arrives (equivocating proposer, or a sender partitioned before anyone
stored the block) used to pin its waiter task, its ``_pending`` /
``_requests`` entries, and its store obligation forever, while
re-broadcasting to the whole committee every retry tick.  After
``sync_giveup`` seconds the request is abandoned: waiters are
cancelled, the suspended children are forgotten (a live chain re-sends
them via a later QC), and the store obligation is dropped.
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto import Digest, PublicKey
from ..network import SimpleSender
from ..store import Store
from ..utils.clock import default_clock
from .config import Committee
from .errors import SerializationError
from .messages import Block
from .wire import encode_sync_request

log = logging.getLogger(__name__)

TIMER_ACCURACY_S = 5.0


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        tx_loopback: asyncio.Queue,
        sync_retry_delay_ms: int,
        network: SimpleSender | None = None,
        telemetry=None,
    ):
        self.name = name
        self.committee = committee
        self.store = store
        self.tx_loopback = tx_loopback
        self.sync_retry_delay = sync_retry_delay_ms / 1000.0
        self.network = network if network is not None else SimpleSender()
        self._journal = telemetry.journal if telemetry is not None else None

        self.log = logging.getLogger(f"{__name__}.{str(name)[:8]}")
        self._pending: set[Digest] = set()  # child digests being synced
        # parent digest -> (first-ask time, child round, parent round):
        # the rounds make the retry broadcast epoch-targeted
        self._requests: dict[Digest, tuple[float, int, int]] = {}
        # Epoch-aware join barrier: set (by the state-sync client) to
        # the snapshot adoption round on a certified-schedule join —
        # ancestry below it is covered by the snapshot and must never
        # be fetched, whatever floor a caller passes.
        self.join_floor = 0
        self._waiters: set[asyncio.Task] = set()
        # give-up bookkeeping: which waiters/children each parent pins
        self._by_parent: dict[Digest, list[asyncio.Task]] = {}
        self._children: dict[Digest, set[Digest]] = {}
        # generous: far past any honest delivery, but bounded (a parent
        # that never arrives must not leak tasks or spam the committee)
        self.sync_giveup = max(30.0, 20 * self.sync_retry_delay)
        self.expired = 0  # abandoned requests (telemetry gauge)
        self._retry_task: asyncio.Task | None = None

    def _ensure_retry_task(self) -> None:
        if self._retry_task is None or self._retry_task.done():
            self._retry_task = asyncio.get_running_loop().create_task(
                self._retry_loop(), name="synchronizer-retry"
            )

    async def _retry_loop(self) -> None:
        while True:
            await default_clock().sleep(TIMER_ACCURACY_S)
            now = default_clock().monotonic()
            for digest, (asked_at, child_round, parent_round) in list(
                self._requests.items()
            ):
                if asked_at + self.sync_giveup < now:
                    self._expire(digest)
                elif asked_at + self.sync_retry_delay < now:
                    self.log.debug("Requesting sync for block %s (retry)", digest)
                    addresses = self._sync_targets(child_round, parent_round)
                    message = encode_sync_request(digest, self.name)
                    await self.network.broadcast(addresses, message)

    def _sync_targets(self, child_round: int, parent_round: int) -> list:
        """Retry-broadcast targets for a missing parent: the members of
        the child's epoch plus the parent's epoch (they differ exactly
        at a reconfiguration boundary — the retiring members are the
        ones guaranteed to hold the old-epoch block).  The all-epoch
        union would instead spam every past epoch's membership on each
        retry tick."""
        seen: dict = {}
        for r in (child_round, max(1, parent_round)):
            com = self.committee.for_round(r)
            for nm, addr in com.broadcast_addresses(self.name):
                seen.setdefault(nm, addr)
        return list(seen.values())

    def _expire(self, parent: Digest) -> None:
        """Abandon a parent that never arrived: unpin everything it
        holds.  The chain self-heals if the digest was real — a later
        block certifying it re-enters via get_parent_block."""
        self.expired += 1
        self._requests.pop(parent, None)
        for task in self._by_parent.pop(parent, ()):
            task.cancel()
        for child in self._children.pop(parent, ()):
            self._pending.discard(child)
        self.store.cancel_notify(parent.to_bytes())
        if self._journal is not None:
            self._journal.record("sync.expire", 0, parent)
        self.log.warning(
            "Giving up sync for parent %s after %.0fs", parent, self.sync_giveup
        )

    async def _waiter(self, parent: Digest, child: Block) -> None:
        """Park on the store until the parent exists, then loop the child
        block back into the core (synchronizer.rs:74-83, 115-118)."""
        try:
            await self.store.notify_read(parent.to_bytes())
        except asyncio.CancelledError:
            return
        self._pending.discard(child.digest())
        self._requests.pop(parent, None)
        if self._journal is not None:
            self._journal.record("sync.done", child.round, parent)
        await self.tx_loopback.put(child)

    async def _request_parent(self, block: Block) -> None:
        if block.digest() in self._pending:
            return
        self._pending.add(block.digest())
        parent = block.parent
        task = asyncio.get_running_loop().create_task(
            self._waiter(parent, block), name=f"sync-wait-{parent}"
        )
        self._waiters.add(task)
        self._by_parent.setdefault(parent, []).append(task)
        self._children.setdefault(parent, set()).add(block.digest())

        def _cleanup(t, parent=parent):
            self._waiters.discard(t)
            tasks = self._by_parent.get(parent)
            if tasks is not None:
                try:
                    tasks.remove(t)
                except ValueError:
                    pass
                if not tasks:
                    self._by_parent.pop(parent, None)
                    self._children.pop(parent, None)

        task.add_done_callback(_cleanup)

        if parent not in self._requests:
            self.log.debug("Requesting sync for block %s", parent)
            self._requests[parent] = (
                default_clock().monotonic(), block.round, block.qc.round
            )
            if self._journal is not None:
                self._journal.record(
                    "sync.req", block.round, parent, str(block.author)[:8]
                )
            address = self.committee.address(block.author)
            if address is not None:
                await self.network.send(
                    address, encode_sync_request(parent, self.name)
                )
        self._ensure_retry_task()

    async def get_parent_block(
        self, block: Block, floor: int = -1
    ) -> Block | None:
        """The block certified by ``block.qc``; None if it must be fetched
        (in which case processing of ``block`` is suspended).

        ``floor`` is the snapshot barrier: a node that adopted a
        QC-anchored state snapshot holds no block history at or below its
        commit cursor, and that history must never be fetched — otherwise
        a snapshot rejoin degenerates into the hop-by-hop ancestry
        backfill the snapshot exists to skip (and stalls outright when an
        old proposer is unreachable).  A missing parent certified at or
        below the floor resolves to the genesis stand-in: the block's own
        verified QC vouches for it, its state effects are inside the
        snapshot, and callers only read ``.round`` from it (the 2-chain
        commit rule can never fire across the cut)."""
        if block.qc.is_genesis():
            return Block.genesis()
        data = await self.store.read(block.parent.to_bytes())
        if data is not None:
            try:
                return Block.deserialize(data)
            except Exception as e:
                raise SerializationError(f"corrupt block in store: {e}") from e
        if block.qc.round <= max(floor, self.join_floor):
            return Block.genesis()
        await self._request_parent(block)
        return None

    async def get_ancestors(
        self, block: Block, floor: int = -1
    ) -> tuple[Block, Block] | None:
        """(b0, b1) with b0 <- |qc0; b1| <- |qc1; block|, or None if the
        parent chain is not yet locally available.  ``floor`` applies the
        snapshot barrier (see get_parent_block) to both hops."""
        b1 = await self.get_parent_block(block, floor)
        if b1 is None:
            return None
        b0 = await self.get_parent_block(b1, floor)
        if b0 is None:
            # Delivered blocks have stored ancestors (synchronizer.rs:142-146)
            # except across a snapshot cut (handled by the floor above);
            # reaching here means the store lost data.
            raise SerializationError(
                f"missing ancestor of delivered block {b1.digest()}"
            )
        return b0, b1

    def shutdown(self) -> None:
        if self._retry_task is not None:
            self._retry_task.cancel()
            self._retry_task = None
        for task in list(self._waiters):
            task.cancel()
        self._waiters.clear()
        self._by_parent.clear()
        self._children.clear()
        self.network.close()
