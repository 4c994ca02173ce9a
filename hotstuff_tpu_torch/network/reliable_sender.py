"""Reliable sender: per-message ACK futures, reconnect with backoff,
retransmission of un-ACKed messages.

A copy of ``hotstuff_tpu.network.reliable_sender``: the WAN link
scheduler (``link_delay=``, ``network/wan.py``), the chaos plane
(``fault_plane=``, ``faults/plane.py``) and flow accounting (``flows=``,
``telemetry/flows.py``) are the reference's.  Parity target:
reference ``ReliableSender`` (network/src/reliable_sender.rs:25-248),
semantics reproduced exactly (the proposer's 2f+1-ACK back-pressure
depends on them):

- every ``send`` returns a CancelHandler (here: an asyncio Future) resolved
  with the peer's ACK payload for that message;
- each peer has one connection task pairing sent frames with ACK frames
  FIFO;
- on connection failure, un-ACKed messages are retransmitted after
  reconnecting with exponential backoff (200 ms doubling, capped at 60 s —
  reference reliable_sender.rs:131,166) with FULL JITTER: each retry
  sleeps uniform(0, delay) so the whole committee doesn't reconnect-
  stampede the instant a partition heals (the deterministic schedule
  synchronised every peer's retry clock);
- messages whose future was cancelled by the caller are dropped instead of
  retransmitted (the reference drops messages whose CancelHandler receiver
  was dropped).

Chaos-plane semantics on reliable links (faults/plane.py): the FIFO
ACK pairing constrains what each fault can mean here. A hard partition
(drop >= 1.0 window) HOLDS frames at the head of the line via
``barrier()`` — no loss decision is consumed, frames flow when the
window closes. A probabilistic drop tears the connection with a
synthetic ConnectionError instead (the frame stays un-ACKed and rides
the reconnect/retransmit path — exactly what a lost frame causes on a
reliable link). Corruption sends the mangled bytes then tears the
connection so the pairing resets and the clean frame is retransmitted.
Duplication is a no-op: a duplicated frame would draw a second ACK and
desync the FIFO pairing.

Under WAN emulation every outbound frame waits for its deliver-at time
and its ACK future resolves one return leg later, so the proposer's
quorum-ACK back-pressure sees full round trips.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque

from ..faults.plane import BARRIER_POLL_S, corrupt_frame
from ..utils.clock import default_clock, default_connector, default_rng
from .errors import UnexpectedAckError, classify
from .framing import FramingError, read_frame, send_frame, set_nodelay
from .pool import BoundedPoolMixin, abort_writer
from .wan import LinkScheduler

log = logging.getLogger(__name__)

CHANNEL_CAPACITY = 1000
RETRY_DELAY_S = 0.2
RETRY_CAP_S = 60.0

Address = tuple[str, int]
CancelHandler = asyncio.Future  # resolves to the ACK payload (bytes)


class FaultDisconnect(ConnectionError):
    """Synthetic disconnect injected by the chaos plane: rides the
    normal reconnect/retransmit path (loss-on-a-reliable-link)."""


class _Connection:
    def __init__(self, address: Address, delay_fn=None, faults=None, flows=None):
        self.address = address
        self._faults = faults
        self._flows = flows
        #: retries whose backoff sleep was jittered (stampede-avoided
        #: reconnect attempts)
        self.jittered_retries = 0
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=CHANNEL_CAPACITY)
        # un-ACKed in-flight messages, FIFO-paired with incoming ACKs
        self.pending: deque[tuple[bytes, CancelHandler]] = deque()
        self._waiting = False  # writer_loop parked on an empty queue
        self._writer: asyncio.StreamWriter | None = None
        self.connect_failures = 0
        # WAN emulation (network/wan.py): outbound frames wait for their
        # deliver-at time; ACK futures resolve one return-leg later, so
        # the proposer's quorum-ACK back-pressure sees full RTTs.
        self._delay_fn = delay_fn
        self._scheduler = (
            None if delay_fn is None else LinkScheduler(delay_fn)
        )
        self.task = asyncio.get_running_loop().create_task(
            self._run(), name=f"reliable-conn-{address}"
        )

    def deliver_at(self) -> float:
        return 0.0 if self._scheduler is None else self._scheduler.deliver_at()

    @property
    def idle(self) -> bool:
        """Nothing queued AND every sent frame ACKed — eviction loses
        no message and cancels no caller's ACK future.

        A connection stuck in connect-retry (``_writer`` unset: never
        established, or between reconnect attempts) has no writer_loop
        to park, so ``_waiting`` never becomes True — without the first
        branch a dead peer would pin its pool slot forever, un-evictable
        while it backs off toward the 60 s retry cap."""
        if self._writer is None:
            return self.queue.empty() and not self.pending
        return self._waiting and self.queue.empty() and not self.pending

    async def _run(self) -> None:
        delay = RETRY_DELAY_S
        while True:
            try:
                reader, writer = await default_connector()(*self.address)
            except OSError as e:
                self.connect_failures += 1
                log.debug("%s", classify(e, "connect", self.address))
                # full jitter: sleep uniform(0, delay) while the CEILING
                # doubles — peers that lost the same partition at the
                # same instant spread their reconnects across the window
                # instead of stampeding the healed link in lockstep
                if delay > RETRY_DELAY_S:
                    self.jittered_retries += 1
                    await default_clock().sleep(default_rng().uniform(0, delay))
                else:
                    await default_clock().sleep(delay)
                delay = min(delay * 2, RETRY_CAP_S)
                continue
            set_nodelay(writer)
            self._writer = writer
            log.debug("Outgoing connection established with %s", self.address)
            delay = RETRY_DELAY_S  # reset on success
            try:
                await self._keep_alive(reader, writer)
            except (
                ConnectionError,
                OSError,
                asyncio.IncompleteReadError,
                FramingError,
            ) as e:
                # classify by what broke: the ACK pairing (un-ACKed
                # frames in flight -> retransmitted on reconnect) vs a
                # plain receive failure
                op = "ack" if self.pending else "receive"
                log.warning("%s", classify(e, op, self.address))
            finally:
                writer.close()
                self._writer = None  # disconnected: back to retry state

    async def _keep_alive(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        # retransmit un-ACKed messages first (skip cancelled),
        # reference reliable_sender.rs:187-199; a live partition window
        # holds the retransmit burst too (head-of-line, like writer_loop)
        self.pending = deque(
            (d, f) for d, f in self.pending if not f.cancelled()
        )
        if self._faults is not None and self.pending:
            while self._faults.barrier():
                await default_clock().sleep(BARRIER_POLL_S)
        for data, _ in self.pending:
            # charged as a RETRANSMIT at the actual re-send instant —
            # never at enqueue time — so net_retx_bytes counts bytes
            # that really crossed the healed link a second time
            if self._flows is not None:
                self._flows.tx(self.address, data, retx=True)
            await send_frame(writer, data)

        async def writer_loop():
            while True:
                self._waiting = True
                try:
                    at, data, fut = await self.queue.get()
                finally:
                    self._waiting = False
                if fut.cancelled():
                    continue
                # join `pending` BEFORE any await: a connection drop
                # during the WAN wait must leave the message where the
                # reconnect path retransmits it (and close() cancels
                # its future) — never in limbo with a forever-pending
                # ACK future.  Retransmits after a reconnect skip the
                # emulated delay; the reconnect backoff (>= 200 ms)
                # already exceeds any link delay.
                self.pending.append((data, fut))
                if at:
                    await LinkScheduler.wait_until(at)
                await self._transmit(writer, data)

        def _resolve(fut, ack):
            if not fut.cancelled():
                fut.set_result(ack)

        async def reader_loop():
            while True:
                ack = await read_frame(reader)
                # each ACK pairs FIFO with exactly one sent frame; a frame
                # whose caller cancelled still consumed this ACK slot
                if self.pending:
                    _, fut = self.pending.popleft()
                    if self._delay_fn is not None:
                        # the ACK's return leg crosses the same link
                        asyncio.get_running_loop().call_later(
                            self._delay_fn(), _resolve, fut, ack
                        )
                    elif not fut.cancelled():
                        fut.set_result(ack)
                else:
                    # protocol desync the reference surfaces as
                    # UnexpectedAck (error.rs): keep the connection (the
                    # peer may just have double-ACKed) but say so
                    log.warning(
                        "%s", UnexpectedAckError(self.address, "no frame in flight")
                    )

        wtask = asyncio.ensure_future(writer_loop())
        rtask = asyncio.ensure_future(reader_loop())
        return await self._supervise(wtask, rtask)

    async def _transmit(self, writer: asyncio.StreamWriter, data: bytes) -> None:
        """Send one frame through the chaos plane (module docstring has
        the reliable-link fault semantics)."""
        faults = self._faults
        if faults is None:
            if self._flows is not None:
                self._flows.tx(self.address, data)
            await send_frame(writer, data)
            return
        while faults.barrier():
            await default_clock().sleep(BARRIER_POLL_S)
        decision = faults.decide()
        if decision.drop:
            # never written: never charged (accounted == bytes written)
            raise FaultDisconnect(f"fault plane dropped frame to {self.address}")
        if decision.delay_s:
            await default_clock().sleep(decision.delay_s)
        if decision.corrupt:
            mangled = corrupt_frame(data)
            if self._flows is not None:
                self._flows.tx(self.address, mangled)
            await send_frame(writer, mangled)
            raise FaultDisconnect(f"fault plane corrupted frame to {self.address}")
        if self._flows is not None:
            self._flows.tx(self.address, data)
        await send_frame(writer, data)

    @staticmethod
    async def _supervise(wtask: asyncio.Task, rtask: asyncio.Task) -> None:
        try:
            done, _ = await asyncio.wait(
                {wtask, rtask}, return_when=asyncio.FIRST_EXCEPTION
            )
            for t in done:
                exc = t.exception()
                if exc is not None:
                    raise exc
        finally:
            wtask.cancel()
            rtask.cancel()

    def close(self) -> None:
        self.task.cancel()
        # release the socket immediately (pool.abort_writer docstring);
        # eviction only targets fully-ACKed idle connections
        abort_writer(self._writer)
        self._writer = None
        # fail every outstanding ACK future so no caller hangs
        while not self.queue.empty():
            _, _, fut = self.queue.get_nowait()
            if not fut.done():
                fut.cancel()
        for _, fut in self.pending:
            if not fut.done():
                fut.cancel()
        self.pending.clear()


class ReliableSender(BoundedPoolMixin):
    """``max_conns``: bounded connection pool (None = reference parity).
    Only IDLE connections — empty queue, every frame ACKed — are LRU
    evicted, so reliability semantics (retransmit, ACK futures) are
    untouched; a proposer's broadcast may transiently exceed the cap
    and the pool shrinks back as ACKs drain.  Pool machinery shared
    with SimpleSender (network/pool.py).

    ``link_delay``, ``fault_plane`` and ``flows`` as on
    ``SimpleSender``."""

    def __init__(
        self,
        link_delay=None,
        max_conns: int | None = None,
        fault_plane=None,
        flows=None,
    ):
        self._connections: dict[Address, _Connection] = {}
        self._link_delay = link_delay
        self._max_conns = max_conns
        self._fault_plane = fault_plane
        self._flows = flows
        self._sweeper: asyncio.Task | None = None

    def _connection(self, address: Address) -> _Connection:
        conn = self._lru_hit(address)
        if conn is not None:
            return conn
        delay_fn = self._link_delay(address) if self._link_delay else None
        faults = (
            self._fault_plane.link(address) if self._fault_plane else None
        )
        conn = _Connection(
            address, delay_fn=delay_fn, faults=faults, flows=self._flows
        )
        self._admit(address, conn)
        return conn

    async def _enqueue(self, address: Address, data: bytes) -> CancelHandler:
        fut: CancelHandler = asyncio.get_running_loop().create_future()
        conn = self._connection(address)
        await conn.queue.put((conn.deliver_at(), data, fut))
        return fut

    async def send(self, address: Address, data: bytes) -> CancelHandler:
        """Queue ``data`` for reliable delivery; the returned future resolves
        with the peer's ACK payload."""
        if self._flows is not None:
            self._flows.logical(data)
        return await self._enqueue(address, data)

    async def broadcast(
        self, addresses: list[Address], data: bytes
    ) -> list[CancelHandler]:
        # ONE logical charge per broadcast call regardless of fan-out —
        # the wire/logical ratio per class is the amplification factor
        if self._flows is not None and addresses:
            self._flows.logical(data)
        return [await self._enqueue(addr, data) for addr in addresses]

    async def lucky_broadcast(
        self, addresses: list[Address], data: bytes, nodes: int
    ) -> list[CancelHandler]:
        """Send to ``nodes`` randomly-picked peers (reference
        reliable_sender.rs lucky_broadcast)."""
        picks = default_rng().sample(addresses, min(nodes, len(addresses)))
        return await self.broadcast(picks, data)

    def close(self) -> None:
        self._close_pool()
