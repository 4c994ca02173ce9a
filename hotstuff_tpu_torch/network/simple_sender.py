"""Best-effort sender with persistent per-peer connections.

A copy of ``hotstuff_tpu.network.simple_sender``: the WAN link
scheduler (``link_delay=``, ``network/wan.py``), the chaos plane
(``fault_plane=``, ``faults/plane.py``) and flow accounting (``flows=``,
``telemetry/flows.py``) are the reference's.  Parity target:
reference ``SimpleSender`` (network/src/simple_sender.rs:22-143): one
long-lived connection task per peer address holding a persistent TCP
connection and a bounded queue (capacity 1000); sending is pushing onto
that queue; messages are dropped on connection failure; ACK frames
arriving from the peer are read and discarded.
"""

from __future__ import annotations

import asyncio
import logging

from ..faults.plane import corrupt_frame
from ..utils.clock import default_clock, default_connector, default_rng
from .errors import classify
from .framing import read_frame, send_frame, set_nodelay
from .pool import BoundedPoolMixin, abort_writer
from .wan import LinkScheduler

log = logging.getLogger(__name__)

CHANNEL_CAPACITY = 1000

Address = tuple[str, int]


class _Connection:
    """Owns one persistent best-effort TCP connection.

    ``delay_fn`` (WAN emulation, network/wan.py): each queued message
    carries a deliver-at time; the send loop waits until then before
    writing — per-message propagation delay, pipelined (never a
    head-of-line rate limit).

    ``faults`` (chaos plane, faults/plane.py): the per-link fault view;
    each frame about to go out consults ``faults.decide()`` — dropped
    frames are simply not written (best-effort semantics make that
    exactly message loss), delays sleep inline, corruption flips a byte,
    duplication writes the frame twice.

    ``flows`` (telemetry/flows.py): every frame written is charged to
    this link's tx flow at the write site."""

    def __init__(self, address: Address, delay_fn=None, faults=None, flows=None):
        self.address = address
        self._faults = faults
        self._flows = flows
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=CHANNEL_CAPACITY)
        self._waiting = False  # parked on an empty queue (see idle)
        self._writer: asyncio.StreamWriter | None = None
        self.connect_failures = 0
        self._scheduler = (
            None if delay_fn is None else LinkScheduler(delay_fn)
        )
        self.task = asyncio.get_running_loop().create_task(
            self._run(), name=f"simple-conn-{address}"
        )

    @property
    def idle(self) -> bool:
        """Nothing queued and nothing in flight — safe to evict without
        losing a message (best-effort semantics allow losing FUTURE
        messages on eviction; in-flight ones must still go out).  "In
        flight" includes the transport write buffer: send_frame returns
        while bytes may still sit unflushed below the high-water mark,
        and eviction aborts without flushing."""
        if not (self._waiting and self.queue.empty()):
            return False
        if self._writer is None:
            return True  # never connected: nothing can be in flight
        try:
            return self._writer.transport.get_write_buffer_size() == 0
        except (RuntimeError, AttributeError):
            return True  # transport already closed/closing

    def put_nowait(self, data: bytes) -> None:
        at = 0.0 if self._scheduler is None else self._scheduler.deliver_at()
        self.queue.put_nowait((at, data))

    async def _next(self):
        self._waiting = True
        try:
            return await self.queue.get()
        finally:
            self._waiting = False

    async def _wait(self, at: float) -> None:
        if at:
            await LinkScheduler.wait_until(at)

    async def _run(self) -> None:
        while True:
            at, data = await self._next()
            try:
                reader, writer = await default_connector()(*self.address)
            except OSError as e:
                self.connect_failures += 1
                log.warning("%s", classify(e, "connect", self.address))
                continue  # drop this message, wait for the next
            set_nodelay(writer)
            self._writer = writer
            log.debug("Outgoing connection established with %s", self.address)
            sink = asyncio.get_running_loop().create_task(self._sink_acks(reader))
            try:
                while True:
                    await self._wait(at)
                    await self._transmit(writer, data)
                    at, data = await self._next()
            except (ConnectionError, OSError) as e:
                log.warning("%s", classify(e, "send", self.address))
            finally:
                sink.cancel()
                writer.close()
                self._writer = None  # disconnected: back to retry state

    async def _transmit(self, writer: asyncio.StreamWriter, data: bytes) -> None:
        # flow accounting charges at THIS site — after the fault
        # decision — so dropped frames are never charged and duplicated
        # ones are charged twice: accounted bytes == bytes written
        if self._faults is None:
            if self._flows is not None:
                self._flows.tx(self.address, data)
            await send_frame(writer, data)
            return
        decision = self._faults.decide()
        if decision.drop:
            return
        if decision.delay_s:
            await default_clock().sleep(decision.delay_s)
        payload = corrupt_frame(data) if decision.corrupt else data
        if self._flows is not None:
            self._flows.tx(self.address, payload)
        await send_frame(writer, payload)
        if decision.duplicate:
            if self._flows is not None:
                self._flows.tx(self.address, payload)
            await send_frame(writer, payload)

    @staticmethod
    async def _sink_acks(reader: asyncio.StreamReader) -> None:
        # Peers ACK on the same socket; this sender ignores them
        # (reference simple_sender.rs:120-131).
        try:
            while True:
                await read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass

    def close(self) -> None:
        self.task.cancel()
        abort_writer(self._writer)
        self._writer = None


class SimpleSender(BoundedPoolMixin):
    """Fire-and-forget sends; keeps one connection per peer.

    ``link_delay``: optional WAN-emulation hook — a callable
    ``(address) -> (() -> float)`` returning the per-link delay sampler
    (None for an undelayed link).

    ``fault_plane``: optional chaos plane (faults/plane.py) — each new
    connection resolves its directed-link fault view once, mirroring
    how ``link_delay`` resolves the WAN delay sampler.

    ``flows``: optional flow accountant (telemetry/flows.py): wire
    bytes charged at each link's write site, one logical charge per
    ``send``/``broadcast`` call.

    ``max_conns``: bounded connection pool (None = reference parity:
    one persistent connection per peer forever).  Big co-located
    committees need the bound — at 256 nodes every (sender, peer) pair
    persisting means a single committee-wide timeout broadcast crosses
    the process fd limit.  Eviction is LRU over IDLE connections only,
    so no queued or in-flight message is ever dropped by the bound."""

    #: broadcast chunks that waited for pool drain (class attr so
    #: unpaced senders pay no per-instance slot)
    pacing_stalls = 0

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

    def _enqueue(self, address: Address, data: bytes) -> None:
        conn = self._connection(address)
        try:
            conn.put_nowait(data)
        except asyncio.QueueFull:
            log.warning("Dropping message to %s: channel full", address)

    async def send(self, address: Address, data: bytes) -> None:
        if self._flows is not None:
            self._flows.logical(data)
        self._enqueue(address, data)

    async def broadcast(self, addresses: list[Address], data: bytes) -> None:
        # ONE logical charge per broadcast call regardless of fan-out —
        # the wire/logical ratio per class is the amplification factor
        if self._flows is not None and addresses:
            self._flows.logical(data)
        if self._max_conns is None or len(addresses) <= self._max_conns:
            for addr in addresses:
                self._enqueue(addr, data)
            return
        # Bounded pool: pace the fan-out so the working set stays near
        # the cap — without this, a committee-wide broadcast creates
        # every connection before the loop can drain ANY of them (send
        # never yields), busting the pool in one burst.  Each chunk gets
        # its OWN drain deadline, and only THIS broadcast's connections
        # count against the cap.  The wait is time-bounded; delivery
        # remains best-effort.
        loop = asyncio.get_running_loop()
        sent: list[Address] = []
        for start in range(0, len(addresses), self._max_conns):
            chunk = addresses[start : start + self._max_conns]
            for addr in chunk:
                self._enqueue(addr, data)
            sent.extend(chunk)
            deadline = loop.time() + 2.0
            stalled = False
            while (
                sum(
                    1
                    for addr in sent
                    if (c := self._connections.get(addr)) is not None
                    and not c.idle
                )
                > self._max_conns
                and loop.time() < deadline
            ):
                stalled = True
                await default_clock().sleep(0.002)
            if stalled:
                self.pacing_stalls += 1

    async def lucky_broadcast(
        self, addresses: list[Address], data: bytes, nodes: int
    ) -> None:
        """Send to ``nodes`` randomly-picked peers (reference
        simple_sender.rs lucky_broadcast)."""
        picks = default_rng().sample(addresses, min(nodes, len(addresses)))
        await self.broadcast(picks, data)

    def close(self) -> None:
        self._close_pool()
