"""Best-effort sender with persistent per-peer connections.

A copy of ``hotstuff_tpu.network.simple_sender`` without the WAN link
scheduler, the fault plane and flow accounting.  Parity target:
reference ``SimpleSender`` (network/src/simple_sender.rs:22-143): one
long-lived connection task per peer address holding a persistent TCP
connection and a bounded queue (capacity 1000); sending is pushing onto
that queue; messages are dropped on connection failure; ACK frames
arriving from the peer are read and discarded.
"""

from __future__ import annotations

import asyncio
import logging

from ..utils.clock import default_clock, default_connector
from .errors import classify
from .framing import read_frame, send_frame, set_nodelay
from .pool import BoundedPoolMixin, abort_writer

log = logging.getLogger(__name__)

CHANNEL_CAPACITY = 1000

Address = tuple[str, int]


class _Connection:
    """Owns one persistent best-effort TCP connection."""

    def __init__(self, address: Address):
        self.address = address
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=CHANNEL_CAPACITY)
        self._waiting = False  # parked on an empty queue (see idle)
        self._writer: asyncio.StreamWriter | None = None
        self.connect_failures = 0
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
        self.queue.put_nowait(data)

    async def _next(self) -> bytes:
        self._waiting = True
        try:
            return await self.queue.get()
        finally:
            self._waiting = False

    async def _run(self) -> None:
        while True:
            data = await self._next()
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
                    await send_frame(writer, data)
                    data = await self._next()
            except (ConnectionError, OSError) as e:
                log.warning("%s", classify(e, "send", self.address))
            finally:
                sink.cancel()
                writer.close()
                self._writer = None  # disconnected: back to retry state

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

    ``max_conns``: bounded connection pool (None = reference parity:
    one persistent connection per peer forever).  Big co-located
    committees need the bound — at 256 nodes every (sender, peer) pair
    persisting means a single committee-wide timeout broadcast crosses
    the process fd limit.  Eviction is LRU over IDLE connections only,
    so no queued or in-flight message is ever dropped by the bound."""

    #: broadcast chunks that waited for pool drain (class attr so
    #: unpaced senders pay no per-instance slot)
    pacing_stalls = 0

    def __init__(self, max_conns: int | None = None):
        self._connections: dict[Address, _Connection] = {}
        self._max_conns = max_conns
        self._sweeper: asyncio.Task | None = None

    def _connection(self, address: Address) -> _Connection:
        conn = self._lru_hit(address)
        if conn is not None:
            return conn
        conn = _Connection(address)
        self._admit(address, conn)
        return conn

    def _enqueue(self, address: Address, data: bytes) -> None:
        conn = self._connection(address)
        try:
            conn.put_nowait(data)
        except asyncio.QueueFull:
            log.warning("Dropping message to %s: channel full", address)

    async def send(self, address: Address, data: bytes) -> None:
        self._enqueue(address, data)

    async def broadcast(self, addresses: list[Address], data: bytes) -> None:
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

    def close(self) -> None:
        self._close_pool()
