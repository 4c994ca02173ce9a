"""Network receiver: TCP listener dispatching frames to a handler.

A copy of ``hotstuff_tpu.network.receiver``: every frame read is
charged to the node's flow accountant (``flows=``,
``telemetry/flows.py``), passes the chaos plane's inbound cut
(``fault_plane=``, ``faults/plane.py``), then goes through ``dispatch_ingest`` (the
zero-copy ingest taps, shared with the native receiver) to
``handler.dispatch(writer, bytes)``.  Parity target:
reference ``Receiver<Handler>`` (network/src/receiver.rs:18-89): bind a
TCP listener, spawn one runner per accepted connection, decode
length-delimited frames, hand each to the handler with the connection's
writer so it can send replies or ACKs back on the same socket (the
proposer's quorum-ACK back-pressure depends on this).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Protocol

from ..crypto.async_service import ingest_note_frame, zero_copy_ingest
from .errors import classify
from .framing import FramingError, read_frame, send_frame, set_nodelay

log = logging.getLogger(__name__)

#: wire tags mirrored from consensus/wire.py — importing it here would
#: cycle (consensus imports this module for the Writer protocol); the
#: tests hold these against the live constants
_TAG_VOTE = 1
_TAG_PRODUCER_V2 = 6


async def dispatch_ingest(handler, writer, frame: bytes) -> None:
    """Frame dispatch through the zero-copy ingest taps, shared by the
    asyncio and native receivers.

    Vote frames are also noted to the native wave packer — the verify
    service later adopts the packed digest/pk/sig columns instead of
    flattening Python claim tuples.  Batched producer-v2 frames parse
    natively into a digest column and body windows and skip per-item
    payload tuples when the handler has ``dispatch_producer_v2``.  A
    plane switched off (``HOTSTUFF_ZERO_COPY=0``), a handler without the
    fast path, or a frame the native parser rejects falls through to
    ``handler.dispatch`` unchanged (the differential fuzz holds native
    and Python accept/reject to byte parity)."""
    if frame:
        tag = frame[0]
        if tag == _TAG_VOTE:
            ingest_note_frame(frame)
        elif tag == _TAG_PRODUCER_V2:
            fast = getattr(handler, "dispatch_producer_v2", None)
            if fast is not None and zero_copy_ingest() is not None:
                from ..crypto import native_ed25519

                parsed = native_ed25519.parse_producer(frame)
                if parsed is not None:
                    digests, spans = parsed
                    await fast(writer, frame, digests, spans)
                    return
    await handler.dispatch(writer, frame)


class Writer:
    """Reply-channel handed to MessageHandler.dispatch."""

    def __init__(self, stream_writer: asyncio.StreamWriter, flows=None):
        self._writer = stream_writer
        self._flows = flows

    async def send(self, payload: bytes) -> None:
        # replies (ACKs, state-read values) leave on the accepted
        # socket, not through a sender — charge their egress here
        if self._flows is not None:
            self._flows.tx(self.peer, payload)
        await send_frame(self._writer, payload)

    @property
    def peer(self):
        return self._writer.get_extra_info("peername")


class MessageHandler(Protocol):
    async def dispatch(self, writer: Writer, message: bytes) -> None: ...


class Receiver:
    """Listens on ``address`` and dispatches every frame to ``handler``;
    ``flows`` (telemetry/flows.py) is charged for every frame read and
    every reply written.

    ``fault_plane`` (chaos plane, faults/plane.py): inbound faulting is
    all-or-nothing — accepted connections arrive from ephemeral ports,
    so frames can't be attributed to a committee peer; committee-pair
    partitions are fully enforced sender-side (every node shares the
    scenario spec).  The receiver-side cut exists for ``isolate``
    windows, where frames from planeless senders (benchmark clients)
    must die too."""

    def __init__(
        self,
        host: str,
        port: int,
        handler: MessageHandler,
        fault_plane=None,
        flows=None,
    ):
        self.host = host
        self.port = port
        self.handler = handler
        self._faults = fault_plane
        self._flows = flows
        self._server: asyncio.AbstractServer | None = None
        self._closing = False
        # insertion-ordered (dict-as-set): shutdown closes connections
        # in accept order, so teardown is reproducible — a plain set
        # iterates in id() order, which varies with heap layout
        self._writers: dict[asyncio.StreamWriter, None] = {}

    async def spawn(self) -> None:
        # the first receiver creates the ingest plane: a library that
        # cannot build raises here, at boot, not on the first vote
        zero_copy_ingest()
        try:
            self._server = await asyncio.start_server(
                self._handle_connection, self.host, self.port
            )
        except OSError as e:
            raise classify(e, "listen", (self.host, self.port)) from e
        log.debug("Listening on %s:%d", self.host, self.port)

    async def _handle_connection(
        self, reader: asyncio.StreamReader, stream_writer: asyncio.StreamWriter
    ) -> None:
        peer = stream_writer.get_extra_info("peername")
        if self._closing:
            # accepted before shutdown closed the listener but handed to
            # us after it closed the live connections: without this,
            # wait_closed() would wait on this connection forever (a
            # race the JAX Receiver has too; co-located committees,
            # whose senders keep reconnecting during shutdown, hit it)
            stream_writer.close()
            return
        set_nodelay(stream_writer)
        log.debug("Incoming connection from %s", peer)
        self._writers[stream_writer] = None
        writer = Writer(stream_writer, flows=self._flows)
        try:
            while True:
                frame = await read_frame(reader)
                # charged before the inbound cut: the bytes crossed the
                # wire whether or not the isolate window swallows them
                if self._flows is not None:
                    self._flows.rx(peer, frame)
                if self._faults is not None and self._faults.inbound_cut():
                    continue  # isolate window: swallow the frame unACKed
                await dispatch_ingest(self.handler, writer, frame)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            FramingError,
        ):
            log.debug("Connection from %s closed", peer)
        finally:
            self._writers.pop(stream_writer, None)
            stream_writer.close()

    @property
    def connections(self) -> int:
        """Live accepted connections."""
        return len(self._writers)

    async def shutdown(self) -> None:
        if self._server is not None:
            self._closing = True
            self._server.close()
            # Persistent peers hold their connections open; close them so
            # wait_closed() (which in 3.12 waits on every live connection)
            # can complete.
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
            self._server = None
