"""In-memory transport: the sim's replacement for TCP.

A copy of ``hotstuff_tpu.sim.transport``.

``SimNet`` is a per-run registry of listeners keyed by port.  Opening a
connection pairs two standalone ``asyncio.StreamReader`` instances with
two :class:`SimStreamWriter` halves: writing on one side feeds the
other side's reader directly — same-loop, zero-copy, deterministic
delivery order (frames arrive in the order the sender's tasks ran).

The senders reach this through the ambient connector seam
(``hotstuff_tpu_torch.utils.clock.default_connector``), so every production
code path — framing, fault plane ``decide()``/``barrier()``, WAN delay
scheduling, reconnect backoff, ACK pairing — runs verbatim on top of
the in-memory stream.  ``SimReceiver`` reuses the production
``Receiver._handle_connection`` loop unchanged; only listen/accept and
teardown are virtual.
"""

from __future__ import annotations

import asyncio
import logging

from ..network.receiver import Receiver

log = logging.getLogger(__name__)


class SimStreamWriter:
    """Duck-typed ``asyncio.StreamWriter`` over an in-memory pipe.

    The surface is exactly what the network stack touches: ``write`` /
    ``drain`` (framing.send_frame), ``close`` / ``is_closing`` /
    ``wait_closed`` (teardown paths), ``get_extra_info`` (peername
    logging; ``"socket"`` -> None makes framing.set_nodelay a no-op),
    and a ``transport`` with ``get_write_buffer_size`` (sender idle
    checks) and ``abort`` (pool.abort_writer)."""

    def __init__(self, peer_reader: asyncio.StreamReader, peername):
        self._peer_reader = peer_reader
        self._peername = peername
        self._peer: "SimStreamWriter | None" = None  # paired half
        self._closed = False

    # -- StreamWriter surface ------------------------------------------

    def write(self, data: bytes) -> None:
        if self._closed:
            raise ConnectionResetError("sim connection closed")
        self._peer_reader.feed_data(data)

    async def drain(self) -> None:
        if self._closed:
            raise ConnectionResetError("sim connection closed")
        await asyncio.sleep(0)  # yield, like a real flush

    def close(self) -> None:
        # Full TCP close: both directions die.  EOF the peer's read
        # side, then close the paired writer (recursion bounded by the
        # _closed flag).
        if self._closed:
            return
        self._closed = True
        try:
            self._peer_reader.feed_eof()
        except AssertionError:
            pass  # peer already fed EOF
        if self._peer is not None:
            self._peer.close()

    def is_closing(self) -> bool:
        return self._closed

    async def wait_closed(self) -> None:
        return None

    def get_extra_info(self, name: str, default=None):
        if name == "peername":
            return self._peername
        if name == "socket":
            return None  # framing.set_nodelay skips cleanly
        return default

    # -- transport duck-type (senders poke writer.transport directly) --

    @property
    def transport(self):
        return self

    def get_write_buffer_size(self) -> int:
        return 0  # writes land in the peer reader instantly

    def abort(self) -> None:
        self.close()


class SimNet:
    """One run's in-memory network: listener registry + connector."""

    def __init__(self):
        self._listeners: dict[int, "SimReceiver"] = {}
        self._conns = 0  # ephemeral "port" counter for peernames

    def listen(self, port: int, receiver: "SimReceiver") -> None:
        if port in self._listeners:
            raise OSError(f"sim: port {port} already in use")
        self._listeners[port] = receiver

    def unlisten(self, port: int) -> None:
        self._listeners.pop(port, None)

    async def open_connection(self, host: str, port: int, **_kw):
        """Ambient-connector replacement for ``asyncio.open_connection``:
        returns ``(reader, writer)`` for the client side and hands the
        server side to the listening :class:`SimReceiver`."""
        receiver = self._listeners.get(port)
        if receiver is None or receiver.closed:
            raise ConnectionRefusedError(f"sim: nothing listening on {port}")
        self._conns += 1
        client_reader = asyncio.StreamReader()
        server_reader = asyncio.StreamReader()
        client_writer = SimStreamWriter(server_reader, (host, port))
        server_writer = SimStreamWriter(
            client_reader, ("sim-client", self._conns)
        )
        client_writer._peer = server_writer
        server_writer._peer = client_writer
        receiver._accept(server_reader, server_writer)
        return client_reader, client_writer


class SimReceiver(Receiver):
    """Production :class:`Receiver` on the in-memory network: the frame
    loop, fault-plane inbound cut and handler dispatch are inherited
    verbatim; only listen/accept/teardown differ."""

    def __init__(
        self, host, port, handler, fault_plane=None, flows=None, net=None
    ):
        # flow accounting inherits the production rx charge site;
        # server-side peernames are ("sim-client", n) so receive flows
        # attribute to the deterministic "sim-client" label
        super().__init__(
            host, port, handler, fault_plane=fault_plane, flows=flows
        )
        self._net = net if net is not None else current_net()
        # dict-as-ordered-set: teardown cancels handlers in accept
        # order (determinism contract — no id()-ordered iteration)
        self._handler_tasks: dict[asyncio.Task, None] = {}
        self.closed = False

    async def spawn(self) -> None:
        self._net.listen(self.port, self)
        log.debug("Sim-listening on port %d", self.port)

    def _accept(self, reader, writer) -> None:
        task = asyncio.get_running_loop().create_task(
            self._handle_connection(reader, writer),
            name=f"sim-recv-{self.port}",
        )
        self._handler_tasks[task] = None
        task.add_done_callback(
            lambda t: self._handler_tasks.pop(t, None)
        )

    async def shutdown(self) -> None:
        self.closed = True
        self._net.unlisten(self.port)
        for w in list(self._writers):
            w.close()
        for t in list(self._handler_tasks):
            t.cancel()
        for t in list(self._handler_tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass


# --- ambient current network ------------------------------------------
# Mirrors the clock/rng/connector seams: Consensus.spawn(transport=
# "sim") builds SimReceivers without any signature change, resolving
# the net the runner installed for this run.

_CURRENT: SimNet | None = None


def set_current_net(net: SimNet | None) -> SimNet | None:
    global _CURRENT
    prev = _CURRENT
    _CURRENT = net
    return prev


def current_net() -> SimNet:
    if _CURRENT is None:
        raise RuntimeError(
            "no SimNet installed (transport='sim' outside a sim run?)"
        )
    return _CURRENT


__all__ = [
    "SimNet",
    "SimReceiver",
    "SimStreamWriter",
    "current_net",
    "set_current_net",
]
