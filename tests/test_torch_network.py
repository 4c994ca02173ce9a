"""The port's asyncio transport against the JAX package's: the
counterparts of tests/test_network.py on ``hotstuff_tpu_torch.network``,
byte-equal frames, and interop both ways — the port's senders into a JAX
``Receiver`` (ACKs included) and the JAX senders into the port's.

Every listener port comes from the OS (``reserve_ports``): a fixed port
range, or the JAX tests' port counter, would collide with other test
files running in parallel workers."""

import asyncio

import pytest

import hotstuff_tpu.network as jnet
from hotstuff_tpu.network.framing import write_frame as jwrite_frame
from hotstuff_tpu_torch.bench.committee import reserve_ports
from hotstuff_tpu_torch.network import (
    AckError,
    ConnectError,
    ListenError,
    NetworkError,
    Receiver,
    ReliableSender,
    SimpleSender,
    read_frame,
    send_frame,
    write_frame,
)
from hotstuff_tpu_torch.network.errors import classify


def port_of(sock) -> int:
    return sock.getsockname()[1]


async def listener(sock, expected: bytes, reply: bytes = b"Ack"):
    """One-shot fake peer on the reserved socket ``sock``: accept one
    connection, assert the first frame, reply, return the frame."""
    got = asyncio.get_running_loop().create_future()

    async def handle(reader, writer):
        frame = await read_frame(reader)
        await send_frame(writer, reply)
        if not got.done():
            got.set_result(frame)

    server = await asyncio.start_server(handle, sock=sock)
    try:
        frame = await asyncio.wait_for(got, 5)
        assert frame == expected
        return frame
    finally:
        # no wait_closed(): senders hold their persistent connection open,
        # and 3.12's wait_closed blocks until every peer connection dies
        server.close()


class EchoHandler:
    def __init__(self):
        self.received = []

    async def dispatch(self, writer, message):
        self.received.append(message)
        await writer.send(b"Ack")


@pytest.mark.parametrize("payload", [b"hello", b"x" * 100_000])
def test_receiver_dispatches_and_acks(payload):
    async def body():
        (sock,) = reserve_ports(1)
        port = port_of(sock)
        sock.close()
        handler = EchoHandler()
        rx = Receiver("127.0.0.1", port, handler)
        await rx.spawn()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await send_frame(writer, payload)
        ack = await asyncio.wait_for(read_frame(reader), 5)
        assert ack == b"Ack"
        assert handler.received == [payload]
        assert rx.connections == 1
        writer.close()
        await rx.shutdown()

    asyncio.run(body())


def test_simple_sender():
    async def body():
        (sock,) = reserve_ports(1)
        port = port_of(sock)
        task = asyncio.create_task(listener(sock, b"ping"))
        await asyncio.sleep(0.1)
        sender = SimpleSender()
        await sender.send(("127.0.0.1", port), b"ping")
        await asyncio.wait_for(task, 5)
        sender.close()

    asyncio.run(body())


def test_simple_broadcast():
    async def body():
        socks = reserve_ports(3)
        tasks = [asyncio.create_task(listener(s, b"all")) for s in socks]
        await asyncio.sleep(0.1)
        sender = SimpleSender()
        await sender.broadcast([("127.0.0.1", port_of(s)) for s in socks], b"all")
        await asyncio.wait_for(asyncio.gather(*tasks), 5)
        sender.close()

    asyncio.run(body())


def test_reliable_send_resolves_with_ack():
    async def body():
        (sock,) = reserve_ports(1)
        port = port_of(sock)
        task = asyncio.create_task(listener(sock, b"important", reply=b"OK"))
        await asyncio.sleep(0.1)
        sender = ReliableSender()
        handle = await sender.send(("127.0.0.1", port), b"important")
        ack = await asyncio.wait_for(handle, 5)
        assert ack == b"OK"
        await asyncio.wait_for(task, 5)
        sender.close()

    asyncio.run(body())


def test_reliable_retry_before_listener_exists():
    """Send with nobody listening (the reserved port refuses), then start
    the listener — backoff reconnect must deliver it."""

    async def body():
        (sock,) = reserve_ports(1)
        port = port_of(sock)
        sender = ReliableSender()
        handle = await sender.send(("127.0.0.1", port), b"late delivery")
        await asyncio.sleep(0.4)  # let a connect attempt fail
        assert not handle.done()
        task = asyncio.create_task(listener(sock, b"late delivery"))
        ack = await asyncio.wait_for(handle, 10)
        assert ack == b"Ack"
        await asyncio.wait_for(task, 5)
        sender.close()

    asyncio.run(body())


def test_reliable_broadcast_quorum_wait():
    """The proposer's pattern: broadcast, then await 2f+1 ACK handles."""

    async def body():
        socks = reserve_ports(3)
        tasks = [asyncio.create_task(listener(s, b"block")) for s in socks]
        await asyncio.sleep(0.1)
        sender = ReliableSender()
        handles = await sender.broadcast(
            [("127.0.0.1", port_of(s)) for s in socks], b"block"
        )
        done = 0
        for fut in asyncio.as_completed(handles, timeout=5):
            await fut
            done += 1
            if done >= 2:
                break
        assert done == 2
        await asyncio.wait_for(asyncio.gather(*tasks), 5)
        sender.close()

    asyncio.run(body())


def test_reliable_retransmits_unacked_on_reconnect():
    """Connection dies after receiving (not ACKing) a frame; the message must
    be retransmitted on the next connection."""

    async def body():
        (sock,) = reserve_ports(1)
        port = port_of(sock)
        first_conn = asyncio.get_running_loop().create_future()

        async def rude_handler(reader, writer):
            # read the frame, then slam the door without ACKing
            await read_frame(reader)
            writer.close()
            if not first_conn.done():
                first_conn.set_result(None)

        rude = await asyncio.start_server(rude_handler, sock=sock)
        sender = ReliableSender()
        handle = await sender.send(("127.0.0.1", port), b"retry me")
        await asyncio.wait_for(first_conn, 5)
        rude.close()
        await rude.wait_closed()
        # now a polite listener takes over the port
        task = asyncio.create_task(listen_on(port, b"retry me"))
        ack = await asyncio.wait_for(handle, 10)
        assert ack == b"Ack"
        await asyncio.wait_for(task, 5)
        sender.close()

    asyncio.run(body())


async def listen_on(port: int, expected: bytes):
    """``listener`` on a port number (a port just released by another
    server of this test)."""
    import socket

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", port))
    return await listener(sock, expected)


def test_network_error_taxonomy():
    """Typed connect/listen/send/receive/ACK errors: classifiable,
    address-carrying, OSError-compatible — and named as in the JAX
    package."""
    err = classify(ConnectionRefusedError(111, "refused"), "connect",
                   ("10.0.0.1", 9999))
    assert isinstance(err, ConnectError)
    assert isinstance(err, NetworkError)
    assert isinstance(err, OSError)
    assert "10.0.0.1:9999" in str(err)
    assert isinstance(classify(OSError(), "ack"), AckError)
    assert isinstance(classify(OSError(), "listen"), ListenError)
    from hotstuff_tpu.network.errors import classify as jclassify

    for op in ("connect", "listen", "send", "receive", "ack", "other"):
        exc = ConnectionResetError(104, "reset")
        mine, theirs = classify(exc, op, ("h", 1)), jclassify(exc, op, ("h", 1))
        assert type(mine).__name__ == type(theirs).__name__
        assert str(mine) == str(theirs)


def test_listen_failure_is_typed():
    """Binding a port twice raises the taxonomy's ListenError."""

    async def body():
        (sock,) = reserve_ports(1)
        port = port_of(sock)
        sock.close()

        class NullHandler:
            async def dispatch(self, writer, message):
                pass

        a = Receiver("127.0.0.1", port, NullHandler())
        await a.spawn()
        b = Receiver("127.0.0.1", port, NullHandler())
        with pytest.raises(ListenError):
            await b.spawn()
        await a.shutdown()

    asyncio.run(body())


def test_simple_sender_bounded_pool_evicts_idle():
    """max_conns bounds the persistent-connection pool: sending to more
    peers than the cap evicts idle LRU connections (and only idle ones),
    while every message still arrives."""

    async def body():
        n = 5
        payload = b"bounded"
        socks = reserve_ports(n)
        listeners = [asyncio.ensure_future(listener(s, payload)) for s in socks]
        await asyncio.sleep(0.05)
        sender = SimpleSender(max_conns=2)
        for s in socks:
            await sender.send(("127.0.0.1", port_of(s)), payload)
            await asyncio.sleep(0.05)  # let the connection drain to idle
        await asyncio.wait_for(asyncio.gather(*listeners), timeout=5)
        assert len(sender._connections) <= 2
        sender.close()

    asyncio.run(body())


def test_reliable_sender_bounded_pool_keeps_acks():
    """ReliableSender's bound only evicts fully-ACKed idle connections:
    a capped broadcast still returns one resolving ACK future per peer."""

    async def body():
        n = 4
        payload = b"capped-reliable"
        socks = reserve_ports(n)
        listeners = [asyncio.ensure_future(listener(s, payload)) for s in socks]
        await asyncio.sleep(0.05)
        sender = ReliableSender(max_conns=2)
        handlers = await sender.broadcast(
            [("127.0.0.1", port_of(s)) for s in socks], payload
        )
        acks = await asyncio.wait_for(asyncio.gather(*handlers), timeout=5)
        assert acks == [b"Ack"] * n
        await asyncio.gather(*listeners)
        # pool shrinks back to the cap once everything is ACKed
        for _ in range(50):
            sender._evict_idle(2)
            if len(sender._connections) <= 2:
                break
            await asyncio.sleep(0.02)
        assert len(sender._connections) <= 2
        sender.close()

    asyncio.run(body())


class _Capture:
    """A writer stand-in that records what ``write_frame`` writes."""

    def __init__(self):
        self.data = b""

    def write(self, data):
        self.data += data


@pytest.mark.parametrize("size", [0, 1, 255, 65_536, 1_000_003])
def test_frames_are_byte_equal(size):
    """The length-delimited framing writes the same bytes in both
    packages, and each package reads the other's frames."""
    payload = bytes(i % 251 for i in range(size))
    mine, theirs = _Capture(), _Capture()
    write_frame(mine, payload)
    jwrite_frame(theirs, payload)
    assert mine.data == theirs.data
    assert mine.data[:4] == size.to_bytes(4, "big")

    async def body():
        for read in (read_frame, jnet.read_frame):
            reader = asyncio.StreamReader()
            reader.feed_data(mine.data)
            reader.feed_eof()
            assert await read(reader) == payload

    asyncio.run(body())


class _Recorder:
    def __init__(self, reply: bytes):
        self.reply = reply
        self.received = []

    async def dispatch(self, writer, message):
        self.received.append(message)
        await writer.send(self.reply + message[:4])


async def _interop(receiver_cls, simple_cls, reliable_cls):
    """Senders of one package into a receiver of the other: each sender's
    frames arrive in order on its own connection, and reliable frames
    resolve with the receiver's ACK bytes."""
    (sock,) = reserve_ports(1)
    port = port_of(sock)
    sock.close()
    handler = _Recorder(b"Ack:")
    rx = receiver_cls("127.0.0.1", port, handler)
    await rx.spawn()
    simple, reliable = simple_cls(), reliable_cls()
    try:
        frames = [b"f%03d" % i + bytes(i) for i in range(20)]
        best_effort, acked = frames[:10], frames[10:]
        for f in best_effort:
            await simple.send(("127.0.0.1", port), f)
        handles = [await reliable.send(("127.0.0.1", port), f) for f in acked]
        acks = await asyncio.wait_for(asyncio.gather(*handles), 5)
        assert acks == [b"Ack:" + f[:4] for f in acked]
        for _ in range(250):
            if len(handler.received) >= len(frames):
                break
            await asyncio.sleep(0.02)
        got = handler.received
        assert [f for f in got if f in best_effort] == best_effort
        assert [f for f in got if f not in best_effort] == acked
    finally:
        simple.close()
        reliable.close()
        await rx.shutdown()


def test_port_senders_into_jax_receiver():
    asyncio.run(_interop(jnet.Receiver, SimpleSender, ReliableSender))


def test_jax_senders_into_port_receiver():
    asyncio.run(_interop(Receiver, jnet.SimpleSender, jnet.ReliableSender))


def test_shutdown_with_a_connection_in_the_accept_handoff():
    """A connection the listener accepted just before shutdown, but whose
    handler had not started when shutdown closed the live connections,
    must not keep ``shutdown`` waiting forever."""

    async def body():
        (sock,) = reserve_ports(1)
        port = port_of(sock)
        sock.close()
        rx = Receiver("127.0.0.1", port, EchoHandler())
        await rx.spawn()
        server = rx._server
        attach = server._attach
        shutdowns = []

        def attach_then_shut_down(*args):
            # the transport is attached; its handler starts a loop pass
            # later — begin shutdown in between
            attach(*args)
            if not shutdowns:
                shutdowns.append(asyncio.ensure_future(rx.shutdown()))

        server._attach = attach_then_shut_down
        _, writer = await asyncio.open_connection("127.0.0.1", port)
        for _ in range(1000):
            if shutdowns:
                break
            await asyncio.sleep(0)
        await asyncio.wait_for(shutdowns[0], 2)
        writer.close()

    asyncio.run(body())
