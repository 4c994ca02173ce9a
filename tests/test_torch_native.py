"""The port's native transport (``network/native.py`` over its own build
of ``native/transport.cpp`` and ``native/wave_pack.cpp``).

The build: it lands in ``build/torch_native/`` under a name that
changes with the sources, a second build is a no-op, ``native/`` stays
as it is, and a build that fails raises at spawn.  The transport,
parametrised over the cases of the JAX package's
``tests/test_network_native.py``: native senders and receivers against
the port's asyncio ones, the JAX package's asyncio ones and each other,
ACK replies, drop then reconnect, reliable ACK futures, retry until the
listener is up, port reuse after shutdown and read-pause flow control.
Committees: four port nodes on the native transport through
``run_committee``, two JAX and two port nodes on the native transport
agreeing on one chain and its state roots, and ``run-many`` / ``deploy``
with ``--transport native`` from the command line, read by the
harness's ``LogParser``.

Every listener port comes from the OS; every wait has a deadline;
every receiver, sender, stack and process is stopped in ``finally``."""

import asyncio
import ctypes
import signal
import subprocess
from pathlib import Path

import pytest
import torch

from benchmark.invariants import check_state_root_agreement
from benchmark.logs import RE_VERIFY_STATS, LogParser

from hotstuff_tpu.network.receiver import Receiver as JaxReceiver
from hotstuff_tpu.network.simple_sender import SimpleSender as JaxSimpleSender
from hotstuff_tpu_torch.bench.committee import reserve_ports, run_committee
from hotstuff_tpu_torch import _native_build
from hotstuff_tpu_torch.network import Receiver, SimpleSender, native
from hotstuff_tpu_torch.network.framing import read_frame, send_frame

from .test_torch_cli import CLI, ENV, _free_run
from .test_torch_consensus_e2e import (
    _assert_one_chain,
    _commits,
    _feed_producers,
    _node_lines,
    _roots,
    _shutdown,
)
from .test_torch_core import JAX, PORT
from .test_torch_node import spawn_client, stop_all, wait_for, write_port_committee

torch.set_num_threads(1)

TIMEOUT_S = 10.0
ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    (sock,) = reserve_ports(1)
    port = sock.getsockname()[1]
    sock.close()  # the listener under test binds it
    return port


# ---- the build -------------------------------------------------------------


def test_the_build_is_the_ports_own_and_named_by_its_sources(tmp_path, monkeypatch):
    loaded = Path(_native_build.load("transport")._name)
    assert loaded.parent == ROOT / "build" / "torch_native"
    assert loaded.name == f"libhs_transport_{_native_build.source_hash('transport')}.so"
    sources = {p: p.read_bytes() for p in (ROOT / "native").iterdir() if p.is_file()}

    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "torch_native")
    built = _native_build.build("transport")
    assert built == tmp_path / "torch_native" / loaded.name
    lib = ctypes.CDLL(str(built))
    assert hasattr(lib, "ht_start") and hasattr(lib, "wp_pack_vote")
    assert not list(built.parent.glob("*.tmp*"))

    def no_compiler(*args, **kwargs):
        raise AssertionError("a second build of the same sources compiled")

    stamp = built.stat().st_mtime_ns
    monkeypatch.setattr(_native_build.subprocess, "run", no_compiler)
    assert _native_build.build("transport") == built and built.stat().st_mtime_ns == stamp

    copy = tmp_path / "native"
    copy.mkdir()
    for name in _native_build.LIBRARIES["transport"].sources:
        (copy / name).write_bytes((ROOT / "native" / name).read_bytes())
    monkeypatch.setattr(_native_build, "NATIVE_DIR", copy)
    assert _native_build.library_path("transport") == built
    (copy / "wave_pack.cpp").write_bytes((copy / "wave_pack.cpp").read_bytes() + b"\n// edited\n")
    assert _native_build.library_path("transport").name != loaded.name

    assert {p: p.read_bytes() for p in (ROOT / "native").iterdir() if p.is_file()} == sources


def test_a_native_transport_that_cannot_build_raises_at_spawn(tmp_path, monkeypatch):
    from hotstuff_tpu_torch.consensus import Consensus

    build = _native_build.build

    def broken(name):
        if name != "transport":
            return build(name)
        raise RuntimeError("g++ failed (1): no compiler here")

    monkeypatch.setattr(native.Reactor, "_instance", None)
    monkeypatch.setattr(_native_build, "_LIBS", {})
    monkeypatch.setattr(_native_build, "build", broken)

    async def body():
        store = PORT.store.Store(str(tmp_path / "db"))
        name, secret = PORT.keys()[0]
        try:
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                await Consensus.spawn(
                    name, PORT.committee([_free_port() for _ in range(4)]),
                    PORT.consensus.Parameters(), PORT.crypto.SignatureService(secret),
                    store, asyncio.Queue(), bind_host="127.0.0.1", transport="native",
                )
        finally:
            store.close()

    asyncio.run(body())


# ---- the transport ---------------------------------------------------------


class EchoHandler:
    """Records frames; ACKs each one (the consensus dispatch pattern)."""

    def __init__(self):
        self.frames: list[bytes] = []
        self.got = asyncio.Event()

    async def dispatch(self, writer, message: bytes) -> None:
        self.frames.append(message)
        self.got.set()
        await writer.send(b"Ack")


async def _next_frame(handler) -> None:
    await asyncio.wait_for(handler.got.wait(), TIMEOUT_S)
    handler.got.clear()


async def _until(cond, what: str) -> None:
    deadline = asyncio.get_running_loop().time() + TIMEOUT_S
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, f"timed out: {what}"
        await asyncio.sleep(0.01)


async def native_sender_to_port_asyncio_receiver(port, closers):
    handler = EchoHandler()
    recv = Receiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    sender = native.NativeSimpleSender()
    closers.append(sender.close)
    await sender.send(("127.0.0.1", port), b"hello-from-native")
    await _next_frame(handler)
    await sender.send(("127.0.0.1", port), b"second")  # the same connection
    await _next_frame(handler)
    assert handler.frames == [b"hello-from-native", b"second"]


async def port_asyncio_sender_to_native_receiver(port, closers):
    handler = EchoHandler()
    recv = native.NativeReceiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    sender = SimpleSender()
    closers.append(sender.close)
    await sender.broadcast([("127.0.0.1", port)], b"from-port-asyncio")
    await _next_frame(handler)
    assert handler.frames == [b"from-port-asyncio"]


async def native_sender_to_jax_asyncio_receiver(port, closers):
    handler = EchoHandler()
    recv = JaxReceiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    sender = native.NativeSimpleSender()
    closers.append(sender.close)
    await sender.send(("127.0.0.1", port), b"port-native-to-jax")
    await _next_frame(handler)
    assert handler.frames == [b"port-native-to-jax"]


async def jax_asyncio_sender_to_native_receiver(port, closers):
    handler = EchoHandler()
    recv = native.NativeReceiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    sender = JaxSimpleSender()
    closers.append(sender.close)
    await sender.send(("127.0.0.1", port), b"jax-asyncio-to-port-native")
    await _next_frame(handler)
    assert handler.frames == [b"jax-asyncio-to-port-native"]


async def ack_reply_on_the_accepted_connection(port, closers):
    handler = EchoHandler()
    recv = native.NativeReceiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), TIMEOUT_S)
    closers.append(writer.close)
    await send_frame(writer, b"ping-to-native")
    assert await asyncio.wait_for(read_frame(reader), TIMEOUT_S) == b"Ack"
    assert handler.frames == [b"ping-to-native"] and recv.connections == 1


async def native_to_native_roundtrip(port, closers):
    handler = EchoHandler()
    recv = native.NativeReceiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    sender = native.NativeSimpleSender()
    closers.append(sender.close)
    payload = bytes(range(256)) * 64  # a 16 KB binary frame
    await sender.send(("127.0.0.1", port), payload)
    await _next_frame(handler)
    for i in range(200):
        await sender.send(("127.0.0.1", port), b"frame-%03d" % i)
    await _until(lambda: len(handler.frames) >= 201, "200 frames")
    assert handler.frames == [payload] + [b"frame-%03d" % i for i in range(200)]


async def drop_then_reconnect(port, closers):
    sender = native.NativeSimpleSender()
    closers.append(sender.close)
    await sender.send(("127.0.0.1", port), b"lost")  # nobody listens: dropped
    await asyncio.sleep(0.3)
    handler = EchoHandler()
    recv = Receiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    for _ in range(20):  # the next send reconnects
        await sender.send(("127.0.0.1", port), b"after-reconnect")
        try:
            await asyncio.wait_for(handler.got.wait(), 0.5)
            break
        except asyncio.TimeoutError:
            continue
    assert b"after-reconnect" in handler.frames and b"lost" not in handler.frames


async def reliable_ack_futures(port, closers):
    handler = EchoHandler()
    recv = native.NativeReceiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    sender = native.NativeReliableSender()
    closers.append(sender.close)
    futs = [await sender.send(("127.0.0.1", port), b"m%d" % i) for i in range(3)]
    futs += await sender.broadcast([("127.0.0.1", port)], b"m3")
    assert await asyncio.wait_for(asyncio.gather(*futs), TIMEOUT_S) == [b"Ack"] * 4
    assert handler.frames == [b"m0", b"m1", b"m2", b"m3"]


async def reliable_retry_until_the_listener_is_up(port, closers):
    sender = native.NativeReliableSender()
    closers.append(sender.close)
    fut = await sender.send(("127.0.0.1", port), b"early-bird")
    await asyncio.sleep(0.3)
    assert not fut.done()
    handler = EchoHandler()
    recv = Receiver("127.0.0.1", port, handler)
    closers.append(recv.shutdown)
    await recv.spawn()
    assert await asyncio.wait_for(fut, TIMEOUT_S) == b"Ack"
    assert handler.frames == [b"early-bird"]


async def port_reusable_after_shutdown(port, closers):
    first = native.NativeReceiver("127.0.0.1", port, EchoHandler())
    await first.spawn()
    await first.shutdown()
    handler = EchoHandler()
    second = native.NativeReceiver("127.0.0.1", port, handler)
    closers.append(second.shutdown)
    await second.spawn()  # raises if the first listener kept the port
    sender = native.NativeSimpleSender()
    closers.append(sender.close)
    await sender.send(("127.0.0.1", port), b"to-second-listener")
    await _next_frame(handler)
    assert handler.frames == [b"to-second-listener"]


async def listen_error_on_a_port_in_use(port, closers):
    from hotstuff_tpu_torch.network import ListenError

    server = await asyncio.start_server(lambda r, w: w.close(), "127.0.0.1", port)
    closers.append(server.close)
    with pytest.raises(ListenError, match=f"127.0.0.1:{port}"):
        await native.NativeReceiver("127.0.0.1", port, EchoHandler()).spawn()


async def read_pause_flow_control(port, closers):
    """A sender blasting ~3.5x HIGH_WATER frames at a slow handler:
    reads pause past the high-water mark and resume at the low one;
    nothing is lost or reordered.  The pauses are counted where the
    receiver makes them (its reactor's ``ht_set_read_paused`` calls,
    seen through a wrapper on this receiver alone): a sampled
    ``_paused`` flag can miss a pause that a fast drain ends between
    two samples."""
    total = 900

    class Slow:
        def __init__(self):
            self.frames: list = []

        async def dispatch(self, writer, message):
            await asyncio.sleep(0)
            self.frames.append(message)

    handler = Slow()
    recv = native.NativeReceiver("127.0.0.1", port, handler)
    transitions: list = []  # (conn, 1 = paused / 0 = resumed), in call order
    real = recv.reactor

    class CountingLib:
        def __getattr__(self, name):
            return getattr(real.lib, name)

        def ht_set_read_paused(self, handle, conn, paused):
            transitions.append((conn, paused))
            return real.lib.ht_set_read_paused(handle, conn, paused)

    class CountingReactor:
        lib = CountingLib()

        def __getattr__(self, name):
            return getattr(real, name)

    recv.reactor = CountingReactor()
    closers.append(recv.shutdown)
    await recv.spawn()
    _, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), TIMEOUT_S)
    closers.append(writer.close)
    for i in range(total):
        await send_frame(writer, i.to_bytes(4, "big") + b"x" * 200)
        if i % 64 == 0:
            await asyncio.sleep(0)

    await _until(lambda: len(handler.frames) >= total, f"{total} frames")
    assert [int.from_bytes(f[:4], "big") for f in handler.frames] == list(range(total))
    pauses = [t for t in transitions if t[1] == 1]
    assert pauses, "the receiver never paused a connection's reads"
    assert not recv._paused


@pytest.mark.parametrize("case", [
    native_sender_to_port_asyncio_receiver,
    port_asyncio_sender_to_native_receiver,
    native_sender_to_jax_asyncio_receiver,
    jax_asyncio_sender_to_native_receiver,
    ack_reply_on_the_accepted_connection,
    native_to_native_roundtrip,
    drop_then_reconnect,
    reliable_ack_futures,
    reliable_retry_until_the_listener_is_up,
    port_reusable_after_shutdown,
    listen_error_on_a_port_in_use,
    read_pause_flow_control,
], ids=lambda f: f.__name__)
def test_native_transport(case):
    async def body():
        closers: list = []
        try:
            await asyncio.wait_for(case(_free_port(), closers), 3 * TIMEOUT_S)
        finally:
            for close in reversed(closers):
                result = close()
                if asyncio.iscoroutine(result):
                    await result

    asyncio.run(body())


def test_one_reactor_serves_every_loop_and_stops_at_exit():
    """The reactor is a process singleton; each ``asyncio.run`` is a new
    loop, and ``ensure_reader`` registers on each.  ``close`` (also the
    interpreter-exit hook) stops the thread and clears the singleton."""

    async def roundtrip():
        await native_to_native_roundtrip(_free_port(), closers := [])
        for close in reversed(closers):
            result = close()
            if asyncio.iscoroutine(result):
                await result

    reactor = native.Reactor.shared()
    for _ in range(2):
        asyncio.run(roundtrip())
        assert native.Reactor.shared() is reactor
    counters = reactor.counters()
    assert counters["rx_frames"] >= 2 * 201 and counters["tx_frames"] >= 2 * 201
    reactor.close()
    assert reactor.handle is None and native.Reactor._instance is None
    asyncio.run(roundtrip())  # a new reactor on first use
    assert native.Reactor.shared() is not reactor


def test_the_drain_copies_each_event_not_the_whole_buffer(monkeypatch):
    """Each reactor event costs a copy of its own bytes: the JAX drain's
    ``self._buf.raw[:n]`` copies the whole 1 MiB receive buffer first,
    one allocation and copy a frame, which held a stopping 64-node
    process's loop for seconds.  A buffer whose ``raw`` refuses must
    still deliver every frame intact."""

    class Guarded(ctypes.c_char * (1 << 20)):
        @property
        def raw(self):
            raise AssertionError("the drain copied the whole receive buffer")

    reactor = native.Reactor.shared()
    monkeypatch.setattr(reactor, "_buf", Guarded())

    async def body():
        await native_to_native_roundtrip(_free_port(), closers := [])
        for close in reversed(closers):
            result = close()
            if asyncio.iscoroutine(result):
                await result

    asyncio.run(body())


# ---- committees ------------------------------------------------------------


def test_run_committee_on_the_native_transport(monkeypatch):
    """Four port stacks on the native transport through ``run_committee``
    on the CUDA kind's host (``device="cpu"``, routing held to the CPU):
    every node commits, the chains and state roots agree, and the vote
    stream reached the ingest plane (adopted or resynced waves)."""
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    r = run_committee(nodes=4, rate=200, duration=3, verifier="cuda", device="cpu",
                      timeout_delay=1_000, transport="native")
    assert min(r["blocks"]) >= 5 and r["chains_agree"] and r["roots_agree"]
    assert r["committed_payloads"] > 0 and r["producer_conns_dropped"] == 0
    svc = r["service"]
    assert svc["cpu"] > 0 and svc["device"] == 0
    assert svc["zero_copy_waves"] + svc["fallback_waves"] > 0
    m = RE_VERIFY_STATS.search(svc["stats_line"])
    assert (int(m.group(15)), int(m.group(16))) == (svc["zero_copy_waves"], svc["fallback_waves"])


def test_mixed_committee_of_jax_and_port_nodes_on_the_native_transport(tmp_path):
    """Two JAX and two port nodes, each on its package's own native
    reactor and library: one chain, and one state root a version."""
    sides = [JAX, PORT, JAX, PORT]
    logs = _node_lines(sides)

    async def body():
        socks = reserve_ports(4)
        ports = [s.getsockname()[1] for s in socks]
        nodes = []
        feeder = None
        try:
            for i, side in enumerate(sides):
                name, secret = side.keys()[i]
                store = side.store.Store(str(tmp_path / f"db_{i}"))
                socks[i].close()
                try:
                    stack = await side.consensus.Consensus.spawn(
                        name, side.committee(ports),
                        side.consensus.Parameters(timeout_delay=1_000, sync_retry_delay=5_000),
                        side.crypto.SignatureService(secret), store, q := asyncio.Queue(),
                        bind_host="127.0.0.1", transport="native",
                    )
                except BaseException:
                    store.close()
                    raise
                nodes.append((side, stack, q, store))
            assert type(nodes[1][1].receiver) is native.NativeReceiver
            assert type(nodes[0][1].receiver).__module__ == "hotstuff_tpu.network.native"
            feeder = asyncio.ensure_future(_feed_producers(nodes))
            _assert_one_chain([await _commits(q, 6) for _, _, q, _ in nodes])
        finally:
            await _shutdown(nodes, feeder)
            for s in socks:
                s.close()

    try:
        asyncio.run(body())
        ok, violations, details = check_state_root_agreement(_roots(logs))
        assert ok is True, violations
        assert details["nodes_reporting"] == 4 and details["versions_compared"] >= 6
    finally:
        logs.close()


def test_run_many_on_the_native_transport_reads_through_the_harness_parser(tmp_path):
    """``run-many --transport native`` at 4 nodes with the port client,
    as two processes: ``LogParser`` reads commits, payloads a second and
    latency, and ``RE_VERIFY_STATS`` the live ``zc=``/``fb=`` counters
    of the wave service's last stats line."""
    write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
    keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
    log = open(tmp_path / "nodes.log", "w")
    # no warm-up: the device host never turns ready and the wave service
    # serves every wave on the CPU, adopted ones from their claim lists
    env = {**ENV, "HOTSTUFF_SKIP_WARMUP": "1"}
    nodes = client = None
    try:
        nodes = subprocess.Popen(
            CLI + ["-vv", "run-many", "--transport", "native", "--device", "cpu", "--keys", keys,
                   "--committee", str(tmp_path / "committee.json"), "--store-prefix",
                   str(tmp_path / "db_"), "--parameters", str(tmp_path / "parameters.json")],
            stdout=log, stderr=subprocess.STDOUT, env=env,
        )
        assert wait_for(lambda: (tmp_path / "nodes.log").read_text().count("successfully booted") == 4, 60)
        client = spawn_client(tmp_path, rate=400, duration=3)
        assert client.wait(timeout=60) == 0
        assert nodes.poll() is None
        nodes.send_signal(signal.SIGTERM)
        assert nodes.wait(timeout=30) == 0
    finally:
        stop_all([client, nodes])
        log.close()
    node_log = (tmp_path / "nodes.log").read_text()
    client_log = (tmp_path / "client.log").read_text()
    assert "Traceback" not in node_log + client_log
    assert node_log.count("successfully booted") == 4
    parser = LogParser([node_log], [client_log])
    assert parser.committed_payloads() > 0
    assert parser.consensus_throughput()[0] > 0 and parser.end_to_end_throughput()[0] > 0
    assert parser.end_to_end_latency() is not None
    stats = RE_VERIFY_STATS.findall(node_log)
    assert stats and stats[-1][0].startswith("cuda@cpu#")
    zc, fb = int(stats[-1][14]), int(stats[-1][15])
    assert zc + fb > 0  # the vote stream reached the ingest plane


def test_deploy_on_the_native_transport_boots_a_local_testbed(tmp_path):
    base = _free_run(4)
    log = open(tmp_path / "deploy.log", "w")
    proc = None
    try:
        proc = subprocess.Popen(
            CLI + ["-vv", "deploy", "--nodes", "4", "--base-port", str(base), "--verifier", "cpu",
                   "--transport", "native"],
            stdout=log, stderr=subprocess.STDOUT, env=ENV, cwd=tmp_path,
        )
        assert wait_for(lambda: "Deployed 4-node local testbed" in (tmp_path / "deploy.log").read_text(), 60)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        stop_all([proc])
        log.close()
    text = (tmp_path / "deploy.log").read_text()
    assert text.count("successfully booted") == 4 and "Traceback" not in text
