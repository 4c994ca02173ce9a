"""The port's chaos plane (``faults/plane.py``, ``faults/scenarios.py``)
and its seams in the senders, the receivers and ``Consensus.spawn``,
held against the JAX package.

The plane: ``corrupt_frame`` bytes, ``expand_rules`` over every sugar
form, 500-draw ``decide()`` streams on every directed link (and a
link's stream unchanged by draws on the others), ``barrier`` /
``inbound_cut`` / ``window_edges`` at fixed times, ``stats()``, spec
loading and the stale-epoch fallback, and every canned scenario.  The
transports: the same frames through a planed ``SimpleSender`` into a
``Receiver`` in each package, reliable senders across a hard cut and
under drops (``FaultDisconnect``), the native senders and receivers
with drop and barrier, and an ``isolate`` window's inbound cut.  A
4-node port committee under a split brain: commits before the window,
a stall inside it, commits again after the heal, one digest a round;
with telemetry on, the ``fault_*`` gauges, the ``fault_plane`` section
and the ``fault.open`` / ``fault.close`` journal edges.

Every listener port comes from the OS; every wait has a deadline;
every receiver, sender and stack is stopped in ``finally``."""

import asyncio
import glob
import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.invariants import check_liveness, check_safety

import hotstuff_tpu.faults.plane as jplane
import hotstuff_tpu.faults.scenarios as jscen
import hotstuff_tpu.network.native as jnative
from hotstuff_tpu import telemetry as jtel
from hotstuff_tpu.network import reliable_sender as jreliable
from hotstuff_tpu.network.receiver import Receiver as JaxReceiver
from hotstuff_tpu.network.reliable_sender import ReliableSender as JaxReliableSender
from hotstuff_tpu.network.simple_sender import SimpleSender as JaxSimpleSender
from hotstuff_tpu_torch import faults as pfaults
from hotstuff_tpu_torch import telemetry as ptel
from hotstuff_tpu_torch.bench.committee import reserve_ports
from hotstuff_tpu_torch.faults import plane as pplane
from hotstuff_tpu_torch.faults import scenarios as pscen
from hotstuff_tpu_torch.network import Receiver, ReliableSender, SimpleSender, native
from hotstuff_tpu_torch.network import reliable_sender as preliable

from .test_torch_consensus_e2e import _feed_producers, _shutdown, _spawn_one
from .test_torch_core import PORT

torch.set_num_threads(1)

EPOCH = 1_000_000.0  # scenario t=0 injected through ``now`` (no wall clock)
TIMEOUT_S = 15.0
SELF = ("127.0.0.1", 1)  # the sender's committee address in the link specs


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("HOTSTUFF_FAULTS", "HOTSTUFF_ADVERSARY", "HOTSTUFF_WAN_SPEC"):
        monkeypatch.delenv(knob, raising=False)
    jtel.reset()
    ptel.reset()
    yield
    jtel.reset()
    ptel.reset()


def _nodes(n=4):
    return {f"127.0.0.1:{9000 + i}": i for i in range(n)}


def _both(spec, self_id=0, n=4, now=EPOCH):
    """The same spec as a plane of each package, for node ``self_id``."""
    spec = dict(spec)
    spec.setdefault("epoch_unix", EPOCH)
    spec.setdefault("nodes", _nodes(n))
    addr = f"127.0.0.1:{9000 + self_id}"
    return (jplane.FaultPlane(spec, addr, now=now), pplane.FaultPlane(spec, addr, now=now))


def _rule(r):
    return tuple(getattr(r, s) for s in r.__slots__)


# ---- primitives ------------------------------------------------------------


@pytest.mark.parametrize("data", [
    b"", b"\x01", b"ab", bytes(range(32)), bytes(range(256)) * 5, b"\xee" + b"x" * 1000,
], ids=lambda d: f"len{len(d)}")
def test_corrupt_frame_gives_the_same_bytes(data):
    assert pplane.corrupt_frame(data) == jplane.corrupt_frame(data)


SUGAR = {
    "partition-halves": {"rules": [{"partition": [[0, 1], [2, 3]], "at": 6, "until": 14}]},
    "partition-three": {"rules": [{"partition": [[0], [1, 2], [3]], "at": 1, "until": 2, "label": "tri"}]},
    "partition-one-group": {"rules": [{"partition": [[0, 1, 2, 3]], "at": 1}]},
    "isolate": {"rules": [{"isolate": 2, "at": 5, "until": 9}]},
    "flapping": jscen.flapping_link(nodes=4, seed=3),
    "links": {"rules": [
        {"from": [0], "to": "*", "drop": 0.3, "delay_ms": 5, "jitter_pct": 50,
         "duplicate": 0.2, "corrupt": 0.1, "at": 0},
        {"from": 1, "to": [2, 3], "delay_ms": 20, "every": 2, "for": 0.5, "at": 1, "until": 30},
        {"to": [0], "corrupt": 0.5, "label": "named"},
    ]},
}


@pytest.mark.parametrize("name", sorted(SUGAR))
def test_expand_rules_gives_the_same_rules(name):
    jlinks, jin = jplane.expand_rules(SUGAR[name])
    plinks, pin = pplane.expand_rules(SUGAR[name])
    assert [_rule(r) for r in plinks] == [_rule(r) for r in jlinks]
    assert [_rule(r) for r in pin] == [_rule(r) for r in jin]
    for t in (0.0, 1.0, 5.0, 5.6, 6.0, 6.9, 8.2, 13.9, 14.0, 29.0, 100.0):
        assert [r.active(t) for r in plinks] == [r.active(t) for r in jlinks]
    assert [r.reps() for r in plinks] == [r.reps() for r in jlinks]


STREAMS = {
    "probabilistic": {"seed": 42, "rules": [
        {"from": "*", "to": "*", "drop": 0.3, "delay_ms": 5, "jitter_pct": 50,
         "duplicate": 0.2, "corrupt": 0.1, "at": 0, "until": 1e9}]},
    "windows": {"seed": 7, "rules": [
        {"partition": [[0, 1], [2, 3]], "at": 4, "until": 9},
        {"from": [0, 2], "to": [1, 3], "drop": 0.5, "duplicate": 0.4, "at": 2, "until": 20,
         "every": 3, "for": 1.5},
        {"from": [3], "to": "*", "delay_ms": 30, "jitter_pct": 20, "corrupt": 0.3, "at": 12}]},
}
LINKS = [(s, d) for s in range(4) for d in range(4) if s != d]


@pytest.mark.parametrize("src, dst", LINKS, ids=lambda v: str(v))
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decision_streams_are_equal_on_every_link(name, src, dst):
    """500 decisions on one directed link, at times that cross the
    spec's windows, are equal; so are the plane's counts and stats."""
    j, p = _both(STREAMS[name], self_id=src)
    addr = f"127.0.0.1:{9000 + dst}"
    jl, pl = j.link(addr), p.link(addr)
    assert (jl is None) == (pl is None)
    if pl is None:
        return
    times = [EPOCH + 0.05 * k for k in range(500)]
    assert [tuple(pl.decide(now=t)) for t in times] == [tuple(jl.decide(now=t)) for t in times]
    assert (pl.seq, pl.dropped) == (jl.seq, jl.dropped) == (500, pl.dropped)
    assert p.counts == j.counts
    assert p.stats() == j.stats()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_a_links_stream_does_not_depend_on_the_other_links(name):
    """Link 0->1 drawn alone equals link 0->1 drawn interleaved with
    0->2 and 0->3, in both packages and across them."""
    streams = []
    for mod in (jplane, pplane):
        for interleave in (False, True):
            spec = {**STREAMS[name], "epoch_unix": EPOCH, "nodes": _nodes()}
            plane = mod.FaultPlane(spec, "127.0.0.1:9000", now=EPOCH)
            out = []
            for k in range(200):
                t = EPOCH + 0.1 * k
                out.append(tuple(plane.link("127.0.0.1:9001").decide(now=t)))
                if interleave:
                    plane.link("127.0.0.1:9002").decide(now=t)
                    plane.link("127.0.0.1:9003").barrier(now=t)
                    plane.link("127.0.0.1:9003").decide(now=t)
            streams.append(out)
    assert all(s == streams[0] for s in streams)


@pytest.mark.parametrize("name", ["partition", "isolate", "flapping"])
def test_barrier_inbound_cut_and_window_edges_agree(name):
    spec = {
        "partition": {"seed": 0, "rules": [{"partition": [[0, 1], [2, 3]], "at": 6, "until": 14,
                                            "label": "p"}]},
        "isolate": {"seed": 0, "rules": [{"isolate": 2, "at": 3, "until": 8}]},
        "flapping": jscen.flapping_link(nodes=4, seed=0),
    }[name]
    times = [EPOCH + t for t in (0, 2.9, 3.0, 5, 5.9, 6, 6.4, 6.5, 7, 8, 9.5, 13.9, 14, 17, 30)]
    for self_id in range(4):
        j, p = _both(spec, self_id=self_id)
        assert p.window_edges() == j.window_edges()
        assert (p.self_id, p.epoch, p.describe()) == (j.self_id, j.epoch, j.describe())
        assert [p.inbound_cut(now=t) for t in times] == [j.inbound_cut(now=t) for t in times]
        for dst in range(4):
            jl, pl = j.link(f"127.0.0.1:{9000 + dst}"), p.link(f"127.0.0.1:{9000 + dst}")
            assert (jl is None) == (pl is None)
            if pl is not None:
                assert [pl.barrier(now=t) for t in times] == [jl.barrier(now=t) for t in times]
                assert pl.seq == jl.seq == 0  # barrier() draws nothing
        assert p.stats() == j.stats()


def test_specs_load_inline_and_from_a_file_the_same(tmp_path):
    spec = {"name": "x", "seed": 1, "nodes": _nodes(), "epoch_unix": EPOCH,
            "rules": [{"partition": [[0, 1], [2, 3]], "at": 2, "until": 4}]}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    for source, addr in ((json.dumps(spec), "127.0.0.1:9002"), (str(path), ("127.0.0.1", 9002)),
                         ("  " + json.dumps(spec), ("127.0.0.1", 9002))):
        j = jplane.FaultPlane.load(source, addr, now=EPOCH)
        p = pplane.FaultPlane.load(source, addr, now=EPOCH)
        assert (p.self_id, p.name, p.seed, p.epoch) == (j.self_id, j.name, j.seed, j.epoch) == (2, "x", 1, EPOCH)
        assert [_rule(r) for r in p.rules] == [_rule(r) for r in j.rules]
    for mod in (jplane, pplane):
        with pytest.raises(FileNotFoundError):
            mod.FaultPlane.load(str(tmp_path / "missing.json"), "127.0.0.1:9000")
        with pytest.raises(json.JSONDecodeError):
            mod.FaultPlane.load("{not json", "127.0.0.1:9000")


@pytest.mark.parametrize("epoch, want", [
    (EPOCH - 10_000, EPOCH),  # stale: boot time
    (EPOCH - 3_599, EPOCH - 3_599),  # inside the hour: kept
    (EPOCH + 60, EPOCH + 60),  # in the future: kept
    (None, EPOCH),  # absent: boot time
])
def test_the_stale_epoch_falls_back_to_boot_time(epoch, want):
    spec = {"seed": 0, "nodes": {"127.0.0.1:9000": 0}, "rules": []}
    if epoch is not None:
        spec["epoch_unix"] = epoch
    j = jplane.FaultPlane(spec, "127.0.0.1:9000", now=EPOCH)
    p = pplane.FaultPlane(spec, "127.0.0.1:9000", now=EPOCH)
    assert p.epoch == j.epoch == want


def test_a_spec_that_does_not_name_the_node_leaves_its_plane_inert():
    spec = {"seed": 3, "nodes": _nodes(), "epoch_unix": EPOCH,
            "rules": [{"isolate": 1, "at": 0}, {"from": "*", "to": "*", "drop": 0.5}]}
    for mod in (jplane, pplane):
        plane = mod.FaultPlane(spec, "127.0.0.1:7777", now=EPOCH)
        assert plane.self_id is None
        assert all(plane.link(a) is None for a in _nodes())
        assert not plane.inbound_cut(now=EPOCH + 1)
    j = jplane.FaultPlane(spec, "127.0.0.1:7777", now=EPOCH)
    p = pplane.FaultPlane(spec, "127.0.0.1:7777", now=EPOCH)
    j.link("127.0.0.1:9000"), p.link("127.0.0.1:9000")
    assert p.stats() == j.stats()


# ---- canned scenarios ------------------------------------------------------


def test_the_scenario_catalogue_is_the_references():
    assert list(pscen.SCENARIOS) == list(jscen.SCENARIOS)
    assert sorted(pscen.__all__) == sorted(jscen.__all__)
    # the package exports the JAX package's names: the plane's, the
    # scenarios' and, since the adversary plane is ported, its and the
    # adaptive policies'
    import hotstuff_tpu.faults as jfaults

    assert sorted(pfaults.__all__) == sorted(jfaults.__all__)


@pytest.mark.parametrize("n", [4, 64])
@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_every_scenario_builds_the_same_spec(name, n):
    spec = pscen.build(name, nodes=n, seed=11)
    assert spec == jscen.build(name, nodes=n, seed=11)
    assert pscen.SCENARIOS[name](nodes=n) == jscen.SCENARIOS[name](nodes=n)
    assert pscen.last_heal(spec) == jscen.last_heal(spec)
    # the port's plane reads the same rules out of it
    spec = {**spec, "epoch_unix": EPOCH, "nodes": _nodes(n)}
    j = jplane.FaultPlane(spec, "127.0.0.1:9000", now=EPOCH)
    p = pplane.FaultPlane(spec, "127.0.0.1:9000", now=EPOCH)
    assert [_rule(r) for r in p.rules] == [_rule(r) for r in j.rules]
    assert p.window_edges() == j.window_edges()


@pytest.mark.parametrize("spec", [
    {"rules": [{"drop": 1.0, "until": None}]},
    {"rules": [{"label": "quiet", "at": 0, "until": 5}]},
    {"rules": [{"delay_ms": 5, "until": 9}], "crashes": [{"node": 1, "restart_at": 12}]},
    {"crashes": [{"node": 1}]},
    {"adversary": [{"policy": "withhold", "until": 7}, {"policy": "equivocate"}]},
    {"adversary": [{"policy": "timeout-surfer"}]},
], ids=["unbounded", "non-impairing", "crash-last", "crash-unbounded", "withhold", "surfer"])
def test_last_heal_is_the_references(spec):
    assert pscen.last_heal(spec) == jscen.last_heal(spec)


def test_an_unknown_scenario_raises_the_same_error():
    errors = []
    for mod in (jscen, pscen):
        with pytest.raises(ValueError) as e:
            mod.build("no-such-scenario")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---- the asyncio transport -------------------------------------------------


class _Sink:
    """Records frames; ACKs each one when ``ack``."""

    def __init__(self, ack=True):
        self.frames: list[bytes] = []
        self.ack = ack

    async def dispatch(self, writer, message: bytes) -> None:
        self.frames.append(message)
        if self.ack:
            await writer.send(b"Ack")


async def _until(cond, what: str, timeout=TIMEOUT_S) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, f"timed out: {what}"
        await asyncio.sleep(0.01)


def _link_spec(dst_port: int, rules, seed=5, epoch=None):
    """Node 0 is ``SELF``, node 1 the receiver on ``dst_port``."""
    return {
        "seed": seed,
        "epoch_unix": time.time() - 1 if epoch is None else epoch,
        "nodes": {f"{SELF[0]}:{SELF[1]}": 0, f"127.0.0.1:{dst_port}": 1},
        "rules": rules,
    }


def _expected(spec, frames, mod=jplane, duplicates=True, corrupt=True):
    """What a best-effort link delivers: each frame's decision drawn
    from a fresh plane (the stream does not depend on the time)."""
    link = mod.FaultPlane(spec, SELF, now=spec["epoch_unix"]).link(next(
        a for a, i in spec["nodes"].items() if i == 1))
    out = []
    for frame in frames:
        d = link.decide(now=spec["epoch_unix"] + 1)
        if d.drop:
            continue
        data = mod.corrupt_frame(frame) if (d.corrupt and corrupt) else frame
        out += [data] * (2 if (d.duplicate and duplicates) else 1)
    return out


FRAMES = [b"\xee" + b"frame-%04d" % i for i in range(300)]
LOSSY = [{"from": [0], "to": [1], "drop": 0.2, "duplicate": 0.15, "corrupt": 0.1,
          "delay_ms": 0.5, "jitter_pct": 50, "at": 0, "until": 1e9}]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_planed_simple_sender_delivers_the_decided_frames(side):
    """300 frames through a ``SimpleSender`` whose plane drops,
    duplicates, corrupts and delays reach the package's ``Receiver`` as
    the decision stream says, equal across the packages."""
    recv_cls, send_cls, mod = {
        "jax": (JaxReceiver, JaxSimpleSender, jplane),
        "port": (Receiver, SimpleSender, pplane),
    }[side]

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        spec = _link_spec(port, LOSSY)
        want = _expected(spec, FRAMES)
        assert want == _expected(spec, FRAMES, mod=pplane)
        sink = _Sink(ack=False)
        recv = recv_cls("127.0.0.1", port, sink)
        plane = mod.FaultPlane(spec, SELF)
        sender = send_cls(fault_plane=plane)
        try:
            sock.close()
            await recv.spawn()
            for frame in FRAMES:
                await sender.send(("127.0.0.1", port), frame)
            await _until(lambda: len(sink.frames) >= len(want), "the decided frames")
            await asyncio.sleep(0.1)  # nothing beyond them arrives
            assert sink.frames == want
            stats = plane.stats()
            assert stats["links"] == {f"127.0.0.1:{port}": {"seq": 300, "dropped": stats["dropped"]}}
            assert stats["dropped"] > 0 and stats["duplicated"] > 0 and stats["corrupted"] > 0
            assert stats["delayed"] == 300 - stats["dropped"]
        finally:
            sender.close()
            await recv.shutdown()

    asyncio.run(body())


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_reliable_sender_holds_frames_through_a_hard_cut(side):
    """Frames sent inside a hard cut are held, not lost: none arrives
    until the heal, then every frame arrives once, in order, and every
    ACK future resolves."""
    recv_cls, send_cls, mod = {
        "jax": (JaxReceiver, JaxReliableSender, jplane),
        "port": (Receiver, ReliableSender, pplane),
    }[side]

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        epoch = time.time()
        spec = _link_spec(port, [{"partition": [[0], [1]], "at": 1.0, "until": 3.0}], epoch=epoch)
        sink = _Sink()
        recv = recv_cls("127.0.0.1", port, sink)
        plane = mod.FaultPlane(spec, SELF)
        sender = send_cls(fault_plane=plane)
        addr = ("127.0.0.1", port)
        try:
            sock.close()
            await recv.spawn()
            before = [await sender.send(addr, b"before-%d" % i) for i in range(10)]
            assert await asyncio.wait_for(asyncio.gather(*before), TIMEOUT_S) == [b"Ack"] * 10
            await asyncio.sleep(max(0.0, epoch + 1.2 - time.time()))
            link = plane.link(addr)
            assert link.barrier()
            during = [await sender.send(addr, b"during-%d" % i) for i in range(10)]
            await asyncio.sleep(max(0.0, epoch + 2.5 - time.time()))
            assert len(sink.frames) == 10 and not any(f.done() for f in during)
            assert await asyncio.wait_for(asyncio.gather(*during), TIMEOUT_S) == [b"Ack"] * 10
            assert time.time() >= epoch + 3.0
            assert sink.frames == [b"before-%d" % i for i in range(10)] + [b"during-%d" % i for i in range(10)]
            assert link.dropped == 0 and plane.counts["dropped"] == 0
        finally:
            sender.close()
            await recv.shutdown()

    asyncio.run(body())


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_reliable_sender_under_drops_delivers_every_frame(side):
    """A drawn drop tears the connection (``FaultDisconnect``): the frame
    rides the reconnect and retransmit path, so every frame arrives, the
    first copies in order, and every ACK future resolves."""
    recv_cls, send_cls, mod = {
        "jax": (JaxReceiver, JaxReliableSender, jplane),
        "port": (Receiver, ReliableSender, pplane),
    }[side]

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        spec = _link_spec(port, [{"from": [0], "to": [1], "drop": 0.25, "at": 0}])
        sink = _Sink()
        recv = recv_cls("127.0.0.1", port, sink)
        plane = mod.FaultPlane(spec, SELF)
        sender = send_cls(fault_plane=plane)
        addr = ("127.0.0.1", port)
        frames = [b"m-%03d" % i for i in range(40)]
        try:
            sock.close()
            await recv.spawn()
            futs = [await sender.send(addr, f) for f in frames]
            assert await asyncio.wait_for(asyncio.gather(*futs), 30) == [b"Ack"] * len(frames)
            firsts = list(dict.fromkeys(sink.frames))
            assert firsts == frames
            assert plane.counts["dropped"] > 0
        finally:
            sender.close()
            await recv.shutdown()

    asyncio.run(body())


@pytest.mark.parametrize("kind", ["drop", "corrupt"])
def test_a_drop_or_a_corruption_raises_fault_disconnect(kind, monkeypatch):
    """On a reliable link a drawn drop writes nothing and raises
    ``FaultDisconnect``; a corruption writes the mangled frame, then
    raises it: the same in both packages."""
    seen = {}
    for name, mod, rel in (("jax", jplane, jreliable), ("port", pplane, preliable)):
        assert issubclass(rel.FaultDisconnect, ConnectionError)
        written = []

        async def fake_send(writer, data, written=written):
            written.append(data)

        monkeypatch.setattr(rel, "send_frame", fake_send)
        decision = mod.Decision(drop=True) if kind == "drop" else mod.Decision(corrupt=True)
        faults = SimpleNamespace(barrier=lambda: False, decide=lambda d=decision: d)
        conn = SimpleNamespace(_faults=faults, _flows=None, address=("127.0.0.1", 9))
        with pytest.raises(rel.FaultDisconnect) as e:
            asyncio.run(rel._Connection._transmit(conn, None, b"frame-bytes"))
        seen[name] = (str(e.value), written)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == ([] if kind == "drop" else [jplane.corrupt_frame(b"frame-bytes")])


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("transport", ["asyncio", "native"])
def test_an_isolate_window_cuts_the_receivers_inbound_frames(side, transport):
    """Inside an ``isolate`` window the isolated node's receiver
    swallows every frame, also from a sender with no plane (a client);
    after it, frames are dispatched again."""
    mod = {"jax": jplane, "port": pplane}[side]
    recv_cls = {
        ("jax", "asyncio"): JaxReceiver, ("port", "asyncio"): Receiver,
        ("jax", "native"): jnative.NativeReceiver, ("port", "native"): native.NativeReceiver,
    }[side, transport]

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        epoch = time.time()
        spec = {"seed": 1, "epoch_unix": epoch, "nodes": {f"127.0.0.1:{port}": 1, "127.0.0.1:1": 0},
                "rules": [{"isolate": 1, "at": 0.0, "until": 2.0}]}
        plane = mod.FaultPlane(spec, ("127.0.0.1", port))
        sink = _Sink(ack=False)
        recv = recv_cls("127.0.0.1", port, sink, fault_plane=plane)
        sender = SimpleSender()  # a client: no plane of its own
        try:
            sock.close()
            await recv.spawn()
            for i in range(5):
                await sender.send(("127.0.0.1", port), b"cut-%d" % i)
            await _until(lambda: plane.counts["inbound_dropped"] >= 5, "the cut frames")
            assert time.time() < epoch + 2.0, "the host was too slow for the window"
            await asyncio.sleep(max(0.0, epoch + 2.05 - time.time()))
            for i in range(3):
                await sender.send(("127.0.0.1", port), b"after-%d" % i)
            await _until(lambda: len(sink.frames) >= 3, "the frames after the window")
            assert sink.frames == [b"after-%d" % i for i in range(3)]
            assert plane.counts["inbound_dropped"] == 5
        finally:
            sender.close()
            await recv.shutdown()

    asyncio.run(body())


# ---- the native transport --------------------------------------------------


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_planed_native_simple_sender_delivers_the_decided_frames(side):
    """Drops only (the native sender's drop skips ``ht_send``): the
    native receiver gets the frames the stream keeps, in order."""
    mod, sender_cls, recv_cls = {
        "jax": (jplane, jnative.NativeSimpleSender, jnative.NativeReceiver),
        "port": (pplane, native.NativeSimpleSender, native.NativeReceiver),
    }[side]
    frames = FRAMES[:200]

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        spec = _link_spec(port, [{"from": [0], "to": [1], "drop": 0.3, "at": 0, "until": 1e9}])
        want = _expected(spec, frames)
        sink = _Sink(ack=False)
        recv = recv_cls("127.0.0.1", port, sink)
        plane = mod.FaultPlane(spec, SELF)
        sender = sender_cls(fault_plane=plane)
        try:
            sock.close()
            await recv.spawn()
            for frame in frames:
                await sender.send(("127.0.0.1", port), frame)
            await _until(lambda: len(sink.frames) >= len(want), "the kept frames")
            await asyncio.sleep(0.1)
            assert sink.frames == want
            assert plane.counts["dropped"] == len(frames) - len(want) > 0
        finally:
            sender.close()
            await recv.shutdown()

    asyncio.run(body())


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("fault", ["barrier", "drop"])
def test_a_native_reliable_sender_holds_the_line_and_loses_nothing(side, fault):
    """A hard cut or a drawn drop holds the head of the line: every
    frame arrives once, in order, and every ACK future resolves."""
    mod, sender_cls, recv_cls = {
        "jax": (jplane, jnative.NativeReliableSender, jnative.NativeReceiver),
        "port": (pplane, native.NativeReliableSender, native.NativeReceiver),
    }[side]

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        epoch = time.time()
        rules = ([{"partition": [[0], [1]], "at": 0.5, "until": 2.5}] if fault == "barrier"
                 else [{"from": [0], "to": [1], "drop": 0.3, "at": 0}])
        spec = _link_spec(port, rules, epoch=epoch)
        sink = _Sink()
        recv = recv_cls("127.0.0.1", port, sink)
        plane = mod.FaultPlane(spec, SELF)
        sender = sender_cls(fault_plane=plane)
        addr = ("127.0.0.1", port)
        frames = [b"r-%03d" % i for i in range(40)]
        try:
            sock.close()
            await recv.spawn()
            futs = [await sender.send(addr, f) for f in frames[:20]]
            if fault == "barrier":
                assert await asyncio.wait_for(asyncio.gather(*futs), TIMEOUT_S) == [b"Ack"] * 20
                await asyncio.sleep(max(0.0, epoch + 0.6 - time.time()))
            futs += [await sender.send(addr, f) for f in frames[20:]]
            if fault == "barrier":
                await asyncio.sleep(max(0.0, epoch + 2.0 - time.time()))
                assert len(sink.frames) == 20 and not any(f.done() for f in futs[20:])
            assert await asyncio.wait_for(asyncio.gather(*futs), TIMEOUT_S) == [b"Ack"] * 40
            assert sink.frames == frames
            if fault == "drop":
                assert plane.counts["dropped"] > 0
        finally:
            sender.close()
            await recv.shutdown()

    asyncio.run(body())


# ---- a 4-node committee ----------------------------------------------------

PARTITION_AT = 3.0
HEAL_AT = 7.0


async def _committee(tmp_path, make_spec, monkeypatch, timeout_delay=500, telemetry=None):
    """Four port stacks under ``HOTSTUFF_FAULTS=make_spec(ports)``."""
    socks = reserve_ports(4)
    ports = [s.getsockname()[1] for s in socks]
    monkeypatch.setenv("HOTSTUFF_FAULTS", json.dumps(make_spec(ports)))
    nodes = []
    try:
        for i in range(4):
            socks[i].close()
            if telemetry is None:
                nodes.append(await _spawn_one(PORT, tmp_path, i, ports, timeout_delay, 5_000))
                continue
            name, secret = PORT.keys()[i]
            store = PORT.store.Store(str(tmp_path / f"db_{i}"))
            commit_q = asyncio.Queue()
            stack = await PORT.consensus.Consensus.spawn(
                name, PORT.committee(ports),
                PORT.consensus.Parameters(timeout_delay=timeout_delay, sync_retry_delay=5_000),
                PORT.crypto.SignatureService(secret), store, commit_q, bind_host="127.0.0.1",
                telemetry=telemetry(name),
            )
            nodes.append((PORT, stack, commit_q, store))
    except BaseException:
        await _shutdown(nodes, None)
        raise
    finally:
        for s in socks:
            s.close()
    return nodes


def test_split_brain_stalls_a_port_committee_and_it_heals(tmp_path, monkeypatch):
    """The split brain of the reference's ``test_chaos_e2e.py`` on four
    port stacks: commits before the window, no new round inside it (2
    against 2: neither half has quorum), a new round within 25 s of the
    heal, and one digest a round on every node."""
    epoch = time.time()

    def spec(ports):
        return {"name": "smoke-split-brain", "seed": 7, "epoch_unix": epoch,
                "nodes": {f"127.0.0.1:{p}": i for i, p in enumerate(ports)},
                "rules": [{"label": "split", "partition": [[0, 1], [2, 3]],
                           "at": PARTITION_AT, "until": HEAL_AT}]}

    async def body():
        nodes = await _committee(tmp_path, spec, monkeypatch)
        feeder = asyncio.ensure_future(_feed_producers(nodes))
        records = {f"node-{i}": [] for i in range(4)}

        async def collect(i, q):
            while True:
                block = await q.get()
                records[f"node-{i}"].append((time.time(), block.round, str(block.digest())))

        collectors = [asyncio.ensure_future(collect(i, q)) for i, (_, _, q, _) in enumerate(nodes)]
        try:
            heal_unix = epoch + HEAL_AT
            recovered = False
            while time.time() < heal_unix + 25.0:
                if check_liveness(records, heal_unix=heal_unix)[0]:
                    recovered = True
                    break
                await asyncio.sleep(0.5)
            every = [obs for commits in records.values() for obs in commits]
            assert [r for t, r, _ in every if t <= epoch + PARTITION_AT], "no commit before the window"
            assert recovered, f"no new round within 25 s of the heal: {sorted({r for _, r, _ in every})}"
            stall_from = epoch + PARTITION_AT + 1.5
            pre = [r for t, r, _ in every if t <= stall_from]
            during = [r for t, r, _ in every if stall_from < t <= heal_unix]
            assert not during or max(during) <= max(pre), "rounds advanced inside the window"
            ok, violations = check_safety(records)
            assert ok, violations
            for _, stack, _, _ in nodes:
                assert stack.receiver._faults is not None
            planes = [stack.receiver._faults for _, stack, _, _ in nodes]
            assert sorted(p.self_id for p in planes) == [0, 1, 2, 3]
            assert all(p.counts["dropped"] > 0 and p.counts["inbound_dropped"] == 0 for p in planes)
        finally:
            for c in collectors:
                c.cancel()
            await _shutdown(nodes, feeder)

    asyncio.run(body())


def test_a_port_committee_with_telemetry_shows_the_planes_gauges_section_and_edges(tmp_path, monkeypatch):
    """With telemetry on, every node registers the five ``fault_*``
    gauges, snapshots a ``fault_plane`` section equal to its plane's
    ``stats()``, and journals ``fault.open`` / ``fault.close`` at the
    window's edges."""
    from hotstuff_tpu_torch.telemetry.journal import Journal

    ptel.enable()
    epoch = time.time()
    jdir = tmp_path / "journals"
    journals = []

    def make_tel(name):
        tel = ptel.for_node(str(name)[:8])
        journal = Journal(tel.node, str(jdir), buffer_records=1)
        journals.append(journal)
        tel.attach_journal(journal)
        return tel

    def spec(ports):
        return {"name": "edges", "seed": 2, "epoch_unix": epoch,
                "nodes": {f"127.0.0.1:{p}": i for i, p in enumerate(ports)},
                "rules": [{"label": "cut", "isolate": 3, "at": 1.0, "until": 2.0}]}

    async def body():
        nodes = await _committee(tmp_path, spec, monkeypatch, timeout_delay=300, telemetry=make_tel)
        feeder = asyncio.ensure_future(_feed_producers(nodes))
        client = SimpleSender()  # no plane: its frames die at node 3's receiver
        try:
            await asyncio.sleep(max(0.0, epoch + 1.2 - time.time()))
            isolated = next(s for _, s, _, _ in nodes if s.receiver._faults.self_id == 3)
            for i in range(5):
                await client.send(("127.0.0.1", isolated.receiver.port), b"\xee client %d" % i)
            await asyncio.sleep(max(0.0, epoch + 2.5 - time.time()))
            text = ptel.registry().render_prometheus()
            snaps = ptel.snapshot_all()
        finally:
            client.close()
            await _shutdown(nodes, feeder)
            for j in journals:
                j.close()
        return text, snaps

    text, snaps = asyncio.run(body())
    for count in ("dropped", "delayed", "duplicated", "corrupted", "inbound_dropped"):
        assert text.count(f"hotstuff_fault_{count}{{") == 4
    assert len(snaps) == 4
    sections = sorted((s["fault_plane"] for s in snaps.values()), key=lambda s: s["node"])
    assert [s["node"] for s in sections] == [0, 1, 2, 3]
    assert all(s["scenario"] == "edges" and s["seed"] == 2 for s in sections)
    assert sections[3]["dropped"] > 0 and sections[3]["inbound_dropped"] >= 5
    assert all(s["inbound_dropped"] == 0 for s in sections[:3])
    edges = []
    for path in glob.glob(str(jdir / "*.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if str(rec.get("e", "")).startswith("fault."):
                    edges.append((rec["e"], rec.get("p"), rec["w"] / 1e9 - epoch))
    assert sorted(e for e, _, _ in edges) == ["fault.close"] * 4 + ["fault.open"] * 4
    assert all(p == "cut" for _, p, _ in edges)
    for kind, _, t in edges:
        want = 1.0 if kind == "fault.open" else 2.0
        assert want - 0.05 <= t <= want + 1.0, (kind, t)
