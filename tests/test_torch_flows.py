"""The port's wire-level flow accounting (``telemetry/flows.py``) against
the JAX package's, at zero tolerance (integer bytes, equal dicts):

- the byte->class map for all 256 first bytes, pinned against both
  packages' live wire tags, and the registered class list;
- one seeded sequence of ``tx``/``rx``/``logical``/retransmit charges
  over 12 peers into both accountants: ``snapshot()``, ``table()``,
  ``amplification()``, ``peer_totals()`` and the sampled
  ``net.tx``/``net.rx`` journal records, under ``HOTSTUFF_NET_TOPK`` 8
  and 2 and ``HOTSTUFF_NET=0``;
- ``/metrics`` text and the snapshot of a port and a JAX
  ``NodeTelemetry`` after the same charges, byte for byte;
- the port's asyncio simple and reliable senders and receiver charging
  exact frame bytes (4 + payload) by class, with the same ledgers as
  the JAX transports on the same frames, and the native loopback, whose
  ledgers equal the reactor's own byte and frame counters;
- one node's egress series from a 64-node ``run-many --health``
  committee on the card, replayed through both packages' health
  monitors: both open ``bandwidth_storm`` at the same tick;
- a 4-node port committee with telemetry on (``run_committee``): every
  snapshot has ``flows`` with the JAX keys and a leader that answered no
  sync request reads a ``propose`` amplification of exactly 3; and the
  2 JAX + 2 port committee, whose two packages' ``flows`` sections have
  the same keys.

Every listener port comes from the OS; every wait has a deadline;
every receiver, sender and stack is stopped in ``finally``."""

import asyncio

import numpy as np
import pytest
import torch

from hotstuff_tpu import telemetry as jtel
from hotstuff_tpu.consensus import wire as jwire
from hotstuff_tpu.network import Receiver as JReceiver
from hotstuff_tpu.network import ReliableSender as JReliableSender
from hotstuff_tpu.network import SimpleSender as JSimpleSender
from hotstuff_tpu.telemetry import flows as jflows
from hotstuff_tpu.telemetry import health as jhealth
from hotstuff_tpu.telemetry.metrics import Registry as JRegistry
from hotstuff_tpu.telemetry.taxonomy import FLOW_CLASSES as J_FLOW_CLASSES
from hotstuff_tpu_torch import telemetry as ptel
from hotstuff_tpu_torch.bench.committee import reserve_ports, run_committee
from hotstuff_tpu_torch.consensus import wire as pwire
from hotstuff_tpu_torch.network import Receiver, ReliableSender, SimpleSender, native
from hotstuff_tpu_torch.telemetry import flows as pflows
from hotstuff_tpu_torch.telemetry import health as phealth
from hotstuff_tpu_torch.telemetry.metrics import Registry as PRegistry
from hotstuff_tpu_torch.telemetry.taxonomy import FLOW_CLASSES

from .test_torch_core import JAX, PORT

SEED = 20_261_017
TIMEOUT_S = 10.0
FLOW_KNOBS = ("HOTSTUFF_NET", "HOTSTUFF_NET_TOPK", "HOTSTUFF_NET_SAMPLE")
TELEMETRY_KNOBS = ("HOTSTUFF_TELEMETRY", "HOTSTUFF_METRICS_PORT", "HOTSTUFF_JOURNAL",
                   "HOTSTUFF_JOURNAL_DIR", "HOTSTUFF_PROFILE", "HOTSTUFF_WORK_STATS")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in FLOW_KNOBS + TELEMETRY_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    jtel.reset()
    ptel.reset()
    yield
    jtel.reset()
    ptel.reset()


# ---- the class map ---------------------------------------------------------


def test_frame_class_of_every_first_byte_and_the_class_list():
    for b in range(256):
        for body in (b"", b"\x00" * 40):
            frame = bytes([b]) + body
            assert pflows.frame_class(frame) == jflows.frame_class(frame), b
    assert pflows.frame_class(b"") == jflows.frame_class(b"") == "other"
    assert pflows._TAG_CLASS == jflows._TAG_CLASS
    assert pflows.FRAME_OVERHEAD == jflows.FRAME_OVERHEAD == 4
    assert FLOW_CLASSES == J_FLOW_CLASSES
    for wire in (pwire, jwire):
        assert pflows.frame_class(bytes([wire.TAG_PROPOSE])) == "propose"
        assert pflows.frame_class(bytes([wire.TAG_VOTE])) == "vote"
        assert pflows.frame_class(bytes([wire.TAG_TIMEOUT])) == "timeout"
        assert pflows.frame_class(bytes([wire.TAG_TC])) == "tc"
        assert pflows.frame_class(bytes([wire.TAG_SYNC_REQUEST])) == "sync-req"
        assert pflows.frame_class(bytes([wire.TAG_PRODUCER])) == "producer-v1"
        assert pflows.frame_class(bytes([wire.TAG_PRODUCER_V2])) == "producer-v2"
        for tag in (wire.TAG_STATE_REQUEST, wire.TAG_STATE_MANIFEST, wire.TAG_STATE_CHUNK,
                    wire.TAG_STATE_READ, wire.STATE_VALUE_TAG):
            assert pflows.frame_class(bytes([tag])) == "state-sync"
        assert pflows.frame_class(bytes([wire.TAG_RECONFIG])) == "reconfig"
        assert pflows.frame_class(wire.ACK) == "ack"
        assert pflows.frame_class(bytes([wire.INGEST_ACK_TAG])) == "ingest-ack"
    for b in range(256):
        assert pflows.frame_class(bytes([b])) in FLOW_CLASSES


# ---- one seeded charge sequence through both accountants -------------------

#: 12 peers: six with committee labels, four known by address only (their
#: host is the label), a native accepted connection and a bare string
PEERS = [(f"10.0.0.{i}", 9000 + i) for i in range(10)] + [("native", 7), "client-x"]
LABELS = [(f"peer{i:02d}ab", PEERS[i]) for i in range(6)]
TAGS = list(range(12)) + [0x41, 0xA2, 0xA3, 0x7F, 0xFF]


def _charges(seed: int, n: int = 700) -> list:
    """(kind, peer, payload, calls): ``kind`` is tx, rx, logical or retx."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = ("tx", "rx", "logical", "retx")[int(rng.integers(0, 4))]
        peer = PEERS[int(rng.integers(0, len(PEERS)))]
        if rng.random() < 0.03:
            payload = b""
        else:
            size = int(rng.choice([0, 1, 37, 512, 4096]))
            payload = bytes([TAGS[int(rng.integers(0, len(TAGS)))]]) + rng.bytes(size)
        ops.append((kind, peer, payload, int(rng.integers(1, 4))))
    return ops


def _charge(acc, ops) -> None:
    for kind, peer, payload, calls in ops:
        if kind == "tx":
            acc.tx(peer, payload)
        elif kind == "rx":
            acc.rx(peer, payload)
        elif kind == "logical":
            acc.logical(payload, calls=calls)
        else:
            acc.tx(peer, payload, retx=True)


class _Records:
    """A journal stand-in that keeps every record call."""

    def __init__(self):
        self.calls: list = []

    def record(self, event, **kw):
        self.calls.append((event, tuple(sorted(kw.items()))))


def _ledgers(mod, ops) -> dict:
    acc = mod.FlowAccounting("n0")
    acc.label_peers(LABELS)
    journal = _Records()
    acc.bind_journal(lambda: journal)
    _charge(acc, ops)
    return {
        "enabled": acc.enabled,
        "snapshot": acc.snapshot(),
        "table": acc.table(),
        "amp": acc.amplification(),
        "peers": acc.peer_totals(),
        "classes": acc.class_totals(),
        "bytes": (acc.tx_bytes(), acc.rx_bytes(), acc.retx_bytes()),
        "journal": journal.calls,
    }


@pytest.mark.parametrize("env", [
    {},
    {"HOTSTUFF_NET_TOPK": "2", "HOTSTUFF_NET_SAMPLE": "7"},
    {"HOTSTUFF_NET_TOPK": "0", "HOTSTUFF_NET_SAMPLE": "0"},
    {"HOTSTUFF_NET": "0"},
], ids=["defaults", "topk2-sample7", "topk0-sample0", "net-off"])
def test_seeded_charges_give_equal_ledgers(monkeypatch, env):
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    ops = _charges(SEED)
    port, ref = _ledgers(pflows, ops), _ledgers(jflows, ops)
    assert port == ref
    snap = port["snapshot"]
    if env.get("HOTSTUFF_NET") == "0":
        assert snap == {"enabled": False} and port["table"] == {"flows": {}, "logical": {}}
        assert port["journal"] == [] and port["bytes"] == (0, 0, 0)
        return
    topk = int(env.get("HOTSTUFF_NET_TOPK", "8"))
    assert len(port["peers"]) == len(PEERS)
    shown = len(PEERS) if topk == 0 else topk
    assert len(snap["peers"]) == shown and snap["peers_elided"] == len(PEERS) - shown
    # eliding peers never elides bytes, and the class split covers them all
    assert snap["tx_bytes"] == sum(c["tx_bytes"] for c in snap["classes"].values())
    assert snap["rx_bytes"] == sum(c["rx_bytes"] for c in snap["classes"].values())
    sample = int(env.get("HOTSTUFF_NET_SAMPLE", "64"))
    events = sum(1 for kind, *_ in ops if kind != "logical")
    assert len(port["journal"]) == (events // sample if sample else 0)
    assert {"peer00ab", "10.0.0.6", "native", "client-x"} <= {p for p, _, _ in port["peers"]}


def test_metrics_text_and_snapshot_of_node_telemetry_are_byte_equal():
    """A port and a JAX ``NodeTelemetry``, each on a registry of its own
    with the flow accountant attached and a sender's peers registered,
    after the same charges: equal Prometheus and OpenMetrics text (the
    three ``net_*_bytes`` gauges in it) and equal snapshot documents
    (the ``flows`` section, and the ``net.peer`` block ranked by flow
    bytes)."""

    class Sender:
        _connections: dict = {}

    out = []
    for tel_mod, mod, registry in ((ptel, pflows, PRegistry()), (jtel, jflows, JRegistry())):
        tel = tel_mod.NodeTelemetry("n0", registry=registry)
        tel.register_network("consensus", Sender(), peers=[(name, addr) for name, addr in LABELS])
        acc = mod.FlowAccounting("n0")
        acc.label_peers(LABELS)
        tel.attach_flows(acc)
        _charge(acc, _charges(SEED + 1, 300))
        out.append((registry.render_prometheus(), registry.render_openmetrics(), tel.snapshot()))
    port, ref = out
    assert port == ref
    prom, _, snap = port
    for gauge in ("net_tx_bytes", "net_rx_bytes", "net_retx_bytes"):
        assert f'hotstuff_{gauge}{{node="n0"}}' in prom
    assert snap["flows"]["enabled"] and snap["flows"]["tx_bytes"] > 0
    ranked = list(snap["net"]["peer"])
    assert all("bytes" in snap["net"]["peer"][p] for p in ranked)
    by_bytes = [snap["net"]["peer"][p]["bytes"] for p in ranked]
    assert by_bytes == sorted(by_bytes, reverse=True)


def test_flows_off_attaches_the_section_and_no_gauges():
    for tel_mod, mod, registry in ((ptel, pflows, PRegistry()), (jtel, jflows, JRegistry())):
        tel = tel_mod.NodeTelemetry("n0", registry=registry)
        tel.attach_flows(mod.FlowAccounting("n0", enabled=False))
        assert tel.snapshot()["flows"] == {"enabled": False}
        assert "net_tx_bytes" not in registry.render_prometheus()


# ---- the monitors' egress sample ----------------------------------------------

#: (seconds, cumulative wire tx bytes, commits) of one node's health
#: samples, a second apart, in a 64-node ``run-many --health`` committee
#: on an H100 host: idle until the first proposal, whose block went to 63
#: peers (~304 kB), then about 270 bytes a second of votes
EGRESS_64 = [
    (0.0, 0, 0), (1.002, 0, 0), (2.003, 0, 0), (3.038, 304593, 0), (4.05, 304868, 1),
    (5.071, 305285, 3), (6.105, 305560, 4), (7.149, 305977, 6), (8.167, 306245, 7),
    (9.185, 306513, 8), (10.237, 306788, 9), (11.271, 307056, 10), (12.316, 307324, 11),
    (13.351, 307592, 12), (14.408, 307867, 13), (15.448, 307972, 13), (16.481, 308247, 14),
    (17.571, 308529, 15), (18.668, 308804, 16), (19.709, 309072, 17), (20.74, 309340, 18),
]


class _Tel:
    journal = None

    def __init__(self, docs):
        self._docs = iter(docs)

    def snapshot(self):
        return next(self._docs)


def test_a_leaders_first_broadcast_opens_bandwidth_storm_in_both_packages():
    """The monitor seeds its egress baseline while the node is idle, so
    the first 63-peer proposal is more than 4x that baseline and above
    the 64 kB/s floor: the JAX monitor opens ``bandwidth_storm`` on the
    same series at the same tick, with the same value, and both close it
    once the rate falls back."""
    docs = [{"trace": {"commits": c, "last_commit_round": c}, "flows": {"enabled": True, "tx_bytes": b}}
            for _, b, c in EGRESS_64]
    runs = []
    for mod in (phealth, jhealth):
        mon = mod.HealthMonitor(_Tel(docs), "n0", timeout_s=5.0)
        ticks = [[i.to_json() for i in mon.tick(100.0 + t)] for t, _, _ in EGRESS_64]
        runs.append((ticks, [i.to_json() for i in mon.open_incidents()]))
        mon.close()
    assert runs[0] == runs[1]
    ticks, still_open = runs[0]
    storms = [(k, i) for k, fired in enumerate(ticks) for i in fired if i["kind"] == "bandwidth_storm"]
    assert storms and storms[0][0] == 3 and storms[0][1]["value"] > 65536
    assert not [i for i in still_open if i["kind"] == "bandwidth_storm"]


# ---- exact bytes through the transports ------------------------------------


def _corpus(seed: int, n: int) -> list:
    """Frames with every known tag, unknown tags and an empty frame, at
    sizes across the framing's small and large paths."""
    rng = np.random.default_rng(seed)
    corpus = [b""]
    for i in range(n - 1):
        size = int(rng.choice([0, 1, 37, 512, 4096]))
        corpus.append(bytes([TAGS[i % len(TAGS)]]) + rng.bytes(size))
    return corpus


def _wire_cost(frames) -> int:
    return sum(pflows.FRAME_OVERHEAD + len(p) for p in frames)


def _by_class(frames) -> dict:
    out: dict = {}
    for p in frames:
        cls = pflows.frame_class(p)
        out[cls] = out.get(cls, 0) + pflows.FRAME_OVERHEAD + len(p)
    return out


class _Collect:
    """ACKs every frame on its connection and counts them."""

    def __init__(self, expect: int):
        self.frames: list = []
        self.expect = expect
        self.done = asyncio.Event()

    async def dispatch(self, writer, message: bytes) -> None:
        self.frames.append(message)
        await writer.send(b"Ack")
        if len(self.frames) >= self.expect:
            self.done.set()


async def _through(receiver_cls, sender_cls, mod, corpus, reliable: bool) -> tuple:
    """``corpus`` sent one frame a ``send`` from ``sender_cls`` into
    ``receiver_cls`` on an OS-assigned port; the two accountants."""
    (sock,) = reserve_ports(1)
    port = sock.getsockname()[1]
    sock.close()
    rx_acc, tx_acc = mod.FlowAccounting("rx", enabled=True), mod.FlowAccounting("tx", enabled=True)
    handler = _Collect(len(corpus))
    recv = receiver_cls("127.0.0.1", port, handler, flows=rx_acc)
    sender = None
    try:
        await recv.spawn()
        sender = sender_cls(flows=tx_acc)
        handles = [await sender.send(("127.0.0.1", port), p) for p in corpus]
        if reliable:
            await asyncio.wait_for(asyncio.gather(*handles), TIMEOUT_S)
        await asyncio.wait_for(handler.done.wait(), TIMEOUT_S)
    finally:
        if sender is not None:
            sender.close()
        await recv.shutdown()
    return tx_acc, rx_acc


@pytest.mark.parametrize("reliable", [False, True], ids=["simple", "reliable"])
def test_asyncio_transport_charges_exact_frame_bytes_as_jax_does(reliable):
    corpus = _corpus(SEED + 2, 48)

    async def body():
        port = await _through(Receiver, ReliableSender if reliable else SimpleSender, pflows,
                              corpus, reliable)
        ref = await _through(JReceiver, JReliableSender if reliable else JSimpleSender, jflows,
                             corpus, reliable)
        return port, ref

    (tx_acc, rx_acc), (jtx, jrx) = asyncio.run(body())
    expected = _wire_cost(corpus)
    assert tx_acc.tx_bytes() == rx_acc.rx_bytes() == expected
    assert {c: e["tx_bytes"] for c, e in tx_acc.class_totals().items()} == _by_class(corpus)
    assert sum(e["tx_frames"] for e in tx_acc.class_totals().values()) == len(corpus)
    # one logical frame a send: amplification 1 in every class
    assert set(tx_acc.amplification().values()) == {1.0}
    # the receiver's ACKs are charged on its tx side, one b"Ack" a frame
    assert rx_acc.tx_bytes() == len(corpus) * (pflows.FRAME_OVERHEAD + 3)
    assert tx_acc.retx_bytes() == 0
    assert tx_acc.table() == jtx.table() and rx_acc.table() == jrx.table()
    assert tx_acc.snapshot() == jtx.snapshot() and rx_acc.snapshot() == jrx.snapshot()


def test_native_loopback_ledgers_equal_the_reactors_counters():
    """Native sender -> native receiver through the port's reactor: the
    flow ledgers and the C++ reactor's own counters agree on every byte
    and frame (both count the length prefix), and the ledgers equal the
    asyncio transport's on the same frames but for the receive peer's
    label (an accepted native connection is ``native``)."""
    corpus = _corpus(SEED + 3, 24)
    dispatched = sum(1 for p in corpus if p)  # the empty frame is never dispatched

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        sock.close()
        rx_acc = pflows.FlowAccounting("rx", enabled=True)
        tx_acc = pflows.FlowAccounting("tx", enabled=True)
        handler = _Collect(dispatched)
        recv = native.NativeReceiver("127.0.0.1", port, handler, flows=rx_acc)
        sender = None
        try:
            await recv.spawn()
            reactor = native.Reactor.shared()
            before = reactor.counters()
            sender = native.NativeSimpleSender(flows=tx_acc)
            for payload in corpus:
                await sender.send(("127.0.0.1", port), payload)
            await asyncio.wait_for(handler.done.wait(), TIMEOUT_S)
            deadline = asyncio.get_running_loop().time() + TIMEOUT_S
            # the reactor's thread counts a frame when it is queued on its
            # connection and its bytes when the socket takes them, so the
            # last ACK replies' bytes may still be on their way
            want = _wire_cost(corpus) + dispatched * (pflows.FRAME_OVERHEAD + 3)
            while (reactor.counters()["tx_bytes"] - before["tx_bytes"] < want
                   or reactor.counters()["tx_frames"] - before["tx_frames"] < len(corpus) + dispatched):
                assert asyncio.get_running_loop().time() < deadline, "reactor counters"
                await asyncio.sleep(0.01)
            after = reactor.counters()
        finally:
            if sender is not None:
                sender.close()
            await recv.shutdown()
        return tx_acc, rx_acc, before, after

    tx_acc, rx_acc, before, after = asyncio.run(body())
    expected = _wire_cost(corpus)
    assert tx_acc.tx_bytes() == rx_acc.rx_bytes() == expected
    assert {c: e["tx_bytes"] for c, e in tx_acc.class_totals().items()} == _by_class(corpus)
    acks = rx_acc.tx_bytes()
    assert acks == dispatched * (pflows.FRAME_OVERHEAD + 3)
    assert after["tx_bytes"] - before["tx_bytes"] == expected + acks
    assert after["tx_frames"] - before["tx_frames"] == len(corpus) + dispatched
    assert after["rx_bytes"] - before["rx_bytes"] >= expected
    assert {k.split("|")[0] for k in rx_acc.table()["flows"]} == {"native"}
    # the same frames through the asyncio transport: equal ledgers but for the label
    asyncio_tx, asyncio_rx = asyncio.run(_through(Receiver, SimpleSender, pflows, corpus, False))
    assert tx_acc.table() == asyncio_tx.table()

    def received(acc) -> dict:
        return {c: (e["rx_bytes"], e["rx_frames"]) for c, e in acc.class_totals().items()
                if e["rx_frames"]}

    assert received(rx_acc) == received(asyncio_rx)


def test_native_reliable_sender_charges_sent_frames_and_one_logical_a_broadcast():
    corpus = _corpus(SEED + 4, 12)[1:]

    async def body():
        socks = reserve_ports(2)
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        handlers = [_Collect(len(corpus)) for _ in ports]
        recvs = [native.NativeReceiver("127.0.0.1", p, h) for p, h in zip(ports, handlers)]
        acc = pflows.FlowAccounting("tx", enabled=True)
        sender = None
        try:
            for r in recvs:
                await r.spawn()
            sender = native.NativeReliableSender(flows=acc)
            handles = []
            for p in corpus:
                handles += await sender.broadcast([("127.0.0.1", port) for port in ports], p)
            await asyncio.wait_for(asyncio.gather(*handles), TIMEOUT_S)
        finally:
            if sender is not None:
                sender.close()
            for r in recvs:
                await r.shutdown()
        return acc

    acc = asyncio.run(body())
    assert acc.tx_bytes() == 2 * _wire_cost(corpus) and acc.retx_bytes() == 0
    assert acc.table()["logical"] == {
        c: [b, sum(1 for p in corpus if pflows.frame_class(p) == c)]
        for c, b in sorted(_by_class(corpus).items())
    }
    assert set(acc.amplification().values()) == {2.0}


# ---- committees ------------------------------------------------------------

JAX_FLOW_KEYS = set(jflows.FlowAccounting("x", enabled=True).snapshot())


def test_port_committee_snapshots_carry_flows_and_a_leaders_amplification(monkeypatch):
    """Four port nodes with telemetry on (``run_committee(...,
    telemetry=True)``): every snapshot's ``flows`` section has the JAX
    keys, node-to-node bytes in ``propose`` and ``vote``, and per-class
    shares covering every byte.  A leader's ``propose`` frames go to its
    3 peers once a broadcast, so a node that answered no sync request
    (no single-peer ``propose`` frame) and retransmitted none reads
    exactly 3; every other leader reads between 1 and 3 plus its
    retransmits' share."""
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    r = run_committee(nodes=4, rate=200, duration=3, verifier="cuda", device="cpu", telemetry=True)
    assert min(r["blocks"]) >= 3 and r["chains_agree"]
    snaps = r["snapshots"]
    assert len(snaps) == 4
    exact = 0
    for node, doc in snaps.items():
        flows = doc["flows"]
        assert set(flows) == JAX_FLOW_KEYS and flows["enabled"]
        classes = flows["classes"]
        assert {"propose", "vote"} <= set(classes)
        assert flows["tx_bytes"] == sum(c["tx_bytes"] for c in classes.values()) > 0
        assert flows["rx_bytes"] == sum(c["rx_bytes"] for c in classes.values()) > 0
        amp = flows["amp"].get("propose")
        if amp is None:
            continue  # led no round
        sync_replies = classes.get("sync-req", {}).get("rx_frames", 0)
        if sync_replies == 0 and classes["propose"]["retx_frames"] == 0:
            assert amp == 3.0, (node, flows)
            exact += 1
        else:
            assert 1.0 <= amp <= 3.0 * (1 + classes["propose"]["retx_bytes"]
                                        / max(1, classes["propose"]["tx_bytes"])), (node, flows)
    assert exact >= 1


def test_mixed_committee_flows_sections_have_the_same_keys(tmp_path):
    """Two JAX and two port nodes with telemetry on, in one event loop:
    both packages' ``flows`` sections have the same keys, and so has
    each class entry."""
    from .test_torch_journal import _committee

    asyncio.run(_committee([JAX, PORT, JAX, PORT], tmp_path, str(tmp_path / "journals")))
    port_docs = list(ptel.snapshot_all().values())
    jax_docs = list(jtel.snapshot_all().values())
    assert len(port_docs) == len(jax_docs) == 2
    for doc in port_docs + jax_docs:
        flows = doc["flows"]
        assert set(flows) == JAX_FLOW_KEYS
        assert {"propose", "vote"} <= set(flows["classes"])
    entry_keys = {frozenset(e) for d in port_docs + jax_docs for e in d["flows"]["classes"].values()}
    assert len(entry_keys) == 1


def test_a_delta_state_matches_its_snapshot_while_the_ranked_peer_blocks_reorder():
    """``chip_smoke.keys_mismatch``, the check of phase (i) that a
    ``/delta`` state decoded after a ``/snapshot`` scrape is that
    document: the two blocks ranked by flow bytes (``flows.peers`` and
    ``net.peer``) may change members and grow between the scrapes, a
    flows class, the ``metrics`` block and an empty histogram's
    percentiles may appear; a key that vanishes, any other new key and
    a ranked block that shrinks are reported."""
    import chip_smoke

    def doc(net_peers, flow_peers):
        return {"n0": {
            "net": {"peer": {p: {"queued": 0, "retrying": 0, "bytes": 10} for p in net_peers},
                    "peers_elided": 2},
            "flows": {"enabled": True, "classes": {"vote": {"tx_bytes": 1}},
                      "peers": {p: {"tx_bytes": 1, "rx_bytes": 1} for p in flow_peers}},
            "trace": {"payload_wait": {"count": 0}},
            "round": 7,
        }}

    snap = phealth.flatten(doc(["a", "b"], ["a"]))
    later = doc(["c", "a"], ["b", "c"])
    later["n0"]["flows"]["classes"]["propose"] = {"tx_bytes": 5}
    later["n0"]["trace"]["payload_wait"].update(count=1, p50_ms=3.0)
    later["n0"]["metrics"] = {"x": 1}
    assert chip_smoke.keys_mismatch(phealth.flatten(later), snap) == []

    gone = doc(["a", "b"], ["a"])
    del gone["n0"]["round"]
    assert chip_smoke.keys_mismatch(phealth.flatten(gone), snap) == ["n0.round"]
    new = doc(["a", "b"], ["a"])
    new["n0"]["epoch"] = 1
    assert chip_smoke.keys_mismatch(phealth.flatten(new), snap) == ["n0.epoch"]
    shrunk = phealth.flatten(doc(["a"], ["a"]))
    assert chip_smoke.keys_mismatch(shrunk, snap) == ["n0.net.peer. holds 1 peers, fewer than 2"]
