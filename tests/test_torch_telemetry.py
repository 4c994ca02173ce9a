"""The port's telemetry plane against the JAX package's: the registry's
Prometheus and OpenMetrics text, the per-round trace recorder, the span
recorder, the ``/delta`` frames, the work stats, the taxonomy tables and
the switches, each driven by the same seeded inputs through both
packages and compared at zero tolerance; a scripted core on both
packages giving the same journal records and trace edges under one fake
clock; telemetry off by default; the ``/metrics`` endpoint's routes; a
4-node ``run-many --metrics-port 0 --journal-dir`` scraped, then stopped
with SIGTERM; and ``bench_verify_split`` on the plain versions.

Telemetry is process-global in both packages: every test starts with
both off and empty, and leaves them so.  Every listener port comes from
the OS; every wait has a deadline."""

import asyncio
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from hotstuff_tpu import telemetry as jtel
from hotstuff_tpu.telemetry import health as jhealth
from hotstuff_tpu.telemetry import spans as jspans
from hotstuff_tpu.telemetry import taxonomy as jtax
from hotstuff_tpu.telemetry.metrics import LATENCY_BOUNDS_S, SIZE_BOUNDS
from hotstuff_tpu.telemetry.trace import TraceRecorder as JTraceRecorder
from hotstuff_tpu.utils import workstats as jws
from hotstuff_tpu_torch import telemetry as ptel
from hotstuff_tpu_torch.telemetry import health as phealth
from hotstuff_tpu_torch.telemetry import spans as pspans
from hotstuff_tpu_torch.telemetry import taxonomy as ptax
from hotstuff_tpu_torch.telemetry.exporter import OPENMETRICS_CONTENT_TYPE, MetricsServer
from hotstuff_tpu_torch.telemetry.trace import TraceRecorder as PTraceRecorder
from hotstuff_tpu_torch.utils import workstats as pws

from .test_torch_core import JAX, PORT, Side, _Peer, teardown
from .test_torch_node import REPO, spawn_client, stop_all, wait_for, write_port_committee

SEED = 20_261_017
ENV_KNOBS = (
    "HOTSTUFF_TELEMETRY", "HOTSTUFF_METRICS_PORT", "HOTSTUFF_JOURNAL",
    "HOTSTUFF_JOURNAL_DIR", "HOTSTUFF_PROFILE", "HOTSTUFF_WORK_STATS",
)


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    for knob in ENV_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    jtel.reset()
    ptel.reset()
    yield
    jtel.reset()
    ptel.reset()


class FakeClock:
    """A clock that moves 250 us at every read: two packages making the
    same reads in the same order see the same times."""

    def __init__(self, start_ns: int = 1_000_000_000, step_ns: int = 250_000):
        self.ns = start_ns
        self.step_ns = step_ns

    def monotonic_ns(self) -> int:
        self.ns += self.step_ns
        return self.ns

    def monotonic(self) -> float:
        return self.monotonic_ns() / 1e9

    def time_ns(self) -> int:
        return 1_760_000_000_000_000_000 + self.monotonic_ns()


# ---- registry --------------------------------------------------------------


def _registry_ops(seed: int, n: int = 400) -> list:
    """A seeded op sequence over every instrument kind: (kind, name,
    labels, value[, bounds])."""
    rng = np.random.default_rng(seed)
    names = {
        "counter": ("commits", "requests_total", "frames"),
        "float": ("wall_seconds",),
        "gauge": ("depth", "pull_depth"),
        "hist": ("lat", "wave_sigs", "gaps"),
    }
    bounds = {"lat": LATENCY_BOUNDS_S, "wave_sigs": SIZE_BOUNDS, "gaps": (0.5, 1.0, 2.0)}
    label_values = ("n0", "n1", 'odd"node\\name\nx')
    ops = []
    for _ in range(n):
        kind = ("counter", "float", "gauge", "hist")[int(rng.integers(0, 4))]
        name = names[kind][int(rng.integers(0, len(names[kind])))]
        labels = {"node": label_values[int(rng.integers(0, 3))]}
        if rng.random() < 0.3:
            labels["route"] = ("device", "cpu")[int(rng.integers(0, 2))]
        if kind == "counter":
            ops.append((kind, name, labels, int(rng.integers(0, 5))))
        elif kind == "float":
            ops.append((kind, name, labels, float(rng.random() * 1e-3)))
        elif kind == "gauge":
            value = float(rng.integers(0, 100)) if rng.random() < 0.5 else float(rng.random())
            ops.append((kind, name, labels, value))
        else:
            scale = (1e-5, 1e-2, 1.0, 500.0)[int(rng.integers(0, 4))]
            ops.append((kind, name, labels, float(rng.random() * scale), bounds[name]))
    return ops


def _apply(registry, ops) -> None:
    for op in ops:
        kind, name, labels, value = op[:4]
        help_ = f"help for {name}"
        if kind == "counter":
            registry.counter(name, help_, dict(labels)).inc(value)
        elif kind == "float":
            registry.float_counter(name, help_, dict(labels)).add(value)
        elif kind == "gauge":
            if name == "pull_depth":
                registry.gauge(name, help_, dict(labels), fn=lambda v=value: v)
            else:
                registry.gauge(name, help_, dict(labels)).set(value)
        else:
            registry.histogram(name, help_, dict(labels), bounds=op[4]).observe(value)
    registry.gauge("broken", "a callback that raises", {"node": "n0"}, fn=lambda: 1 / 0)


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_registry_renders_byte_equal_text(seed):
    from hotstuff_tpu.telemetry.metrics import Registry as JRegistry
    from hotstuff_tpu_torch.telemetry.metrics import Registry as PRegistry

    ops = _registry_ops(seed)
    jax_reg, port_reg = JRegistry(), PRegistry()
    _apply(jax_reg, ops)
    _apply(port_reg, ops)
    prom = port_reg.render_prometheus()
    assert prom == jax_reg.render_prometheus()
    om = port_reg.render_openmetrics()
    assert om == jax_reg.render_openmetrics()
    assert om.endswith("# EOF\n") and "hotstuff_requests_total{" in om
    assert "# TYPE hotstuff_requests counter" in om  # family without _total
    assert 'hotstuff_broken{node="n0"} -1' in prom  # a scrape never throws
    for inst_j, inst_p in zip(jax_reg, port_reg):
        assert (inst_p.name, inst_p.labels, inst_p.to_json()) == (
            inst_j.name, inst_j.labels, inst_j.to_json()
        )


def test_prometheus_golden_output():
    """The port's counterpart of tests/test_telemetry.py's golden text."""
    from hotstuff_tpu_torch.telemetry.metrics import Registry

    reg = Registry()
    reg.counter("commits", "Blocks committed", {"node": "n0"}).inc(7)
    reg.gauge("depth", "Queue depth", {"node": "n0"}, fn=lambda: 4)
    h = reg.histogram("lat", "Latency", {"node": "n0"}, bounds=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    assert reg.render_prometheus() == (
        "# HELP hotstuff_commits Blocks committed\n"
        "# TYPE hotstuff_commits counter\n"
        'hotstuff_commits{node="n0"} 7\n'
        "# HELP hotstuff_depth Queue depth\n"
        "# TYPE hotstuff_depth gauge\n"
        'hotstuff_depth{node="n0"} 4\n'
        "# HELP hotstuff_lat Latency\n"
        "# TYPE hotstuff_lat histogram\n"
        'hotstuff_lat_bucket{node="n0",le="0.1"} 1\n'
        'hotstuff_lat_bucket{node="n0",le="1"} 1\n'
        'hotstuff_lat_bucket{node="n0",le="+Inf"} 2\n'
        'hotstuff_lat_sum{node="n0"} 5.05\n'
        'hotstuff_lat_count{node="n0"} 2\n'
    )


# ---- trace recorder --------------------------------------------------------


def _trace_ops(seed: int, n: int = 600) -> list:
    rng = np.random.default_rng(seed)
    digests = [bytes([i]) * 32 for i in range(24)]
    ops = []
    for _ in range(n):
        kind = int(rng.integers(0, 6))
        d = digests[int(rng.integers(0, len(digests)))]
        ops.append((kind, d, int(rng.integers(1, 200))))
    return ops


def _drive_trace(rec, ops) -> None:
    for kind, digest, round_ in ops:
        if kind == 0:
            rec.mark_proposed(digest, round_)
        elif kind == 1:
            rec.mark_first_vote(digest)
        elif kind == 2:
            rec.mark_qc_formed(digest)
        elif kind == 3:
            rec.mark_committed(digest, round_)
        elif kind == 4:
            rec.mark_timeout()
        else:
            rec.mark_tc_advance()


@pytest.mark.parametrize("seed", [SEED, SEED + 7])
def test_trace_recorder_same_ring_and_histograms(seed):
    from hotstuff_tpu.telemetry.metrics import Registry as JRegistry
    from hotstuff_tpu_torch.telemetry.metrics import Registry as PRegistry

    ops = _trace_ops(seed)
    jax_reg, port_reg = JRegistry(), PRegistry()
    kw = {"capacity": 8, "ring": 16}
    jrec = JTraceRecorder(jax_reg, {"node": "n0"}, clock=FakeClock().monotonic, **kw)
    prec = PTraceRecorder(port_reg, {"node": "n0"}, clock=FakeClock().monotonic, **kw)
    _drive_trace(jrec, ops)
    _drive_trace(prec, ops)
    assert list(prec.ring) == list(jrec.ring) and len(prec.ring) == 16
    assert prec.recent(5) == jrec.recent(5)
    assert prec.to_json() == jrec.to_json()
    assert prec.to_json()["edges"]["propose_to_commit"]["count"] > 0
    assert prec.open_count() == jrec.open_count() <= 8
    assert port_reg.render_openmetrics() == jax_reg.render_openmetrics()


# ---- spans -----------------------------------------------------------------


def test_span_recorders_same_stats_snapshot_histograms_and_journal_fanout():
    rng = np.random.default_rng(SEED)
    names = list(jspans.LEAF_STAGES) + ["e2e", "pipeline.occupancy"]
    spans = [
        (names[int(rng.integers(0, len(names)))], int(rng.integers(0, 10**12)),
         int(rng.integers(-5, 10**8)))
        for _ in range(120)
    ]
    assert pspans.LEAF_STAGES == jspans.LEAF_STAGES
    assert pspans.STAGE_BOUNDS_MS == jspans.STAGE_BOUNDS_MS
    out = {}
    for tel, sp in ((jtel, jspans), (ptel, pspans)):
        tel.enable()
        rec = sp.SpanRecorder(capacity=50)
        sink = []

        class Journal:  # the span fan-out's journal: records every call
            def record(self, *args, **kwargs):
                sink.append((args, kwargs))

        sp.attach_journal(Journal())
        try:
            for name, t0, dur in spans:
                rec.add(name, t0, dur)
        finally:
            sp.disable()
        out[sp] = (rec.stats(), rec.snapshot(), tel.registry().render_openmetrics(), sink)
    assert out[pspans] == out[jspans]
    stats, snapshot, text, sink = out[pspans]
    assert stats == {"spans": 120, "buffered": 50, "capacity": 50, "dropped": 70}
    assert len(snapshot) == 50 and 'stage="pipeline.occupancy"' in text
    assert len(sink) == 120 and sink[0][0][0] == "span"


def test_span_switches_match(monkeypatch):
    for sp in (jspans, pspans):
        assert sp.recorder() is None and not sp.enabled()
        assert sp.span("prepare") is sp.span("dispatch")  # the shared no-op
        sp.disable()  # re-arm the one-time env check
    monkeypatch.setenv("HOTSTUFF_PROFILE", "1")
    assert pspans.enabled() and jspans.enabled()
    assert ptel.enabled() and jtel.enabled()  # profiling implies collection
    assert pspans.enable() is pspans.recorder()


# ---- /delta frames ---------------------------------------------------------


def _docs(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        doc = {
            "n0": {
                "round": int(rng.integers(0, 5)) + i // 4,
                "trace": {"p50_ms": float(rng.random()), "ok": bool(rng.random() < 0.5)},
                "lanes": [int(v) for v in rng.integers(0, 3, size=int(rng.integers(0, 4)))],
                "name": "node-0",
                "skip": None,
            }
        }
        if rng.random() < 0.3:
            doc["n1"] = {"round": int(rng.integers(0, 9))}
        docs.append(doc)
    return docs


def test_delta_frames_equal_across_packages_with_a_resync():
    docs = _docs(SEED)
    frames = {}
    for mod in (jhealth, phealth):
        stream, decoder = mod.DeltaStream(), mod.DeltaDecoder()
        states, out = [], []
        for i, doc in enumerate(docs):
            # mostly in sequence; a stale, an unknown and a gapped since
            since = decoder.since
            if i in (9, 21):
                since = -1
            elif i == 30:
                since = max(decoder.since - 20, 0)
            frame = stream.frame(doc, since)
            if i == 15:  # a lost frame: the next delta's base is unknown
                decoder.seq = max(decoder.seq - 1, 0)
            state = decoder.apply(frame)
            out.append(frame)
            states.append(None if state is None else dict(state))
            if state is not None:
                assert state == mod.flatten(doc)
        frames[mod] = (out, states, decoder.resyncs, mod.flatten(docs[-1]))
    assert frames[phealth] == frames[jhealth]
    out, states, resyncs, _ = frames[phealth]
    assert resyncs >= 1 and any(s is None for s in states)
    assert any("full" in f for f in out[1:]) and any("set" in f for f in out)


# ---- work stats ------------------------------------------------------------


def test_workstats_document_and_counting_verifier_match(monkeypatch):
    from hotstuff_tpu.crypto.service import CpuVerifier as JCpu
    from hotstuff_tpu_torch.crypto.service import CpuVerifier as PCpu

    assert pws.WORKSTATS_KEYS == jws.WORKSTATS_KEYS
    docs, counts = {}, {}
    for side, ws, cpu in ((JAX, jws, JCpu), (PORT, pws, PCpu)):
        stats = ws.WorkStats()
        verifier = ws.CountingVerifier(cpu(), stats)
        (pk, sk), (pk2, _) = side.keys()[:2]
        digest = side.crypto.Digest.of(b"work stats")
        sig = side.crypto.Signature.new(digest, sk)
        verdicts = [
            verifier.verify_one(digest, pk, sig),
            verifier.verify_one(digest, pk2, sig),
            verifier.verify_shared_msg(digest, [(pk, sig)] * 3),
            list(verifier.verify_many([digest.to_bytes()] * 2, [pk.to_bytes(), pk2.to_bytes()],
                                      [sig.to_bytes()] * 2)),
        ]
        stats.lag_samples, stats.lag_total_s, stats.lag_max_s = 4, 0.01, 0.007
        stats.verify_wall_s = 0.25  # measured walls differ run to run
        stats.started = 100.0
        with monkeypatch.context() as m:
            m.setattr(time, "monotonic", lambda: 103.5)
            docs[side.root] = stats.to_json()
        counts[side.root] = (stats.verify_calls, stats.verify_sigs, verdicts, verifier.name)
    assert docs["hotstuff_tpu_torch"] == docs["hotstuff_tpu"]
    assert set(docs["hotstuff_tpu_torch"]) == set(pws.WORKSTATS_KEYS)
    assert counts["hotstuff_tpu_torch"] == counts["hotstuff_tpu"]
    assert counts["hotstuff_tpu_torch"][:2] == (4, 7)


def test_counting_verifier_still_reaches_the_device_host():
    """A node with telemetry or work stats wraps its verifier: every
    attribute the wave service reads must reach the device host behind
    it, or the card goes idle quietly."""
    from hotstuff_tpu_torch.crypto.async_service import AsyncVerifyService
    from hotstuff_tpu_torch.node.node import make_verifier

    host = make_verifier("cuda", device="cpu")
    counted = pws.CountingVerifier(host, pws.WorkStats())
    for attr in ("async_kind", "supports_wave_padding", "device_ready", "routes",
                 "cpu_backend", "min_device_batch"):
        assert getattr(counted, attr) == getattr(host, attr)
    assert counted.name == "cuda"

    async def service():
        return AsyncVerifyService.for_backend(counted)

    svc = asyncio.run(service())
    try:
        assert svc.device and svc._stats_tag.startswith("cuda@cpu#")
    finally:
        svc.close()


# ---- taxonomy and switches -------------------------------------------------


def test_taxonomy_is_the_references():
    names = [n for n in dir(jtax) if n.isupper()]
    assert names == [n for n in dir(ptax) if n.isupper()]
    for name in names:
        assert getattr(ptax, name) == getattr(jtax, name), name
    for edge in ("commit", "sync.adopt", "reconfig.link", "health.view_storm", "nope"):
        assert ptax.is_registered_edge(edge) == jtax.is_registered_edge(edge)
    assert ptax.is_registered_stage("prepare") and not ptax.is_registered_stage("nope")


@pytest.mark.parametrize("env", [
    {}, {"HOTSTUFF_TELEMETRY": "1"}, {"HOTSTUFF_TELEMETRY": "off"},
    {"HOTSTUFF_METRICS_PORT": "9100"}, {"HOTSTUFF_JOURNAL": "1"},
    {"HOTSTUFF_JOURNAL_DIR": "/nonexistent/journals"},
], ids=lambda env: ",".join(env) or "none")
def test_switches_match(monkeypatch, env):
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    for fn in ("enabled", "journal_enabled"):
        assert getattr(ptel, fn)() == getattr(jtel, fn)(), fn
    assert ptel.journal_dir("/x/db_0") == jtel.journal_dir("/x/db_0")
    assert (ptel.for_node("n0") is None) == (jtel.for_node("n0") is None)
    assert ptel.health_enabled() is False


def test_off_by_default_creates_no_instrument(tmp_path):
    """The default: no handle, no journal directory, no span recorder,
    and a core, a proposer and both kinds of wave service built without
    one register nothing."""
    from hotstuff_tpu_torch.crypto.async_service import AsyncVerifyService
    from hotstuff_tpu_torch.crypto.service import CpuVerifier

    assert not ptel.enabled() and ptel.for_node("n0") is None
    assert ptel.journal_dir(str(tmp_path / "db")) is None
    assert pspans.recorder() is None

    async def build():
        h = make_core_tel(tmp_path, PORT, None)
        proposer = PORT.consensus.Proposer(
            h.name, h.committee, h.core.signature_service, rx_producer=asyncio.Queue(),
            rx_message=asyncio.Queue(), tx_loopback=h.core.rx_loopback,
        )
        inline = AsyncVerifyService(CpuVerifier())
        try:
            assert h.core._trace is None and h.core._journal is None
            assert proposer._payload_wait is None and inline._tel_wave is None
            assert await inline.verify_claims([]) == []
        finally:
            proposer.shutdown()
            teardown(h)

    asyncio.run(build())
    assert list(ptel.registry()) == []
    assert not list(tmp_path.glob("**/*.jsonl"))


def test_snapshot_is_a_superset_of_work_stats_and_cached_per_name():
    ptel.enable()
    tel = ptel.for_node("n0")
    assert ptel.for_node("n0") is tel and ptel.for_node("n1") is not tel
    tel.attach_workstats(pws.WorkStats())
    tel.add_section("broken", lambda: 1 / 0)
    snap = tel.snapshot()
    assert set(pws.WORKSTATS_KEYS) <= set(snap)
    assert snap["broken"] == {"error": "division by zero"}
    assert set(ptel.snapshot_all()) == {"n0", "n1"}
    assert set(ptel.trace_all()) == {"n0", "n1"}


# ---- the scripted core: journal records and trace edges --------------------


def make_core_tel(tmp_path, side: Side, tel, timeout_ms: int = 60_000):
    """tests/test_torch_core.py's ``make_core`` (node 0) with a
    telemetry handle."""
    from types import SimpleNamespace

    from hotstuff_tpu_torch.bench.committee import reserve_ports

    socks = reserve_ports(4)
    store = side.store.Store(str(tmp_path / f"db-{side.root}"))
    com = side.committee([s.getsockname()[1] for s in socks])
    name, secret = side.keys()[0]
    rx_events, rx_message, loopback = side.core.make_event_channels(2_000)
    sync = side.consensus.Synchronizer(name, com, store, loopback, 10_000, telemetry=tel)
    core = side.consensus.Core(
        name, com, side.crypto.SignatureService(secret), side.service.CpuVerifier(), store,
        side.leader.LeaderElector(com), sync, timeout_ms, rx_events=rx_events,
        rx_loopback=loopback, tx_proposer=asyncio.Queue(), tx_commit=asyncio.Queue(),
        telemetry=tel,
    )
    return SimpleNamespace(core=core, store=store, committee=com, name=name, secret=secret,
                           sync=sync, socks=socks, tx_proposer=core.tx_proposer,
                           tx_commit=core.tx_commit)


async def _scripted(side: Side, tmp_path, m) -> dict:
    """tests/test_torch_core.py's scripted sequence (b1..b3, a QC, the
    round-4 proposal, a timeout, a TC, a timeout) through node 0's core
    and proposer with telemetry and a journal on one fake clock."""
    tel_mod = importlib.import_module(f"{side.root}.telemetry")
    journal_mod = importlib.import_module(f"{side.root}.telemetry.journal")
    proposer_mod = importlib.import_module(f"{side.root}.consensus.proposer")
    clock = FakeClock()
    m.setattr(journal_mod, "default_clock", lambda: clock)
    m.setattr(proposer_mod, "default_clock", lambda: clock)
    tel_mod.enable()
    name = side.keys()[0][0]
    tel = tel_mod.for_node(str(name)[:8])
    tel.trace._clock = clock.monotonic
    jdir = str(tmp_path / f"journal-{side.root}")
    journal = journal_mod.Journal(tel.node, jdir, buffer_records=4)
    tel.attach_journal(journal)
    h = make_core_tel(tmp_path, side, tel)
    peers = [_Peer(s) for s in h.socks[1:]]
    for p in peers:
        await p.start()
    proposer = side.consensus.Proposer(
        h.name, h.committee, h.core.signature_service, rx_producer=asyncio.Queue(),
        rx_message=asyncio.Queue(), tx_loopback=h.core.rx_loopback, telemetry=tel,
    )
    core = h.core
    try:
        ks = side.keys()
        b1, b2, b3 = side.chain(3)
        for b in (b1, b2, b3):
            await core._handle_proposal(b)
        for pk, sk in ks[1:3]:
            await core._handle_vote(side.signed_vote(b3, pk, sk))
        make = None
        while not h.tx_proposer.empty():
            message = h.tx_proposer.get_nowait()
            if message.kind == side.consensus.ProposerMessage.MAKE:
                make = message
        proposer._buffer_payload(side.payload(99))
        await asyncio.wait_for(
            proposer._make_block(make.round, make.qc, make.tc, make.allow_empty), 5
        )
        b4 = core.rx_loopback.get_nowait()
        await core._process_block(b4)
        await core._local_timeout_round()
        for pk, sk in ks[1:3]:
            await core._handle_timeout(side.signed_timeout(core.high_qc, 4, pk, sk))
        await core._local_timeout_round()
        assert core.round == 5
        journal.close()
        lines = []
        for path in sorted(os.listdir(jdir)):
            with open(os.path.join(jdir, path)) as f:
                lines += [json.loads(line) for line in f]
        snap = tel.snapshot()
        snap["journal"].pop("dir")
        text = tel_mod.registry().render_openmetrics()
        return {
            "records": [(r["e"], r["r"], r["d"], r["p"]) for r in lines if r["e"] != "meta"],
            "stamps": [(r["m"], r["w"], r["s"]) for r in lines if r["e"] != "meta"],
            "ring": list(tel.trace.ring),
            "snapshot": snap,
            "metrics": [line for line in text.splitlines()
                        if 'node="' in line and "qc_verify_cache_hit" not in line],
        }
    finally:
        proposer.shutdown()
        for p in peers:
            p.server.close()
        teardown(h)


def test_scripted_core_same_journal_records_and_trace_edges(tmp_path, monkeypatch):
    out = {}
    for side in (JAX, PORT):
        with monkeypatch.context() as m:
            out[side.root] = asyncio.run(_scripted(side, tmp_path, m))
    jax, port = out["hotstuff_tpu"], out["hotstuff_tpu_torch"]
    assert port["records"] == jax["records"]
    assert port["stamps"] == jax["stamps"]
    events = [e for e, *_ in port["records"]]
    for edge in ("vote.send", "qc.form", "qc", "round.enter", "commit", "propose",
                 "payload.first", "timeout", "tc"):
        assert edge in events, edge
    assert all(ptax.is_registered_edge(e) for e in events)
    assert [r for e, r, *_ in port["records"] if e == "commit"] == [1, 2]
    assert port["ring"] == jax["ring"] and [e["round"] for e in port["ring"]] == [1, 2]
    # the compact-certificate counters of the aggregator's section come
    # with BLS; every counter the port has is the reference's
    port_agg, jax_agg = port["snapshot"].pop("aggregator"), jax["snapshot"].pop("aggregator")
    assert port_agg.items() <= jax_agg.items() and port_agg
    assert port["snapshot"] == jax["snapshot"]
    assert port["metrics"] == jax["metrics"] and port["metrics"]


# ---- the endpoint ----------------------------------------------------------


async def _get(port: int, path: str, method: str = "GET") -> tuple[int, dict, bytes]:
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), 5)
    try:
        writer.write(f"{method} {path} HTTP/1.0\r\nHost: x\r\n\r\n".encode())
        raw = await asyncio.wait_for(reader.read(), 5)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split()[1]), headers, body


def test_metrics_server_routes():
    ptel.enable()
    tel = ptel.for_node("n0")
    tel.trace.mark_proposed(b"\x01" * 32, 3)
    tel.trace.mark_committed(b"\x01" * 32, 3)
    tel.counter("frames", "Frames").inc(5)

    async def body():
        server = await MetricsServer(ptel.registry(), host="127.0.0.1", port=0).start()
        try:
            assert server.port > 0
            status, headers, text = await _get(server.port, "/metrics")
            assert status == 200 and headers["Content-Type"] == OPENMETRICS_CONTENT_TYPE
            assert text.decode() == ptel.registry().render_openmetrics()
            assert text.endswith(b"# EOF\n") and b'hotstuff_frames_total{node="n0"} 5' in text
            status, _, snap = await _get(server.port, "/snapshot")
            assert status == 200 and json.loads(snap) == json.loads(json.dumps(ptel.snapshot_all()))
            status, _, trace = await _get(server.port, "/trace")
            assert status == 200 and json.loads(trace)["n0"][0]["round"] == 3
            _, _, full = await _get(server.port, "/delta?since=-1")
            full = json.loads(full)
            decoder = phealth.DeltaDecoder()
            assert decoder.apply(full) == phealth.flatten(ptel.export_doc())
            tel.counter("frames", "Frames").inc(2)
            _, _, delta = await _get(server.port, f"/delta?since={full['seq']}")
            delta = json.loads(delta)
            assert delta["base"] == full["seq"] and delta["set"]
            assert decoder.apply(delta) == phealth.flatten(ptel.export_doc())
            _, _, junk = await _get(server.port, "/delta?since=zz")
            assert "full" in json.loads(junk)
            assert (await _get(server.port, "/nope"))[0] == 404
            assert (await _get(server.port, "/metrics", "POST"))[0] == 405
        finally:
            await server.stop()

    asyncio.run(body())


async def _no_server():
    return await ptel.maybe_start_server(None)


def test_maybe_start_server_none_is_off():
    assert asyncio.run(_no_server()) is None and not ptel.enabled()


# ---- the CLI: run-many with the endpoint and the journal --------------------

CLI = [sys.executable, "-m", "hotstuff_tpu_torch.node"]
RE_ENDPOINT = re.compile(r"Telemetry /metrics endpoint listening on port (\d+)")
RE_CORE_COMMIT = re.compile(r"hotstuff_tpu_torch\.consensus\.core\.(\S+) Committed block (\d+) ->")


def _scrape(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.headers.get("Content-Type"), r.read().decode()


@pytest.mark.parametrize("verifier", ["cpu", "cuda"])
def test_run_many_exports_metrics_snapshots_and_journals(tmp_path, verifier):
    """A 4-node ``run-many --metrics-port 0 --journal-dir`` with the
    client (``--verifier cuda`` on the plain versions' host, never warm,
    so its wave service serves from the CPU): the endpoint logs its
    port, ``/metrics``, ``/snapshot``, ``/trace`` and ``/delta`` answer
    for 4 nodes, ``LogParser`` reads the ``Telemetry snapshot:`` lines,
    and after SIGTERM every node's journal holds a commit record for
    each of its ``Committed`` lines, beside the clean-stop lines."""
    from benchmark.logs import LogParser
    from benchmark.traces import load_journals

    write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
    keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
    jdir = tmp_path / "journals"
    log_path = tmp_path / "nodes.log"
    log = open(log_path, "w")
    env = {**os.environ, "PYTHONPATH": REPO, "HOTSTUFF_SKIP_WARMUP": "1", "HOTSTUFF_WORK_STATS": "1"}
    nodes = client = None
    try:
        nodes = subprocess.Popen(
            CLI + ["-vv", "run-many", "--verifier", verifier, "--device", "cpu", "--keys", keys,
                   "--committee", str(tmp_path / "committee.json"), "--store-prefix",
                   str(tmp_path / "db_"), "--parameters", str(tmp_path / "parameters.json"),
                   "--metrics-port", "0", "--journal-dir", str(jdir)],
            stdout=log, stderr=subprocess.STDOUT, env=env,
        )
        assert wait_for(lambda: log_path.read_text().count("successfully booted") == 4, 60)
        port = int(RE_ENDPOINT.search(log_path.read_text())[1])
        client = spawn_client(tmp_path, rate=300, duration=2)
        assert client.wait(timeout=60) == 0
        assert wait_for(lambda: log_path.read_text().count("Telemetry snapshot:") >= 4
                        and log_path.read_text().count("Work stats:") >= 4, 30)
        ctype, metrics = _scrape(port, "/metrics")
        _, snapshot = _scrape(port, "/snapshot")
        _, trace = _scrape(port, "/trace")
        _, full = _scrape(port, "/delta?since=0")
        full = json.loads(full)
        _, delta = _scrape(port, f"/delta?since={full['seq']}")
        assert nodes.poll() is None
        nodes.send_signal(signal.SIGTERM)
        assert nodes.wait(timeout=30) == 0
    finally:
        stop_all([client, nodes])
        log.close()
    text = log_path.read_text()
    assert "Traceback" not in text and "Stopping 4 node(s) on a signal" in text
    assert ctype == OPENMETRICS_CONTENT_TYPE and metrics.endswith("# EOF\n")
    assert len(set(re.findall(r'node="([^"]+)"', metrics))) == 4
    families = set(re.findall(r"^# TYPE (\S+) ", metrics, re.M))
    for sample in re.findall(r"^(hotstuff_\w+?)(?:_total|_bucket|_sum|_count)?[{ ]", metrics, re.M):
        assert sample in families, sample
    snapshot = json.loads(snapshot)
    assert len(snapshot) == 4 and all(set(pws.WORKSTATS_KEYS) <= set(d) for d in snapshot.values())
    assert set(json.loads(trace)) == set(snapshot)
    decoder = phealth.DeltaDecoder()
    decoder.apply(full)
    state = decoder.apply(json.loads(delta))
    assert state is not None
    assert {k for k in state if ".metrics." not in k} == set(phealth.flatten(snapshot))
    parser = LogParser([text], [(tmp_path / "client.log").read_text()])
    assert len(parser.telemetry_docs) == 1  # the last document of the one log
    assert text.count("Telemetry snapshot:") >= 4 and text.count("Work stats:") >= 4
    journals = load_journals(str(jdir))
    assert set(journals) == set(snapshot)
    logged: dict = {}
    for node, rnd in RE_CORE_COMMIT.findall(text):
        logged.setdefault(node, []).append(int(rnd))
    for node, records in journals.items():
        assert [r["r"] for r in records if r["e"] == "commit"] == logged[node]
    assert sum(map(len, logged.values())) > 0
    if verifier == "cuda":
        assert "Verify service stats [cuda@cpu#" in text
        assert "Kernel launches: dual_scalar_mult=0 verify_compressed=0" in text
        assert 'hotstuff_verify_route_total{svc="cuda@cpu#' in metrics
        assert 'backend="cuda",route="cpu"' in metrics


# ---- the bench block -------------------------------------------------------


def test_bench_verify_split_on_the_plain_versions(monkeypatch):
    """``bench_verify_split`` with ``device="cpu"``: 8 claims a route, the
    split read from the registry, every verdict valid."""
    import torch

    from hotstuff_tpu_torch.bench import verifier as pbench

    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        msgs, pks, sigs = pbench.make_qc_batch(16)
        r = pbench.bench_verify_split(msgs, pks, sigs, device="cpu", qc=16)
    finally:
        torch.set_num_threads(threads)
    assert r["qc_size"] == 16 and r["waves"] == 8
    assert r["host_wall_ms"] > 0 and r["device_wall_ms"] > 0
    assert r["device_sigs"] + r["cpu_fallback_sigs"] == 8 * 16
    assert r["claims_submitted"] == r["claims_unique"] == 16
    assert r["launches"] == 0  # the plain versions launch no kernel
