"""The port's flight recorder against the JAX package's: the same events
under one fake clock give byte-equal JSONL ring segments (rotation, the
ring bound, a torn line, reopening with and without resume), the same
directory resolution and the same off-by-default answer; the crash
hooks flush on SIGTERM and still wake the event loop's own handler; and
``benchmark/traces.py`` merges the journals of a 4-node port committee,
and of a committee of 2 JAX and 2 port nodes, into one timeline holding
every committed round.

Journaling is process-global in both packages: every test starts with
both telemetry planes off and leaves them so.  Every listener port comes
from the OS; every wait has a deadline."""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from benchmark.traces import TraceSet, load_journals
from hotstuff_tpu import telemetry as jtel
from hotstuff_tpu.telemetry import journal as jjournal
from hotstuff_tpu_torch import telemetry as ptel
from hotstuff_tpu_torch.bench.committee import reserve_ports
from hotstuff_tpu_torch.telemetry import journal as pjournal

from .test_torch_core import JAX, PORT
from .test_torch_node import REPO
from .test_torch_telemetry import ENV_KNOBS, FakeClock

TIMEOUT_S = 30.0


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    for knob in ENV_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    jtel.reset()
    ptel.reset()
    yield
    jtel.reset()
    ptel.reset()


class FakeDigest:
    """Stands in for a digest at record time: the journal calls only
    ``encode_base64()``, at flush."""

    def __init__(self, s: str):
        self._s = s

    def encode_base64(self) -> str:
        return (self._s * 16)[:22]


def _journal(mod, monkeypatch, node, path, clock, **kw):
    """A journal of package ``mod`` on ``clock``: the JAX journal binds
    the ambient clock at construction, the port's takes ``clock=``."""
    if mod is pjournal:
        return pjournal.Journal(node, str(path), clock=clock, **kw)
    with monkeypatch.context() as m:
        m.setattr(jjournal, "default_clock", lambda: clock)
        return jjournal.Journal(node, str(path), **kw)


def _events(j, first: int, n: int) -> None:
    """A seeded mix of every record shape: digests, peers, durations."""
    edges = ("propose", "recv.vote", "commit", "timeout", "span", "ingest.credit")
    for i in range(first, first + n):
        e = edges[(i * 7) % len(edges)]
        digest = FakeDigest(f"d{i % 13}") if e in ("propose", "recv.vote", "commit") else None
        peer = f"peer{i % 3}" if e == "recv.vote" else ""
        dur = (i * 1_237) % 50_000 if e in ("span", "ingest.credit") else None
        j.record(e, i // 3, digest, peer, dur_ns=dur)


def _files(path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(path.glob("*.jsonl"))}


def _both(tmp_path, monkeypatch, body) -> dict:
    """``body(mod, dir, clock)`` for each package on its own directory and
    a fresh fake clock; the segment files each left behind."""
    out = {}
    for mod in (jjournal, pjournal):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        body(mod, d, FakeClock())
        out[mod] = _files(d)
    return out


def test_segments_are_byte_equal_with_rotation_and_the_ring_bound(tmp_path, monkeypatch):
    def body(mod, d, clock):
        j = _journal(mod, monkeypatch, "ab/+C3==", d, clock,
                     segment_bytes=512, segments=3, buffer_records=4)
        _events(j, 0, 400)
        j.flush()
        stats = j.stats()
        j.close()
        assert stats["rotated"] > 0 and stats["segments"] <= 3 and stats["dropped"] > 0

    files = _both(tmp_path, monkeypatch, body)
    assert files[pjournal] == files[jjournal]
    assert 1 <= len(files[pjournal]) <= 3
    assert all("/" not in name and "+" not in name for name in files[pjournal])
    for data in files[pjournal].values():
        lines = data.decode().splitlines()
        meta = json.loads(lines[0])
        assert meta["e"] == "meta" and meta["n"] == "ab/+C3=="
        assert all(json.loads(line)["e"] != "meta" for line in lines[1:])
    (journals,) = [load_journals(str(tmp_path / "hotstuff_tpu_torch"))]
    assert list(journals) == ["ab/+C3=="]
    assert journals["ab/+C3=="][-1]["r"] == 399 // 3  # the newest events survive


def test_flush_on_close_torn_line_and_resume_are_byte_equal(tmp_path, monkeypatch):
    def body(mod, d, clock):
        j = _journal(mod, monkeypatch, "nodeB", d, clock, buffer_records=100)
        _events(j, 0, 5)
        stats = j.stats()
        assert stats["records"] == 0 and stats["buffered"] == 5
        j.close()
        assert j.stats()["records"] == 5
        (path,) = d.glob("*.jsonl")
        with open(path, "a") as f:
            f.write('{"e":"commit","r":3,"d":"tr')  # a crash mid-write
        # a restart resumes the ring after the torn line and keeps
        # numbering records and segments after the persisted ones
        j2 = _journal(mod, monkeypatch, "nodeB", d, clock, buffer_records=2, resume=True)
        assert j2.stats()["records"] == 5
        _events(j2, 5, 5)
        j2.close()

    files = _both(tmp_path, monkeypatch, body)
    assert files[pjournal] == files[jjournal] and len(files[pjournal]) == 2
    recs = load_journals(str(tmp_path / "hotstuff_tpu_torch"))["nodeB"]
    assert [r["s"] for r in recs] == list(range(10))


def test_reopen_without_resume_drops_the_previous_runs_segments(tmp_path, monkeypatch):
    def body(mod, d, clock):
        j1 = _journal(mod, monkeypatch, "nodeC", d, clock, buffer_records=1)
        j1.record("commit", 1, FakeDigest("old"))
        j1.close()
        j2 = _journal(mod, monkeypatch, "nodeC", d, clock, buffer_records=1)
        j2.record("commit", 2, FakeDigest("new"))
        j2.close()

    files = _both(tmp_path, monkeypatch, body)
    assert files[pjournal] == files[jjournal]
    journals = load_journals(str(tmp_path / "hotstuff_tpu_torch"))
    assert [r["r"] for r in journals["nodeC"]] == [2]


def test_journal_dir_resolution_and_off_by_default(tmp_path, monkeypatch):
    store = str(tmp_path / "store")

    def answers():
        return [(tel.journal_enabled(), tel.journal_dir(store), tel.enabled())
                for tel in (jtel, ptel)]

    steps = []
    steps.append(answers())  # off by default: no directory, nothing on
    monkeypatch.setenv("HOTSTUFF_JOURNAL", "1")
    steps.append(answers())
    monkeypatch.setenv("HOTSTUFF_JOURNAL_DIR", str(tmp_path / "env_dir"))
    steps.append(answers())
    for tel in (jtel, ptel):
        tel.set_journal_dir(str(tmp_path / "flag_dir"))
    steps.append(answers())
    for tel in (jtel, ptel):
        tel.reset()
    monkeypatch.delenv("HOTSTUFF_JOURNAL")
    monkeypatch.delenv("HOTSTUFF_JOURNAL_DIR")
    for tel in (jtel, ptel):
        tel.set_journal_dir(str(tmp_path / "flag_dir"))
    steps.append(answers())
    for jax, port in steps:
        assert port == jax
    got = [port for _, port in steps]
    assert got == [
        (False, None, False),
        (True, store + ".journal", True),
        (True, str(tmp_path / "env_dir"), True),
        (True, str(tmp_path / "flag_dir"), True),
        (True, str(tmp_path / "flag_dir"), True),
    ]
    assert not list(tmp_path.iterdir())  # resolving writes nothing


# ---- crash hooks -----------------------------------------------------------

SIGNAL_SCRIPT = r'''
import asyncio, json, os, signal, sys
from hotstuff_tpu_torch.telemetry.journal import Journal

jdir, with_loop_handler = sys.argv[1], sys.argv[2] == "1"

async def main():
    loop = asyncio.get_running_loop()
    task = asyncio.current_task()
    if with_loop_handler:
        loop.add_signal_handler(signal.SIGTERM, task.cancel)
    j = Journal("nodeS", jdir, buffer_records=1000)  # installs the hooks
    for r in range(1, 4):
        j.record("commit", r)
    os.kill(os.getpid(), signal.SIGTERM)
    try:
        await asyncio.sleep(10)
        print(json.dumps({"woken": False}))
    except asyncio.CancelledError:
        # the hook flushed before the loop's handler ran
        with open(os.path.join(jdir, "nodeS-000000.jsonl")) as f:
            flushed = sum(1 for line in f if '"commit"' in line)
        j.record("commit", 4)
        j.close()
        print(json.dumps({"woken": True, "flushed_at_signal": flushed}))

asyncio.run(main())
'''


@pytest.mark.parametrize("with_loop_handler", [True, False], ids=["loop-handler", "default"])
def test_sigterm_flushes_journals_and_keeps_the_loops_handler(tmp_path, with_loop_handler):
    """The first journal wraps the process's SIGTERM handler: a SIGTERM
    flushes every journal, then runs the previous handler — the event
    loop's, which cancels the main task (the CLI's clean stop), or, with
    none, the default disposition, so the process still dies of the
    signal with its journal on disk."""
    out = subprocess.run(
        [sys.executable, "-c", SIGNAL_SCRIPT, str(tmp_path), "1" if with_loop_handler else "0"],
        capture_output=True, text=True, timeout=60, env={**os.environ, "PYTHONPATH": REPO},
    )
    recs = load_journals(str(tmp_path))["nodeS"]
    if with_loop_handler:
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout) == {"woken": True, "flushed_at_signal": 3}
        assert [r["r"] for r in recs] == [1, 2, 3, 4]
    else:
        assert out.returncode == -15 and out.stdout == ""
        assert [r["r"] for r in recs] == [1, 2, 3]


# ---- merged timelines ------------------------------------------------------


async def _committee(sides, tmp_path, jdir, commits_each: int = 4) -> list:
    """Four stacks, node i on ``sides[i]``, each with its package's
    telemetry handle and journal (attached before spawn); the (round,
    digest) of each node's committed blocks."""
    socks = reserve_ports(4)
    ports = [s.getsockname()[1] for s in socks]
    nodes = []
    try:
        for i, side in enumerate(sides):
            tel_mod = jtel if side is JAX else ptel
            journal_mod = jjournal if side is JAX else pjournal
            tel_mod.enable()
            name, secret = side.keys()[i]
            tel = tel_mod.for_node(str(name)[:8])
            journal = journal_mod.Journal(tel.node, jdir, buffer_records=8)
            tel.attach_journal(journal)
            store = side.store.Store(str(tmp_path / f"db_{i}"))
            commit_q: asyncio.Queue = asyncio.Queue()
            socks[i].close()
            nodes.append((side, None, commit_q, store, journal))
            stack = await side.consensus.Consensus.spawn(
                name, side.committee(ports),
                side.consensus.Parameters(timeout_delay=1_000, sync_retry_delay=5_000),
                side.crypto.SignatureService(secret), store, commit_q,
                bind_host="127.0.0.1", telemetry=tel,
            )
            nodes[-1] = (side, stack, commit_q, store, journal)

        async def feed():
            i = 0
            while True:
                i += 1
                for side, stack, *_ in nodes:
                    await stack.tx_producer.put(side.crypto.Digest.of(b"journal payload %d" % i))
                await asyncio.sleep(0.02)

        feeder = asyncio.ensure_future(feed())
        try:
            chains = []
            for _, _, commit_q, _, _ in nodes:
                chain = []
                while len(chain) < commits_each:
                    block = await asyncio.wait_for(commit_q.get(), timeout=TIMEOUT_S)
                    if block.round > 0:
                        chain.append((block.round, block.digest().encode_base64()[:16]))
                chains.append(chain)
        finally:
            feeder.cancel()
        return chains
    finally:
        for _, stack, _, _, _ in nodes:
            if stack is not None:
                await stack.shutdown()
        for _, _, _, store, journal in nodes:
            journal.close()
            store.close()
        for s in socks:
            s.close()


@pytest.mark.parametrize("sides", [[PORT] * 4, [JAX, PORT, JAX, PORT]],
                         ids=["port", "2jax-2port"])
def test_merged_journals_hold_every_committed_round(tmp_path, sides):
    jdir = str(tmp_path / "journals")
    chains = asyncio.run(_committee(sides, tmp_path, jdir))
    ts = TraceSet.load(jdir)
    assert len(ts.nodes) == 4
    merged = {(ts.blocks[d]["round"], d) for d in ts.committed()}
    for chain in chains:
        assert set(chain) <= merged
    assert ts.coverage() >= 0.95
    for d in ts.reconstructed():
        assert ts.blocks[d]["leader"] in ts.nodes
    assert ts.edge_gaps()["propose_to_recv"]
    assert "CROSS-NODE TRACE" in ts.summary()
