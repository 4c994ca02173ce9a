"""The port's deterministic simulator (``hotstuff_tpu_torch/sim``) held
against the JAX package's (``hotstuff_tpu/sim``).

The virtual loop and clock, the schedule drawer, its spec conversion and
mutation for 50 seeds at 4 and 16 nodes, every entry of the regression
corpus (``tests/data/sim_seeds.json``) replayed through both packages
with equal verdicts, judge blocks, flow tables, attributions and journal
digests (the port's journal normalised to the reference's logger names),
same-seed runs equal within the port and across processes under another
``PYTHONHASHSEED``, the torn-tail crash leaving the reference's WAL bytes,
``transport="sim"`` under ``HOTSTUFF_SIM_LINK_MS``, and the port's copies
of the judge and the journal loader on the same run directories.  Every
run is in virtual time at 4 or 16 nodes, a few seconds at most.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import benchmark.invariants as jinv
import benchmark.traces as jtraces
import chip_smoke
import hotstuff_tpu.sim as jsim
import hotstuff_tpu.sim.schedule as jschedule
import hotstuff_tpu.telemetry.critpath as jcritpath
import hotstuff_tpu_torch.sim as psim
import hotstuff_tpu_torch.sim.schedule as pschedule
import hotstuff_tpu_torch.telemetry.critpath as pcritpath
from hotstuff_tpu_torch.sim import invariants as pinv
from hotstuff_tpu_torch.sim.harness import SIM_BASE_PORT
from hotstuff_tpu_torch.telemetry import traces as ptraces

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "data" / "sim_seeds.json"

#: a crash with a torn WAL tail (complete header, missing body), the
#: reference's ``tests/test_simnet.py`` schedule
CRASH = {
    "version": jschedule.SCHEDULE_VERSION,
    "seed": 12345,
    "nodes": 4,
    "duration_s": 9.0,
    "profile": "honest",
    "events": [
        {"kind": "crash", "node": 2, "at": 2.0, "restart_at": 4.0, "torn_bytes": 33}
    ],
}

#: verdict fields the two packages must give alike
FIELDS = (
    "seed", "profile", "ok", "all_ok", "safety_ok", "trusted_ok", "commits",
    "rounds", "block", "failures", "threats", "timeouts", "attribution",
)


def _corpus() -> dict:
    with open(CORPUS) as f:
        return json.load(f)


def _both(schedule: dict, tmp_path: Path, tag: str = ""):
    """(JAX verdict, port verdict, JAX workdir, port workdir) of one
    schedule."""
    jdir, pdir = tmp_path / f"jax{tag}", tmp_path / f"port{tag}"
    j = jsim.run_schedule(schedule, workdir=str(jdir))
    p = psim.run_schedule(schedule, workdir=str(pdir))
    return j, p, jdir, pdir


def _flows(verdict) -> str:
    return json.dumps(verdict.flows, sort_keys=True)


def _assert_same_run(j, p, pdir: Path) -> None:
    for field in FIELDS:
        assert getattr(p, field) == getattr(j, field), field
    assert _flows(p) == _flows(j)
    # the port's journal keeps its own logger names; written as the
    # reference's, it is the reference's journal byte for byte
    assert p.journal_digest != j.journal_digest
    assert psim.normalised_journal_digest(str(pdir / "journal.jsonl")) == j.journal_digest


# ---- virtual loop -----------------------------------------------------


@pytest.mark.parametrize("pkg", [jsim, psim], ids=["jax", "port"])
def test_virtual_loop_sleeps_cost_no_wall_time(pkg):
    loop = pkg.SimLoop()
    clock = pkg.VirtualClock(loop)

    async def nap():
        stamps = []
        for i in range(60):
            await asyncio.sleep(60.0 + i / 8)
            stamps.append((clock.monotonic(), clock.time(), clock.monotonic_ns()))
        return stamps

    t0 = time.monotonic()
    try:
        stamps = loop.run_until_complete(nap())
    finally:
        loop.close()
    assert stamps[-1][0] >= 3600.0
    assert time.monotonic() - t0 < 5.0
    assert pkg.SIM_EPOCH == psim.SIM_EPOCH == jsim.SIM_EPOCH
    assert all(wall == pkg.SIM_EPOCH + mono for mono, wall, _ns in stamps)


def test_the_virtual_loops_keep_one_time_line():
    """The same coroutine on both packages' loops: equal virtual stamps,
    and a wait no timer can end is each package's ``SimDeadlock``."""

    async def work(clock):
        out = []
        for delay in (0.05, 1.5, 0.0, 2.25, 0.001):
            await clock.sleep(delay)
            out.append((clock.monotonic(), clock.time(), clock.monotonic_ns()))
        return out

    runs = []
    for pkg in (jsim, psim):
        loop = pkg.SimLoop()
        try:
            runs.append(loop.run_until_complete(work(pkg.VirtualClock(loop))))
            with pytest.raises(pkg.SimDeadlock):
                loop.run_until_complete(loop.create_future())
        finally:
            loop.close()
    assert runs[0] == runs[1]


# ---- schedules --------------------------------------------------------


@pytest.mark.parametrize("nodes", [4, 16])
def test_schedules_specs_and_mutations_are_the_references(nodes):
    assert pschedule.SCHEDULE_VERSION == jschedule.SCHEDULE_VERSION
    assert pschedule.BYZ_FRACTION == jschedule.BYZ_FRACTION
    assert SIM_BASE_PORT == jsim.harness.SIM_BASE_PORT
    profiles = set()
    for seed in range(50):
        s = psim.draw_schedule(seed, nodes=nodes)
        assert s == jsim.draw_schedule(seed, nodes=nodes)
        profiles.add(s["profile"])
        assert psim.schedule_to_spec(s, SIM_BASE_PORT) == jsim.schedule_to_spec(s, SIM_BASE_PORT)
        for profile in ("honest", "byz-collude", "adaptive"):
            forced = psim.draw_schedule(seed, nodes=nodes, profile=profile)
            assert forced == jsim.draw_schedule(seed, nodes=nodes, profile=profile)
            assert psim.schedule_to_spec(forced, 9000) == jsim.schedule_to_spec(forced, 9000)
        for salt in range(3):
            child = psim.mutate_schedule(s, salt)
            assert child == jsim.mutate_schedule(s, salt)
            assert psim.profile_of_events(child["events"]) == jsim.profile_of_events(child["events"])
    assert profiles == {"honest", "byz-collude"}
    with pytest.raises(ValueError):
        psim.schedule_to_spec({"seed": 1, "nodes": 4, "events": [{"kind": "bogus"}]}, 7000)


# ---- the regression corpus -------------------------------------------


@pytest.mark.parametrize(
    "entry", _corpus()["entries"], ids=lambda e: f"seed-{e['seed']}-{e['profile']}"
)
def test_corpus_entry_gives_the_references_verdict_and_journal(entry, tmp_path):
    corpus = _corpus()
    assert corpus["version"] == pschedule.SCHEDULE_VERSION
    schedule = entry.get("schedule") or psim.draw_schedule(entry["seed"], nodes=corpus["nodes"])
    assert schedule["profile"] == entry["profile"]
    j, p, _jdir, pdir = _both(schedule, tmp_path)
    _assert_same_run(j, p, pdir)
    assert p.ok == entry["ok"], (entry["note"], p.failures)
    assert p.attribution is not None
    # phase (p) of chip_smoke.py holds the card's run to these numbers
    i = corpus["entries"].index(entry)
    assert chip_smoke.SIM_CORPUS_REFERENCE[i] == (
        entry["seed"], j.rounds, j.commits, j.timeouts, j.journal_digest)
    if "schedule" in entry:
        assert list(p.threats) == list(entry.get("threats", []))
        assert psim.normalised_journal_digest(str(pdir / "journal.jsonl")) == entry["journal_digest"]


def test_a_16_node_schedule_gives_the_references_run(tmp_path):
    schedule = psim.draw_schedule(1, nodes=16)
    j, p, _jdir, pdir = _both(schedule, tmp_path)
    _assert_same_run(j, p, pdir)
    assert p.ok and p.rounds > 20 and p.commits > 16 * 20


# ---- determinism -------------------------------------------------------


def test_same_seed_port_runs_give_equal_journals_and_flows(tmp_path):
    schedule = psim.draw_schedule(3, nodes=4)
    a = psim.run_schedule(schedule, workdir=str(tmp_path / "a"))
    b = psim.run_schedule(schedule, workdir=str(tmp_path / "b"))
    assert a.ok and b.ok
    assert a.journal_digest == b.journal_digest
    ja = (tmp_path / "a" / "journal.jsonl").read_bytes()
    assert ja and ja == (tmp_path / "b" / "journal.jsonl").read_bytes()
    assert a.flows and _flows(a) == _flows(b)
    wire = sum(row[0] for tables in a.flows.values() for t in tables for row in t["flows"].values())
    assert wire > 0
    assert {"propose", "vote"} <= {
        key.rsplit("|", 2)[2] for tables in a.flows.values() for t in tables for key in t["flows"]
    }


def test_the_entry_point_replays_across_processes(tmp_path):
    """``python -m hotstuff_tpu_torch.sim`` under another
    ``PYTHONHASHSEED``: one JSON line, the in-process run's digests and
    flow tables, and the corpus's expectations met."""
    schedule = psim.draw_schedule(1, nodes=4)
    here = psim.run_schedule(schedule, workdir=str(tmp_path / "here"))
    env = {**os.environ, "PYTHONHASHSEED": "4242", "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.sim", "1", str(CORPUS)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    runs = json.loads(lines[0])["runs"]
    assert len(runs) == 1 + len(_corpus()["entries"])
    first = runs[0]
    assert first["journal_digest"] == here.journal_digest
    assert first["normalised_digest"] == psim.normalised_journal_digest(
        str(tmp_path / "here" / "journal.jsonl"))
    assert first["flows_digest"] == hashlib.sha256(_flows(here).encode()).hexdigest()
    assert (first["ok"], first["rounds"], first["commits"]) == (here.ok, here.rounds, here.commits)
    for run in runs[1:]:
        expect = run["expect"]
        assert run["ok"] == expect["ok"] and run["profile"] == expect["profile"]
        if "journal_digest" in expect:
            assert run["threats"] == expect["threats"]
            assert run["normalised_digest"] == expect["journal_digest"]


# ---- crash points ------------------------------------------------------


@pytest.mark.parametrize("restart_at", [4.0, None], ids=["restarted", "left-down"])
def test_torn_tail_crash_leaves_the_references_wal_bytes(restart_at, tmp_path):
    """A crash appends a torn record after the store's per-put flushes;
    the port's stores are ``WalEngine``s, so ``StateMachine.apply_block``
    does not batch, and every store's log is the reference's byte for
    byte: with the torn tail still there (left down) and after recovery
    truncated it and the node rejoined (restarted)."""
    schedule = json.loads(json.dumps(CRASH))
    schedule["events"][0]["restart_at"] = restart_at
    j, p, jdir, pdir = _both(schedule, tmp_path)
    _assert_same_run(j, p, pdir)
    assert p.ok, p.failures
    assert p.commits > 0
    journal = (pdir / "journal.jsonl").read_text()
    assert "node 2 crashed (torn tail 33B)" in journal
    assert ("node 2 restarted" in journal) == (restart_at is not None)
    for i in range(4):
        wal = (pdir / f"store-{i}" / "wal.log").read_bytes()
        assert wal and wal == (jdir / f"store-{i}" / "wal.log").read_bytes(), i
    if restart_at is None:
        # the tail: an 8-byte header promising a 32 B key and a 200 B
        # value, and 25 of its bytes
        wal = (pdir / "store-2" / "wal.log").read_bytes()
        assert b"\x20\x00\x00\x00\xc8\x00\x00\x00" in wal[-33:-24]


# ---- transport="sim" ---------------------------------------------------


@pytest.mark.parametrize("link_ms", ["20", "120"])
def test_sim_link_delay_paces_both_packages_alike(link_ms, tmp_path, monkeypatch):
    monkeypatch.setenv("HOTSTUFF_SIM_LINK_MS", link_ms)
    schedule = psim.draw_schedule(1, nodes=4)
    j, p, _jdir, pdir = _both(schedule, tmp_path)
    _assert_same_run(j, p, pdir)
    monkeypatch.delenv("HOTSTUFF_SIM_LINK_MS")
    default = psim.run_schedule(schedule, workdir=str(tmp_path / "default"))
    # the default hop is 50 ms: a shorter one makes more rounds
    assert (p.rounds > default.rounds) == (int(link_ms) < 50)
    assert p.rounds != default.rounds


def test_spawn_on_the_sim_transport_listens_on_the_installed_net(tmp_path):
    """``Consensus.spawn(..., transport="sim")`` registers a
    ``SimReceiver`` on the run's ``SimNet`` and answers a connection
    made through it; without a ``SimNet`` it raises as the reference
    does."""
    from hotstuff_tpu_torch.consensus import Committee, Parameters
    from hotstuff_tpu_torch.consensus.consensus import Consensus
    from hotstuff_tpu_torch.crypto import SignatureService, generate_keypair
    from hotstuff_tpu_torch.sim.transport import set_current_net
    from hotstuff_tpu_torch.store import Store
    from hotstuff_tpu_torch.store.engine import WalEngine
    from hotstuff_tpu_torch.utils.clock import set_default_clock, set_default_connector

    pairs = sorted(generate_keypair(bytes(32), i) for i in range(4))
    committee = Committee.new([(pk, 1, ("127.0.0.1", 7100 + i)) for i, (pk, _) in enumerate(pairs)])
    loop = psim.SimLoop()
    net = psim.SimNet()

    async def body():
        path = str(tmp_path / "db")
        store = Store(path, engine=WalEngine(path))
        stack = await Consensus.spawn(
            pairs[0][0], committee, Parameters(), SignatureService(pairs[0][1]),
            store, asyncio.Queue(), bind_host="127.0.0.1", transport="sim",
        )
        try:
            assert isinstance(stack.receiver, psim.SimReceiver)
            assert net._listeners[7100] is stack.receiver
            _reader, writer = await net.open_connection("127.0.0.1", 7100)
            writer.close()
            with pytest.raises(ConnectionRefusedError):
                await net.open_connection("127.0.0.1", 7101)
        finally:
            await stack.shutdown()
            store.close()
        assert 7100 not in net._listeners

    prev_clock = set_default_clock(psim.VirtualClock(loop))
    prev_conn = set_default_connector(net.open_connection)
    prev_net = set_current_net(net)
    try:
        asyncio.set_event_loop(loop)
        loop.run_until_complete(body())
        pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
        for t in pending:
            t.cancel()
        loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
    finally:
        asyncio.set_event_loop(None)
        loop.close()
        set_default_clock(prev_clock)
        set_default_connector(prev_conn)
        set_current_net(prev_net)
    with pytest.raises(RuntimeError, match="no SimNet installed"):
        psim.SimReceiver("127.0.0.1", 7100, handler=None)


def test_the_clock_setters_swap_and_restore_the_ambient_seams():
    import asyncio as aio
    import random

    from hotstuff_tpu_torch.utils import clock as pclock
    from hotstuff_tpu.utils import clock as jclock

    assert set(jclock.__all__) == set(pclock.__all__)
    rng = random.Random("x")

    async def conn(*_a, **_k):
        return None

    for mod in (jclock, pclock):
        loop = psim.SimLoop()
        try:
            vclock = psim.VirtualClock(loop)
            assert mod.set_default_clock(vclock) is mod.SYSTEM_CLOCK
            assert mod.default_clock() is vclock
            assert mod.set_default_clock(None) is vclock
            assert mod.default_clock() is mod.SYSTEM_CLOCK
            assert mod.set_default_rng(rng) is random and mod.default_rng() is rng
            assert mod.set_default_rng(None) is rng and mod.default_rng() is random
            assert mod.set_default_connector(conn) is aio.open_connection
            assert mod.default_connector() is conn
            assert mod.set_default_connector(None) is conn
            assert mod.default_connector() is aio.open_connection
        finally:
            loop.close()


# ---- the judge and the journal loader ----------------------------------


@pytest.mark.parametrize("seed", [0, 17])
def test_the_judges_copy_reads_logs_as_the_harness_does(seed, tmp_path):
    """The port's ``sim/invariants.py`` on the logs of a collusion run
    (seed 0) and of a reconfiguration (seed 17): every extractor, check
    and rendered block equal to ``benchmark/invariants.py``'s."""
    schedule = psim.draw_schedule(seed, nodes=4)
    psim.run_schedule(schedule, workdir=str(tmp_path))
    logs = str(tmp_path / "logs")
    spec = psim.schedule_to_spec(schedule, SIM_BASE_PORT)
    for name in ("commits_from_logs", "state_roots_from_logs", "epochs_from_logs",
                 "byz_activity_from_logs"):
        assert getattr(pinv, name)(logs) == getattr(jinv, name)(logs), name
    commits = pinv.commits_from_logs(logs)
    assert commits and all(commits.values())
    assert pinv.check_safety(commits) == jinv.check_safety(commits)
    adversaries = pinv.adversaries_from_spec(spec)
    assert adversaries == jinv.adversaries_from_spec(spec)
    assert bool(adversaries) == (seed == 0)
    assert pinv.trusted_subset_recheck(commits, set(adversaries)) == jinv.trusted_subset_recheck(
        commits, set(adversaries))
    epochs = pinv.epochs_from_logs(logs)
    assert pinv.check_epoch_agreement(epochs) == jinv.check_epoch_agreement(epochs)
    assert any(epochs.values()) == (seed == 17)
    assert pinv.check_handoff_gap(commits, epochs, 400) == jinv.check_handoff_gap(commits, epochs, 400)
    assert pinv.check_liveness(commits, psim.SIM_EPOCH + 6.0, 20.0, 400) == jinv.check_liveness(
        commits, jsim.SIM_EPOCH + 6.0, 20.0, 400)
    got = pinv.check_run(logs, spec, epoch_unix=psim.SIM_EPOCH)
    assert got == jinv.check_run(logs, spec, epoch_unix=jsim.SIM_EPOCH)
    assert "+ CHAOS" in got[1]
    assert pinv.RE_COMMITTED.pattern == jinv.RE_COMMITTED.pattern


def test_the_journal_loaders_copy_merges_as_the_harness_does(tmp_path):
    """The port's ``telemetry/traces.py`` on a crash-restarted run's
    journals (resumed rings, deduplicated seqs): the blocks, nodes,
    producer waits, merge accounting and offsets of the harness's
    ``TraceSet``, and the same critical-path report through either
    package's ``analyze``."""
    psim.run_schedule(CRASH, workdir=str(tmp_path))
    jdir = str(tmp_path / "journals")
    mine, theirs = ptraces.TraceSet.load(jdir), jtraces.TraceSet.load(jdir)
    assert mine.journals == theirs.journals and len(mine.nodes) == 4
    assert mine.blocks == theirs.blocks and mine.blocks
    assert mine.nodes == theirs.nodes
    assert mine.payload_waits == theirs.payload_waits
    assert mine.merge_stats == theirs.merge_stats and mine.merge_stats["overlap"] >= 0
    assert (mine.offsets, mine.reference) == (theirs.offsets, theirs.reference)
    assert mine.journal_coverage() == theirs.journal_coverage()
    a = pcritpath.analyze(mine).attribution()
    assert a == jcritpath.analyze(theirs).attribution() == pcritpath.analyze(theirs).attribution()
    assert a["commits"] > 0
