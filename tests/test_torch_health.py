"""The port's health plane (``telemetry/health.py``, the node's health
branch and ``--health``) against the JAX package's.

On the same inputs, drawn from a numpy seed, both packages give equal
results, compared with ``==``: the floats are computed by the same
stdlib expressions, so there is no tolerance.  Covered: ``Window`` and
``rate``, ``Incident.to_json``, every detector on seeded windows and at
its threshold boundaries (with the EWMA state it returns), the campaign
recorder's gate, bound and persisted bytes, and a ``HealthMonitor`` of
each package driven by ``tick(now)`` over one scripted sequence of
snapshot documents and attributions: the same incidents at every tick,
the same ``Health incident:`` lines, the same journal records (both
journals on one fake clock) and campaign files equal byte for byte.

End to end, as an operator runs it: a 4-node port ``run-many --health
--metrics-port 0 --journal-dir`` fed by the client, whose logs
``benchmark.logs.LogParser`` folds into a ``+ HEALTH`` block and whose
``/delta`` ``benchmark.watch``'s ``FleetWatcher`` reads; and a
committee below quorum (2 of 4 keys), where every node opens
``leader_stall`` and persists its campaign ring on SIGTERM.

Telemetry is process-global in both packages: every test starts with
both off and empty, and leaves them so.  Every listener port comes from
the OS; every wait has a deadline; every process is stopped in
``finally``."""

import asyncio
import dataclasses
import json
import logging
import os
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from hotstuff_tpu import telemetry as jtel
from hotstuff_tpu.telemetry import health as jhealth
from hotstuff_tpu.telemetry import journal as jjournal
from hotstuff_tpu_torch import telemetry as ptel
from hotstuff_tpu_torch.telemetry import health as phealth
from hotstuff_tpu_torch.telemetry import journal as pjournal

from .test_torch_journal import _journal
from .test_torch_node import REPO, spawn_client, stop_all, wait_for, write_port_committee
from .test_torch_telemetry import ENV_KNOBS, FakeClock

SEED = 20_261_017
CLI = [sys.executable, "-m", "hotstuff_tpu_torch.node"]
RE_ENDPOINT = re.compile(r"Telemetry /metrics endpoint listening on port (\d+)")
RE_INCIDENT = re.compile(r"Health incident: (\{.*\})")


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    for knob in ENV_KNOBS + ("HOTSTUFF_HEALTH",):
        monkeypatch.delenv(knob, raising=False)
    jtel.reset()
    ptel.reset()
    yield
    jtel.reset()
    ptel.reset()


def plain(x):
    """A result with each package's ``Incident`` made a tuple, so the two
    packages' results compare with ``==``."""
    if isinstance(x, (jhealth.Incident, phealth.Incident)):
        return ("Incident", dataclasses.astuple(x), x.to_json())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def test_exports_and_constants_are_the_references():
    assert phealth.__all__ == jhealth.__all__
    for name in ("HEALTH_EDGE_PREFIX", "HEALTH_KINDS", "CAMPAIGN_SUFFIX", "DELTA_HISTORY",
                 "PERSIST_EVERY", "CLEAR_AFTER"):
        assert getattr(phealth, name) == getattr(jhealth, name), name


@pytest.mark.parametrize("value", [None, "", "0", "1", "true", "off", " On ", "no", "FALSE", "yes"])
def test_health_switch_matches(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv("HOTSTUFF_HEALTH", value)
    assert ptel.health_enabled() == jtel.health_enabled()
    assert ptel.health_enabled() == (value in ("1", "true", " On ", "yes"))


# ---- windows, rate, incidents ----------------------------------------------


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_window_and_rate_equal(seed):
    rng = np.random.default_rng(seed)
    for span, cap in ((60.0, 256), (5.0, 256), (30.0, 8), (0.5, 4)):
        jw, pw = jhealth.Window(span, cap), phealth.Window(span, cap)
        t = float(rng.random())
        for _ in range(300):
            t += float(rng.choice([0.0, 0.1, 1.0, float(rng.random() * 3)]))
            v = float(rng.integers(0, 1000)) if rng.random() < 0.5 else float(rng.random() * 1e6)
            jw.push(t, v)
            pw.push(t, v)
            assert pw.samples() == jw.samples() and len(pw) == len(jw)
            s = jw.samples()
            for cut in (s, s[:1], s[-2:], s[:0], [(t, 1.0), (t, 5.0)], [(t, 5.0), (t - 1.0, 1.0)]):
                assert phealth.rate(cut) == jhealth.rate(cut)


def test_incident_to_json_equal():
    rng = np.random.default_rng(SEED)
    for _ in range(200):
        args = ("leader_stall", f"n{int(rng.integers(0, 9))}", "crit", "detail",
                float(rng.random() * 10 ** int(rng.integers(-4, 7))))
        a, b = jhealth.Incident(*args), phealth.Incident(*args)
        assert b.to_json() == a.to_json()
        assert json.dumps(b.to_json(), sort_keys=True) == json.dumps(a.to_json(), sort_keys=True)
    assert phealth.Incident("k", "n", "warn", "d").to_json() == jhealth.Incident("k", "n", "warn", "d").to_json()


# ---- the detectors ---------------------------------------------------------


def _counter(rng, n: int, t0: float = 0.0, stall_p: float = 0.5) -> list:
    """(t, monotonic counter) samples with stretches of no progress."""
    out, t, v = [], t0, float(rng.integers(0, 50))
    for _ in range(n):
        t += float(rng.choice([0.5, 1.0, float(rng.random() * 2)]))
        if rng.random() > stall_p:
            v += float(rng.integers(1, 20))
        out.append((round(t, 3), v))
    return out


def _leader_stall_cases(rng):
    yield ([], 10.0, 5.0)
    yield ([(0.0, 3.0)], 14.9, 5.0)  # under the horizon
    yield ([(0.0, 3.0)], 15.0, 5.0)  # exactly at it
    yield ([(0.0, 3.0), (5.0, 4.0)], 20.0, 5.0)  # stalled exactly k x timeout since the advance
    yield ([(0.0, 3.0), (5.0, 4.0)], 19.99, 5.0)
    for _ in range(150):
        samples = _counter(rng, int(rng.integers(1, 40)))
        now = samples[-1][0] + float(rng.random() * 20)
        yield (samples, now, float(rng.choice([0.1, 0.5, 1.0, 5.0])))


def _storm_cases(rng, min_rate):
    yield ([], None)
    yield ([(1.0, 0.0)], 0.2)
    yield ([(0.0, 0.0), (1.0, 0.0)], None)  # seeds the baseline
    yield ([(0.0, 0.0), (1.0, 4.0 * min_rate)], min_rate)  # r == factor x baseline: quiet
    yield ([(0.0, 0.0), (1.0, min_rate)], min_rate / 8)  # r == min_rate
    yield ([(0.0, 0.0), (2.0, min_rate)], min_rate / 8)  # below min_rate
    for _ in range(150):
        samples = _counter(rng, int(rng.integers(0, 12)), stall_p=0.7)
        scale = min_rate * float(rng.choice([0.01, 1.0, 100.0]))
        samples = [(t, v * scale) for t, v in samples]
        yield (samples, None if rng.random() < 0.2 else float(rng.random() * scale))


@pytest.mark.parametrize("seed", [SEED, SEED + 3])
def test_leader_stall_equal(seed):
    rng = np.random.default_rng(seed)
    fired = 0
    for progress, now, timeout_s in _leader_stall_cases(rng):
        for k in (3.0, 1.0):
            want = jhealth.leader_stall(progress, now, timeout_s, k=k, node="n1")
            assert plain(phealth.leader_stall(progress, now, timeout_s, k=k, node="n1")) == plain(want)
            fired += want is not None
    assert fired > 10


@pytest.mark.parametrize("name, min_rate", [("view_change_storm", 0.5), ("bandwidth_storm", 65536.0)])
def test_ewma_storm_detectors_equal_with_their_state(name, min_rate):
    rng = np.random.default_rng(SEED)
    jf, pf = getattr(jhealth, name), getattr(phealth, name)
    fired = 0
    for samples, baseline in _storm_cases(rng, min_rate):
        want = jf(samples, baseline, node="n2")
        assert plain(pf(samples, baseline, node="n2")) == plain(want)
        fired += want[0] is not None
    # the EWMA carried tick to tick, as the monitor carries it
    jstate = pstate = None
    window = []
    for t, v in _counter(rng, 200, stall_p=0.3):
        burst = min_rate * 40 if rng.random() < 0.05 else 0.0
        window = (window + [(t, v * min_rate + burst)])[-8:]
        (ji, jstate), (pi, pstate) = jf(window, jstate, alpha=0.3), pf(window, pstate, alpha=0.3)
        assert plain(pi) == plain(ji) and pstate == jstate
        fired += ji is not None
    assert fired > 0


def test_commit_collapse_equal():
    rng = np.random.default_rng(SEED)
    cases = [[], [(0.0, 0.0)] * 3, [(0.0, 0.0), (1.0, 4.0), (2.0, 5.0), (3.0, 5.0)],
             [(0.0, 0.0), (1.0, 4.0), (2.0, 8.0), (3.0, 9.0), (4.0, 10.0)],  # late == 0.25 x early
             [(0.0, 0.0), (1.0, 0.5), (2.0, 1.0), (3.0, 1.0)]]  # early under the baseline floor
    cases += [_counter(rng, int(rng.integers(0, 30)), stall_p=float(rng.random())) for _ in range(300)]
    fired = 0
    for samples in cases:
        for ratio, floor in ((0.25, 1.0), (0.5, 0.1)):
            want = jhealth.commit_collapse(samples, ratio, floor, node="n3")
            assert plain(phealth.commit_collapse(samples, ratio, floor, node="n3")) == plain(want)
            fired += want is not None
    assert fired > 0


def test_shed_storm_equal():
    rng = np.random.default_rng(SEED)
    cases = [[], [(0.0, 0.0)], [(0.0, 0.0), (0.5, 10.0)],  # total == min_shed, r == threshold
             [(0.0, 0.0), (1.0, 9.0)], [(0.0, 0.0), (1.0, 19.99)]]
    cases += [[(t, v * float(rng.choice([0.1, 5.0, 50.0]))) for t, v in _counter(rng, int(rng.integers(0, 10)))]
              for _ in range(300)]
    fired = 0
    for samples in cases:
        want = jhealth.shed_storm(samples, node="n4")
        assert plain(phealth.shed_storm(samples, node="n4")) == plain(want)
        fired += want is not None
    assert fired > 0


def test_fleet_detectors_equal():
    rng = np.random.default_rng(SEED)
    names = [f"node{i}" for i in range(12)]
    fired = 0
    for _ in range(200):
        now = 100.0
        rounds = {n: (now - float(rng.choice([0.0, 5.0, 5.01, float(rng.random() * 8)])),
                      float(rng.integers(0, 60))) for n in rng.choice(names, size=int(rng.integers(0, 12)))}
        offsets = {n: float(rng.random() * 2 - 1) for n in names if rng.random() < 0.3}
        for lag in (16.0, 1.0):
            want = jhealth.straggler(rounds, offsets, now, lag_rounds=lag)
            assert plain(phealth.straggler(rounds, offsets, now, lag_rounds=lag)) == plain(want)
            fired += len(want)
        roots = {str(n): (int(rng.integers(0, 4)), f"{int(rng.integers(0, 3)):064x}")
                 for n in rng.choice(names, size=int(rng.integers(0, 12)))}
        want = jhealth.root_divergence(roots)
        assert plain(phealth.root_divergence(roots)) == plain(want)
        fired += len(want)
        epochs = {str(n): (None if rng.random() < 0.2 else int(rng.integers(1, 4)))
                  for n in rng.choice(names, size=int(rng.integers(0, 12)))}
        want = jhealth.epoch_skew(epochs)
        assert plain(phealth.epoch_skew(epochs)) == plain(want)
        fired += len(want)
    # the boundaries: a lag of exactly lag_rounds, a sample exactly max_age_s old
    rounds = {"a": (95.0, 40.0), "b": (100.0, 24.0), "c": (94.9, 0.0)}
    assert plain(phealth.straggler(rounds, {}, 100.0)) == plain(jhealth.straggler(rounds, {}, 100.0))
    assert [i.node for i in phealth.straggler(rounds, {}, 100.0)] == ["b"]
    assert fired > 0


def test_crit_regime_shift_equal():
    rng = np.random.default_rng(SEED)
    regimes = ["network-bound", "verify-bound", "aggregation-bound", "ingest-bound", "unknown", "", None]
    fired = 0
    for _ in range(400):
        seq = [regimes[int(i)] for i in rng.choice(len(regimes), size=int(rng.integers(0, 12)),
                                                   p=[0.3, 0.3, 0.1, 0.1, 0.1, 0.05, 0.05])]
        if rng.random() < 0.4 and seq:
            seq += [seq[0]] * int(rng.integers(1, 5))
        for confirm in (3, 1):
            want = jhealth.crit_regime_shift(seq, confirm=confirm, node="n5")
            assert plain(phealth.crit_regime_shift(seq, confirm=confirm, node="n5")) == plain(want)
            fired += want is not None
    assert fired > 0


# ---- the campaign recorder -------------------------------------------------


def test_campaign_recorder_gate_bound_and_bytes(tmp_path):
    rng = np.random.default_rng(SEED)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    suffix = phealth.CAMPAIGN_SUFFIX
    jr = jhealth.CampaignRecorder("n0", str(jdir / f"n0{suffix}"), interval_s=1.0, capacity=16)
    pr = phealth.CampaignRecorder("n0", str(pdir / f"n0{suffix}"), interval_s=1.0, capacity=16)
    t, taken = 0.0, 0
    for i in range(120):
        t += float(rng.choice([0.25, 0.999, 1.0, 1.5]))
        row = {"round": i, "commits": float(rng.integers(0, 500)), "credit": int(rng.integers(0, 9)),
               "incidents": int(rng.integers(0, 3))}
        got = pr.sample(t, dict(row))
        assert got == jr.sample(t, dict(row))
        taken += got
        assert len(pr) == len(jr) <= 16
        assert pr.to_json() == jr.to_json()
    assert 16 < taken < 120  # the gate dropped rows and the bound held
    assert pr.persist() == str(pdir / f"n0{suffix}") and jr.persist() == str(jdir / f"n0{suffix}")
    pbytes, jbytes = (pdir / f"n0{suffix}").read_bytes(), (jdir / f"n0{suffix}").read_bytes()
    assert pbytes == jbytes and len(json.loads(pbytes)["samples"]) == 16
    assert phealth.CampaignRecorder.load(pr.path) == jhealth.CampaignRecorder.load(jr.path)
    assert sorted(os.listdir(pdir)) == [f"n0{suffix}"]  # the tmp file was renamed over
    assert phealth.CampaignRecorder("n1").persist() is None is jhealth.CampaignRecorder("n1").persist()


def test_campaign_file_of_a_node_id_with_a_slash(tmp_path):
    """A base64 node id may hold ``/``: the reference joins it raw, so the
    ring's path names a missing subdirectory and never persists; the
    port's node writes it under the journal's filename-safe id, with the
    id itself in the file."""
    from hotstuff_tpu_torch.node.node import campaign_file

    raw = os.path.join(str(tmp_path), f"ab/cd+ef{jhealth.CAMPAIGN_SUFFIX}")
    with pytest.raises(FileNotFoundError):
        jhealth.CampaignRecorder("ab/cd+ef", raw).persist()
    path = campaign_file(str(tmp_path), "ab/cd+ef")
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == f"ab_cd_ef{phealth.CAMPAIGN_SUFFIX}"
    rec = phealth.CampaignRecorder("ab/cd+ef", path)
    rec.sample(1.0, {"round": 1})
    assert rec.persist() == path
    assert phealth.CampaignRecorder.load(path)["node"] == "ab/cd+ef"


# ---- the monitor, scripted -------------------------------------------------


def _scripted_docs(seed: int, n: int) -> list:
    """Snapshot documents as a node's ``tel.snapshot()`` returns them,
    scripted to open and close every node-local incident: commit stalls
    (leader_stall), a collapse of the commit rate, TC bursts (view_storm),
    shedding (shed_storm) and, from a JAX node with flows on, egress
    bursts (bandwidth_storm)."""
    rng = np.random.default_rng(seed)
    commits = tcs = shed = tx = 0
    docs = []
    for i in range(n):
        phase = (i // 25) % 4
        if phase != 1:  # the second stretch of every 100 ticks: no commits
            commits += int(rng.integers(0, 4)) if phase == 3 else int(rng.integers(2, 6))
        tcs += int(rng.integers(3, 9)) if 60 <= i % 100 < 64 else int(rng.random() < 0.1)
        shed += int(rng.integers(300, 600)) if 40 <= i % 100 < 46 else 0
        tx += int(rng.integers(10_000, 20_000)) * (200 if 80 <= i % 100 < 83 else 1)
        doc = {
            "node": "n0",
            "trace": {"commits": commits, "tc_advances": tcs, "last_commit_round": commits + tcs},
            "ingest": {"shed_total": shed, "last_credit": int(rng.integers(0, 100))},
            "state": {"version": commits},
        }
        if i >= 10:
            doc["flows"] = {"enabled": True, "tx_bytes": tx}
        if rng.random() < 0.05:
            doc = {}  # a snapshot with no sections at all
        docs.append(doc)
    return docs


def _scripted_attributions(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.1:
            out.append(None)
        elif r < 0.15:
            out.append(RuntimeError("no samples yet"))
        else:
            regime = "network-bound" if (i // 17) % 2 else "aggregation-bound"
            if rng.random() < 0.1:
                regime = "verify-bound"  # a one-tick flap
            out.append({"samples": 8, "dominant": "qc_to_commit", "regime": regime,
                        "edges_ms": {"qc_to_commit": round(float(rng.random() * 900), 3)}})
    return out


class ScriptedTel:
    """A node's telemetry handle as the monitor sees it: ``snapshot()``
    and ``journal``."""

    def __init__(self, docs, journal):
        self._docs = iter(docs)
        self.journal = journal

    def snapshot(self):
        return next(self._docs)


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _monitor(mod, jmod, tmp_path, monkeypatch, docs, atts):
    d = tmp_path / mod.__name__.split(".")[0]
    d.mkdir()
    journal = _journal(jmod, monkeypatch, "n0", d, FakeClock())
    logger = logging.getLogger(f"scripted.{mod.__name__}")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    lines = Lines()
    logger.handlers = [lines]
    feed = iter(atts)

    def attribution():
        att = next(feed)
        if isinstance(att, Exception):
            raise att
        return att

    mon = mod.HealthMonitor(ScriptedTel(docs, journal), "n0", timeout_s=2.0,
                            campaign_path=str(d / f"n0{mod.CAMPAIGN_SUFFIX}"),
                            logger=logger, attribution_fn=attribution)
    return mon, journal, lines, d


@pytest.mark.parametrize("seed", [SEED, SEED + 11])
def test_scripted_monitors_give_the_same_incidents_lines_records_and_campaigns(tmp_path, monkeypatch, seed):
    n = 200
    docs, atts = _scripted_docs(seed, n), _scripted_attributions(seed, n)
    mj, jj, lj, dj = _monitor(jhealth, jjournal, tmp_path, monkeypatch, docs, atts)
    mp, jp, lp, dp = _monitor(phealth, pjournal, tmp_path, monkeypatch, docs, atts)
    rng = np.random.default_rng(seed)
    now = 100.0
    for _ in range(n):
        now += float(rng.choice([1.0, 1.0, 0.5, 2.5]))
        fired = mp.tick(now)
        assert plain(fired) == plain(mj.tick(now))
        assert plain(mp.open_incidents()) == plain(mj.open_incidents())
        assert mp.last_attribution == mj.last_attribution
    mj.close()
    mp.close()
    jj.close()
    jp.close()
    assert lp.lines == lj.lines
    opened = {json.loads(RE_INCIDENT.search(x)[1])["kind"] for x in lp.lines if RE_INCIDENT.search(x)}
    assert opened >= {"leader_stall", "view_storm", "commit_collapse", "shed_storm", "bandwidth_storm",
                      "crit_regime_shift"}
    jfiles = {f.name: f.read_bytes() for f in sorted(dj.iterdir())}
    pfiles = {f.name: f.read_bytes() for f in sorted(dp.iterdir())}
    assert pfiles == jfiles
    records = [json.loads(x) for name, body in pfiles.items() if name.endswith(".jsonl")
               for x in body.decode().splitlines()]
    health = [(r["e"], r["p"]) for r in records if r["e"].startswith(phealth.HEALTH_EDGE_PREFIX)]
    logged = [(f"health.{d['kind']}", d["phase"]) for d in
              (json.loads(RE_INCIDENT.search(x)[1]) for x in lp.lines if RE_INCIDENT.search(x))]
    assert health == logged and len(health) > 10
    campaign = json.loads(pfiles[f"n0{phealth.CAMPAIGN_SUFFIX}"])
    assert len(campaign["samples"]) > phealth.PERSIST_EVERY


def test_monitor_run_persists_its_campaign_when_cancelled(tmp_path):
    """``run`` on each package: a tick a few ms, then a cancel, whose
    ``finally`` makes the last persist."""

    class Tel:
        journal = None

        def snapshot(self):
            return {"trace": {"commits": 1}}

    async def drive(mod, path):
        mon = mod.HealthMonitor(Tel(), "n0", timeout_s=5.0, interval_s=0.005, campaign_path=str(path))
        task = asyncio.ensure_future(mon.run())
        await asyncio.sleep(0.05)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        return mon

    for mod in (jhealth, phealth):
        path = tmp_path / f"{mod.__name__.split('.')[0]}{mod.CAMPAIGN_SUFFIX}"
        mon = asyncio.run(drive(mod, path))
        saved = mod.CampaignRecorder.load(str(path))
        assert saved["node"] == "n0" and len(saved["samples"]) == len(mon.recorder) >= 1


# ---- end to end: a port committee with --health ----------------------------


def _per_node_logs(text: str, names: list) -> list:
    """The one ``run-many`` log cut into the logs ``run`` would have
    written: a line goes to the node whose id it names, the process's own
    lines to the first node."""
    out = {n: [] for n in names}
    for line in text.splitlines(keepends=True):
        owner = next((n for n in names if n in line), names[0])
        out[owner].append(line)
    return ["".join(lines) for lines in out.values()]


def _short_names(tmp_path, n: int) -> list:
    from hotstuff_tpu_torch.node.config import Secret

    return [str(Secret.read(str(tmp_path / f"key_{i}.json")).name)[:8] for i in range(n)]


def _run_many(tmp_path, keys: int, extra=()):
    keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(keys))
    log = open(tmp_path / "nodes.log", "w")
    try:
        return subprocess.Popen(
            CLI + ["-vv", "run-many", "--verifier", "cpu", "--health", "--keys", keys,
                   "--committee", str(tmp_path / "committee.json"), "--store-prefix",
                   str(tmp_path / "db_"), "--parameters", str(tmp_path / "parameters.json"),
                   "--metrics-port", "0", "--journal-dir", str(tmp_path / "journals"), *extra],
            stdout=log, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": REPO},
        )
    finally:
        log.close()


def _incidents(text: str) -> list:
    return [json.loads(m) for m in RE_INCIDENT.findall(text)]


def _journal_health(jdir) -> dict:
    from benchmark.traces import load_journals

    return {n: [(r["e"], r["p"]) for r in recs if r["e"].startswith("health.")]
            for n, recs in load_journals(str(jdir)).items()}


def _campaigns(jdir) -> dict:
    """node id -> its persisted campaign ring (the id is the file's)."""
    out = {}
    for path in jdir.glob(f"*{phealth.CAMPAIGN_SUFFIX}"):
        doc = phealth.CampaignRecorder.load(str(path))
        out[doc["node"]] = doc
    return out


def test_run_many_health_reads_through_log_parser_and_fleet_watch(tmp_path):
    """4 port nodes with ``--health``: four monitors, a ``health``
    snapshot section a node, the ``+ HEALTH`` block of ``LogParser`` over
    the nodes' logs, ``FleetWatcher`` reading all four from the port's
    ``/delta`` with no STALE row, and after SIGTERM a campaign ring and a
    journal per node whose ``health.*`` records are the logged
    incidents."""
    from benchmark.logs import LogParser
    from benchmark.watch import FleetWatcher, run_watch

    write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
    names = _short_names(tmp_path, 4)
    log_path = tmp_path / "nodes.log"
    nodes = client = None
    try:
        nodes = _run_many(tmp_path, 4)
        assert wait_for(lambda: log_path.read_text().count("successfully booted") == 4, 60)
        port = int(RE_ENDPOINT.search(log_path.read_text())[1])
        client = spawn_client(tmp_path, rate=300, duration=3)
        assert client.wait(timeout=60) == 0
        assert wait_for(lambda: log_path.read_text().count("Telemetry snapshot:") >= 4, 30)
        targets = [{"name": n, "host": "127.0.0.1", "port": port} for n in names]
        frames = []
        watcher = FleetWatcher(targets, sorted(names), timeout_s=1.0)
        view = run_watch(watcher, once=True, out=frames.append)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/snapshot", timeout=10) as r:
            snapshot = json.loads(r.read())
        assert nodes.poll() is None
        nodes.send_signal(signal.SIGTERM)
        assert nodes.wait(timeout=30) == 0
    finally:
        stop_all([client, nodes])
    text = log_path.read_text()
    assert "Traceback" not in text and "health tick failed" not in text
    assert text.count("Health monitor running for node") == 4
    assert set(snapshot) == set(names)
    assert all(isinstance(doc["health"]["open"], list) for doc in snapshot.values())
    parser = LogParser(_per_node_logs(text, names), [(tmp_path / "client.log").read_text()])
    assert parser.health_nodes == 4 and parser.committed_payloads() > 0
    summary = parser.result()
    assert " + HEALTH (anomaly detectors):" in summary and " Nodes monitored: 4" in summary
    assert len(view["nodes"]) == 4 and not any(v["stale"] for v in view["nodes"])
    assert {v["name"] for v in view["nodes"]} == set(names)
    assert all(v["commits"] > 0 for v in view["nodes"])
    assert "STALE" not in frames[0] and all(n in frames[0] for n in names)
    logged = {n: [] for n in names}
    for doc in _incidents(text):
        logged[doc["node"]].append((f"health.{doc['kind']}", doc["phase"]))
    assert _journal_health(tmp_path / "journals") == logged
    campaigns = _campaigns(tmp_path / "journals")
    assert set(campaigns) == set(names)
    assert all(len(doc["samples"]) >= 2 for doc in campaigns.values())


def test_a_committee_below_quorum_opens_leader_stall_on_every_node(tmp_path):
    """2 of a 4-node committee's keys and a 500 ms timeout delay: no QC
    and no TC can form, so each node's monitor opens ``leader_stall``
    once 3 x 500 ms pass without a commit; the journal holds the open
    edge and SIGTERM persists the campaign ring with the incident in its
    last row."""
    write_port_committee(tmp_path, timeout_delay=500, sync_retry_delay=500)
    names = _short_names(tmp_path, 2)
    log_path = tmp_path / "nodes.log"
    nodes = None

    def stalled() -> set:
        return {d["node"] for d in _incidents(log_path.read_text())
                if d["kind"] == "leader_stall" and d["phase"] == "open"}

    try:
        nodes = _run_many(tmp_path, 2)
        assert wait_for(lambda: stalled() == set(names), 60)
        assert nodes.poll() is None
        nodes.send_signal(signal.SIGTERM)
        assert nodes.wait(timeout=30) == 0
    finally:
        stop_all([nodes])
    text = log_path.read_text()
    assert "Traceback" not in text and text.count("Health monitor running for node") == 2
    opens = [d for d in _incidents(text) if d["kind"] == "leader_stall" and d["phase"] == "open"]
    assert all(d["value"] >= 1.5 and d["severity"] == "crit" for d in opens)
    journals = _journal_health(tmp_path / "journals")
    assert all(("health.leader_stall", "open") in journals[n] for n in names)
    campaigns = _campaigns(tmp_path / "journals")
    assert set(campaigns) == set(names)
    assert all(doc["samples"][-1]["incidents"] >= 1 for doc in campaigns.values())
