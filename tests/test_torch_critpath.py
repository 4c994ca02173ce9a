"""The port's commit critical-path engine (``telemetry/critpath.py``)
against the JAX package's, at zero tolerance: both compute floats by
the same stdlib expressions, so every document, string and dataclass
is compared with ``==``.

Inputs: the fixture journals of the JAX ``tests/test_critpath.py``
(honest, skewed clocks, missing vote edges, a missing ``qc.form`` with
the adoption fallback, clock damage, ring drops) merged by
``benchmark.traces``; seeded stage totals and attribution documents for
``classify_regime`` and ``diff``; seeded trace-ring entries for
``rolling_attribution``; and the journals a 4-node port ``run-many``
committee writes, which is the engine's real input."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from benchmark.traces import TraceSet, load_journals
from hotstuff_tpu.telemetry import critpath as jcrit
from hotstuff_tpu_torch.telemetry import critpath as pcrit

from .test_critpath import MS, _committee_journals
from .test_torch_node import REPO, spawn_client, stop_all, wait_for, write_port_committee

SEED = 20_261_017
CLI = [sys.executable, "-m", "hotstuff_tpu_torch.node"]
RE_ENDPOINT = re.compile(r"Telemetry /metrics endpoint listening on port (\d+)")


def test_exports_and_constants_are_the_references():
    assert pcrit.__all__ == jcrit.__all__
    assert pcrit.DIFF_SHARE_PP == jcrit.DIFF_SHARE_PP
    assert pcrit.DIFF_MIN_SHARE == jcrit.DIFF_MIN_SHARE
    assert pcrit.LOCAL_EDGE_REGIME == jcrit.LOCAL_EDGE_REGIME


# ---- fixture journals ------------------------------------------------------


def _no_vote_send():
    return {n: [r for r in recs if r["e"] != "vote.send"] for n, recs in _committee_journals().items()}


def _qc_adoption():
    journals = _committee_journals()
    journals["A"] = [r for r in journals["A"] if r["e"] != "qc.form"]
    for r in range(1, 6):
        d = f"blk{r:02d}0000000000000"[:16]
        tr = 1_000_000 * MS + r * 15 * MS
        journals["A"].append({"e": "qc", "r": r, "d": d, "p": "", "m": tr + 13 * MS + MS // 2,
                              "w": tr + 13 * MS + MS // 2})
    return journals


def _clock_damage():
    journals = _committee_journals()
    for recs in journals.values():
        for r in recs:
            if r["e"] == "commit" and r["r"] == 2:
                r["w"] -= 40 * MS
    return journals


def _seeded_drops():
    """Seeded record loss: every node loses a random tenth of its records."""
    rng = np.random.default_rng(SEED)
    return {n: [r for r in recs if rng.random() >= 0.1] for n, recs in _committee_journals(8).items()}


FIXTURES = {
    "honest": lambda: TraceSet(_committee_journals()),
    "skewed": lambda: TraceSet(_committee_journals(skews={"B": 50 * MS, "C": -20 * MS, "D": 35 * MS})),
    "no_vote_send": lambda: TraceSet(_no_vote_send()),
    "qc_adoption": lambda: TraceSet(_qc_adoption()),
    "clock_damage": lambda: TraceSet(_clock_damage()),
    "ring_drops": lambda: TraceSet(_committee_journals(),
                                   merge_stats={"loaded": 300, "dropped": 100, "overlap": 7}),
    "seeded_loss": lambda: TraceSet(_seeded_drops()),
    "empty": lambda: TraceSet({}),
}


def _same_reports(traces, quorum=None):
    """Both packages' ``analyze`` on one TraceSet: reports, attribution
    documents, rendered blocks and regimes, all equal; returns JAX's."""
    jr = jcrit.analyze(traces, quorum)
    pr = pcrit.analyze(traces, quorum)
    assert dataclasses.asdict(pr) == dataclasses.asdict(jr)
    assert [c.dominant for c in pr.commits] == [c.dominant for c in jr.commits]
    assert pr.attribution() == jr.attribution()
    assert pcrit.render(pr) == jcrit.render(jr)
    assert pcrit.classify_regime(pr.stage_totals) == jcrit.classify_regime(jr.stage_totals) == jr.regime
    return jr


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_analyze_render_and_regime_equal_on_the_fixture_journals(fixture):
    report = _same_reports(FIXTURES[fixture]())
    if fixture != "empty":
        assert report.commits  # the comparison is not vacuous
    _same_reports(FIXTURES[fixture](), quorum=2)


def test_diff_equal_on_the_fixture_documents():
    """``diff`` of every ordered pair of the fixture attribution
    documents, at the default tolerance and at tight ones: the same
    failing-stage strings."""
    docs = {name: jcrit.analyze(make()).attribution() for name, make in FIXTURES.items()}
    fails = 0
    for a in docs.values():
        for b in docs.values():
            for pp, floor in ((pcrit.DIFF_SHARE_PP, pcrit.DIFF_MIN_SHARE), (0.5, 0.0), (5.0, 0.1)):
                want = jcrit.diff(a, b, share_pp=pp, min_share=floor)
                assert pcrit.diff(a, b, share_pp=pp, min_share=floor) == want
                fails += len(want)
    assert fails > 0
    for a, b in (({}, docs["honest"]), (docs["honest"], None), ({"stages": {}}, docs["honest"])):
        assert pcrit.diff(a, b) == jcrit.diff(a, b) == []


def _seeded_doc(rng) -> dict:
    stages = [s for s in pcrit.CRITPATH_STAGES if s != "unattributed"]
    picked = rng.choice(stages, size=int(rng.integers(1, len(stages) + 1)), replace=False)
    shares = rng.dirichlet(np.ones(len(picked)))
    return {"stages": {str(s): {"share": round(float(v), 4)} for s, v in zip(picked, shares)}}


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_diff_and_classify_regime_equal_on_seeded_inputs(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        a, b = _seeded_doc(rng), _seeded_doc(rng)
        pp = float(rng.choice([0.0, 1.0, 10.0, float(rng.random() * 30)]))
        assert pcrit.diff(a, b, share_pp=pp) == jcrit.diff(a, b, share_pp=pp)
        totals = {str(s): float(rng.random() * 50) * int(rng.integers(0, 2))
                  for s in rng.choice(list(pcrit.CRITPATH_STAGES), size=4)}
        assert pcrit.classify_regime(totals) == jcrit.classify_regime(totals)
    assert pcrit.classify_regime({}) == jcrit.classify_regime({}) == "unknown"


# ---- rolling attribution ---------------------------------------------------


def _ring_entries(rng, n: int) -> list:
    """Trace-ring dicts as ``TraceRecorder.mark_committed`` makes them,
    with edges missing at random (a commit seen without its vote or QC
    edge, a record with no commit measurement at all)."""
    out = []
    for i in range(n):
        e = {"round": i, "digest": f"{i:016x}"}
        if rng.random() < 0.9:
            e["propose_to_commit_ms"] = round(float(rng.random() * 2000), 3)
        for edge in ("propose_to_vote", "vote_to_qc", "qc_to_commit"):
            if rng.random() < 0.8:
                e[f"{edge}_ms"] = round(float(rng.random() * 900), 3)
        out.append(e)
    return out


@pytest.mark.parametrize("seed", [SEED, SEED + 5])
def test_rolling_attribution_equal_on_seeded_ring_entries(seed):
    rng = np.random.default_rng(seed)
    seen = 0
    for n in list(range(0, 8)) + [16, 64, 64, 200]:
        entries = _ring_entries(rng, n)
        for window in (entries, entries[-64:], entries[:3]):
            want = jcrit.rolling_attribution(window)
            assert pcrit.rolling_attribution(window) == want
            seen += want is not None
    assert seen > 0
    for edge_case in (None, [], [{"round": 1}] * 6, [{"propose_to_commit_ms": 9.0}] * 6,
                      [{"propose_to_commit_ms": 1.0, "vote_to_qc_ms": 2.0}] * 4):
        assert pcrit.rolling_attribution(edge_case) == jcrit.rolling_attribution(edge_case)


# ---- the real input: a port committee's journals ---------------------------


def test_critpath_equal_on_a_port_committees_journals(tmp_path):
    """A 4-node port ``run-many --journal-dir --metrics-port 0`` fed by
    the client; after SIGTERM its journals, merged by
    ``benchmark.traces``, give the same reports, documents and text
    through both engines, and the nodes' trace rings, scraped from
    ``/trace`` before the stop, the same rolling attribution."""
    write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
    keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
    jdir = tmp_path / "journals"
    log_path = tmp_path / "nodes.log"
    log = open(log_path, "w")
    env = {**os.environ, "PYTHONPATH": REPO}
    nodes = client = None
    try:
        nodes = subprocess.Popen(
            CLI + ["-vv", "run-many", "--verifier", "cpu", "--keys", keys,
                   "--committee", str(tmp_path / "committee.json"), "--store-prefix",
                   str(tmp_path / "db_"), "--parameters", str(tmp_path / "parameters.json"),
                   "--journal-dir", str(jdir), "--metrics-port", "0"],
            stdout=log, stderr=subprocess.STDOUT, env=env,
        )
        assert wait_for(lambda: log_path.read_text().count("successfully booted") == 4, 60)
        client = spawn_client(tmp_path, rate=300, duration=3)
        assert client.wait(timeout=60) == 0
        port = int(RE_ENDPOINT.search(log_path.read_text())[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace", timeout=10) as r:
            rings = json.loads(r.read())
        assert nodes.poll() is None
        nodes.send_signal(signal.SIGTERM)
        assert nodes.wait(timeout=30) == 0
    finally:
        stop_all([client, nodes])
        log.close()
    assert "Traceback" not in log_path.read_text()
    stats: dict = {}
    journals = load_journals(str(jdir), stats)
    assert len(journals) == 4
    report = _same_reports(TraceSet(journals, merge_stats=stats))
    assert len(report.commits) >= 4
    att = report.attribution()
    assert pcrit.diff(att, att) == jcrit.diff(att, att) == []
    # the nodes' own trace rings (``/trace``), whole, cut to fewer than
    # four entries, and with an edge removed from every other entry
    assert set(rings) == set(journals)
    attributed = 0
    for ring in rings.values():
        holed = [{k: v for k, v in e.items() if not (i % 2 and k == "vote_to_qc_ms")}
                 for i, e in enumerate(ring)]
        for entries in (ring, ring[-64:], ring[:3], holed):
            want = jcrit.rolling_attribution(entries)
            assert pcrit.rolling_attribution(entries) == want
            attributed += want is not None
    assert attributed >= 4
    assert json.loads(json.dumps(att)) == att
