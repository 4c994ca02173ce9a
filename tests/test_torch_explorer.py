"""The port's simulator explorer (``hotstuff_tpu_torch/sim/explorer.py``)
held against the JAX package's (``hotstuff_tpu/sim/explorer.py``).

The shrinker on the reference's planted safety bug, ``fitness`` over the
regression corpus, the flat sweep, repro bundles, the guided search at
budget 18 (its promotions, the corpus copy it appends to and the
scenario files it writes, three of them the committed
``tests/data/adapt_scenarios/`` files byte for byte), ``promote_to_corpus``
run twice, the package's names, and the explorer's jobs of ``python -m
hotstuff_tpu_torch.sim`` in a subprocess.  Every corpus or scenario path
is a copy under ``tmp_path``; the last test holds the committed files to
their digests from just before the searches and from the module's
import.  Each search runs once a package, at 4 nodes in virtual time, in
a module fixture: the JAX package's in a child process
(``scripts/sim_reference.py --explorer``) while the port's run here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
import hotstuff_tpu.sim as jsim
import hotstuff_tpu.sim.explorer as jexplorer
import hotstuff_tpu_torch.sim as psim
import hotstuff_tpu_torch.sim.explorer as pexplorer

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "data" / "sim_seeds.json"
SCENARIOS = ROOT / "tests" / "data" / "adapt_scenarios"

#: the reference's planted safety bug (``tests/test_simnet.py``)
PLANTED = {"kind": "byz", "policy": "collude", "nodes": [0, 1], "at": 1.0, "until": None}

def _digests() -> dict:
    paths = [CORPUS] + sorted(SCENARIOS.iterdir())
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}


#: the committed files' digests when this module is collected, before
#: any of its tests ran
DATA_BEFORE = _digests()


def _corpus() -> dict:
    with open(CORPUS) as f:
        return json.load(f)


def _planted(pkg) -> dict:
    schedule = pkg.draw_schedule(48, nodes=4)
    assert schedule["profile"] == "honest"
    schedule["events"] = schedule["events"] + [dict(PLANTED)]
    return schedule


def _small_planted(pkg) -> dict:
    """The planted event after one innocent event: three runs shrink it."""
    schedule = _planted(pkg)
    schedule["events"] = schedule["events"][:1] + [dict(PLANTED)]
    return schedule


@pytest.fixture(scope="module")
def searches(tmp_path_factory):
    """The guided search (on a corpus copy), the shrinker on the planted
    schedule and the flat sweep of (q), each package's: ``{"jax": {...},
    "port": {...}}`` in ``scripts/sim_reference.py``'s ``explorer_results``
    shape, with ``dir`` where the corpus copy and ``scenarios/`` lie and
    each progress message's path written ``<tmp>``."""
    jdir, pdir = tmp_path_factory.mktemp("jax-explorer"), tmp_path_factory.mktemp("port-explorer")
    data_before = _digests()
    with open(jdir / "stderr.txt", "w") as err:
        child = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / "sim_reference.py"), "--explorer", str(jdir)],
            cwd=jdir, env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=err, stderr=err,
        )
    try:
        g, e = chip_smoke.SIM_GUIDED, chip_smoke.SIM_EXPLORE
        shutil.copyfile(CORPUS, pdir / "corpus.json")
        said: list[str] = []
        r = psim.explore_guided(
            g["budget"], nodes=g["nodes"], start_seed=g["start_seed"], corpus_path=str(pdir / "corpus.json"),
            scenarios_dir=str(pdir / "scenarios"), progress=said.append,
        )
        guided = {
            "budget": r.budget, "generations": r.generations, "passed": r.passed, "threats": r.threats,
            "best_fitness": r.best_fitness, "regimes": r.regimes,
            "findings": [dataclasses.asdict(f) for f in r.findings], "promoted": r.promoted,
            "scenarios": [os.path.basename(p) for p in r.scenarios], "progress": said,
            "paths": r.scenarios,
        }
        schedule = _planted(psim)
        said = []
        shrunk = {"schedule": schedule, "minimal": psim.shrink(schedule, progress=said.append), "progress": said}
        flat = psim.explore(e["seeds"], nodes=e["nodes"], start_seed=e["start_seed"])
        sweep = {"seeds": flat.seeds, "passed": flat.passed, "honest": flat.honest, "byz": flat.byz,
                 "threats": flat.threats, "regimes": flat.regimes,
                 "findings": [dataclasses.asdict(f) for f in flat.findings]}
        assert child.wait(timeout=300) == 0, (jdir / "stderr.txt").read_text()[-3000:]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    out = {"jax": json.loads((jdir / "explorer.json").read_text()),
           "port": {"guided": guided, "shrink": shrunk, "explore": sweep},
           "data": (data_before, _digests())}
    for name, d in (("jax", jdir), ("port", pdir)):
        out[name]["dir"] = d
        out[name]["guided"]["progress"] = [m.replace(str(d), "<tmp>") for m in out[name]["guided"]["progress"]]
    return out


# ---- the shrinker --------------------------------------------------------


def test_shrink_converges_on_the_planted_event_as_the_reference_does(searches):
    j, p = searches["jax"]["shrink"], searches["port"]["shrink"]
    assert p["schedule"] == j["schedule"] == _planted(jsim) == _planted(psim)
    assert p["minimal"]["events"] == j["minimal"]["events"] == [PLANTED]
    assert p["minimal"] == j["minimal"]
    assert p["progress"] == j["progress"] and len(p["progress"]) == len(p["schedule"]["events"]) - 1
    assert tuple(p["progress"]) == chip_smoke.SIM_SHRINK_PROGRESS
    # the minimal schedule still fails, and passes without the event
    assert not psim.run_schedule(p["minimal"]).ok
    assert psim.run_schedule(dict(p["minimal"], events=[])).ok


# ---- fitness ---------------------------------------------------------------


def _scored_schedules() -> list:
    corpus = _corpus()
    out = [
        pytest.param(e.get("schedule") or jsim.draw_schedule(e["seed"], nodes=corpus["nodes"]),
                     id=f"seed-{e['seed']}-{e['profile']}")
        for e in corpus["entries"]
    ]
    return out + [pytest.param(jsim.draw_schedule(1, nodes=4), id="seed-1-drawn"),
                  pytest.param(_planted(jsim), id="planted")]


@pytest.mark.parametrize("schedule", _scored_schedules())
def test_fitness_and_regime_of_each_run_are_the_references(schedule, tmp_path):
    j = jsim.run_schedule(schedule, workdir=str(tmp_path / "jax"))
    p = psim.run_schedule(schedule, workdir=str(tmp_path / "port"))
    assert (p.threats, p.timeouts, p.safety_ok, p.trusted_ok) == (j.threats, j.timeouts, j.safety_ok, j.trusted_ok)
    assert (p.attribution or {}).get("regime") == (j.attribution or {}).get("regime")
    for baseline in (None, "network-bound", "verify-bound"):
        assert pexplorer.fitness(p, baseline) == jexplorer.fitness(j, baseline), baseline
    # the explorer's digest is the reference's; the verdict's own is the port's
    assert p.normalised_digest == j.journal_digest != p.journal_digest
    assert p.normalised_digest == psim.normalised_journal_digest(str(tmp_path / "port" / "journal.jsonl"))
    assert "normalised_digest" not in p.to_json()
    assert p.to_json().keys() == j.to_json().keys()


def test_fitness_orders_the_threats_as_the_reference_does():
    """Synthetic verdicts over every branch of the score."""
    base = dict(seed=1, profile="adaptive", ok=True, all_ok=True, safety_ok=True, trusted_ok=None,
                commits=4, rounds=2, journal_digest="", block="")
    cases = [
        {},
        {"trusted_ok": False},
        {"safety_ok": False, "threats": ["full-history-divergence"]},
        {"threats": ["liveness-stall"], "timeouts": 7},
        {"attribution": {"regime": "verify-bound"}, "timeouts": 3},
        {"attribution": {"regime": "network-bound"}},
        {"attribution": {}},
    ]
    for case in cases:
        j = jsim.SimVerdict(**{**base, **case})
        p = psim.SimVerdict(**{**base, **case})
        for baseline in (None, "network-bound"):
            assert pexplorer.fitness(p, baseline) == jexplorer.fitness(j, baseline), case


# ---- the flat sweep and repro bundles ---------------------------------------


def test_explore_gives_the_references_counts_and_regimes(searches):
    j, p = searches["jax"]["explore"], searches["port"]["explore"]
    for field in ("seeds", "passed", "honest", "byz", "threats", "regimes", "findings"):
        assert p[field] == j[field], field
    assert p["findings"] == []
    e = chip_smoke.SIM_EXPLORE
    assert {k: p[k] for k in ("seeds", "passed", "honest", "byz", "threats", "regimes")} == {
        k: e[k] for k in ("seeds", "passed", "honest", "byz", "threats", "regimes")}


def test_explore_shrinks_and_bundles_a_failing_seed_as_the_reference_does(tmp_path, monkeypatch):
    """A sweep whose seed draws the planted schedule: one finding, its
    bundle and its minimal schedule as the reference's."""
    results = {}
    for name, pkg, mod in (("jax", jsim, jexplorer), ("port", psim, pexplorer)):
        monkeypatch.setattr(mod, "draw_schedule", lambda seed, nodes=4, duration_s=None, pkg=pkg: _small_planted(pkg))
        said: list[str] = []
        result = pkg.explore(1, nodes=4, start_seed=48, out_dir=str(tmp_path / name), progress=said.append)
        results[name] = (result, said)
    (j, jsaid), (p, psaid) = results["jax"], results["port"]
    assert (p.passed, p.honest, p.byz, p.threats, p.regimes) == (j.passed, j.honest, j.byz, j.threats, j.regimes)
    assert len(p.findings) == len(j.findings) == 1
    pf, jf = dataclasses.asdict(p.findings[0]), dataclasses.asdict(j.findings[0])
    assert pf.pop("repro_dir") == str(tmp_path / "port" / "repro-48")
    assert jf.pop("repro_dir") == str(tmp_path / "jax" / "repro-48")
    assert pf == jf and pf["minimal_events"] == [PLANTED]
    assert [m.replace(str(tmp_path / "port"), "") for m in psaid] == [
        m.replace(str(tmp_path / "jax"), "") for m in jsaid]
    for name in ("schedule.json", "minimal.json", "invariants.txt"):
        assert (tmp_path / "port" / "repro-48" / name).read_bytes() == (
            tmp_path / "jax" / "repro-48" / name).read_bytes(), name


def test_write_repro_bundle_writes_the_references_files(tmp_path):
    schedule = _planted(psim)
    j = jexplorer.write_repro_bundle(schedule, jsim.run_schedule(schedule), str(tmp_path / "jax"))
    p = pexplorer.write_repro_bundle(schedule, psim.run_schedule(schedule), str(tmp_path / "port"))
    jdir, pdir = Path(j), Path(p)
    assert pdir == tmp_path / "port"
    for name in ("schedule.json", "invariants.txt"):
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name
    # the bundle's journal and verdict keep the port's logger names
    assert psim.normalised_journal_digest(str(pdir / "journal.jsonl")) == hashlib.sha256(
        (jdir / "journal.jsonl").read_bytes()).hexdigest()
    jv, pv = (json.loads((d / "verdict.json").read_text()) for d in (jdir, pdir))
    assert pv.keys() == jv.keys()
    assert pv.pop("journal_digest") != jv.pop("journal_digest")
    assert pv == jv


# ---- the guided search -------------------------------------------------------


def test_explore_guided_gives_the_references_result(searches):
    j, p = searches["jax"]["guided"], searches["port"]["guided"]
    for field in ("budget", "generations", "passed", "threats", "best_fitness", "regimes", "findings", "progress"):
        assert p[field] == j[field], field
    g = chip_smoke.SIM_GUIDED
    assert (p["budget"], p["generations"], p["passed"], p["threats"], p["best_fitness"], len(p["findings"]),
            p["regimes"]) == (g["budget"], g["generations"], g["passed"], g["threats"], g["best_fitness"],
                              g["findings"], g["regimes"])


def test_explore_guided_promotes_the_references_entries(searches):
    jp, pp = searches["jax"]["guided"]["promoted"], searches["port"]["guided"]["promoted"]
    assert len(pp) == len(jp) == 4
    for pe, je in zip(pp, jp):
        assert pe == je  # field for field, the journal digest the reference's
    assert tuple((e["seed"], e["profile"], e["ok"], tuple(e["threats"]), e["journal_digest"]) for e in pp) == (
        chip_smoke.SIM_GUIDED["promoted"])


def test_explore_guided_appends_the_references_corpus_bytes(searches):
    port_bytes = (searches["port"]["dir"] / "corpus.json").read_bytes()
    assert port_bytes == (searches["jax"]["dir"] / "corpus.json").read_bytes()
    assert port_bytes != CORPUS.read_bytes()
    assert hashlib.sha256(port_bytes).hexdigest() == chip_smoke.SIM_GUIDED["corpus_sha256"]
    added = json.loads(port_bytes)["entries"][len(_corpus()["entries"]):]
    assert [e["seed"] for e in added] == [5000018]


def test_explore_guided_writes_the_committed_scenario_files(searches):
    j, p = searches["jax"], searches["port"]
    names = p["guided"]["scenarios"]
    assert names == j["guided"]["scenarios"] and len(names) == 4
    pdir, jdir = p["dir"] / "scenarios", j["dir"] / "scenarios"
    assert p["guided"]["paths"] == [str(pdir / name) for name in names]
    for name in names:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name
    committed = chip_smoke.SIM_GUIDED["committed"]
    assert set(committed) < set(names)
    for name in committed:
        assert (pdir / name).read_bytes() == (SCENARIOS / name).read_bytes(), name
    for name, sha in chip_smoke.SIM_GUIDED["emitted_sha256"].items():
        assert hashlib.sha256((pdir / name).read_bytes()).hexdigest() == sha


def test_promote_to_corpus_twice_adds_nothing_the_second_time(searches, tmp_path):
    added = {}
    for name, mod in (("jax", jexplorer), ("port", pexplorer)):
        promoted = searches[name]["guided"]["promoted"]
        corpus = tmp_path / f"{name}.json"
        shutil.copyfile(CORPUS, corpus)
        first = mod.promote_to_corpus(promoted, str(corpus))
        once = corpus.read_bytes()
        second = mod.promote_to_corpus(promoted, str(corpus))
        assert corpus.read_bytes() == once
        added[name] = (first, second, once)
    assert added["port"] == added["jax"]
    assert added["port"][:2] == (1, 0)


def test_emit_scenario_writes_the_references_spec(tmp_path):
    schedule = _planted(psim)
    j = jexplorer.emit_scenario(schedule, jsim.run_schedule(schedule), str(tmp_path / "jax" / "a.json"))
    p = pexplorer.emit_scenario(schedule, psim.run_schedule(schedule), str(tmp_path / "port" / "a.json"))
    assert Path(p).read_bytes() == Path(j).read_bytes()
    assert json.loads(Path(p).read_text())["name"] == "adapt-48"


# ---- the package and its entry point ------------------------------------------


def test_the_package_exports_every_name_of_the_references():
    assert set(jsim.__all__) <= set(psim.__all__)
    assert set(psim.__all__) - set(jsim.__all__) == {"normalised_journal_digest"}
    assert pexplorer.__all__ == jexplorer.__all__
    for name in psim.__all__:
        assert hasattr(psim, name), name
    assert pexplorer.NOTE_PREFIX in _corpus()["entries"][-1]["note"]


def _files(root: Path) -> dict:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
    }


def test_the_entry_points_explorer_jobs_print_one_line_and_write_only_their_files(tmp_path):
    """``guided:``, ``explore:`` and ``shrink:`` in a subprocess: one
    JSON line with the JAX package's results for the same arguments, and
    every file written under ``--workdir`` or into the ``--corpus`` copy:
    the working directory and ``TMPDIR`` stay empty."""
    cwd, tmpdir, workdir = (tmp_path / d for d in ("cwd", "tmpdir", "work"))
    for d in (cwd, tmpdir):
        d.mkdir()
    corpus = tmp_path / "corpus.json"
    shutil.copyfile(CORPUS, corpus)
    schedule = _small_planted(psim)
    small = tmp_path / "small.json"
    small.write_text(json.dumps(schedule))
    before = _files(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "TMPDIR": str(tmpdir)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "hotstuff_tpu_torch.sim", "--workdir", str(workdir), "--corpus", str(corpus),
         "guided:3:4:0", "explore:2:4:5", f"shrink:{small}"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        # the JAX package's results for the same jobs, while the child runs
        jcorpus = tmp_path / "jax-corpus.json"
        shutil.copyfile(CORPUS, jcorpus)
        said: list[str] = []
        jg = jsim.explore_guided(3, nodes=4, start_seed=0, corpus_path=str(jcorpus),
                                 scenarios_dir=str(tmp_path / "jax-scenarios"), progress=said.append)
        jf = jsim.explore(2, nodes=4, start_seed=5)
        jsaid: list[str] = []
        jmin = jsim.shrink(schedule, progress=jsaid.append)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    lines = stdout.strip().splitlines()
    assert len(lines) == 1
    guided_run, flat_run, shrunk = json.loads(lines[0])["runs"]

    assert guided_run["kind"] == "guided"
    assert guided_run["progress"] == [m.replace(str(jcorpus), str(corpus)) for m in said]
    for field in ("budget", "generations", "passed", "threats", "best_fitness", "regimes"):
        assert guided_run[field] == getattr(jg, field), field
    assert guided_run["findings"] == [dataclasses.asdict(f) for f in jg.findings]
    assert guided_run["promoted"] == [
        {k: e[k] for k in ("seed", "profile", "ok", "threats", "journal_digest")} for e in jg.promoted]
    assert guided_run["promoted"]
    assert guided_run["scenarios"] == {
        Path(s).name: hashlib.sha256(Path(s).read_bytes()).hexdigest() for s in jg.scenarios}
    assert corpus.read_bytes() == jcorpus.read_bytes()

    assert flat_run["kind"] == "explore"
    assert (flat_run["seeds"], flat_run["passed"], flat_run["honest"], flat_run["byz"], flat_run["threats"],
            flat_run["regimes"]) == (jf.seeds, jf.passed, jf.honest, jf.byz, jf.threats, jf.regimes)

    assert shrunk["kind"] == "shrink" and shrunk["seed"] == 48 and shrunk["events"] == 2
    assert shrunk["minimal_events"] == jmin["events"] == [PLANTED]
    assert shrunk["progress"] == jsaid
    assert (shrunk["minimal_ok"], shrunk["clean_ok"]) == (False, True)
    for run in (guided_run, flat_run, shrunk):
        assert run["wall_s"] > 0

    # the corpus copy and the job directories are all that changed
    after = _files(tmp_path)
    changed = {k for k in after if before.get(k) != after[k]} - {
        k for k in after if k.startswith(("jax-", "work/"))}
    assert changed == {"corpus.json"}
    assert not list(cwd.iterdir()) and not list(tmpdir.iterdir())
    assert sorted(p.name for p in (workdir / "0" / "scenarios").iterdir()) == sorted(guided_run["scenarios"])


def test_the_committed_corpus_and_scenario_files_are_unchanged(searches):
    """No search wrote under ``tests/data``: the fixture's digests from
    just before and just after both packages' searches are equal, and
    equal to those from this module's import and to those now (after
    every test of the file that ran before this one in this process)."""
    before, after = searches["data"]
    assert before == after == DATA_BEFORE == _digests()
