#!/usr/bin/env python3
"""Record the JAX package's simulator verdicts and explorer results that
phases (p) and (q) of ``chip_smoke.py`` hold the port to, and compare
them with its constants.

    JAX_PLATFORMS=cpu python3 scripts/sim_reference.py
    JAX_PLATFORMS=cpu python3 scripts/sim_reference.py --explorer DIR

Runs ``hotstuff_tpu.sim.run_schedule`` on the CPU over every entry of
``tests/data/sim_seeds.json`` and over seed 1 drawn at 64 nodes (~40 s
for that one), prints (seed, rounds, commits, timeouts, journal digest)
a corpus entry and the 64-node run's ok, rounds, commits, timeouts and
digest.  Then the explorer, every file it writes in a temporary
directory: ``explore_guided`` on a copy of the corpus (its counts,
regimes, promoted entries, the sha256 of each scenario file and of the
appended copy; ~25 s), ``shrink`` of the planted collusion schedule (its
progress messages and minimal events; ~5 s) and the flat sweep
``explore`` (~8 s).  Exits 1 if any differs from
``chip_smoke.SIM_CORPUS_REFERENCE``, ``SIM_64``, ``SIM_GUIDED``,
``SIM_PLANTED``, ``SIM_SHRINK_PROGRESS`` or ``SIM_EXPLORE``.  The JAX
package does not run on the card, so (p) and (q) compare with these
constants.  With ``--explorer DIR`` it runs the explorer part only, its
files under DIR, and writes each result whole to ``DIR/explorer.json``
(``tests/test_torch_explorer.py`` runs it beside the port's searches).
"""

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from hotstuff_tpu.sim import draw_schedule, explore, explore_guided, run_schedule, shrink  # noqa: E402


def explorer_results(out_dir: str) -> dict:
    """The JAX explorer on (q)'s inputs, its files written under
    ``out_dir`` (``corpus.json``, the corpus copy the guided search
    appends to, and ``scenarios/``): a JSON-able record of each result."""
    g, planted, e = chip_smoke.SIM_GUIDED, chip_smoke.SIM_PLANTED, chip_smoke.SIM_EXPLORE
    corpus = os.path.join(out_dir, "corpus.json")
    shutil.copyfile(os.path.join(ROOT, chip_smoke.SIM_CORPUS), corpus)
    said = []
    t0 = time.perf_counter()
    r = explore_guided(g["budget"], nodes=g["nodes"], start_seed=g["start_seed"], corpus_path=corpus,
                       scenarios_dir=os.path.join(out_dir, "scenarios"), progress=said.append)
    guided = {
        "budget": r.budget, "generations": r.generations, "passed": r.passed, "threats": r.threats,
        "best_fitness": r.best_fitness, "regimes": r.regimes,
        "findings": [dataclasses.asdict(f) for f in r.findings], "promoted": r.promoted,
        "scenarios": [os.path.basename(p) for p in r.scenarios], "progress": said,
        "wall_s": time.perf_counter() - t0,
    }
    schedule = draw_schedule(planted["seed"], nodes=planted["nodes"])
    schedule["events"] = schedule["events"] + [dict(planted["event"])]
    said = []
    t0 = time.perf_counter()
    minimal = shrink(schedule, progress=said.append)
    shrunk = {"schedule": schedule, "minimal": minimal, "progress": said, "wall_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    flat = explore(e["seeds"], nodes=e["nodes"], start_seed=e["start_seed"])
    sweep = {"seeds": flat.seeds, "passed": flat.passed, "honest": flat.honest, "byz": flat.byz,
             "threats": flat.threats, "regimes": flat.regimes,
             "findings": [dataclasses.asdict(f) for f in flat.findings], "wall_s": time.perf_counter() - t0}
    return {"guided": guided, "shrink": shrunk, "explore": sweep}


def explorer_reference() -> bool:
    """The JAX explorer's results beside chip_smoke.py's constants."""
    g, planted, e = chip_smoke.SIM_GUIDED, chip_smoke.SIM_PLANTED, chip_smoke.SIM_EXPLORE
    with tempfile.TemporaryDirectory(prefix="sim-reference-") as tmp:
        doc = explorer_results(tmp)
        r = doc["guided"]
        emitted = {name: chip_smoke.sha256_file(os.path.join(tmp, "scenarios", name)) for name in r["scenarios"]}
        corpus_sha = chip_smoke.sha256_file(os.path.join(tmp, "corpus.json"))
    # the emitted files that are committed ones, byte for byte
    scenarios = os.path.join(ROOT, chip_smoke.SIM_SCENARIOS)
    committed = {name: sha for name, sha in emitted.items() if os.path.isfile(os.path.join(scenarios, name))
                 and sha == chip_smoke.sha256_file(os.path.join(scenarios, name))}
    guided = {
        "budget": r["budget"], "nodes": g["nodes"], "start_seed": g["start_seed"],
        "generations": r["generations"], "passed": r["passed"], "threats": r["threats"],
        "best_fitness": r["best_fitness"], "findings": len(r["findings"]), "regimes": r["regimes"],
        "promoted": tuple((p["seed"], p["profile"], p["ok"], tuple(p["threats"]), p["journal_digest"])
                          for p in r["promoted"]),
        "committed": tuple(sorted(committed)),
        "emitted_sha256": {k: v for k, v in emitted.items() if k not in committed},
        "corpus_sha256": corpus_sha,
    }
    print("guided:", guided, f"{r['wall_s']:.1f} s")
    shrunk = doc["shrink"]
    print("shrink:", shrunk["progress"], shrunk["minimal"]["events"], f"{shrunk['wall_s']:.1f} s")
    flat = doc["explore"]
    sweep = {"seeds": flat["seeds"], "nodes": e["nodes"], "start_seed": e["start_seed"], "passed": flat["passed"],
             "honest": flat["honest"], "byz": flat["byz"], "threats": flat["threats"],
             "findings": len(flat["findings"]), "regimes": flat["regimes"]}
    print("explore:", sweep, f"{flat['wall_s']:.1f} s")
    return (guided == {**g, "committed": tuple(sorted(g["committed"]))}
            and tuple(shrunk["progress"]) == chip_smoke.SIM_SHRINK_PROGRESS
            and shrunk["minimal"]["events"] == [planted["event"]] and sweep == e)


def main() -> int:
    if sys.argv[1:2] == ["--explorer"]:
        with open(os.path.join(sys.argv[2], "explorer.json"), "w") as f:
            json.dump(explorer_results(sys.argv[2]), f)
        return 0
    with open(os.path.join(ROOT, chip_smoke.SIM_CORPUS)) as f:
        corpus = json.load(f)
    rows = []
    for entry in corpus["entries"]:
        schedule = entry.get("schedule") or draw_schedule(entry["seed"], nodes=corpus["nodes"])
        v = run_schedule(schedule)
        rows.append((entry["seed"], v.rounds, v.commits, v.timeouts, v.journal_digest))
        print(rows[-1], flush=True)
    t0 = time.perf_counter()
    ref = chip_smoke.SIM_64
    v = run_schedule(draw_schedule(ref["seed"], nodes=ref["nodes"]))
    big = {"seed": ref["seed"], "nodes": ref["nodes"], "ok": v.ok, "rounds": v.rounds,
           "commits": v.commits, "timeouts": v.timeouts, "journal_digest": v.journal_digest}
    print(big, f"{time.perf_counter() - t0:.1f} s")
    same = tuple(rows) == chip_smoke.SIM_CORPUS_REFERENCE and big == ref
    same = explorer_reference() and same
    print("chip_smoke.py's constants match:", same)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
