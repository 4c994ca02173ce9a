#!/usr/bin/env python3
"""Record the JAX package's simulator verdicts that phase (p) of
``chip_smoke.py`` holds the port to, and compare them with its constants.

    JAX_PLATFORMS=cpu python3 scripts/sim_reference.py

Runs ``hotstuff_tpu.sim.run_schedule`` on the CPU over every entry of
``tests/data/sim_seeds.json`` and over seed 1 drawn at 64 nodes (~40 s
for that one), prints (seed, rounds, commits, timeouts, journal digest)
a corpus entry and the 64-node run's ok, rounds, commits, timeouts and
digest, and exits 1 if any differs from ``chip_smoke.SIM_CORPUS_REFERENCE``
or ``chip_smoke.SIM_64``.  The JAX package does not run on the card, so
(p) compares with these constants.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from hotstuff_tpu.sim import draw_schedule, run_schedule  # noqa: E402


def main() -> int:
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
    print("chip_smoke.py's constants match:", same)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
