"""Replay seeded schedules through the simulator and print the verdicts.

    python -m hotstuff_tpu_torch.sim [--workdir DIR] JOB [JOB ...]

A JOB is a seed (its schedule drawn at 4 nodes, ``draw_schedule``'s
default), ``SEED:NODES``, or a JSON file: a seed corpus (``tests/data/sim_seeds.json``:
every entry, drawn at the corpus's ``nodes`` or replayed from its inline
``schedule``) or one schedule.  The jobs run one after another in this
process; the output is ONE JSON line, ``{"runs": [...], "wall_s": t}``,
a run each with its verdict, its journal digests (the port's own and the
one normalised to the reference's logger names), a digest of its flow
tables, its wall seconds and, for a corpus entry, what the corpus
expects of it.  Exit code 0 whatever the verdicts: the caller judges.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

from .runner import normalised_journal_digest, run_schedule
from .schedule import draw_schedule


def _jobs(spec: str) -> list[tuple[str, dict, dict]]:
    """(label, schedule, expectations) for one JOB argument."""
    if os.path.isfile(spec):
        with open(spec) as f:
            doc = json.load(f)
        if "entries" not in doc:
            return [(spec, doc, {})]
        out = []
        for i, entry in enumerate(doc["entries"]):
            schedule = entry.get("schedule") or draw_schedule(
                entry["seed"], nodes=int(doc["nodes"])
            )
            expect = {"ok": entry["ok"], "profile": entry["profile"]}
            if "schedule" in entry:
                expect["threats"] = list(entry.get("threats", []))
                expect["journal_digest"] = entry["journal_digest"]
            out.append((f"{spec}[{i}]", schedule, expect))
        return out
    seed, _, nodes = spec.partition(":")
    schedule = draw_schedule(int(seed), nodes=int(nodes)) if nodes else draw_schedule(int(seed))
    return [(spec, schedule, {})]


def _run(label: str, schedule: dict, expect: dict, workdir: str) -> dict:
    t0 = time.perf_counter()
    verdict = run_schedule(schedule, workdir)
    wall = time.perf_counter() - t0
    flows = json.dumps(verdict.flows, sort_keys=True).encode()
    return {
        "job": label,
        "seed": verdict.seed,
        "nodes": int(schedule["nodes"]),
        "profile": verdict.profile,
        "ok": verdict.ok,
        "all_ok": verdict.all_ok,
        "safety_ok": verdict.safety_ok,
        "trusted_ok": verdict.trusted_ok,
        "threats": verdict.threats,
        "rounds": verdict.rounds,
        "commits": verdict.commits,
        "timeouts": verdict.timeouts,
        "failures": verdict.failures,
        "journal_digest": verdict.journal_digest,
        "normalised_digest": normalised_journal_digest(
            os.path.join(workdir, "journal.jsonl")
        ),
        "flows_digest": hashlib.sha256(flows).hexdigest(),
        "wall_s": wall,
        "expect": expect,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hotstuff_tpu_torch.sim",
        description="Replay seeded schedules in virtual time.",
    )
    parser.add_argument("jobs", nargs="+", metavar="JOB")
    parser.add_argument(
        "--workdir",
        help="keep each run's stores, logs and journal under DIR/<n>",
    )
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    runs = []
    jobs = [job for spec in args.jobs for job in _jobs(spec)]
    with tempfile.TemporaryDirectory(prefix="hotstuff-sim-") as tmp:
        base = args.workdir or tmp
        for i, (label, schedule, expect) in enumerate(jobs):
            workdir = os.path.join(base, str(i))
            os.makedirs(workdir, exist_ok=True)
            runs.append(_run(label, schedule, expect, workdir))
    print(json.dumps({"runs": runs, "wall_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
