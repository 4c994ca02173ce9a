"""Replay seeded schedules through the simulator and print the verdicts.

    python -m hotstuff_tpu_torch.sim [--workdir DIR] [--corpus FILE] JOB [JOB ...]

A JOB is a seed (its schedule drawn at 4 nodes, ``draw_schedule``'s
default), ``SEED:NODES``, or a JSON file: a seed corpus (``tests/data/sim_seeds.json``:
every entry, drawn at the corpus's ``nodes`` or replayed from its inline
``schedule``) or one schedule.  The explorer's jobs (``sim/explorer.py``):

- ``guided:BUDGET[:NODES[:START]]``: ``explore_guided``; its promoted
  entries are appended to ``--corpus FILE`` (give it a copy: the search
  edits it) and its scenario files written under the job's directory;
- ``explore:SEEDS[:NODES[:START]]``: the flat sweep ``explore``;
- ``shrink:FILE``: ``shrink`` of the one schedule in FILE, then a run of
  the minimal schedule and one of it with no events.

NODES defaults to 4 and START to 0.  The jobs run one after another in
this process; the output is ONE JSON line, ``{"runs": [...], "wall_s":
t}``.  A replay's run has its verdict, its journal digests (the port's
own and the one normalised to the reference's logger names), a digest of
its flow tables, its wall seconds and, for a corpus entry, what the
corpus expects of it; an explorer job's has its result's counts, its
findings, its promoted entries, the sha256 of each scenario file, its
progress messages and its wall seconds.  Every file a job writes lies
under ``--workdir`` (a temporary directory without it) or is the
``--corpus`` file.  Exit code 0 whatever the verdicts: the caller
judges.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time

from .explorer import explore, explore_guided, shrink
from .runner import run_schedule
from .schedule import draw_schedule

EXPLORER_JOBS = ("guided", "explore", "shrink")


def _jobs(spec: str) -> list[tuple[str, dict, dict]]:
    """(label, schedule, expectations) for one JOB argument; an explorer
    job is (JOB, None, {})."""
    if spec.partition(":")[0] in EXPLORER_JOBS:
        return [(spec, None, {})]
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
        "normalised_digest": verdict.normalised_digest,
        "flows_digest": hashlib.sha256(flows).hexdigest(),
        "wall_s": wall,
        "expect": expect,
    }


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _explorer(job: str, workdir: str, corpus: str | None) -> dict:
    """Run one explorer JOB with its files under ``workdir``: the runs it
    makes without a directory of their own take temporary ones there."""
    scratch = os.path.join(workdir, "tmp")
    os.makedirs(scratch, exist_ok=True)
    saved, tempfile.tempdir = tempfile.tempdir, scratch
    try:
        return _explore_job(job, workdir, corpus)
    finally:
        tempfile.tempdir = saved


def _explore_job(job: str, workdir: str, corpus: str | None) -> dict:
    t0 = time.perf_counter()
    kind, _, rest = job.partition(":")
    said: list[str] = []
    out: dict = {"job": job, "kind": kind}
    if kind == "shrink":
        with open(rest) as f:
            schedule = json.load(f)
        minimal = shrink(schedule, progress=said.append)
        out.update(
            seed=int(schedule["seed"]),
            events=len(schedule["events"]),
            minimal_events=minimal["events"],
            minimal_ok=run_schedule(minimal, os.path.join(workdir, "minimal")).ok,
            clean_ok=run_schedule(
                dict(minimal, events=[]), os.path.join(workdir, "clean")
            ).ok,
        )
    else:
        count, nodes, start = (rest.split(":") + ["4", "0"])[:3]
        if kind == "guided":
            scenarios = os.path.join(workdir, "scenarios")
            r = explore_guided(
                int(count), nodes=int(nodes), start_seed=int(start),
                out_dir=os.path.join(workdir, "repro"), corpus_path=corpus,
                scenarios_dir=scenarios, progress=said.append,
            )
            out.update(
                budget=r.budget,
                generations=r.generations,
                best_fitness=r.best_fitness,
                promoted=[
                    {k: e[k] for k in ("seed", "profile", "ok", "threats", "journal_digest")}
                    for e in r.promoted
                ],
                scenarios={os.path.basename(p): _sha256(p) for p in r.scenarios},
            )
        else:
            r = explore(
                int(count), nodes=int(nodes), start_seed=int(start),
                out_dir=os.path.join(workdir, "repro"), progress=said.append,
            )
            out.update(seeds=r.seeds, honest=r.honest, byz=r.byz)
        out.update(
            nodes=int(nodes),
            start_seed=int(start),
            passed=r.passed,
            threats=r.threats,
            regimes=r.regimes,
            findings=[dataclasses.asdict(f) for f in r.findings],
        )
    out["progress"] = said
    out["wall_s"] = time.perf_counter() - t0
    return out


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
    parser.add_argument(
        "--corpus",
        help="the corpus a guided job appends its promoted entries to",
    )
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    runs = []
    jobs = [job for spec in args.jobs for job in _jobs(spec)]
    with contextlib.ExitStack() as stack:
        base = args.workdir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="hotstuff-sim-")
        )
        for i, (label, schedule, expect) in enumerate(jobs):
            workdir = os.path.join(base, str(i))
            os.makedirs(workdir, exist_ok=True)
            if schedule is None:
                runs.append(_explorer(label, workdir, args.corpus))
            else:
                runs.append(_run(label, schedule, expect, workdir))
    print(json.dumps({"runs": runs, "wall_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
