"""Seeded schedule exploration + greedy failure shrinking.

A copy of ``hotstuff_tpu.sim.explorer``.  ``explore`` sweeps a seed
range: each seed deterministically draws a schedule (partitions, link
loss/delay, crashes with torn WAL tails, reconfig ops, Byzantine
collusion), runs it in virtual time, and judges it with the full
invariant stack.  A failing seed gets a **repro bundle** — the schedule
JSON, the merged journal and the rendered invariant block, all
reproducible from the printed seed alone — and is then **shrunk**:
events are greedily removed one at a time while the failure persists,
converging to a minimal failing schedule (re-running a candidate costs
well under a second of wall-clock, so shrinking is cheap).

Failure semantics per profile:
- ``honest`` schedules must PASS every invariant; any FAIL is a finding.
- ``byz-collude`` schedules must FAIL full-history safety AND PASS the
  trusted-subset recheck; anything else (no divergence, or divergence
  the trusted subset can't absolve) is a finding.

Every digest the explorer writes into a file meant for the shared
regression corpus or for the chaos bench — a promoted entry's
``journal_digest`` and an emitted scenario's ``_promoted`` block — is
the run's :attr:`~hotstuff_tpu_torch.sim.runner.SimVerdict.normalised_digest`
(the records' ``src`` under the reference's logger names), so the same
search writes the reference's files byte for byte.  A repro bundle's own
``journal.jsonl`` and ``verdict.json`` keep the port's names.
"""

from __future__ import annotations

import dataclasses
import json
import os

from .runner import SimVerdict, run_schedule
from .schedule import draw_schedule, mutate_schedule, schedule_to_spec

#: a promoted corpus entry's note opens with the reference's words, so
#: the entries the two packages append to the shared corpus are equal
NOTE_PREFIX = "guided search (ISSUE 18): "


@dataclasses.dataclass
class Finding:
    seed: int
    profile: str
    failures: list[str]
    repro_dir: str | None
    minimal_events: list[dict]  #: shrunk schedule's surviving events


@dataclasses.dataclass
class ExploreResult:
    seeds: int
    passed: int
    findings: list[Finding]
    honest: int
    byz: int
    #: commit critical-path regime -> number of seeds classified there
    #: (per-seed attribution from the sim journals; seeds whose runs
    #: committed nothing don't contribute)
    regimes: dict = dataclasses.field(default_factory=dict)
    #: schedules whose run raised an invariant threat (full-history
    #: divergence or a liveness stall) — the guided-vs-flat comparison
    #: metric (the reference's scripts/adapt_check.py)
    threats: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings


def shrink(
    schedule: dict,
    is_failing=None,
    progress=None,
) -> dict:
    """Greedily minimize a failing schedule: repeatedly try dropping one
    event; keep any drop under which the run still fails.  Loops until a
    full pass removes nothing (a local minimum — every remaining event
    is necessary for THIS failure)."""
    if is_failing is None:
        is_failing = lambda sched: not run_schedule(sched).ok  # noqa: E731
    current = dict(schedule)
    changed = True
    while changed and current["events"]:
        changed = False
        for i in range(len(current["events"])):
            candidate = dict(current)
            candidate["events"] = (
                current["events"][:i] + current["events"][i + 1 :]
            )
            if is_failing(candidate):
                if progress:
                    progress(
                        f"  shrink: dropped {current['events'][i]['kind']} "
                        f"event, {len(candidate['events'])} remain"
                    )
                current = candidate
                changed = True
                break
    return current


def write_repro_bundle(
    schedule: dict, verdict: SimVerdict, out_dir: str
) -> str:
    """Materialize seed + schedule JSON + merged journal + verdict in
    ``out_dir`` by re-running the schedule there (deterministic, so the
    re-run IS the original run)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "schedule.json"), "w") as f:
        json.dump(schedule, f, indent=2)
    rerun = run_schedule(schedule, workdir=out_dir)  # writes journal.jsonl
    with open(os.path.join(out_dir, "verdict.json"), "w") as f:
        json.dump(rerun.to_json(), f, indent=2)
    with open(os.path.join(out_dir, "invariants.txt"), "w") as f:
        f.write(rerun.block + "\n")
    return out_dir


def explore(
    seeds: int,
    nodes: int = 4,
    start_seed: int = 0,
    duration_s: float | None = None,
    out_dir: str | None = None,
    do_shrink: bool = True,
    progress=None,
) -> ExploreResult:
    """Run ``seeds`` consecutive seeds starting at ``start_seed``; see
    module docstring for the failure semantics."""
    say = progress or (lambda _msg: None)
    findings: list[Finding] = []
    regimes: dict = {}
    passed = honest = byz = threats = 0
    for k in range(seeds):
        seed = start_seed + k
        schedule = draw_schedule(seed, nodes=nodes, duration_s=duration_s)
        if schedule["profile"] == "byz-collude":
            byz += 1
        else:
            honest += 1
        verdict = run_schedule(schedule)
        if verdict.threats:
            threats += 1
        if verdict.attribution is not None:
            regime = verdict.attribution.get("regime", "unknown")
            regimes[regime] = regimes.get(regime, 0) + 1
        if verdict.ok:
            passed += 1
            if (k + 1) % 25 == 0:
                say(f"  {k + 1}/{seeds} seeds, {len(findings)} findings")
            continue
        say(
            f"  FAIL seed {seed} ({schedule['profile']}): "
            + "; ".join(verdict.failures)
        )
        repro = None
        if out_dir is not None:
            repro = write_repro_bundle(
                schedule,
                verdict,
                os.path.join(out_dir, f"repro-{seed}"),
            )
            say(f"  repro bundle: {repro}")
        minimal = schedule
        if do_shrink and schedule["events"]:
            minimal = shrink(schedule, progress=say)
            say(
                f"  minimal failing schedule: "
                f"{len(minimal['events'])}/{len(schedule['events'])} events "
                f"({', '.join(e['kind'] for e in minimal['events'])})"
            )
            if repro is not None:
                with open(os.path.join(repro, "minimal.json"), "w") as f:
                    json.dump(minimal, f, indent=2)
        findings.append(
            Finding(
                seed=seed,
                profile=schedule["profile"],
                failures=list(verdict.failures),
                repro_dir=repro,
                minimal_events=list(minimal["events"]),
            )
        )
    return ExploreResult(
        seeds=seeds,
        passed=passed,
        findings=findings,
        honest=honest,
        byz=byz,
        regimes=regimes,
        threats=threats,
    )


# ---------------------------------------------------------------------------
# guided search: fitness-driven mutation instead of a flat sweep


def fitness(verdict: SimVerdict, baseline_regime: str | None = None) -> int:
    """Score one run for the guided search.  Ordered by how close the
    schedule got to breaking an invariant: an uncontained attack
    (trusted-subset FAIL) dominates everything, then full-history
    divergence, then a liveness stall, then a critpath regime shift,
    then raw timeout pressure as the gradient signal that lets the
    search climb toward stalls it hasn't reached yet."""
    score = 0
    if verdict.trusted_ok is False:
        score += 5000
    if not verdict.safety_ok:
        score += 1000
    if "liveness-stall" in verdict.threats:
        score += 200
    if baseline_regime is not None and verdict.attribution is not None:
        regime = verdict.attribution.get("regime")
        if regime and regime != baseline_regime:
            score += 25
    score += 2 * verdict.timeouts
    return score


@dataclasses.dataclass
class GuidedResult:
    """Outcome of one guided search (``explore_guided``)."""

    budget: int  #: schedules evaluated by the SEARCH (== flat's seeds)
    generations: int
    passed: int
    threats: int  #: schedules whose run raised an invariant threat
    best_fitness: int
    findings: list[Finding]
    #: corpus entries appended to tests/data/sim_seeds.json (inline
    #: schedule + expected verdict + normalised journal digest)
    promoted: list[dict] = dataclasses.field(default_factory=list)
    #: canned scenario spec files emitted for the real-cluster
    #: chaos/byz matrix (``python -m benchmark chaos --spec <file>``)
    scenarios: list[str] = dataclasses.field(default_factory=list)
    regimes: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings


def _schedule_key(schedule: dict) -> str:
    return json.dumps(
        {k: schedule[k] for k in ("nodes", "duration_s", "events")},
        sort_keys=True,
    )


def promote_to_corpus(entries: list[dict], corpus_path: str) -> int:
    """Append promoted schedules to the regression corpus, deduplicating
    on journal digest (the run identity).  Returns how many were new."""
    with open(corpus_path) as f:
        corpus = json.load(f)
    seen = {
        e.get("journal_digest")
        for e in corpus["entries"]
        if e.get("journal_digest")
    }
    added = 0
    for entry in entries:
        if entry.get("journal_digest") in seen:
            continue
        corpus["entries"].append(entry)
        seen.add(entry.get("journal_digest"))
        added += 1
    if added:
        with open(corpus_path, "w") as f:
            json.dump(corpus, f, indent=2)
            f.write("\n")
    return added


def emit_scenario(schedule: dict, verdict: SimVerdict, out_path: str) -> str:
    """Write a promoted schedule as a canned chaos/byz scenario spec —
    the exact dialect ``python -m benchmark chaos --spec`` consumes (the
    chaos bench re-stamps ``nodes``/``epoch_unix`` at boot, so the sim
    values are placeholders)."""
    from .harness import SIM_BASE_PORT

    spec = schedule_to_spec(schedule, SIM_BASE_PORT)
    spec["name"] = f"adapt-{schedule['seed']}"
    spec["_promoted"] = {
        "profile": schedule.get("profile", "honest"),
        "threats": list(verdict.threats),
        "sim_ok": verdict.ok,
        "journal_digest": verdict.normalised_digest,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(spec, f, indent=2)
        f.write("\n")
    return out_path


def explore_guided(
    budget: int,
    nodes: int = 4,
    start_seed: int = 0,
    duration_s: float | None = None,
    out_dir: str | None = None,
    do_shrink: bool = True,
    corpus_path: str | None = None,
    scenarios_dir: str | None = None,
    max_promote: int = 4,
    progress=None,
) -> GuidedResult:
    """Fitness-guided schedule search at the SAME run budget as a flat
    ``explore(seeds=budget)`` sweep.

    Generation 0 draws ~budget/3 schedules (two thirds forced to the
    adaptive profile, the rest seed-decided like the flat sweep); every
    later generation mutates the fittest survivors
    (:func:`~hotstuff_tpu_torch.sim.schedule.mutate_schedule`) until the
    budget is spent.  Failing schedules become findings (shrunk, repro
    bundle); the fittest invariant-threatening schedules are shrunk
    with a threat-preserving predicate and **promoted**: appended to
    the regression corpus with their inline schedule + journal digest,
    and emitted as canned chaos scenario specs.
    """
    say = progress or (lambda _msg: None)
    findings: list[Finding] = []
    regimes: dict = {}
    evaluated: list[tuple[int, dict, SimVerdict]] = []
    seen: set[str] = set()
    passed = threats = spent = 0
    baseline_regime: str | None = None
    gen = 0
    gen_size = max(2, min(budget, budget // 3 or budget))

    def evaluate(schedule: dict) -> SimVerdict:
        nonlocal passed, threats, spent
        verdict = run_schedule(schedule)
        spent += 1
        seen.add(_schedule_key(schedule))
        if verdict.ok:
            passed += 1
        if verdict.threats:
            threats += 1
            say(
                f"  THREAT seed {schedule['seed']} "
                f"({schedule['profile']}): {','.join(verdict.threats)} "
                f"fitness {fitness(verdict, baseline_regime)}"
            )
        if verdict.attribution is not None:
            regime = verdict.attribution.get("regime", "unknown")
            regimes[regime] = regimes.get(regime, 0) + 1
        evaluated.append(
            (fitness(verdict, baseline_regime), schedule, verdict)
        )
        return verdict

    # generation 0: a seeded nursery biased toward adaptive adversaries
    for k in range(min(gen_size, budget)):
        profile = "adaptive" if k % 3 != 2 else None
        schedule = draw_schedule(
            start_seed + k, nodes=nodes, duration_s=duration_s,
            profile=profile,
        )
        evaluate(schedule)
    # modal critpath regime of the nursery = the "normal" regime;
    # mutants that shift it score fitness
    if regimes:
        baseline_regime = max(regimes.items(), key=lambda kv: kv[1])[0]

    # later generations: mutate the fittest survivors
    salt = 0
    while spent < budget:
        gen += 1
        size = min(gen_size, budget - spent)
        parents = sorted(evaluated, key=lambda e: -e[0])[: max(2, size // 3)]
        say(
            f"  gen {gen}: {size} mutants from {len(parents)} parents "
            f"(best fitness {parents[0][0]})"
        )
        for i in range(size):
            parent = parents[i % len(parents)][1]
            child = None
            for _ in range(16):  # skip children identical to a past run
                salt += 1
                candidate = mutate_schedule(parent, salt)
                if _schedule_key(candidate) not in seen:
                    child = candidate
                    break
            evaluate(child if child is not None else candidate)

    # findings: schedules that FAILED their profile expectation
    for _fit, schedule, verdict in sorted(evaluated, key=lambda e: -e[0]):
        if verdict.ok:
            continue
        say(
            f"  FAIL seed {schedule['seed']} ({schedule['profile']}): "
            + "; ".join(verdict.failures)
        )
        repro = None
        if out_dir is not None:
            repro = write_repro_bundle(
                schedule, verdict,
                os.path.join(out_dir, f"repro-{schedule['seed']}"),
            )
            say(f"  repro bundle: {repro}")
        minimal = schedule
        if do_shrink and schedule["events"]:
            minimal = shrink(schedule, progress=say)
            if repro is not None:
                with open(os.path.join(repro, "minimal.json"), "w") as f:
                    json.dump(minimal, f, indent=2)
        findings.append(
            Finding(
                seed=schedule["seed"],
                profile=schedule["profile"],
                failures=list(verdict.failures),
                repro_dir=repro,
                minimal_events=list(minimal["events"]),
            )
        )

    # promotion: the fittest threatening schedules (failures first —
    # sort order above — then contained attacks), shrunk with a
    # threat-preserving predicate, re-run for their final expectations
    promoted: list[dict] = []
    scenarios: list[str] = []
    # class diversity: a fitness sort alone would fill every slot with
    # copies of the single highest-scoring attack family; cap each
    # (profile, threat-set) class so a lower-scoring but DIFFERENT
    # counterexample (e.g. an adaptive liveness stall next to collude
    # divergences) still earns a corpus slot
    per_class = max(1, max_promote // 2)
    classes: dict[tuple, int] = {}
    for _fit, schedule, verdict in sorted(evaluated, key=lambda e: -e[0]):
        if len(promoted) >= max_promote:
            break
        if not verdict.threats:
            continue
        cls = (schedule.get("profile"), tuple(sorted(verdict.threats)))
        if classes.get(cls, 0) >= per_class:
            continue
        classes[cls] = classes.get(cls, 0) + 1
        minimal = schedule
        if do_shrink and schedule["events"]:
            want = set(verdict.threats)
            minimal = shrink(
                schedule,
                is_failing=lambda s, w=want: (
                    set(run_schedule(s).threats) >= w
                ),
                progress=say,
            )
        final = run_schedule(minimal)
        entry = {
            "seed": int(minimal["seed"]),
            "profile": minimal.get("profile", "honest"),
            "ok": bool(final.ok),
            "note": (
                NOTE_PREFIX
                + ",".join(
                    ev.get("policy", ev["kind"])
                    for ev in minimal["events"]
                    if ev["kind"] in ("byz", "crash", "reconfig")
                )
                + " -> " + ",".join(final.threats)
            ),
            "threats": list(final.threats),
            "journal_digest": final.normalised_digest,
            "schedule": minimal,
        }
        promoted.append(entry)
        say(
            f"  PROMOTE seed {minimal['seed']} "
            f"({entry['profile']}, ok={entry['ok']}): {entry['note']}"
        )
        if scenarios_dir is not None:
            scenarios.append(
                emit_scenario(
                    minimal, final,
                    os.path.join(
                        scenarios_dir, f"adapt-{minimal['seed']}.json"
                    ),
                )
            )
    if corpus_path is not None and promoted:
        added = promote_to_corpus(promoted, corpus_path)
        say(f"  corpus: {added} new entries -> {corpus_path}")

    return GuidedResult(
        budget=spent,
        generations=gen,
        passed=passed,
        threats=threats,
        best_fitness=max((f for f, _s, _v in evaluated), default=0),
        findings=findings,
        promoted=promoted,
        scenarios=scenarios,
        regimes=regimes,
    )


__all__ = [
    "ExploreResult",
    "Finding",
    "GuidedResult",
    "emit_scenario",
    "explore",
    "explore_guided",
    "fitness",
    "promote_to_corpus",
    "shrink",
    "write_repro_bundle",
]
