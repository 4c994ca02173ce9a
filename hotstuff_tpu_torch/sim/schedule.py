"""Seeded schedule drawing + spec conversion.

A copy of ``hotstuff_tpu.sim.schedule``: the same seed draws the same
schedule in both packages.

A **schedule** is the sim's unit of exploration: a JSON-serializable
dict drawn deterministically from a single integer seed, describing
everything that happens to the committee during one virtual-time run —
partitions, lossy/slow links, crash-points with WAL torn-tail bytes,
reconfiguration ops and Byzantine adversary policies.

``schedule_to_spec`` converts a schedule into the SAME spec dialect the
chaos plane already speaks (faults/plane.py + faults/adversary.py), so
one JSON document drives FaultPlane, AdversaryPlane and the invariant
checkers (``sim/invariants.py`` ``check_run``) unchanged.
"""

from __future__ import annotations

import copy
import os
import random

from ..faults.adaptive import ADAPTIVE_POLICIES
from .loop import SIM_EPOCH

#: schedule format version (bump on incompatible changes so committed
#: seed corpora can be detected as stale instead of misread)
SCHEDULE_VERSION = 1

#: profile mix: roughly this fraction of explore seeds draw the
#: byz-collude family (expected full-history FAIL / trusted-subset PASS)
BYZ_FRACTION = 0.15

#: virtual-time layout (seconds).  Events are confined to
#: [EVENT_MIN_AT, EVENT_MAX_END] so every schedule heals with enough
#: virtual runway left for liveness recovery before the run ends.
DEFAULT_DURATION_S = 9.0
EVENT_MIN_AT = 1.5
EVENT_MAX_END = 6.0


def draw_schedule(
    seed: int,
    nodes: int = 4,
    duration_s: float | None = None,
    profile: str | None = None,
) -> dict:
    """Draw one schedule, a pure function of ``seed`` (plus the explicit
    shape arguments).  ``profile`` forces ``"honest"`` /
    ``"byz-collude"``; by default the seed decides."""
    rng = random.Random(f"sim-schedule|{seed}")
    if duration_s is None:
        duration_s = float(
            os.environ.get("HOTSTUFF_SIM_DURATION", DEFAULT_DURATION_S)
        )
    duration = float(duration_s)
    if profile is None:
        profile = "byz-collude" if rng.random() < BYZ_FRACTION else "honest"
    events: list[dict] = []

    def window(max_len: float = 2.5) -> tuple[float, float]:
        at = round(rng.uniform(EVENT_MIN_AT, EVENT_MAX_END - 1.0), 2)
        until = round(min(at + rng.uniform(0.8, max_len), EVENT_MAX_END), 2)
        return at, until

    if profile == "byz-collude":
        # f+1 colluders for the whole run: a REAL divergent history the
        # full-history safety checker must FAIL and the trusted-subset
        # regime must absolve.  Optional link noise rides along (and is
        # what the shrinker learns to drop).
        events.append(
            {
                "kind": "byz",
                "policy": "collude",
                "nodes": [0, 1],
                "at": 1.0,
                "until": None,
            }
        )
        for _ in range(rng.randint(0, 2)):
            at, until = window()
            src, dst = rng.sample(range(nodes), 2)
            events.append(
                {
                    "kind": "delay",
                    "from": [src],
                    "to": [dst],
                    "delay_ms": rng.randint(5, 40),
                    "jitter_pct": 20,
                    "at": at,
                    "until": until,
                }
            )
    elif profile == "adaptive":
        # one state-reactive adversary (faults/adaptive.py) plus the
        # protocol event its trigger preys on.  Windows are BOUNDED —
        # an unbounded liveness-impairing policy would push last_heal
        # to +inf and hide a genuine stall from the liveness check.
        policy = rng.choice(ADAPTIVE_POLICIES)
        attacker = rng.randrange(nodes)
        until = round(rng.uniform(4.5, EVENT_MAX_END), 2)
        events.append(
            {
                "kind": "byz",
                "policy": policy,
                "nodes": [attacker],
                "at": 1.0,
                "until": until,
            }
        )
        if policy == "sync-predator":
            # prey: a crash-recovered peer state-syncing mid-window
            victim = (attacker + 1 + rng.randrange(nodes - 1)) % nodes
            crash_at = round(rng.uniform(EVENT_MIN_AT, 3.0), 2)
            events.append(
                {
                    "kind": "crash",
                    "node": victim,
                    "at": crash_at,
                    "restart_at": round(
                        crash_at + rng.uniform(1.0, 1.8), 2
                    ),
                    "torn_bytes": rng.randint(1, 48),
                }
            )
        elif policy == "reconfig-sniper":
            # prey: an epoch activation inside the snipe margin
            events.append(
                {
                    "kind": "reconfig",
                    "at": round(rng.uniform(EVENT_MIN_AT, 3.5), 2),
                    "sponsor": rng.randrange(nodes),
                    "margin": rng.randint(2, 6),
                }
            )
            duration += 3.0
        elif policy == "ambush-leader":
            # prey: fresh TCs — isolate a peer so view changes seat the
            # ambusher behind one
            at, until2 = window()
            events.append(
                {
                    "kind": "isolate",
                    "node": (attacker + 1) % nodes,
                    "at": at,
                    "until": until2,
                }
            )
        elif policy == "timeout-surfer" and rng.random() < 0.5:
            # surfing alone stretches views; combined with a crashed
            # peer the committee drops to bare quorum and every
            # stretched view risks tipping into a stall
            crash_at = round(rng.uniform(EVENT_MIN_AT, 3.0), 2)
            events.append(
                {
                    "kind": "crash",
                    "node": (attacker + 1) % nodes,
                    "at": crash_at,
                    "restart_at": round(
                        crash_at + rng.uniform(1.2, 2.0), 2
                    ),
                    "torn_bytes": rng.randint(1, 48),
                }
            )
        for _ in range(rng.randint(0, 1)):
            at, until2 = window()
            src, dst = rng.sample(range(nodes), 2)
            events.append(
                {
                    "kind": "delay",
                    "from": [src],
                    "to": [dst],
                    "delay_ms": rng.randint(5, 40),
                    "jitter_pct": 20,
                    "at": at,
                    "until": until2,
                }
            )
    else:
        for _ in range(rng.randint(0, 2)):
            at, until = window()
            members = list(range(nodes))
            rng.shuffle(members)
            cut = rng.randint(1, nodes - 1)
            events.append(
                {
                    "kind": "partition",
                    "groups": [sorted(members[:cut]), sorted(members[cut:])],
                    "at": at,
                    "until": until,
                }
            )
        for _ in range(rng.randint(0, 2)):
            at, until = window()
            src, dst = rng.sample(range(nodes), 2)
            events.append(
                {
                    "kind": "loss",
                    "from": [src],
                    "to": [dst],
                    "drop": round(rng.uniform(0.05, 0.3), 3),
                    "at": at,
                    "until": until,
                }
            )
        for _ in range(rng.randint(0, 2)):
            at, until = window()
            src, dst = rng.sample(range(nodes), 2)
            events.append(
                {
                    "kind": "delay",
                    "from": [src],
                    "to": [dst],
                    "delay_ms": rng.randint(5, 60),
                    "jitter_pct": 20,
                    "at": at,
                    "until": until,
                }
            )
        if rng.random() < 0.5:
            at = round(rng.uniform(EVENT_MIN_AT, EVENT_MAX_END - 2.5), 2)
            events.append(
                {
                    "kind": "crash",
                    "node": rng.randrange(nodes),
                    "at": at,
                    "restart_at": round(at + rng.uniform(1.5, 2.5), 2),
                    "torn_bytes": rng.randint(1, 48),
                }
            )
        if rng.random() < 0.2:
            events.append(
                {
                    "kind": "reconfig",
                    "at": round(rng.uniform(EVENT_MIN_AT, EVENT_MAX_END - 2.0), 2),
                    "sponsor": rng.randrange(nodes),
                    "margin": rng.randint(2, 6),
                }
            )
            # The op can only 2-chain-commit after the last heal, and the
            # epoch boundary then costs a view change before the first
            # epoch-2 commit — give the handoff its own virtual runway.
            duration += 3.0
    return {
        "version": SCHEDULE_VERSION,
        "seed": int(seed),
        "nodes": int(nodes),
        "duration_s": duration,
        "profile": profile,
        "events": events,
    }


def schedule_to_spec(schedule: dict, base_port: int) -> dict:
    """Convert a schedule into the shared chaos/adversary spec dialect.
    ``epoch_unix`` is pinned to :data:`SIM_EPOCH` (= virtual t=0), so
    window arithmetic, liveness heal math and journal timestamps all
    share one origin."""
    nodes = int(schedule["nodes"])
    spec: dict = {
        "name": f"sim-{schedule['seed']}",
        "seed": int(schedule["seed"]),
        "epoch_unix": SIM_EPOCH,
        "nodes": {f"127.0.0.1:{base_port + i}": i for i in range(nodes)},
        "rules": [],
        "adversary": [],
        "crashes": [],
        # generous in virtual seconds: post-heal view-change backoff is
        # capped by the sim's Parameters (see harness), so recovery is
        # quick, but a bound keeps a genuinely wedged run a FAILURE
        "liveness": {"resume_within_s": 20.0, "max_round_gap": 400},
    }
    for i, ev in enumerate(schedule.get("events", ())):
        kind = ev["kind"]
        label = f"{kind}-{i}"
        if kind == "partition":
            spec["rules"].append(
                {
                    "label": label,
                    "partition": ev["groups"],
                    "at": ev["at"],
                    "until": ev["until"],
                }
            )
        elif kind == "isolate":
            spec["rules"].append(
                {
                    "label": label,
                    "isolate": ev["node"],
                    "at": ev["at"],
                    "until": ev["until"],
                }
            )
        elif kind == "loss":
            spec["rules"].append(
                {
                    "label": label,
                    "from": ev["from"],
                    "to": ev["to"],
                    "drop": ev["drop"],
                    "at": ev["at"],
                    "until": ev["until"],
                }
            )
        elif kind == "delay":
            spec["rules"].append(
                {
                    "label": label,
                    "from": ev["from"],
                    "to": ev["to"],
                    "delay_ms": ev["delay_ms"],
                    "jitter_pct": ev.get("jitter_pct", 0),
                    "at": ev["at"],
                    "until": ev["until"],
                }
            )
        elif kind == "crash":
            spec["crashes"].append(
                {
                    "node": ev["node"],
                    "at": ev["at"],
                    "restart_at": ev["restart_at"],
                    "torn_bytes": ev.get("torn_bytes", 0),
                }
            )
        elif kind == "byz":
            spec["adversary"].append(
                {
                    "policy": ev["policy"],
                    "nodes": list(ev.get("nodes", ())) or [ev.get("node", 0)],
                    "at": ev["at"],
                    "until": ev["until"],
                }
            )
        elif kind == "reconfig":
            spec.setdefault("reconfig", []).append(
                {
                    "at": ev["at"],
                    "sponsor": ev["sponsor"],
                    "margin": ev["margin"],
                }
            )
            spec["handoff_gap_rounds"] = 400
        else:
            raise ValueError(f"unknown schedule event kind {kind!r}")
    if spec["adversary"]:
        spec["quorum_mode"] = "trusted-subset"
    else:
        del spec["adversary"]
    if not spec["crashes"]:
        del spec["crashes"]
    return spec


def profile_of_events(events) -> str:
    """Recompute a schedule's profile from its event list (mutation can
    cross profile boundaries): collude anywhere ⇒ the byz-collude
    judgment, any other adversary ⇒ adaptive, else honest."""
    policies = [
        ev.get("policy") for ev in events if ev.get("kind") == "byz"
    ]
    if "collude" in policies:
        return "byz-collude"
    if policies:
        return "adaptive"
    return "honest"


def mutate_schedule(schedule: dict, salt: int) -> dict:
    """One guided-search mutation step: a pure function of
    ``(schedule, salt)``.  The child gets a derived seed (fresh
    adversary/ambient rng streams) and a recomputed profile, and every
    mutated window stays inside the healing envelope so the liveness
    check keeps applying."""
    rng = random.Random(f"sim-mutate|{schedule['seed']}|{salt}")
    child = copy.deepcopy(schedule)
    events: list[dict] = child["events"]
    nodes = int(child["nodes"])

    def window() -> tuple[float, float]:
        at = round(rng.uniform(EVENT_MIN_AT, EVENT_MAX_END - 1.0), 2)
        until = round(
            min(at + rng.uniform(0.8, 2.5), EVENT_MAX_END), 2
        )
        return at, until

    ops = [
        "add-adaptive-byz",
        "add-crash",
        "add-link-noise",
        "perturb-timing",
        "drop-event",
    ]
    op = rng.choice(ops)
    if op == "add-adaptive-byz":
        policy = rng.choice(ADAPTIVE_POLICIES)
        until = round(rng.uniform(4.5, EVENT_MAX_END), 2)
        events.append(
            {
                "kind": "byz",
                "policy": policy,
                "nodes": [rng.randrange(nodes)],
                "at": 1.0,
                "until": until,
            }
        )
        if policy == "reconfig-sniper" and not any(
            ev["kind"] == "reconfig" for ev in events
        ):
            events.append(
                {
                    "kind": "reconfig",
                    "at": round(rng.uniform(EVENT_MIN_AT, 3.5), 2),
                    "sponsor": rng.randrange(nodes),
                    "margin": rng.randint(2, 6),
                }
            )
            child["duration_s"] = float(child["duration_s"]) + 3.0
    elif op == "add-crash":
        crash_at = round(rng.uniform(EVENT_MIN_AT, 3.0), 2)
        events.append(
            {
                "kind": "crash",
                "node": rng.randrange(nodes),
                "at": crash_at,
                "restart_at": round(crash_at + rng.uniform(1.0, 2.0), 2),
                "torn_bytes": rng.randint(1, 48),
            }
        )
    elif op == "add-link-noise":
        at, until = window()
        src, dst = rng.sample(range(nodes), 2)
        if rng.random() < 0.5:
            events.append(
                {
                    "kind": "loss",
                    "from": [src],
                    "to": [dst],
                    "drop": round(rng.uniform(0.05, 0.3), 3),
                    "at": at,
                    "until": until,
                }
            )
        else:
            events.append(
                {
                    "kind": "delay",
                    "from": [src],
                    "to": [dst],
                    "delay_ms": rng.randint(5, 60),
                    "jitter_pct": 20,
                    "at": at,
                    "until": until,
                }
            )
    elif op == "perturb-timing" and events:
        ev = rng.choice(events)
        shift = round(rng.uniform(-0.4, 0.4), 2)
        if "at" in ev:
            ev["at"] = round(
                min(max(0.5, ev["at"] + shift), EVENT_MAX_END - 0.5), 2
            )
        if ev.get("until") is not None:
            ev["until"] = round(
                min(max(ev["at"] + 0.3, ev["until"] + shift), EVENT_MAX_END),
                2,
            )
        if "restart_at" in ev:
            ev["restart_at"] = round(
                max(ev["at"] + 0.5, ev["restart_at"] + shift), 2
            )
    elif op == "drop-event" and events:
        events.pop(rng.randrange(len(events)))

    # derived child seed: fresh ambient/adversary rng streams, and a
    # distinct corpus identity for promotion (deterministic in salt)
    child["seed"] = (int(schedule["seed"]) * 1000003 + int(salt)) % (1 << 31)
    child["profile"] = profile_of_events(events)
    return child


__all__ = [
    "BYZ_FRACTION",
    "DEFAULT_DURATION_S",
    "SCHEDULE_VERSION",
    "draw_schedule",
    "mutate_schedule",
    "profile_of_events",
    "schedule_to_spec",
]
