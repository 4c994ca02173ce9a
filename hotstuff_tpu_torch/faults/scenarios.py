"""Canned chaos scenarios for a small local committee.

A copy of ``hotstuff_tpu.faults.scenarios``.  The ``byz-*`` and
``reconfig-*`` specs are plain dicts for a runner: the port's
``FaultPlane`` reads only their ``rules``, as the reference's does.

Each builder returns a complete fault-plane spec dict (see
``plane.FaultPlane``) given the committee size and seed; the chaos
runner fills in ``nodes`` (address -> index) and
``epoch_unix`` before writing the spec file nodes load.

Timing convention: scenario t=0 is the shared ``epoch_unix``, which the
runner sets to config time plus a boot margin (the spec file must exist
before the first node boots).  Fault windows open a few seconds after
t=0 so every node commits under clean conditions first, and close well
before the bench ends so liveness recovery is observable.
"""

from __future__ import annotations


def split_brain(nodes: int = 4, seed: int = 0, at: float = 6.0,
                until: float = 14.0) -> dict:
    """Partition the committee into two quorum-less halves (f vs f+1
    loses liveness on both sides for n=4: 2/2).  Safety must hold
    throughout; commits must resume after the heal."""
    half = nodes // 2
    return {
        "name": "split-brain",
        "seed": seed,
        "rules": [
            {
                "label": "split-brain",
                "partition": [list(range(half)), list(range(half, nodes))],
                "at": at,
                "until": until,
            }
        ],
        "liveness": {"resume_within_s": 20.0, "max_round_gap": 200},
    }


def leader_isolation(nodes: int = 4, seed: int = 0, at: float = 6.0,
                     until: float = 13.0) -> dict:
    """Cut node 0 (the round-robin leader every ``nodes`` rounds) off
    from the committee AND from clients (inbound cut).  The rest keep
    committing via timeouts/TCs; node 0 catches up after the heal."""
    return {
        "name": "leader-isolation",
        "seed": seed,
        "rules": [
            {"label": "leader-isolation", "isolate": 0, "at": at,
             "until": until}
        ],
        "liveness": {"resume_within_s": 20.0, "max_round_gap": 200},
    }


def flapping_link(nodes: int = 4, seed: int = 0, at: float = 5.0,
                  until: float = 17.0) -> dict:
    """One link (0<->1) hard-drops for 1.5s out of every 3s.  Quorum is
    never lost (n=4 tolerates one bad link) but the reconnect/backoff
    path is exercised repeatedly."""
    return {
        "name": "flapping-link",
        "seed": seed,
        "rules": [
            {"label": "flap-0-1", "from": [0], "to": [1], "drop": 1.0,
             "at": at, "until": until, "every": 3.0, "for": 1.5},
            {"label": "flap-1-0", "from": [1], "to": [0], "drop": 1.0,
             "at": at, "until": until, "every": 3.0, "for": 1.5},
        ],
        "liveness": {"resume_within_s": 20.0, "max_round_gap": 200},
    }


def rolling_crash_restart(nodes: int = 4, seed: int = 0) -> dict:
    """Kill and respawn one node at a time (f=1 for n=4, so the
    committee keeps committing with 3/4 live).  Process-level: executed
    by the chaos runner, not the in-node plane."""
    return {
        "name": "rolling-crash-restart",
        "seed": seed,
        "rules": [],
        "crashes": [
            {"node": 1, "at": 5.0, "restart_at": 9.0},
            {"node": 2, "at": 11.0, "restart_at": 15.0},
        ],
        "liveness": {"resume_within_s": 25.0, "max_round_gap": 200},
    }


def byz_equivocate(nodes: int = 4, seed: int = 0, at: float = 2.0) -> dict:
    """Node 0 signs a second conflicting block whenever it leads.
    Honest safety rules hold (each node votes once per round), so the
    committee keeps committing the main branch: safety must PASS with
    the equivocations attributed to node 0's authority."""
    return {
        "name": "byz-equivocate",
        "seed": seed,
        "rules": [],
        "adversary": [
            {"policy": "equivocate", "node": 0, "at": at, "until": None}
        ],
        "liveness": {"resume_within_s": 20.0, "max_round_gap": 200},
    }


def byz_forge_qc(nodes: int = 4, seed: int = 0, at: float = 2.0) -> dict:
    """Node 0 broadcasts properly-signed timeouts carrying forged QCs
    (real committee authors, garbage aggregate signatures).  Honest
    verification must reject every one; commits continue."""
    return {
        "name": "byz-forge-qc",
        "seed": seed,
        "rules": [],
        "adversary": [
            {"policy": "forge-qc", "node": 0, "at": at, "until": None}
        ],
        "liveness": {"resume_within_s": 20.0, "max_round_gap": 200},
    }


def byz_withhold(nodes: int = 4, seed: int = 0, at: float = 4.0,
                 until: float = 12.0) -> dict:
    """Node 0 receives proposals but never votes while the window is
    open, forcing rounds led by slow quorums/timeouts.  An impairing
    window: liveness must recover after it closes."""
    return {
        "name": "byz-withhold",
        "seed": seed,
        "rules": [],
        "adversary": [
            {"policy": "withhold", "node": 0, "at": at, "until": until}
        ],
        "liveness": {"resume_within_s": 25.0, "max_round_gap": 200},
    }


def byz_collude(nodes: int = 4, seed: int = 0, at: float = 2.0) -> dict:
    """f+1 colluders (nodes 0 and 1 in a 4-committee — one more than
    the f=1 the quorum math tolerates): both equivocate when leading
    and double-vote the shadow branch, and the designated shadow
    committer reports the shadow chain in its commit log.  The result
    is a REAL divergent history: the safety checker must FAIL with the
    conflicting commits attributed to the colluding authorities.  The
    ``trusted-subset`` quorum mode re-checks the same history under the
    TEE-style f+1 regime, where excluding the untrusted colluders
    restores consistency."""
    return {
        "name": "byz-collude",
        "seed": seed,
        "rules": [],
        "adversary": [
            {"policy": "collude", "nodes": [0, 1], "at": at, "until": None}
        ],
        "quorum_mode": "trusted-subset",
        "liveness": {"resume_within_s": 25.0, "max_round_gap": 200},
    }


def reconfig_rotate(nodes: int = 4, seed: int = 0, at: float = 6.0) -> dict:
    """Live committee rotation (docs/RECONFIG.md): at t=``at`` the
    runner submits a sponsored reconfiguration that adds a freshly
    keyed member (node ``nodes``) and drops node 0.  The op is 2-chain
    committed, every node splices the new epoch at commit+margin, the
    joiner state-syncs the certified schedule in and votes in its first
    active round, and node 0 retires after its grace window.  Commits
    must never stall more than the declared handoff gap across the
    boundary."""
    return {
        "name": "reconfig-rotate",
        "seed": seed,
        "rules": [],
        "reconfig": [
            {"at": at, "join": [nodes], "retire": [0], "sponsor": 1},
        ],
        "handoff_gap_rounds": 64,
        "liveness": {"resume_within_s": 25.0, "max_round_gap": 200},
    }


def reconfig_join_under_partition(
    nodes: int = 4, seed: int = 0, at: float = 6.0
) -> dict:
    """Rotation with the joiner's first seconds spent behind a severed
    link to one serving peer: the certified-schedule fetch must fall
    back to the remaining members (manifest collection is a broadcast,
    not a single-peer trust decision)."""
    return {
        "name": "reconfig-join-under-partition",
        "seed": seed,
        "rules": [
            # the joiner (index ``nodes``) cannot reach node 1 while it
            # bootstraps; nodes 2/3 still serve manifests and chunks
            {"label": "join-cut", "from": [nodes], "to": [1], "drop": 1.0,
             "at": at, "until": at + 12.0},
            {"label": "join-cut-rev", "from": [1], "to": [nodes],
             "drop": 1.0, "at": at, "until": at + 12.0},
        ],
        "reconfig": [
            {"at": at, "join": [nodes], "retire": [0], "sponsor": 1},
        ],
        "handoff_gap_rounds": 96,
        "liveness": {"resume_within_s": 30.0, "max_round_gap": 250},
    }


def reconfig_retire_crash(nodes: int = 4, seed: int = 0,
                          at: float = 6.0) -> dict:
    """Rotation with a SIGKILL+rejoin of a SURVIVING member straddling
    the epoch boundary: node 2 dies right after the op is submitted and
    restarts after the new epoch has activated, so its recovery path
    must replay the persisted schedule links (or re-fetch them via
    state-sync) before it can verify new-epoch certificates."""
    return {
        "name": "reconfig-retire-crash",
        "seed": seed,
        "rules": [],
        "reconfig": [
            {"at": at, "join": [nodes], "retire": [0], "sponsor": 1},
        ],
        "crashes": [
            {"node": 2, "at": at + 2.0, "restart_at": at + 12.0},
        ],
        "handoff_gap_rounds": 96,
        "liveness": {"resume_within_s": 30.0, "max_round_gap": 250},
    }


def byz_reconfig(nodes: int = 4, seed: int = 0, at: float = 2.0) -> dict:
    """Node 0 plays reconfiguration games: when leading it proposes
    forged reconfig ops (attacker-only committees under garbage sponsor
    signatures — honest verification must kill every one at admission
    or block verify), and when a REAL rotation commits it logs a skewed
    activation round.  The runner also drives one genuine rotation so
    the shadow claims conflict with honest epoch agreement: full-history
    checking must FAIL epoch agreement with the skew attributed to node
    0, and the ``trusted-subset`` regime (excluding the adversary) must
    PASS."""
    return {
        "name": "byz-reconfig",
        "seed": seed,
        "rules": [],
        "adversary": [
            {"policy": "reconfig", "node": 0, "at": at, "until": None}
        ],
        "reconfig": [
            {"at": 6.0, "join": [nodes], "retire": [], "sponsor": 1},
        ],
        "quorum_mode": "trusted-subset",
        "handoff_gap_rounds": 96,
        "liveness": {"resume_within_s": 25.0, "max_round_gap": 200},
    }


SCENARIOS = {
    "split-brain": split_brain,
    "leader-isolation": leader_isolation,
    "flapping-link": flapping_link,
    "rolling-crash-restart": rolling_crash_restart,
    "byz-equivocate": byz_equivocate,
    "byz-forge-qc": byz_forge_qc,
    "byz-withhold": byz_withhold,
    "byz-collude": byz_collude,
    "reconfig-rotate": reconfig_rotate,
    "reconfig-join-under-partition": reconfig_join_under_partition,
    "reconfig-retire-crash": reconfig_retire_crash,
    "byz-reconfig": byz_reconfig,
}


def build(name: str, nodes: int = 4, seed: int = 0) -> dict:
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}"
        ) from None
    return builder(nodes=nodes, seed=seed)


def last_heal(spec: dict) -> float:
    """Scenario time after which no fault is ever active again: the max
    of rule ``until`` edges (impairing rules only) and crash restarts.
    Unbounded rules make the scenario never heal (returns +inf)."""
    t = 0.0
    for rule in spec.get("rules", ()):
        impairs = any(
            rule.get(k) for k in ("drop", "delay_ms", "duplicate", "corrupt")
        ) or "partition" in rule or "isolate" in rule
        if not impairs:
            continue
        until = rule.get("until")
        if until is None:
            return float("inf")
        t = max(t, float(until))
    for crash in spec.get("crashes", ()):
        restart = crash.get("restart_at")
        if restart is None:
            return float("inf")
        t = max(t, float(restart))
    for rule in spec.get("adversary", ()):
        # vote withholding — plus the adaptive policies that delay votes
        # (timeout-surfer), starve a bootstrap (sync-predator), or
        # withhold near epoch boundaries (reconfig-sniper) — impairs
        # liveness; equivocation, forged QCs, double votes, and floods
        # are rejected/absorbed while the committee keeps committing
        if rule.get("policy") not in (
            "withhold", "timeout-surfer", "sync-predator", "reconfig-sniper",
        ):
            continue
        until = rule.get("until")
        if until is None:
            return float("inf")
        t = max(t, float(until))
    return t


__all__ = ["SCENARIOS", "build", "last_heal", "split_brain",
           "leader_isolation", "flapping_link", "rolling_crash_restart",
           "byz_equivocate", "byz_forge_qc", "byz_withhold", "byz_collude",
           "reconfig_rotate", "reconfig_join_under_partition",
           "reconfig_retire_crash", "byz_reconfig"]
