"""Committee-wide safety/liveness invariants: the simulator's judge.

A copy of the reference harness's ``benchmark/invariants.py`` with the
patterns of ``benchmark/logs.py`` it reads (``RE_COMMITTED``,
``RE_STATE_ROOT``, ``RE_EPOCH``, ``_ts``), so the port judges a sim run
without the harness, which imports the JAX package.

The checkers are PURE functions over per-node commit observations;
``commits_from_logs`` is the adapter that extracts the observations
from a run's node logs (the benchmark log dialect the sim runner
renders), and ``chaos_block`` renders the verdict as the ``+ CHAOS``
SUMMARY section.

Safety (must hold under ANY fault schedule):
  - no two nodes commit different blocks at the same round;
  - no single node commits two different blocks at the same round
    (restarted nodes may legitimately RE-commit the same block after a
    crash — only a *different* digest at a seen round is a violation).
  Together with per-lifetime in-order commitment these imply the
  committed chains are prefixes of one another.

Liveness (must hold once the scenario heals):
  - some node commits a NEW round (beyond the pre-heal maximum) within
    ``resume_within_s`` of the last heal edge;
  - the first new round is within ``max_round_gap`` of the pre-heal
    maximum (bounds rounds burned to view-change storms during the
    outage).
"""

from __future__ import annotations

import glob
import math
import os
import re
from datetime import datetime

from ..faults.scenarios import last_heal

_TS = r"(\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{3})Z"
RE_COMMITTED = re.compile(_TS + r".*Committed block (\d+) -> (\S+)")
# replicated-execution state root per applied commit (core contract:
# ``State root <version> -> <root> (round <round>)``)
RE_STATE_ROOT = re.compile(
    _TS + r".*State root (\d+) -> (\S+) \(round (\d+)\)"
)
# live-reconfiguration boundary crossing (core contract:
# ``Epoch <epoch> activated at round <round>``)
RE_EPOCH = re.compile(_TS + r".*Epoch (\d+) activated at round (\d+)")


def _ts(s: str) -> float:
    return datetime.strptime(s, "%Y-%m-%dT%H:%M:%S.%f").timestamp()


# commit observation: (wall-clock seconds, round, block digest)
Commit = tuple[float, int, str]

# state-root observation: (state version, root digest, round)
StateRoot = tuple[int, str, int]

# Adversary-plane activity lines (core/proposer/adversary log contract,
# mirroring the RE_COMMITTED approach: the node's log IS its history).
RE_BYZ_ATTACK = re.compile(
    r"byz (equivocate|forge-qc|withhold|double-vote|flood|shadow-commit"
    r"|reconfig-forge|reconfig-shadow"
    r"|adapt-ambush|adapt-sync|adapt-surf|adapt-snipe"
    r"|sync-withhold|vote-delay)"
)
# Credit-capped flood admission accounting (faults/adversary.py
# ``ingest_flood``): the victim's typed ACK stream, summed per node.
RE_FLOOD_ADMISSION = re.compile(
    r"byz flood admission: accepted (\d+) shed (\d+)"
)
# Honest-side defense lines: rejected certificates / evicted signatures
# (core._handle_timeout, aggregator.QCMaker) and equivocation evidence
# (a second paid digest cell — aggregator._admit_cell).
RE_QC_REJECT = re.compile(
    r"qc reject: invalid certificate|Evicting invalid vote signature"
)
RE_VOTE_CONFLICT = re.compile(r"second digest cell paid by")


def commits_from_logs(logs_dir: str) -> dict[str, list[Commit]]:
    """Per-node committed-block observations from a logs directory.
    A restarted node's log holds both lifetimes (the runner appends)."""
    out: dict[str, list[Commit]] = {}
    for path in sorted(glob.glob(os.path.join(logs_dir, "node-*.log"))):
        name = os.path.basename(path)[: -len(".log")]
        with open(path) as f:
            content = f.read()
        out[name] = [
            (_ts(ts), int(rnd), digest)
            for ts, rnd, digest in RE_COMMITTED.findall(content)
        ]
    return out


def state_roots_from_logs(logs_dir: str) -> dict[str, list[StateRoot]]:
    """Per-node replicated-execution state roots from a logs directory:
    one (version, root, round) observation per applied commit.  A
    snapshot-rejoined node's sequence legitimately skips the versions it
    slept through — agreement is checked per VERSION, not per index."""
    out: dict[str, list[StateRoot]] = {}
    for path in sorted(glob.glob(os.path.join(logs_dir, "node-*.log"))):
        name = os.path.basename(path)[: -len(".log")]
        with open(path) as f:
            content = f.read()
        out[name] = [
            (int(version), root, int(rnd))
            for _ts_, version, root, rnd in RE_STATE_ROOT.findall(content)
        ]
    return out


def check_state_root_agreement(
    roots_by_node: dict[str, list[StateRoot]],
) -> tuple[bool | None, list[str], dict]:
    """Every node that reports a state root at a given version must
    report the SAME root — the replicated execution layer is
    deterministic, so divergence means a node executed (or *reported*,
    under byz shadow-committers) a different history.  A node may
    re-report a version across restarts, but only with the same root.
    Returns (ok, violations, details); ok is ``None`` when no node
    logged any state root (execution layer absent from the run)."""
    violations: list[str] = []
    chosen: dict[int, tuple[str, str]] = {}  # version -> (root, first node)
    observed = 0
    for node in sorted(roots_by_node):
        seen_here: dict[int, str] = {}
        for version, root, _rnd in roots_by_node[node]:
            observed += 1
            prev = seen_here.get(version)
            if prev is not None and prev != root:
                violations.append(
                    f"{node} reported two state roots at version "
                    f"{version}: {prev} vs {root}"
                )
            seen_here[version] = root
            got = chosen.get(version)
            if got is None:
                chosen[version] = (root, node)
            elif got[0] != root:
                violations.append(
                    f"state-root divergence at version {version}: "
                    f"{got[1]} -> {got[0]}, {node} -> {root}"
                )
    details = {
        "versions_compared": len(chosen),
        "max_version": max(chosen) if chosen else 0,
        "nodes_reporting": sum(1 for r in roots_by_node.values() if r),
    }
    if not observed:
        return None, [], details
    return (not violations), violations, details


def epochs_from_logs(logs_dir: str) -> dict[str, list[tuple[int, int]]]:
    """Per-node epoch-activation observations from a logs directory:
    one ``(epoch, activation_round)`` per logged boundary crossing.
    Nodes that boot (or state-sync) straight into an epoch never log a
    crossing for it — agreement is checked over the nodes that DID."""
    out: dict[str, list[tuple[int, int]]] = {}
    for path in sorted(glob.glob(os.path.join(logs_dir, "node-*.log"))):
        name = os.path.basename(path)[: -len(".log")]
        with open(path) as f:
            content = f.read()
        out[name] = [
            (int(epoch), int(rnd))
            for _ts_, epoch, rnd in RE_EPOCH.findall(content)
        ]
    return out


def check_epoch_agreement(
    epochs_by_node: dict[str, list[tuple[int, int]]],
) -> tuple[bool | None, list[str], dict]:
    """Every node that activates a given epoch must activate it at the
    SAME round — the activation point is ``commit_round + margin`` of a
    2-chain-committed reconfiguration, so divergence means a node
    applied (or *reported*, under byz reconfig-shadow) a different epoch
    history.  Re-activating the same epoch across restarts is fine, but
    only at the same round.  Returns (ok, violations, details); ok is
    ``None`` when no node logged any activation (static-committee run).
    """
    violations: list[str] = []
    chosen: dict[int, tuple[int, str]] = {}  # epoch -> (round, first node)
    observed = 0
    for node in sorted(epochs_by_node):
        seen_here: dict[int, int] = {}
        for epoch, rnd in epochs_by_node[node]:
            observed += 1
            prev = seen_here.get(epoch)
            if prev is not None and prev != rnd:
                violations.append(
                    f"{node} activated epoch {epoch} at two rounds: "
                    f"{prev} vs {rnd}"
                )
            seen_here[epoch] = rnd
            got = chosen.get(epoch)
            if got is None:
                chosen[epoch] = (rnd, node)
            elif got[0] != rnd:
                violations.append(
                    f"epoch-activation divergence at epoch {epoch}: "
                    f"{got[1]} -> round {got[0]}, {node} -> round {rnd}"
                )
    details = {
        "epochs_activated": len(chosen),
        "max_epoch": max(chosen) if chosen else 0,
        "nodes_reporting": sum(1 for e in epochs_by_node.values() if e),
    }
    if not observed:
        return None, [], details
    return (not violations), violations, details


def check_handoff_gap(
    commits_by_node: dict[str, list[Commit]],
    epochs_by_node: dict[str, list[tuple[int, int]]],
    bound: int,
    untrusted: set[str] | frozenset[str] = frozenset(),
) -> tuple[bool | None, list[str], dict]:
    """Commits must never stall more than ``bound`` rounds across an
    epoch boundary: for each activation round A (the MODAL value per
    epoch, so a byz shadow reporter cannot move the boundary), the gap
    between the last committed round before A and the first at/after A
    is at most ``bound`` — and a boundary with no commit beyond it at
    all is a stalled handoff.  ``untrusted`` nodes' observations are
    ignored.  Returns (ok, violations, details); ok is ``None`` without
    any observed boundary."""
    from collections import Counter

    activations: dict[int, Counter] = {}
    for node, obs in epochs_by_node.items():
        if node in untrusted:
            continue
        for epoch, rnd in obs:
            activations.setdefault(epoch, Counter())[rnd] += 1
    if not activations:
        return None, [], {}
    rounds = sorted(
        {
            rnd
            for node, commits in commits_by_node.items()
            if node not in untrusted
            for (_t, rnd, _d) in commits
        }
    )
    violations: list[str] = []
    boundaries: list[tuple[int, int, int | None]] = []
    for epoch in sorted(activations):
        boundary = activations[epoch].most_common(1)[0][0]
        before = [r for r in rounds if r < boundary]
        after = [r for r in rounds if r >= boundary]
        if not after:
            boundaries.append((epoch, boundary, None))
            violations.append(
                f"no commit at or after epoch {epoch}'s activation "
                f"round {boundary} — the handoff stalled"
            )
            continue
        # a boundary inside the pre-genesis gap (no commit before it)
        # measures from round 0: the committee had never committed yet
        gap = after[0] - (before[-1] if before else 0)
        boundaries.append((epoch, boundary, gap))
        if gap > bound:
            violations.append(
                f"commit gap {gap} across epoch {epoch}'s boundary "
                f"(round {boundary}) exceeds the handoff bound {bound}"
            )
    details = {
        "boundaries": boundaries,
        "max_gap": max(
            (g for _e, _b, g in boundaries if g is not None), default=None
        ),
        "bound": bound,
    }
    return (not violations), violations, details


def reconfig_render(
    epoch_ok: bool | None,
    epoch_viol: list[str],
    epoch_details: dict,
    hand_ok: bool | None,
    hand_viol: list[str],
    hand_details: dict,
    trusted_epoch: tuple[bool | None, list[str]] | None = None,
) -> str:
    """Render the ``+ RECONFIG`` SUMMARY section: the epoch-agreement
    verdict, the measured handoff gaps per boundary, and (under
    ``quorum_mode: trusted-subset``) the agreement verdict once the
    adversarial epoch histories are discarded."""
    lines = [" + RECONFIG:\n"]
    if epoch_ok is None:
        lines.append(" Epoch agreement: n/a (no epoch activations logged)\n")
    else:
        ed = epoch_details
        lines.append(
            f" Epoch agreement: {'PASS' if epoch_ok else 'FAIL'}"
            f" ({ed.get('epochs_activated', 0)} epoch boundaries,"
            f" {ed.get('nodes_reporting', 0)} nodes,"
            f" max epoch {ed.get('max_epoch', 0)})\n"
        )
        shown = epoch_viol[:8]
        for v in shown:
            lines.append(f"   ! {v}\n")
        if len(epoch_viol) > len(shown):
            lines.append(
                f"   ! ... and {len(epoch_viol) - len(shown)} more "
                "epoch-agreement violations\n"
            )
    if hand_ok is not None:
        gaps = ", ".join(
            f"epoch {e} @ round {b}: gap {'stalled' if g is None else g}"
            for e, b, g in hand_details.get("boundaries", ())
        )
        lines.append(
            f" Handoff gap (bound {hand_details.get('bound')}): "
            f"{'PASS' if hand_ok else 'FAIL'}"
            + (f" ({gaps})" if gaps else "")
            + "\n"
        )
        for v in hand_viol:
            lines.append(f"   ! {v}\n")
    if trusted_epoch is not None:
        t_ok, t_viol = trusted_epoch
        verdict = "n/a" if t_ok is None else ("PASS" if t_ok else "FAIL")
        lines.append(
            f" Trusted-subset epoch agreement (adversaries excluded): "
            f"{verdict}\n"
        )
        for v in t_viol[:8]:
            lines.append(f"   ! {v}\n")
    return "".join(lines)


def byz_activity_from_logs(logs_dir: str) -> dict[str, dict[str, int]]:
    """Per-node Byzantine activity counts from a logs directory: attack
    lines on adversarial nodes, defense lines on honest ones."""
    out: dict[str, dict[str, int]] = {}
    for path in sorted(glob.glob(os.path.join(logs_dir, "node-*.log"))):
        name = os.path.basename(path)[: -len(".log")]
        with open(path) as f:
            content = f.read()
        counts: dict[str, int] = {}
        for policy in RE_BYZ_ATTACK.findall(content):
            counts[policy] = counts.get(policy, 0) + 1
        for accepted, shed in RE_FLOOD_ADMISSION.findall(content):
            counts["flood_accepted"] = (
                counts.get("flood_accepted", 0) + int(accepted)
            )
            counts["flood_shed"] = counts.get("flood_shed", 0) + int(shed)
        qc_rejects = len(RE_QC_REJECT.findall(content))
        if qc_rejects:
            counts["qc_reject"] = qc_rejects
        conflicts = len(RE_VOTE_CONFLICT.findall(content))
        if conflicts:
            counts["vote_conflict"] = conflicts
        out[name] = counts
    return out


def adversaries_from_spec(
    spec: dict, authorities: dict[int, str] | None = None
) -> dict[str, dict]:
    """Map the spec's adversarial node indexes to log-node names with
    their policies and (when the caller can resolve key files)
    authority identities: {"node-0": {"policies": [...], "authority":
    "ab12cd34" | None}}."""
    out: dict[str, dict] = {}
    for rule in spec.get("adversary", ()):
        nodes = rule.get("node", rule.get("nodes", ()))
        if isinstance(nodes, int):
            nodes = (nodes,)
        for idx in nodes:
            idx = int(idx)
            entry = out.setdefault(
                f"node-{idx}",
                {
                    "index": idx,
                    "policies": [],
                    "authority": (authorities or {}).get(idx),
                },
            )
            policy = rule.get("policy", "?")
            if policy not in entry["policies"]:
                entry["policies"].append(policy)
    return out


def attribute_violations(
    violations: list[str], adversaries: dict[str, dict]
) -> list[str]:
    """Annotate each safety violation with the adversarial authorities
    involved: a violation naming an adversarial node (or occurring at
    all while equivocators are live) must point at the equivocating
    authors, not just the conflicting digests."""
    if not adversaries:
        return list(violations)
    out = []
    for v in violations:
        involved = [
            (name, info)
            for name, info in sorted(adversaries.items())
            if re.search(rf"\b{re.escape(name)}\b", v)
        ] or sorted(adversaries.items())
        tags = ", ".join(
            f"{name} ({'/'.join(info['policies'])}"
            + (f", authority {info['authority']}" if info["authority"] else "")
            + ")"
            for name, info in involved
        )
        out.append(f"{v} [adversary: {tags}]")
    return out


def check_safety(
    commits_by_node: dict[str, list[Commit]],
) -> tuple[bool, list[str]]:
    """No conflicting commits at any round, across nodes or within one
    node's (possibly multi-lifetime) history."""
    violations: list[str] = []
    chosen: dict[int, tuple[str, str]] = {}  # round -> (digest, first node)
    for node in sorted(commits_by_node):
        seen_here: dict[int, str] = {}
        for _t, rnd, digest in commits_by_node[node]:
            prev = seen_here.get(rnd)
            if prev is not None and prev != digest:
                violations.append(
                    f"{node} committed two blocks at round {rnd}: "
                    f"{prev} vs {digest}"
                )
            seen_here[rnd] = digest
            got = chosen.get(rnd)
            if got is None:
                chosen[rnd] = (digest, node)
            elif got[0] != digest:
                violations.append(
                    f"conflicting commits at round {rnd}: "
                    f"{got[1]} -> {got[0]}, {node} -> {digest}"
                )
    return (not violations), violations


def trusted_subset_recheck(
    commits_by_node: dict[str, list[Commit]],
    untrusted: set[str] | frozenset[str],
) -> tuple[bool, list[str]]:
    """Re-check safety under TEE-style trusted-subset quorum math
    (arXiv:2512.09409): when attested hardware removes equivocation from
    the fault model, a quorum needs only f+1 of 2f+1 *trusted* replicas,
    and the histories of the untrusted (here: adversarial) nodes are
    discarded before checking consistency.  A full-history FAIL that
    turns into a PASS here demonstrates the attack lives entirely in the
    colluders' reported histories."""
    trusted = {
        node: commits
        for node, commits in commits_by_node.items()
        if node not in untrusted
    }
    return check_safety(trusted)


def check_liveness(
    commits_by_node: dict[str, list[Commit]],
    heal_unix: float,
    resume_within_s: float | None = None,
    max_round_gap: int | None = None,
) -> tuple[bool, list[str], dict]:
    """New rounds commit soon after the last heal edge (wall clock
    ``heal_unix``).  Returns (ok, violations, details) — details carries
    the measured resume latency for the CHAOS block."""
    all_commits = sorted(
        (t, rnd)
        for commits in commits_by_node.values()
        for (t, rnd, _d) in commits
    )
    details: dict = {}
    if not all_commits:
        return False, ["no commits anywhere in the run"], details
    pre = [rnd for t, rnd in all_commits if t <= heal_unix]
    pre_max = max(pre) if pre else -1
    details["pre_heal_max_round"] = pre_max
    post = [
        (t, rnd) for t, rnd in all_commits if t > heal_unix and rnd > pre_max
    ]
    if not post:
        return (
            False,
            [
                "no new rounds committed after the last heal "
                f"(pre-heal max round {pre_max})"
            ],
            details,
        )
    first_t, first_rnd = post[0]
    resumed_after = first_t - heal_unix
    details["resumed_after_s"] = resumed_after
    details["first_new_round"] = first_rnd
    violations: list[str] = []
    if resume_within_s is not None and resumed_after > resume_within_s:
        violations.append(
            f"commits resumed {resumed_after:.1f}s after the heal "
            f"(bound {resume_within_s:.1f}s)"
        )
    if max_round_gap is not None and pre_max >= 0:
        gap = first_rnd - pre_max
        details["round_gap"] = gap
        if gap > max_round_gap:
            violations.append(
                f"round gap across the outage: {gap} (bound {max_round_gap})"
            )
    return (not violations), violations, details


def chaos_block(
    scenario: str,
    seed: int,
    safety_ok: bool,
    safety_violations: list[str],
    liveness_ok: bool | None,
    liveness_violations: list[str],
    details: dict,
    heal_rel: float | None = None,
    state_ok: bool | None = None,
    state_violations: list[str] | tuple = (),
    state_details: dict | None = None,
) -> str:
    """Render the ``+ CHAOS`` SUMMARY section.  ``liveness_ok=None``
    means the scenario never heals (unbounded rule) — liveness is n/a,
    not a failure.  ``state_ok`` is the state-root agreement verdict:
    None with ``state_details=None`` omits the line (caller has no
    execution layer), None WITH details renders n/a (layer present but
    no roots logged)."""
    lines = [
        " + CHAOS:\n",
        f" Scenario: {scenario} (seed {seed})\n",
        f" Safety (no conflicting commits): {'PASS' if safety_ok else 'FAIL'}\n",
    ]
    # a sustained attack (byz-collude) yields one violation per shadow
    # commit — hundreds per run; cap the render, the count tells the story
    shown = safety_violations[:8]
    for v in shown:
        lines.append(f"   ! {v}\n")
    if len(safety_violations) > len(shown):
        lines.append(
            f"   ! ... and {len(safety_violations) - len(shown)} more "
            "conflicting-commit violations\n"
        )
    if state_details is not None:
        if state_ok is None:
            lines.append(
                " State-root agreement: n/a (no state roots logged)\n"
            )
        else:
            sd = state_details
            lines.append(
                " State-root agreement: "
                f"{'PASS' if state_ok else 'FAIL'}"
                f" ({sd.get('versions_compared', 0)} versions,"
                f" {sd.get('nodes_reporting', 0)} nodes,"
                f" max v{sd.get('max_version', 0)})\n"
            )
            s_shown = list(state_violations)[:8]
            for v in s_shown:
                lines.append(f"   ! {v}\n")
            if len(state_violations) > len(s_shown):
                lines.append(
                    f"   ! ... and {len(state_violations) - len(s_shown)} "
                    "more state-root violations\n"
                )
    if liveness_ok is None:
        lines.append(" Liveness: n/a (scenario never heals)\n")
    else:
        detail = ""
        if "resumed_after_s" in details:
            detail = f" (resumed {details['resumed_after_s']:.1f}s after heal"
            if "round_gap" in details:
                detail += f", round gap {details['round_gap']}"
            detail += ")"
        heal_txt = (
            f"heal at t={heal_rel:.1f}s" if heal_rel is not None else "heal"
        )
        lines.append(
            f" Liveness (recovery after {heal_txt}): "
            f"{'PASS' if liveness_ok else 'FAIL'}{detail}\n"
        )
        for v in liveness_violations:
            lines.append(f"   ! {v}\n")
    return "".join(lines)


def byz_block(
    adversaries: dict[str, dict],
    activity: dict[str, dict[str, int]],
    safety_ok: bool,
    trusted_result: tuple[bool, list[str]] | None = None,
    trusted_state_result: tuple[bool | None, list[str]] | None = None,
) -> str:
    """Render the ``+ BYZ`` SUMMARY section: which nodes attacked, with
    what policies and how often; what the honest committee rejected; and
    (under ``quorum_mode: trusted-subset``) the safety AND state-root
    verdicts once the adversarial histories are discarded."""
    lines = [" + BYZ:\n"]
    for name, info in sorted(adversaries.items()):
        who = f" Adversary {name}"
        if info.get("authority"):
            who += f" (authority {info['authority']})"
        who += f": {'/'.join(info['policies'])}"
        attacks = {
            k: v
            for k, v in activity.get(name, {}).items()
            if k not in (
                "qc_reject", "vote_conflict",
                "flood_accepted", "flood_shed",
            )
        }
        if attacks:
            who += " — " + ", ".join(
                f"{k} x{v}" for k, v in sorted(attacks.items())
            )
        lines.append(who + "\n")
        counts = activity.get(name, {})
        if counts.get("flood_accepted") or counts.get("flood_shed"):
            # credit-capped flood: the victim's admission verdict on the
            # attacker's producer batches (shed = the plane held)
            lines.append(
                f"   flood admission at victim: "
                f"accepted {counts.get('flood_accepted', 0)}, "
                f"shed {counts.get('flood_shed', 0)}\n"
            )
    defended = {
        node: counts
        for node, counts in sorted(activity.items())
        if node not in adversaries
        and (counts.get("qc_reject") or counts.get("vote_conflict"))
    }
    for node, counts in defended.items():
        parts = []
        if counts.get("qc_reject"):
            parts.append(f"qc_reject x{counts['qc_reject']}")
        if counts.get("vote_conflict"):
            parts.append(f"vote_conflict x{counts['vote_conflict']}")
        lines.append(f" Honest {node} rejected: {', '.join(parts)}\n")
    lines.append(
        f" Attack contained (full-history safety): "
        f"{'PASS' if safety_ok else 'FAIL'}\n"
    )
    if trusted_result is not None:
        t_ok, t_viol = trusted_result
        lines.append(
            " Trusted-subset quorum (adversaries excluded): "
            f"{'PASS' if t_ok else 'FAIL'}\n"
        )
        for v in t_viol:
            lines.append(f"   ! {v}\n")
    if trusted_state_result is not None:
        ts_ok, ts_viol = trusted_state_result
        verdict = "n/a" if ts_ok is None else ("PASS" if ts_ok else "FAIL")
        lines.append(
            " Trusted-subset state roots (adversaries excluded): "
            f"{verdict}\n"
        )
        for v in ts_viol[:8]:
            lines.append(f"   ! {v}\n")
    return "".join(lines)


def check_run(
    logs_dir: str,
    spec: dict,
    epoch_unix: float,
    authorities: dict[int, str] | None = None,
) -> tuple[bool, str]:
    """Full invariant check for a finished chaos bench run: parse the
    node logs, evaluate both invariants against the scenario spec, and
    return (all_ok, rendered CHAOS block).  When the spec carries an
    ``adversary`` schedule, safety violations are attributed to the
    Byzantine authorities and a ``+ BYZ`` section is appended; the
    full-history verdict still governs the exit status (a successful
    collusion FAILs the run even if the trusted-subset recheck passes)."""
    commits = commits_from_logs(logs_dir)
    safety_ok, safety_viol = check_safety(commits)
    adversaries = adversaries_from_spec(spec, authorities)
    if adversaries:
        safety_viol = attribute_violations(safety_viol, adversaries)
    # replicated-execution invariant: honest nodes' state roots agree
    # per version.  n/a (no roots logged) never fails a run; a FAIL does
    # — diverging execution is a safety violation even when the commit
    # histories themselves agree.
    roots = state_roots_from_logs(logs_dir)
    state_ok, state_viol, state_details = check_state_root_agreement(roots)
    if adversaries:
        state_viol = attribute_violations(state_viol, adversaries)
    heal_rel = last_heal(spec)
    liveness = spec.get("liveness", {})
    if math.isinf(heal_rel):
        live_ok: bool | None = None
        live_viol: list[str] = []
        details: dict = {}
        block = chaos_block(
            spec.get("name", "custom"), int(spec.get("seed", 0)),
            safety_ok, safety_viol, live_ok, live_viol, details,
            state_ok=state_ok, state_violations=state_viol,
            state_details=state_details,
        )
        all_ok = safety_ok
    else:
        live_ok, live_viol, details = check_liveness(
            commits,
            heal_unix=epoch_unix + heal_rel,
            resume_within_s=liveness.get("resume_within_s"),
            max_round_gap=liveness.get("max_round_gap"),
        )
        block = chaos_block(
            spec.get("name", "custom"), int(spec.get("seed", 0)),
            safety_ok, safety_viol, live_ok, live_viol, details,
            heal_rel=heal_rel,
            state_ok=state_ok, state_violations=state_viol,
            state_details=state_details,
        )
        all_ok = safety_ok and live_ok
    all_ok = all_ok and state_ok is not False
    # live-reconfiguration invariants: every node that crossed an epoch
    # boundary crossed it at the same round, and commits never stalled
    # more than the declared handoff gap across any boundary
    epochs = epochs_from_logs(logs_dir)
    epoch_ok, epoch_viol, epoch_details = check_epoch_agreement(epochs)
    if adversaries:
        epoch_viol = attribute_violations(epoch_viol, adversaries)
    hand_bound = spec.get("handoff_gap_rounds")
    hand_ok: bool | None = None
    hand_viol: list[str] = []
    hand_details: dict = {}
    if hand_bound is not None:
        # boundaries are measured over honest observations only — a byz
        # shadow reporter must not be able to move the measured boundary
        hand_ok, hand_viol, hand_details = check_handoff_gap(
            commits, epochs, int(hand_bound), untrusted=set(adversaries)
        )
    trusted_epoch = None
    if adversaries and spec.get("quorum_mode") == "trusted-subset":
        te_ok, te_viol, _te_details = check_epoch_agreement(
            {n: e for n, e in epochs.items() if n not in adversaries}
        )
        trusted_epoch = (te_ok, te_viol)
    if spec.get("reconfig") or epoch_ok is not None:
        block += reconfig_render(
            epoch_ok, epoch_viol, epoch_details,
            hand_ok, hand_viol, hand_details,
            trusted_epoch=trusted_epoch,
        )
    all_ok = all_ok and epoch_ok is not False and hand_ok is not False
    if adversaries:
        trusted_result = None
        trusted_state_result = None
        if spec.get("quorum_mode") == "trusted-subset":
            trusted_result = trusted_subset_recheck(
                commits, set(adversaries)
            )
            ts_ok, ts_viol, _ts_details = check_state_root_agreement(
                {n: r for n, r in roots.items() if n not in adversaries}
            )
            trusted_state_result = (ts_ok, ts_viol)
        block += byz_block(
            adversaries,
            byz_activity_from_logs(logs_dir),
            safety_ok,
            trusted_result,
            trusted_state_result,
        )
    return all_ok, block


__all__ = [
    "Commit",
    "RE_COMMITTED",
    "RE_EPOCH",
    "RE_STATE_ROOT",
    "StateRoot",
    "adversaries_from_spec",
    "attribute_violations",
    "byz_activity_from_logs",
    "byz_block",
    "chaos_block",
    "check_epoch_agreement",
    "check_handoff_gap",
    "check_liveness",
    "check_run",
    "check_safety",
    "check_state_root_agreement",
    "commits_from_logs",
    "epochs_from_logs",
    "reconfig_render",
    "state_roots_from_logs",
    "trusted_subset_recheck",
]
