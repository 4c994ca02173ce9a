"""Commit critical-path engine: where a committed block's wall-clock goes.

A copy of ``hotstuff_tpu.telemetry.critpath``, whole.

The flight recorder (journal.py) gives per-node event streams and
``benchmark/traces.py`` merges them into clock-aligned per-block
timelines — but a timeline is not an attribution.  This module walks,
for every committed block, the causal chain that HAD to complete before
the commit could fire under 2-chain chained HotStuff:

    producer recv -> propose(B) -> quorum-th replica recv -> that
    voter's local verify+sign -> vote net edge -> quorum-th vote
    arrival at the next leader -> QC(B) assembled -> next proposal
    broadcast (the QC rides it) -> [same per-round chain for B'] ->
    QC(B') assembled -> commit(B) observed at the slowest node

and charges each hop to one stage of the registered taxonomy
(``CRITPATH_STAGES`` in taxonomy.py — the same registry the
taxonomy-registry lint enforces for journal edges).  The two chained
rounds share stage buckets: ``net.propose`` is the sum of both rounds'
proposal fan-outs, and so on.  Whatever the reconstruction cannot
anchor on journaled events lands in ``unattributed`` — rendered,
never hidden (the coverage figure is the engine's own honesty metric).

Pure and unit-testable: stdlib + the port's constant-leaf taxonomy
only.  The input is duck-typed (anything with ``.blocks`` / ``.nodes`` /
``.payload_waits`` shaped like ``benchmark.traces.TraceSet``), so
fixture journals and the journals a port committee writes feed it
without the node runtime.

Consumers in the port: the node's health branch (``node/node.py``)
injects :func:`rolling_attribution` over the trace recorder's recent
commits into ``telemetry/health.py``'s ``HealthMonitor``, which feeds
the ``crit_regime_shift`` detector and the snapshot's ``health``
section (``dominant_stage``, ``regime``).  :func:`analyze`,
:func:`render` and :func:`diff` read merged journals, the port's as
well as the JAX node's.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from .taxonomy import CRITPATH_REGIMES, CRITPATH_STAGES

#: default attribution-diff tolerance: a stage's share of commit
#: latency may grow this many percentage points before --diff fails
#: (HOTSTUFF_CRITPATH_DIFF_PP overrides at the CLI)
DIFF_SHARE_PP = 10.0

#: a diffed stage is ignored below this share on BOTH sides — tiny
#: stages flap in percentage terms without moving the commit latency
DIFF_MIN_SHARE = 0.02

#: on-node rolling attribution: which local trace-recorder edge maps to
#: which regime (a coarse single-node proxy for the cross-node engine —
#: propose->vote rides the proposal net hop + verify, vote->qc is
#: aggregation, qc->commit is the chained round + QC propagation)
LOCAL_EDGE_REGIME = {
    "propose_to_vote": "verify-bound",
    "vote_to_qc": "aggregation-bound",
    "qc_to_commit": "network-bound",
}


def _pctl(values: list[float], q: float) -> float:
    """Nearest-rank percentile over a non-empty list (q in [0, 100])."""
    xs = sorted(values)
    if not xs:
        return 0.0
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


@dataclass
class Segment:
    """One hop of a commit's critical path.  ``w_start``/``w_end`` are
    offset-corrected wall ns when the hop is anchored on journaled
    events (the Perfetto track renders those), None for derived
    estimates (ingest.wait)."""

    stage: str
    ms: float
    detail: str = ""
    w_start: int | None = None
    w_end: int | None = None


@dataclass
class CommitPath:
    """One committed block's reconstructed critical path."""

    digest: str
    round: int
    node: str  # last node to commit (the path ends there)
    total_ms: float  # measured: ingest estimate + propose -> commit
    stages: dict = field(default_factory=dict)  # stage -> ms (attributed)
    segments: list = field(default_factory=list)  # [Segment], path order
    coverage: float = 0.0  # attributed / total (capped at 1)

    @property
    def dominant(self) -> str:
        if not self.stages:
            return "unattributed"
        attributed = sum(self.stages.values())
        residual = max(0.0, self.total_ms - attributed)
        best = max(self.stages, key=lambda s: self.stages[s])
        if residual > self.stages[best]:
            return "unattributed"
        return best


@dataclass
class CritPathReport:
    """The run-level aggregation ``analyze`` returns."""

    commits: list = field(default_factory=list)  # [CommitPath]
    regime: str = "unknown"
    coverage: float = 0.0  # mean per-commit attributed fraction
    journal_coverage: float = 1.0
    dropped_records: int = 0
    stage_totals: dict = field(default_factory=dict)  # stage -> summed ms

    def attribution(self) -> dict:
        """The machine-readable attribution document: bench.py's
        "critpath" block, the perfgate guards, SimVerdict.attribution,
        and both sides of the --diff gate all speak this shape."""
        totals = [c.total_ms for c in self.commits]
        measured = sum(totals)
        stages: dict[str, dict] = {}
        for stage in CRITPATH_STAGES:
            if stage == "unattributed":
                continue
            per_commit = [c.stages.get(stage, 0.0) for c in self.commits]
            summed = sum(per_commit)
            if not summed:
                continue
            stages[stage] = {
                "p50_ms": round(_pctl(per_commit, 50), 3),
                "p99_ms": round(_pctl(per_commit, 99), 3),
                "share": round(summed / measured, 4) if measured else 0.0,
            }
        dominant = Counter(c.dominant for c in self.commits)
        return {
            "commits": len(self.commits),
            "p50_ms": round(_pctl(totals, 50), 3),
            "p99_ms": round(_pctl(totals, 99), 3),
            "coverage_pct": round(100.0 * self.coverage, 1),
            "journal_coverage_pct": round(100.0 * self.journal_coverage, 1),
            "regime": self.regime,
            "stages": stages,
            "dominant": dict(dominant),
        }


def _quorum(n: int) -> int:
    """2f+1 for n = 3f+1 committees (n - f in general)."""
    return n - (n - 1) // 3 if n else 0


def _kth_smallest(values: list, k: int):
    """k-th smallest (1-based), clamped into the available range."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, min(len(xs), k) - 1)]


def _decompose_round(
    info: dict, quorum: int, segments: list, stages: dict
) -> int | None:
    """Attribute propose -> QC-formed for one block's round, appending
    anchored segments and summing stage buckets.  Returns the QC
    formation wall (corrected ns) — falling back to the first high-QC
    adoption when the qc.form edge is missing — or None when even that
    is unknown.  Missing intermediate edges shrink attribution (the
    residual lands in unattributed), they never fabricate time."""
    if info["propose"] is None:
        return None
    _, w0 = info["propose"]
    rnd = info["round"]
    qcf = info.get("qc_form") or info.get("qc")
    w_qc = qcf[2] if qcf is not None else None

    def charge(stage: str, start: int, end: int, detail: str) -> None:
        ms = (end - start) / 1e6
        if ms < 0:
            return  # clock-correction artifact: skip, never negative-charge
        stages[stage] = stages.get(stage, 0.0) + ms
        segments.append(
            Segment(stage, ms, detail, w_start=start, w_end=end)
        )

    # propose -> quorum-th replica receive (the leader holds the block
    # at w0, so quorum-1 network arrivals complete the proposal fan-out)
    recvs = info["recv"]
    q_recv = _kth_smallest([w for _, w in recvs.values()], quorum - 1)
    cursor = w0
    if q_recv is not None:
        charge(
            "net.propose", w0, q_recv, f"r{rnd} propose fan-out"
        )
        cursor = q_recv

    # the critical voter: the one whose vote ARRIVED quorum-th at the
    # aggregating (next-leader) node — its chain is the binding one
    rv = info.get("recv_vote") or {}
    v_star, w_rv = None, None
    if rv:
        arrivals = sorted(
            (w, voter) for voter, (_n, _m, w) in rv.items()
        )
        k = max(0, min(len(arrivals), quorum - 1) - 1)
        w_rv, v_star = arrivals[k]

    if v_star is not None:
        got = recvs.get(v_star)
        vote = info["vote_send"].get(v_star)
        if got is not None and vote is not None:
            charge(
                "vote.local",
                got[1],
                vote[1],
                f"r{rnd} verify+sign at {v_star}",
            )
            charge(
                "net.vote", vote[1], w_rv, f"r{rnd} vote from {v_star}"
            )
            cursor = w_rv
        elif vote is not None:
            charge(
                "net.vote", vote[1], w_rv, f"r{rnd} vote from {v_star}"
            )
            cursor = w_rv
        else:
            cursor = max(cursor, w_rv)
    if w_qc is not None and cursor is not None:
        charge("agg.form", cursor, w_qc, f"r{rnd} QC assembly")
    return w_qc


def analyze(traces, quorum: int | None = None) -> CritPathReport:
    """Reconstruct and attribute every committed block's critical path.

    ``traces``: a ``benchmark.traces.TraceSet`` (or any object with the
    same ``blocks`` / ``nodes`` / ``payload_waits`` surface).  ``quorum``
    defaults to 2f+1 for the journaled committee size."""
    blocks: dict[str, dict] = traces.blocks
    if quorum is None:
        quorum = _quorum(len(traces.nodes))
    by_round: dict[int, str] = {}
    for digest, info in blocks.items():
        if info["propose"] is not None:
            by_round.setdefault(info["round"], digest)

    # producer recv -> propose is journaled per PAYLOAD digest and
    # cannot be joined to a block digest; charge the run-median wait as
    # the per-commit ingest estimate (documented as such)
    waits = sorted(getattr(traces, "payload_waits", ()) or ())
    ingest_ms = waits[len(waits) // 2] if waits else 0.0

    report = CritPathReport()
    for digest, info in sorted(
        blocks.items(), key=lambda kv: kv[1]["round"]
    ):
        if not info["commit"] or info["propose"] is None:
            continue
        _, w0 = info["propose"]
        node, (_, w_commit) = max(
            info["commit"].items(), key=lambda kv: kv[1][1]
        )
        if w_commit < w0:
            continue  # irrecoverable clock damage: skip the block
        path = CommitPath(
            digest=digest,
            round=info["round"],
            node=node,
            total_ms=ingest_ms + (w_commit - w0) / 1e6,
        )
        if ingest_ms:
            path.stages["ingest.wait"] = ingest_ms
            path.segments.append(
                Segment(
                    "ingest.wait", ingest_ms, "median producer wait"
                )
            )
        w_qc = _decompose_round(info, quorum, path.segments, path.stages)

        # the 2-chain: B commits when the QC for the DIRECT successor
        # round forms — hand off to that leader and charge its round
        nxt = by_round.get(info["round"] + 1)
        w_qc2 = None
        if w_qc is not None and nxt is not None:
            ninfo = blocks[nxt]
            _, w1 = ninfo["propose"]
            if w1 >= w_qc:
                ms = (w1 - w_qc) / 1e6
                path.stages["lead.handoff"] = (
                    path.stages.get("lead.handoff", 0.0) + ms
                )
                path.segments.append(
                    Segment(
                        "lead.handoff",
                        ms,
                        f"QC r{info['round']} -> propose r{ninfo['round']}",
                        w_start=w_qc,
                        w_end=w1,
                    )
                )
            w_qc2 = _decompose_round(
                ninfo, quorum, path.segments, path.stages
            )
        if w_qc2 is not None and w_commit >= w_qc2:
            ms = (w_commit - w_qc2) / 1e6
            path.stages["commit.exec"] = (
                path.stages.get("commit.exec", 0.0) + ms
            )
            path.segments.append(
                Segment(
                    "commit.exec",
                    ms,
                    f"chained QC -> commit at {node}",
                    w_start=w_qc2,
                    w_end=w_commit,
                )
            )
        attributed = sum(path.stages.values())
        path.coverage = (
            min(1.0, attributed / path.total_ms) if path.total_ms else 0.0
        )
        report.commits.append(path)

    for c in report.commits:
        for stage, ms in c.stages.items():
            report.stage_totals[stage] = (
                report.stage_totals.get(stage, 0.0) + ms
            )
    if report.commits:
        report.coverage = sum(c.coverage for c in report.commits) / len(
            report.commits
        )
    merge_stats = getattr(traces, "merge_stats", None) or {}
    report.dropped_records = merge_stats.get("dropped", 0)
    jc = getattr(traces, "journal_coverage", None)
    report.journal_coverage = jc() if callable(jc) else 1.0
    report.regime = classify_regime(report.stage_totals)
    return report


def classify_regime(stage_totals: dict) -> str:
    """Name the run's binding constraint: the regime whose stage group
    holds the largest share of attributed milliseconds."""
    scores = {
        regime: sum(stage_totals.get(s, 0.0) for s in group)
        for regime, group in CRITPATH_REGIMES.items()
    }
    if not any(scores.values()):
        return "unknown"
    return max(sorted(scores), key=lambda r: scores[r])


# ---- rendering -------------------------------------------------------------


def render(report: CritPathReport) -> str:
    """The "+ CRITPATH" SUMMARY block."""
    lines = [" + CRITPATH (commit critical path):\n"]
    att = report.attribution()
    if not report.commits:
        lines.append(" No committed blocks reconstructed.\n")
        return "".join(lines)
    lines.append(
        f" Commits attributed: {att['commits']};"
        f" stage coverage {att['coverage_pct']:.0f}%"
        f" of measured commit latency\n"
    )
    drop_note = (
        f" ({report.dropped_records} records rotated away)"
        if report.dropped_records
        else ""
    )
    lines.append(
        f" Journal coverage: {att['journal_coverage_pct']:.0f}%"
        f"{drop_note}\n"
    )
    lines.append(
        f" Commit latency: p50 {att['p50_ms']:.2f} ms"
        f"  p99 {att['p99_ms']:.2f} ms;"
        f" regime: {att['regime']}\n"
    )
    for stage in CRITPATH_STAGES:
        entry = att["stages"].get(stage)
        if entry is None:
            continue
        lines.append(
            f"   {stage + ':':<14} p50 {entry['p50_ms']:7.2f} ms"
            f"  p99 {entry['p99_ms']:7.2f} ms"
            f"  share {100.0 * entry['share']:5.1f}%\n"
        )
    total = sum(att["dominant"].values())
    if total:
        top = ", ".join(
            f"{stage} {100.0 * n / total:.0f}%"
            for stage, n in Counter(att["dominant"]).most_common(4)
        )
        lines.append(f" Dominant stage per commit: {top}\n")
    slowest = sorted(
        (
            (seg.ms, c.round, seg)
            for c in report.commits
            for seg in c.segments
        ),
        key=lambda t: -t[0],
    )[:5]
    if slowest:
        lines.append(" Slowest edges:\n")
        for ms, rnd, seg in slowest:
            lines.append(
                f"   {ms:8.2f} ms  {seg.stage:<13} {seg.detail}\n"
            )
    return "".join(lines)


# ---- attribution diff (the regression gate) --------------------------------


def diff(
    current: dict,
    reference: dict,
    share_pp: float = DIFF_SHARE_PP,
    min_share: float = DIFF_MIN_SHARE,
) -> list[str]:
    """Compare two attribution documents; return regression lines
    (empty = pass).  A stage regresses when its SHARE of commit latency
    grows more than ``share_pp`` percentage points over the reference —
    catching "same scalar, different shape" drifts the latency ratchet
    is blind to.  Stages below ``min_share`` on both sides are noise
    and ignored; stages or whole documents missing on either side are
    skipped (skip-if-missing, like the perfgate guards)."""
    fails: list[str] = []
    cur_stages = (current or {}).get("stages") or {}
    ref_stages = (reference or {}).get("stages") or {}
    if not cur_stages or not ref_stages:
        return fails
    for stage, cur in cur_stages.items():
        ref = ref_stages.get(stage)
        cur_share = float(cur.get("share", 0.0))
        ref_share = float(ref.get("share", 0.0)) if ref else 0.0
        if cur_share < min_share and ref_share < min_share:
            continue
        growth_pp = 100.0 * (cur_share - ref_share)
        if growth_pp > share_pp:
            fails.append(
                f"critpath.{stage}.share grew"
                f" {100.0 * ref_share:.1f}% -> {100.0 * cur_share:.1f}%"
                f" (+{growth_pp:.1f}pp > {share_pp:.1f}pp allowed)"
            )
    return fails


# ---- on-node rolling attribution (health plane) ----------------------------


def rolling_attribution(entries) -> dict | None:
    """Coarse per-node attribution over the trace recorder's recent
    commit entries (telemetry/trace.py ring dicts) — no cross-node
    merge exists on-node, so this classifies from the three local
    lifecycle edges.  Returns None below a minimal sample count (the
    detector must not flap on one commit)."""
    entries = [
        e
        for e in (entries or ())
        if e.get("propose_to_commit_ms") is not None
    ]
    if len(entries) < 4:
        return None
    edges_ms = {}
    for edge in LOCAL_EDGE_REGIME:
        vals = [
            e[f"{edge}_ms"]
            for e in entries
            if e.get(f"{edge}_ms") is not None
        ]
        if vals:
            edges_ms[edge] = sum(vals) / len(vals)
    if not edges_ms:
        return None
    dominant = max(sorted(edges_ms), key=lambda k: edges_ms[k])
    return {
        "samples": len(entries),
        "dominant": dominant,
        "regime": LOCAL_EDGE_REGIME[dominant],
        "edges_ms": {k: round(v, 3) for k, v in edges_ms.items()},
    }


__all__ = [
    "DIFF_SHARE_PP",
    "DIFF_MIN_SHARE",
    "LOCAL_EDGE_REGIME",
    "Segment",
    "CommitPath",
    "CritPathReport",
    "analyze",
    "classify_regime",
    "render",
    "diff",
    "rolling_attribution",
]
