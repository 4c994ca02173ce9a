"""Live fleet health plane: delta frames, online anomaly detectors,
incident records, the bounded campaign recorder and the per-node monitor.

A copy of ``hotstuff_tpu.telemetry.health``:

- :func:`flatten` + :class:`DeltaStream` / :class:`DeltaDecoder` — the
  ``/delta`` wire format.  A node flattens its snapshot document into
  dot-keyed scalars and serves **delta frames** against a short frame
  history, keyed by a monotonic sequence number, so a scraper pulls
  O(changed keys) per tick instead of the whole document.  A decoder
  that misses a frame (sequence gap, node restart) drops its state and
  re-pulls a full frame — resync is one extra round trip, never a
  wrong merge.
- **Online anomaly detectors** — pure functions over sliding windows of
  ``(t, value)`` samples.  No I/O, no clock reads, no hidden state:
  every input (including the EWMA baseline) is a parameter and every
  output is an :class:`Incident` (or updated state), so each detector
  is unit-testable with fixture windows.
- :class:`CampaignRecorder` — a bounded fixed-interval time-series ring
  of the key gauges, persisted beside the journal as
  ``<node>-campaign.json`` (*not* ``.jsonl``: the journal loader globs
  ``*.jsonl``).
- :class:`HealthMonitor` — the per-node async loop: samples the node's
  own snapshot, runs the node-local detectors, journals
  ``health.<kind>`` open/close edges and logs ``Health incident: {json}``
  lines that ``benchmark/logs.py`` folds into the ``+ HEALTH`` block.

Fleet-level detectors (straggler, state-root divergence, epoch skew)
need cross-node visibility and run in a scraper over the same pure
functions.

One plane the port does not have yet: the wire-level flow accountant.
A port node's snapshot has no ``flows`` section, so the monitor never
pushes an egress sample and :func:`bandwidth_storm` never fires — the
JAX node's behaviour with flows off.  The detector itself is the
reference's.

This module is a stdlib-only leaf — no imports from the rest of the
package.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from collections import deque
from dataclasses import dataclass

log = logging.getLogger(__name__)

#: dynamic journal-edge family for incidents (taxonomy.HEALTH_PREFIX
#: mirrors this; kept literal here so this file stays import-free)
HEALTH_EDGE_PREFIX = "health."

#: every incident kind a detector can emit (docs + rendering order)
HEALTH_KINDS: tuple = (
    "leader_stall",
    "view_storm",
    "commit_collapse",
    "straggler",
    "shed_storm",
    "root_divergence",
    "epoch_skew",
    "crit_regime_shift",
    "bandwidth_storm",
)

# ---- delta-frame wire format ----------------------------------------------

_SCALARS = (int, float, str, bool)


def flatten(doc, prefix: str = "", out: dict | None = None) -> dict:
    """Flatten a nested snapshot document into dot-keyed scalars.

    Lists are indexed (``a.0``, ``a.1``); None and non-scalar leaves
    are dropped — the delta stream diffs scalar maps only.
    """
    if out is None:
        out = {}
    if isinstance(doc, dict):
        for k, v in doc.items():
            flatten(v, f"{prefix}{k}.", out)
        return out
    if isinstance(doc, (list, tuple)):
        for i, v in enumerate(doc):
            flatten(v, f"{prefix}{i}.", out)
        return out
    if isinstance(doc, _SCALARS):
        out[prefix[:-1]] = doc
    return out


#: frames of history a node keeps for delta serving: a scraper at a
#: 1 s tick tolerates ~this many missed pulls before paying a full frame
DELTA_HISTORY = 8


class DeltaStream:
    """Server side of ``/delta``: diff the current flat state against a
    short history of served frames.

    ``frame(doc, since)`` returns a **full** frame
    ``{"seq": s, "full": {...}}`` when ``since`` is unknown (first pull,
    history fallen off, node restarted) and a **delta** frame
    ``{"seq": s, "base": since, "set": {...}, "del": [...]}``
    otherwise.  ``seq`` only advances when the state actually changed,
    so an idle fleet serves empty deltas.
    """

    def __init__(self, history: int = DELTA_HISTORY):
        self.seq = 0
        self._frames: deque = deque(maxlen=history)  # (seq, flat state)

    def frame(self, doc: dict, since: int = -1) -> dict:
        flat = flatten(doc)
        if not self._frames or self._frames[-1][1] != flat:
            self.seq += 1
            self._frames.append((self.seq, flat))
        latest_seq, latest = self._frames[-1]
        base = None
        if 0 <= since <= latest_seq:
            for s, f in self._frames:
                if s == since:
                    base = f
                    break
        if base is None:
            return {"seq": latest_seq, "full": latest}
        sentinel = object()
        changed = {
            k: v for k, v in latest.items() if base.get(k, sentinel) != v
        }
        removed = [k for k in base if k not in latest]
        return {
            "seq": latest_seq,
            "base": since,
            "set": changed,
            "del": removed,
        }


class DeltaDecoder:
    """Client side of ``/delta``: apply frames, detect sequence gaps.

    ``apply`` returns the up-to-date flat state, or ``None`` on a gap
    (the delta's base is not the state we hold) — the caller re-pulls
    with ``since=-1`` (``self.since`` already reset) and merges the full
    frame next tick.
    """

    def __init__(self):
        self.seq = -1
        self.state: dict = {}
        self.resyncs = 0

    @property
    def since(self) -> int:
        return self.seq

    def apply(self, frame: dict) -> dict | None:
        if "full" in frame:
            self.state = dict(frame["full"])
            self.seq = frame["seq"]
            return self.state
        if frame.get("base") != self.seq:
            self.seq = -1
            self.state = {}
            self.resyncs += 1
            return None
        self.state.update(frame.get("set", {}))
        for k in frame.get("del", ()):
            self.state.pop(k, None)
        self.seq = frame["seq"]
        return self.state


# ---- sliding windows -------------------------------------------------------


class Window:
    """Bounded sliding window of ``(t, value)`` samples (time-trimmed
    and capacity-capped)."""

    def __init__(self, span_s: float = 60.0, capacity: int = 256):
        self.span_s = span_s
        self._q: deque = deque(maxlen=capacity)

    def push(self, t: float, v: float) -> None:
        self._q.append((t, v))
        while self._q and t - self._q[0][0] > self.span_s:
            self._q.popleft()

    def samples(self) -> list:
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)


def rate(samples) -> float | None:
    """Mean rate of change across a counter-sample window, or ``None``
    when the window spans no time (fewer than two samples)."""
    if len(samples) < 2:
        return None
    (t0, v0), (t1, v1) = samples[0], samples[-1]
    if t1 <= t0:
        return None
    return (v1 - v0) / (t1 - t0)


# ---- incidents -------------------------------------------------------------


@dataclass(frozen=True)
class Incident:
    """One detector firing: what, where, how bad, and the measured
    value that tripped the threshold."""

    kind: str
    node: str
    severity: str
    detail: str
    value: float = 0.0

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "node": self.node,
            "severity": self.severity,
            "detail": self.detail,
            "value": round(self.value, 3),
        }


# ---- online anomaly detectors (pure functions) -----------------------------


def leader_stall(
    progress, now: float, timeout_s: float, k: float = 3.0, node: str = ""
) -> Incident | None:
    """No proposal/commit progress for ``k × timeout``.

    ``progress``: ``(t, monotonic counter)`` samples — the expected
    leader's proposal count fleet-side, or commit progress node-side
    (a stalled leader stalls every replica's commit counter).  Requires
    the window to cover at least ``k × timeout_s`` of observation so a
    cold start never fires.
    """
    if not progress:
        return None
    horizon = k * timeout_s
    if now - progress[0][0] < horizon:
        return None
    last_advance_t, last_v = progress[0]
    for t, v in progress[1:]:
        if v > last_v:
            last_advance_t, last_v = t, v
    stalled_s = now - last_advance_t
    if stalled_s < horizon:
        return None
    return Incident(
        "leader_stall",
        node,
        "crit",
        f"no progress for {stalled_s:.1f}s "
        f"(threshold {horizon:.1f}s = {k:g}x{timeout_s:g}s timeout)",
        stalled_s,
    )


def view_change_storm(
    tc_samples,
    baseline_ewma: float | None,
    alpha: float = 0.3,
    factor: float = 4.0,
    min_rate: float = 0.5,
    node: str = "",
) -> tuple:
    """TC rate above the EWMA baseline: ``(incident | None, new ewma)``.

    ``tc_samples``: ``(t, tc_advances total)``.  The first observed rate
    seeds the baseline; the baseline only absorbs quiet ticks (a storm
    must not normalize itself).  ``min_rate`` floors the trigger so a
    single TC against a zero baseline does not page.
    """
    r = rate(tc_samples)
    if r is None:
        return None, baseline_ewma
    if baseline_ewma is None:
        return None, r
    if r >= min_rate and r > factor * baseline_ewma:
        inc = Incident(
            "view_storm",
            node,
            "warn",
            f"TC rate {r:.2f}/s vs baseline {baseline_ewma:.2f}/s "
            f"(x{factor:g} threshold)",
            r,
        )
        return inc, baseline_ewma
    return None, (1.0 - alpha) * baseline_ewma + alpha * r


def bandwidth_storm(
    egress_samples,
    baseline_ewma: float | None,
    alpha: float = 0.3,
    factor: float = 4.0,
    min_rate: float = 65536.0,
    node: str = "",
) -> tuple:
    """Wire egress rate above the EWMA baseline:
    ``(incident | None, new ewma)``.

    ``egress_samples``: ``(t, net_tx_bytes total)`` from the node's flow
    accountant.  Same EWMA discipline as :func:`view_change_storm`: the
    first observed rate seeds the baseline and only quiet ticks are
    absorbed, so a retransmit or equivocation storm cannot normalize
    itself.  ``min_rate`` (bytes/s) floors the trigger so a chatty-idle
    committee never pages on its own heartbeat traffic.
    """
    r = rate(egress_samples)
    if r is None:
        return None, baseline_ewma
    if baseline_ewma is None:
        return None, r
    if r >= min_rate and r > factor * baseline_ewma:
        inc = Incident(
            "bandwidth_storm",
            node,
            "warn",
            f"wire egress {r / 1e3:.0f} kB/s vs baseline "
            f"{baseline_ewma / 1e3:.0f} kB/s (x{factor:g} threshold)",
            r,
        )
        return inc, baseline_ewma
    return None, (1.0 - alpha) * baseline_ewma + alpha * r


def commit_collapse(
    commit_samples,
    collapse_ratio: float = 0.25,
    min_baseline_rate: float = 1.0,
    node: str = "",
) -> Incident | None:
    """Recent commit rate collapsed vs. the window's own earlier rate.

    ``commit_samples``: ``(t, commits total)``.  Splits the window at
    its time midpoint; fires when the recent-half rate drops below
    ``collapse_ratio`` x the earlier-half rate and the earlier half was
    genuinely committing (``min_baseline_rate``).
    """
    if len(commit_samples) < 4:
        return None
    t_mid = (commit_samples[0][0] + commit_samples[-1][0]) / 2.0
    early = [s for s in commit_samples if s[0] <= t_mid]
    late = [s for s in commit_samples if s[0] >= t_mid]
    r_early, r_late = rate(early), rate(late)
    if r_early is None or r_late is None or r_early < min_baseline_rate:
        return None
    if r_late <= collapse_ratio * r_early:
        return Incident(
            "commit_collapse",
            node,
            "crit",
            f"commit rate {r_late:.2f}/s, was {r_early:.2f}/s "
            f"(<= {collapse_ratio:g}x)",
            r_late,
        )
    return None


def straggler(
    rounds_by_node: dict,
    offsets: dict,
    now: float,
    lag_rounds: float = 16.0,
    max_age_s: float = 5.0,
) -> list:
    """Nodes whose round trails the fleet head.

    ``rounds_by_node``: node -> ``(sample time, round)``; ``offsets``:
    node -> estimated clock offset seconds (subtracted from the sample
    time before the freshness check, so a skewed-but-reporting node is
    not misread as silent — clock-offset awareness, not lag inflation).
    Only nodes with a sample fresher than ``max_age_s`` participate; a
    silent node is the STALE column's problem, not a straggler verdict.
    """
    fresh = {}
    for name, (t, round_) in rounds_by_node.items():
        if now - (t - offsets.get(name, 0.0)) <= max_age_s:
            fresh[name] = round_
    if len(fresh) < 2:
        return []
    head = max(fresh.values())
    out = []
    for name in sorted(fresh):
        lag = head - fresh[name]
        if lag >= lag_rounds:
            out.append(
                Incident(
                    "straggler",
                    name,
                    "warn",
                    f"round {fresh[name]:.0f} trails fleet head "
                    f"{head:.0f} by {lag:.0f} rounds",
                    lag,
                )
            )
    return out


def shed_storm(
    shed_samples,
    rate_threshold: float = 20.0,
    min_shed: int = 10,
    node: str = "",
) -> Incident | None:
    """Ingest BUSY spike: the admission plane shedding faster than
    ``rate_threshold`` payloads/s across the window (and at least
    ``min_shed`` absolute, so one burst at window edge cannot fire)."""
    r = rate(shed_samples)
    if r is None:
        return None
    total = shed_samples[-1][1] - shed_samples[0][1]
    if total >= min_shed and r >= rate_threshold:
        return Incident(
            "shed_storm",
            node,
            "warn",
            f"ingest shedding {r:.1f} payloads/s "
            f"({total:.0f} over the window)",
            r,
        )
    return None


def root_divergence(roots_by_node: dict) -> list:
    """State-root mismatch at the same applied version — the state-root
    agreement invariant, caught live instead of at run end.

    ``roots_by_node``: node -> ``(version, root)``.  Fires one
    fleet-wide incident per divergent version, naming every root and
    its holders.
    """
    by_version: dict = {}
    for name, (version, root) in sorted(roots_by_node.items()):
        by_version.setdefault(version, {}).setdefault(root, []).append(name)
    out = []
    for version in sorted(by_version):
        holders = by_version[version]
        if len(holders) > 1:
            detail = "; ".join(
                f"{root[:16]}..@{','.join(nodes)}"
                for root, nodes in sorted(holders.items())
            )
            out.append(
                Incident(
                    "root_divergence",
                    "",
                    "crit",
                    f"state roots diverge at version {version}: {detail}",
                    float(version),
                )
            )
    return out


def crit_regime_shift(
    regime_samples, confirm: int = 3, node: str = ""
) -> Incident | None:
    """The node's rolling commit critical-path regime changed and STUCK.

    ``regime_samples``: oldest-to-newest regime strings (one per health
    tick with enough commit samples; ticks without an attribution are
    simply not pushed).  Fires when the newest ``confirm`` consecutive
    samples agree on a regime different from the one established before
    them — a one-tick flap (a single slow round misclassified) never
    pages, but "this committee went from verify-bound to network-bound
    and stayed there" does.  Pure function: unit-testable with fixture
    windows like every other detector here.
    """
    seq = [r for r in regime_samples if r and r != "unknown"]
    if len(seq) < confirm + 1:
        return None
    head = seq[-confirm:]
    new = head[0]
    if any(r != new for r in head):
        return None  # the shift has not settled yet
    prev = None
    for r in reversed(seq[:-confirm]):
        if r != new:
            prev = r
            break
    if prev is None:
        return None
    return Incident(
        "crit_regime_shift",
        node,
        "warn",
        f"commit critical path shifted {prev} -> {new} "
        f"(confirmed over {confirm} ticks)",
        float(confirm),
    )


def epoch_skew(epochs_by_node: dict) -> list:
    """Committee-epoch disagreement across the live fleet:
    every node's ``core_epoch`` gauge should match once a
    reconfiguration boundary has passed — a node stuck on an older
    epoch missed (or refused) a certified schedule splice and will stop
    verifying new-epoch certificates.

    ``epochs_by_node``: node -> reported active epoch.  Fires one
    fleet-wide crit incident naming the head epoch and every laggard.
    A skew is legitimate only for the instants nodes cross the boundary
    a round apart, so callers tolerate one-tick flaps; a *persisting*
    incident is the real signal.
    """
    fresh = {
        name: int(e) for name, e in epochs_by_node.items() if e is not None
    }
    if len(fresh) < 2:
        return []
    head = max(fresh.values())
    laggards = {n: e for n, e in sorted(fresh.items()) if e < head}
    if not laggards:
        return []
    detail = ", ".join(f"{n}@{e}" for n, e in laggards.items())
    return [
        Incident(
            "epoch_skew",
            "",
            "crit",
            f"fleet head epoch {head}, trailing: {detail}",
            float(head),
        )
    ]


# ---- campaign recorder -----------------------------------------------------

CAMPAIGN_SUFFIX = "-campaign.json"


class CampaignRecorder:
    """Bounded fixed-interval time-series ring of the key gauges.

    ``sample`` is rate-gated to ``interval_s`` and the ring is
    capacity-capped, so hours of campaign keep a fixed footprint: at
    the default 4096 samples x ~10 short keys the persisted JSON stays
    well under 1 MB.  ``persist`` rewrites atomically (tmp + rename)
    beside the journal as ``<node>-campaign.json`` — a name the journal
    loader's ``*.jsonl`` glob never matches.
    """

    def __init__(
        self,
        node: str,
        path: str | None = None,
        interval_s: float = 1.0,
        capacity: int = 4096,
    ):
        self.node = node
        self.path = path
        self.interval_s = interval_s
        self._samples: deque = deque(maxlen=capacity)
        self._last_t: float | None = None

    def sample(self, t: float, values: dict) -> bool:
        """Record one row when the interval gate opens; returns whether
        the row was taken."""
        if self._last_t is not None and t - self._last_t < self.interval_s:
            return False
        self._last_t = t
        self._samples.append({"t": round(t, 3), **values})
        return True

    def __len__(self) -> int:
        return len(self._samples)

    def to_json(self) -> dict:
        return {
            "node": self.node,
            "interval_s": self.interval_s,
            "samples": list(self._samples),
        }

    def persist(self) -> str | None:
        if self.path is None:
            return None
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, sort_keys=True)
        os.replace(tmp, self.path)
        return self.path

    @staticmethod
    def load(path: str) -> dict:
        with open(path, encoding="utf-8") as f:
            return json.load(f)


# ---- per-node monitor ------------------------------------------------------

#: ticks between campaign persists (interval-relative, ~every 30 s at
#: the default 1 s tick)
PERSIST_EVERY = 30

#: quiet ticks before an open incident is closed (hysteresis: a
#: detector flapping at threshold must not spray open/close edges)
CLEAR_AFTER = 2


class HealthMonitor:
    """The per-node online health loop.

    Samples the node's own telemetry snapshot once per ``interval_s``,
    feeds the node-local detectors (leader-stall via commit progress,
    view-change storm, commit collapse, shed storm, bandwidth storm),
    and turns firings
    into incident records on three surfaces at once: a
    ``health.<kind>`` open/close journal edge pair (the Perfetto
    incidents track), a ``Health incident: {json}`` log line (the
    ``+ HEALTH`` SUMMARY block), and the campaign ring.
    """

    def __init__(
        self,
        tel,
        node: str,
        timeout_s: float,
        interval_s: float = 1.0,
        stall_k: float = 3.0,
        campaign_path: str | None = None,
        logger=None,
        attribution_fn=None,
    ):
        self._tel = tel
        self.node = node
        self.timeout_s = max(timeout_s, 0.1)
        self.interval_s = interval_s
        self.stall_k = stall_k
        self._log = logger or log
        span = max(60.0, 4 * stall_k * self.timeout_s)
        self._w_commits = Window(span_s=span)
        self._w_tcs = Window(span_s=span)
        self._w_shed = Window(span_s=span)
        self._w_net = Window(span_s=span)
        self._tc_ewma: float | None = None
        self._net_ewma: float | None = None
        # rolling commit critical-path attribution: ``attribution_fn``
        # (wired by the node from telemetry.critpath.rolling_attribution
        # over the trace ring — this module stays import-free) returns
        # {"dominant", "regime", ...} or None when under-sampled
        self._attribution_fn = attribution_fn
        self._regimes: deque = deque(maxlen=32)
        self.last_attribution: dict | None = None
        self._open: dict = {}  # kind -> Incident
        self._quiet: dict = {}  # kind -> consecutive quiet ticks
        self.recorder = CampaignRecorder(
            node, campaign_path, interval_s=max(interval_s, 1.0)
        )
        self._ticks = 0

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                await asyncio.sleep(self.interval_s)
                try:
                    self.tick(loop.time())
                except Exception as e:  # noqa: BLE001 — never kill the node
                    self._log.warning("health tick failed: %s", e)
        finally:
            self.close()

    # -- one sampling tick (sync, also driven directly by tests) ---------

    def tick(self, now: float) -> list:
        snap = self._tel.snapshot()
        trace = snap.get("trace", {}) or {}
        ingest = snap.get("ingest", {}) or {}
        state = snap.get("state", {}) or {}
        flows = snap.get("flows", {}) or {}
        commits = float(trace.get("commits", 0) or 0)
        tcs = float(trace.get("tc_advances", 0) or 0)
        shed = float(ingest.get("shed_total", 0) or 0)
        net_tx = float(flows.get("tx_bytes", 0) or 0)
        round_ = int(trace.get("last_commit_round", 0) or 0)
        self._w_commits.push(now, commits)
        self._w_tcs.push(now, tcs)
        self._w_shed.push(now, shed)
        if flows.get("enabled"):
            self._w_net.push(now, net_tx)

        fired = []
        inc = leader_stall(
            self._w_commits.samples(),
            now,
            self.timeout_s,
            k=self.stall_k,
            node=self.node,
        )
        if inc:
            fired.append(inc)
        inc, self._tc_ewma = view_change_storm(
            self._w_tcs.samples(), self._tc_ewma, node=self.node
        )
        if inc:
            fired.append(inc)
        inc = commit_collapse(self._w_commits.samples(), node=self.node)
        if inc:
            fired.append(inc)
        inc = shed_storm(self._w_shed.samples(), node=self.node)
        if inc:
            fired.append(inc)
        inc, self._net_ewma = bandwidth_storm(
            self._w_net.samples(), self._net_ewma, node=self.node
        )
        if inc:
            fired.append(inc)
        if self._attribution_fn is not None:
            try:
                att = self._attribution_fn()
            except Exception:  # noqa: BLE001 — attribution is advisory
                att = None
            if att:
                self.last_attribution = att
                regime = att.get("regime")
                if regime:
                    self._regimes.append(regime)
                inc = crit_regime_shift(
                    list(self._regimes), node=self.node
                )
                if inc:
                    fired.append(inc)

        self._transition(fired, round_)

        if self.recorder.sample(
            now,
            {
                "round": round_,
                "commits": commits,
                "tcs": tcs,
                "shed": shed,
                "net_tx": net_tx,
                "credit": ingest.get("last_credit", 0),
                "version": state.get("version", 0),
                "incidents": len(self._open),
            },
        ):
            self._ticks += 1
            if self._ticks % PERSIST_EVERY == 0:
                self.recorder.persist()
        return fired

    def _transition(self, fired: list, round_: int) -> None:
        """Open/close incident edges with clear-side hysteresis."""
        now_kinds = {i.kind: i for i in fired}
        for kind, inc in now_kinds.items():
            self._quiet[kind] = 0
            if kind not in self._open:
                self._open[kind] = inc
                self._emit(inc, "open", round_)
        for kind in list(self._open):
            if kind in now_kinds:
                continue
            self._quiet[kind] = self._quiet.get(kind, 0) + 1
            if self._quiet[kind] >= CLEAR_AFTER:
                inc = self._open.pop(kind)
                self._quiet.pop(kind, None)
                self._emit(inc, "close", round_)

    def _emit(self, inc: Incident, phase: str, round_: int) -> None:
        doc = {**inc.to_json(), "phase": phase}
        self._log.info("Health incident: %s", json.dumps(doc, sort_keys=True))
        journal = getattr(self._tel, "journal", None)
        if journal is not None:
            journal.record(f"health.{inc.kind}", round_=round_, peer=phase)

    def open_incidents(self) -> list:
        return list(self._open.values())

    def close(self) -> None:
        """Final campaign persist (node shutdown)."""
        try:
            self.recorder.persist()
        except OSError as e:
            self._log.warning("campaign persist failed: %s", e)


__all__ = [
    "HEALTH_EDGE_PREFIX",
    "HEALTH_KINDS",
    "CAMPAIGN_SUFFIX",
    "DELTA_HISTORY",
    "flatten",
    "DeltaStream",
    "DeltaDecoder",
    "Window",
    "rate",
    "Incident",
    "leader_stall",
    "view_change_storm",
    "bandwidth_storm",
    "commit_collapse",
    "straggler",
    "shed_storm",
    "root_divergence",
    "epoch_skew",
    "crit_regime_shift",
    "CampaignRecorder",
    "HealthMonitor",
]
