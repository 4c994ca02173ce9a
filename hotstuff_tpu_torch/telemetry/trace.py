"""Per-round block-lifecycle trace recorder.

A copy of ``hotstuff_tpu.telemetry.trace``; ``clock=`` is injectable, so
one fake clock can drive both packages' recorders.

Timestamps the edges a block crosses on its way to commit — as seen by
THIS node (every node runs its own recorder; the harness compares them
across logs):

    payload-received .. proposed      (payload_wait, observed by the
                                       proposer at make time)
    proposed -> first-vote            (propose_to_vote)
    first-vote -> QC-formed           (vote_to_qc)
    QC-formed -> committed            (qc_to_commit)
    proposed -> committed             (propose_to_commit, the end-to-end
                                       per-block consensus latency)

plus the view-change edges (local timeouts, TC-driven round advances,
round gaps across a view change).

Hot-path cost model: one ``mark_*`` is a dict lookup plus scalar writes
into a preallocated 5-slot record; the record itself (one small list) is
allocated once per *proposal*, never per message or per signature.  The
open-record map and the completed-round ring are both bounded, so a
flood of never-committing proposals cannot grow memory.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque

from .metrics import Registry

# Open-record slots (one list per block in flight).
_ROUND = 0
_T_PROPOSED = 1
_T_VOTE = 2
_T_QC = 3

#: lifecycle edges reported per committed block, in causal order
EDGES = ("propose_to_vote", "vote_to_qc", "qc_to_commit", "propose_to_commit")

#: open records kept (proposals whose fate is undecided)
DEFAULT_CAPACITY = 4_096
#: completed per-round records kept for inspection (the ring buffer)
DEFAULT_RING = 256


class TraceRecorder:
    """Bounded per-block lifecycle recorder + per-edge histograms.

    ``labels`` (typically ``{"node": <id>}``) distinguish co-located
    nodes sharing one process-wide registry.
    """

    def __init__(
        self,
        registry: Registry,
        labels: dict | None = None,
        capacity: int = DEFAULT_CAPACITY,
        ring: int = DEFAULT_RING,
        clock=time.monotonic,
    ):
        labels = labels or {}
        self._clock = clock
        self._capacity = capacity
        # digest bytes -> [round, t_proposed, t_first_vote, t_qc_formed]
        self._open: OrderedDict[bytes, list] = OrderedDict()
        # completed round records, newest last (bounded ring)
        self.ring: deque = deque(maxlen=ring)
        self.hist = {
            edge: registry.histogram(
                "commit_edge_seconds",
                "Block lifecycle edge latency as seen by this node",
                {**labels, "edge": edge},
            )
            for edge in EDGES
        }
        self.payload_wait = registry.histogram(
            "payload_wait_seconds",
            "Payload buffered at the proposer before entering a block",
            dict(labels),
        )
        self.commits = registry.counter(
            "committed_blocks_total", "Blocks committed", dict(labels)
        )
        self.timeouts = registry.counter(
            "local_timeouts_total", "Local round timeouts fired", dict(labels)
        )
        self.tcs = registry.counter(
            "tc_advances_total", "Round advances driven by a TC", dict(labels)
        )
        self.round_gap = registry.histogram(
            "commit_round_gap",
            "Rounds between consecutive commits (1 = no view change)",
            dict(labels),
            bounds=tuple(float(2**i) for i in range(10)),
        )
        self._last_commit_round = 0

    # ---- lifecycle marks (hot path) ------------------------------------

    def mark_proposed(self, digest: bytes, round_: int) -> None:
        """First sighting of a (verified) proposal for ``round_``."""
        if digest in self._open:
            return
        if len(self._open) >= self._capacity:
            self._open.popitem(last=False)
        self._open[digest] = [round_, self._clock(), 0.0, 0.0]

    def mark_first_vote(self, digest: bytes) -> None:
        rec = self._open.get(digest)
        if rec is not None and not rec[_T_VOTE]:
            rec[_T_VOTE] = self._clock()

    def mark_qc_formed(self, digest: bytes) -> None:
        rec = self._open.get(digest)
        if rec is not None and not rec[_T_QC]:
            rec[_T_QC] = self._clock()

    def mark_committed(self, digest: bytes, round_: int = 0) -> None:
        now = self._clock()
        rec = self._open.pop(digest, None)
        self.commits.inc()
        if rec is None:
            # committed via chain walk without ever being seen as a
            # proposal (sync'd ancestor) — count it, no edge samples
            return
        round_ = rec[_ROUND] or round_
        if self._last_commit_round:
            self.round_gap.observe(float(round_ - self._last_commit_round))
        self._last_commit_round = round_
        t_prop, t_vote, t_qc = rec[_T_PROPOSED], rec[_T_VOTE], rec[_T_QC]
        entry = {"round": round_, "digest": digest[:8].hex()}
        if t_vote:
            self.hist["propose_to_vote"].observe(t_vote - t_prop)
            entry["propose_to_vote_ms"] = round((t_vote - t_prop) * 1e3, 3)
        if t_qc and t_vote:
            self.hist["vote_to_qc"].observe(t_qc - t_vote)
            entry["vote_to_qc_ms"] = round((t_qc - t_vote) * 1e3, 3)
        if t_qc:
            self.hist["qc_to_commit"].observe(now - t_qc)
            entry["qc_to_commit_ms"] = round((now - t_qc) * 1e3, 3)
        self.hist["propose_to_commit"].observe(now - t_prop)
        entry["propose_to_commit_ms"] = round((now - t_prop) * 1e3, 3)
        self.ring.append(entry)

    def mark_timeout(self) -> None:
        self.timeouts.inc()

    def mark_tc_advance(self) -> None:
        self.tcs.inc()

    # ---- snapshot (off the hot path) -----------------------------------

    def open_count(self) -> int:
        return len(self._open)

    def recent(self, n: int = 16) -> list[dict]:
        """The newest ``n`` completed per-round trace records."""
        if n >= len(self.ring):
            return list(self.ring)
        return list(self.ring)[-n:]

    def to_json(self) -> dict:
        return {
            "commits": self.commits.value,
            "timeouts": self.timeouts.value,
            "tc_advances": self.tcs.value,
            "last_commit_round": self._last_commit_round,
            "open_traces": len(self._open),
            "edges": {e: self.hist[e].to_json() for e in EDGES},
            "payload_wait": self.payload_wait.to_json(),
            "round_gap": self.round_gap.to_json(scale=1.0, unit="rounds"),
        }


__all__ = ["TraceRecorder", "EDGES", "DEFAULT_CAPACITY", "DEFAULT_RING"]
