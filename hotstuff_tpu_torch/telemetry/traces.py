"""Cross-node journal merge: the part of the reference harness's
``benchmark/traces.py`` that the commit critical path reads.

A copy of ``load_journals``, ``estimate_offsets`` and ``TraceSet``
trimmed to what ``telemetry/critpath.py`` ``analyze`` reads: ``.blocks``
(every block's propose, receive, vote, QC and commit stamps on
offset-corrected wall clocks), ``.nodes``, ``.payload_waits``,
``.journals``, ``.merge_stats`` and ``journal_coverage()``.  The
reference's plane spans, timeouts, summary and Chrome trace are left
out.  The sim runner attributes a run with it; it reads JSONL only.
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import defaultdict
from statistics import median

from .taxonomy import (
    BYZ_PREFIX,
    CONTROL_EDGES,
    HEALTH_PREFIX,
    INGEST_PREFIX,
    NET_PREFIX,
    RECONFIG_PREFIX,
)

_SEG_RE = re.compile(r"^(?P<prefix>.+)-(?P<seq>\d{6})\.jsonl$")

#: record kinds of the planes, which never reach a block's timeline
_PLANE_PREFIXES = (
    BYZ_PREFIX,
    HEALTH_PREFIX,
    INGEST_PREFIX,
    RECONFIG_PREFIX,
    NET_PREFIX,
)

#: records that name no block: producer waits are taken apart, the rest
#: (profiler spans, fault windows, timeouts) are not read here
_NOT_A_BLOCK = ("span", "fault.open", "fault.close", "timeout")


def load_journals(
    dir_path: str, stats: dict | None = None
) -> dict[str, list[dict]]:
    """node id -> that node's records, merged across ring segments and
    sorted by record sequence (falling back to monotonic time for
    journals predating the ``s`` field).  Torn lines (a crash mid-write)
    are skipped; the node id comes from each segment's meta line
    (filenames are sanitized and ambiguous).

    A crash-restarted node resumes its ring and can replay records whose
    sequence numbers were already persisted (a torn tail hides the true
    max seq) — duplicates are dropped by (node, seq), first occurrence
    wins.  When ``stats`` (a dict) is passed it is filled with the merge
    accounting: ``overlap`` (deduped records), ``loaded`` /``dropped``
    totals and per-node counts (``dropped`` comes from the ring's
    cumulative no-silent-caps counter in the meta lines)."""
    by_node: dict[str, list[dict]] = defaultdict(list)
    meta_drop: dict[str, int] = defaultdict(int)
    overlap = 0
    paths = sorted(glob.glob(os.path.join(dir_path, "*.jsonl")))
    for path in paths:
        node = None
        records = []
        drop = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn line (crash mid-write)
                if rec.get("e") == "meta":
                    node = rec.get("n", node)
                    drop = max(drop, int(rec.get("drop", 0) or 0))
                    continue
                records.append(rec)
        if node is None:
            # segment lost its meta line: fall back to the filename prefix
            m = _SEG_RE.match(os.path.basename(path))
            node = m.group("prefix") if m else os.path.basename(path)
        by_node[node].extend(records)
        meta_drop[node] = max(meta_drop[node], drop)
    for node, records in by_node.items():
        seen: set[int] = set()
        deduped = []
        for r in records:
            s = r.get("s")
            if isinstance(s, int):
                if s in seen:
                    overlap += 1
                    continue
                seen.add(s)
            deduped.append(r)
        # segment files sort chronologically, so first occurrence wins;
        # order by seq when the journal carries it (restart-safe — the
        # monotonic clock resets across boots, seqs don't)
        if len(seen) == len(deduped):
            deduped.sort(key=lambda r: r.get("s", 0))
        else:
            deduped.sort(key=lambda r: r.get("m", 0))
        by_node[node] = deduped
    if stats is not None:
        loaded = {n: len(rs) for n, rs in by_node.items()}
        stats["overlap"] = overlap
        stats["loaded"] = sum(loaded.values())
        stats["dropped"] = sum(meta_drop.values())
        stats["by_node"] = {
            n: {"loaded": loaded[n], "dropped": meta_drop.get(n, 0)}
            for n in by_node
        }
    return dict(by_node)


def estimate_offsets(
    journals: dict[str, list[dict]],
    warnings: list | None = None,
) -> tuple[dict[str, int], str | None]:
    """(offsets, reference): per-node wall-clock offset in ns relative
    to the reference node (``corrected = w - offset[node]``).  Per
    directed pair the MEDIAN matched send/recv delta is used (robust to
    scheduling-spike outliers); nodes with no matched message pair to
    the connected component degrade gracefully to offset 0 (their
    cross-node edges are then only as good as NTP) with a line appended
    to ``warnings`` when a list is passed — never a crash."""
    # send-side indexes: who proposed each digest (and when), and when
    # each node sent its vote for each digest
    propose_at: dict[str, tuple[str, int]] = {}
    vote_sent: dict[tuple[str, str], int] = {}
    for node, records in journals.items():
        for r in records:
            e = r.get("e")
            d, w = r.get("d"), r.get("w")
            if d is None or w is None:
                continue
            if e == "propose" and d not in propose_at:
                propose_at[d] = (node, w)
            elif e == "vote.send":
                vote_sent.setdefault((d, node), w)

    # every observed one-way delta per directed pair (sender, receiver)
    deltas: dict[tuple[str, str], list[int]] = defaultdict(list)

    for node, records in journals.items():
        for r in records:
            e = r.get("e")
            d, w = r.get("d"), r.get("w")
            if d is None or w is None:
                continue
            if e == "recv.propose":
                src = propose_at.get(d)
                if src is not None and src[0] != node:
                    deltas[(src[0], node)].append(w - src[1])
            elif e == "recv.vote":
                peer = r.get("p", "")
                sent = vote_sent.get((d, peer))
                if sent is not None and peer != node:
                    deltas[(peer, node)].append(w - sent)

    # symmetric pairwise offsets where both directions were measured
    pair_offset: dict[tuple[str, str], float] = {}
    adjacency: dict[str, set[str]] = defaultdict(set)
    for (a, b), d_ab in deltas.items():
        d_ba = deltas.get((b, a))
        if d_ba is None or (a, b) in pair_offset:
            continue
        # clock(b) - clock(a), delay cancelled under symmetric medians
        off = (median(d_ab) - median(d_ba)) / 2.0
        pair_offset[(a, b)] = off
        pair_offset[(b, a)] = -off
        adjacency[a].add(b)
        adjacency[b].add(a)

    nodes = sorted(journals)
    if not nodes:
        return {}, None
    reference = max(nodes, key=lambda n: (len(adjacency.get(n, ())), n))
    offsets: dict[str, int] = {n: 0 for n in nodes}
    seen = {reference}
    frontier = [reference]
    while frontier:
        a = frontier.pop()
        for b in adjacency.get(a, ()):
            if b in seen:
                continue
            offsets[b] = offsets[a] + int(pair_offset[(a, b)])
            seen.add(b)
            frontier.append(b)
    if warnings is not None and len(nodes) > 1:
        for n in nodes:
            if n not in seen:
                warnings.append(
                    f"node {n}: no matched send/recv pair to reference"
                    f" {reference}; clock offset defaulted to 0"
                )
    return offsets, reference


class TraceSet:
    """A run's merged, clock-aligned per-block timelines."""

    def __init__(
        self,
        journals: dict[str, list[dict]],
        merge_stats: dict | None = None,
    ):
        self.journals = journals
        self.nodes = sorted(journals)
        # merge accounting from load_journals (dedup overlap, ring-drop
        # counters): critpath's journal-coverage figure reads these
        self.merge_stats: dict = merge_stats or {}
        self.offset_warnings: list[str] = []
        self.offsets, self.reference = estimate_offsets(
            journals, self.offset_warnings
        )
        # digest -> timeline; every (m, w) pair below is (node-local
        # monotonic ns, offset-corrected wall ns)
        self.blocks: dict[str, dict] = {}
        # producer-channel edges: per-payload wait from the leader's
        # recv.producer to its payload.first, ms on that node's
        # monotonic clock
        self.payload_waits: list[float] = []
        self._reconstruct()

    @classmethod
    def load(cls, dir_path: str) -> "TraceSet":
        stats: dict = {}
        return cls(load_journals(dir_path, stats), merge_stats=stats)

    def journal_coverage(self) -> float:
        """Fraction of journaled records still in the ring at merge time
        (1.0 = nothing rotated away)."""
        loaded = self.merge_stats.get("loaded", 0)
        dropped = self.merge_stats.get("dropped", 0)
        if not dropped:
            return 1.0
        return loaded / float(loaded + dropped)

    def _corr(self, node: str, w: int) -> int:
        return w - self.offsets.get(node, 0)

    def _block(self, digest: str, round_: int) -> dict:
        info = self.blocks.get(digest)
        if info is None:
            info = self.blocks[digest] = {
                "round": round_,
                "leader": None,
                "propose": None,  # (m, w_corr) at the leader
                "recv": {},  # node -> (m, w_corr), first arrival
                "vote_send": {},  # node -> (m, w_corr)
                "recv_vote": {},  # voter -> (recv node, m, w_corr), first
                "qc_form": None,  # (node, m, w_corr), QC assembled
                "qc": None,  # (node, m, w_corr), first high-QC adoption
                "commit": {},  # node -> (m, w_corr)
            }
        elif round_ and not info["round"]:
            info["round"] = round_
        return info

    def _reconstruct(self) -> None:
        for node, records in self.journals.items():
            producer_seen: dict[str, int] = {}  # digest -> monotonic ns
            for r in records:
                e = r["e"]
                if e.startswith(_PLANE_PREFIXES) or e in CONTROL_EDGES:
                    continue
                if e == "recv.producer":
                    producer_seen.setdefault(r["d"], r["m"])
                    continue
                if e == "payload.first":
                    got = producer_seen.get(r["d"])
                    if got is not None:
                        self.payload_waits.append((r["m"] - got) / 1e6)
                    continue
                if e in _NOT_A_BLOCK:
                    continue
                stamp = (r["m"], self._corr(node, r["w"]))
                info = self._block(r["d"], r["r"])
                if e == "propose":
                    if info["propose"] is None:
                        info["leader"] = node
                        info["propose"] = stamp
                elif e == "recv.propose":
                    if node not in info["recv"]:
                        info["recv"][node] = stamp
                elif e == "vote.send":
                    info["vote_send"].setdefault(node, stamp)
                elif e == "recv.vote":
                    voter = r.get("p", "")
                    if voter and voter not in info["recv_vote"]:
                        info["recv_vote"][voter] = (node, r["m"], stamp[1])
                elif e == "qc.form":
                    if info["qc_form"] is None:
                        info["qc_form"] = (node, r["m"], stamp[1])
                elif e == "qc":
                    if info["qc"] is None:
                        info["qc"] = (node, r["m"], stamp[1])
                elif e == "commit":
                    info["commit"].setdefault(node, stamp)


__all__ = ["TraceSet", "estimate_offsets", "load_journals"]
