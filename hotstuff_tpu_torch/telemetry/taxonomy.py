"""Central span-stage and journal-edge taxonomy.

A copy of ``hotstuff_tpu.telemetry.taxonomy``: every span stage name
(``telemetry/spans.py``), every journal edge name (``telemetry/journal.py``
records) and every critical-path stage is registered here, with the
same names and groups as the reference, so a journal a port node writes
merges with a JAX node's in ``benchmark/traces.py`` and renders on the
same tracks.

Adding an edge or stage is a two-line change: record it at the call
site, register it here (with the rendering group it belongs to).  The
reference's lint plane checks the call sites against these tables; the
port has no lint plane yet, so its tests compare the tables with the
reference's.

This module is a pure-constant leaf: stdlib only, no imports.
"""

# ---- verify-pipeline span stages (telemetry/spans.py) ----------------------

#: leaf stages, in pipeline order — the canonical waterfall rows; spans
#: with other names (parents, ad-hoc) are recorded but never summed
SPAN_LEAF_STAGES: tuple = (
    "coalesce.wait",
    "native.pack",
    "route.decide",
    "pipeline.wait",
    "stage.pack",
    "stage.slot_wait",
    "queue.wait",
    "flatten",
    "prepare",
    "dispatch",
    "device.execute",
    "mesh.psum",
    "readback",
    "host.verify",
    "host.pairing",
    "verdict.fanout",
)

#: frame spans: overlap the leaves, excluded from waterfall sums
SPAN_PARENT_STAGES: tuple = (
    "e2e",
    "dispatch.wall",
    "agg.verify",
    "scheme.route",
)

#: value annotations: span records whose duration field encodes a VALUE
#: (e.g. in-flight wave depth), excluded from waterfall sums and
#: rendered as counter series
SPAN_ANNOTATION_STAGES: tuple = ("pipeline.occupancy",)

#: BLS-aggregation detail stages (the reference's BLS service and its
#: device aggregation): sub-phases of the ``agg.verify`` parent frame —
#: recorded and histogrammed, never waterfall rows.
SPAN_AGG_STAGES: tuple = (
    "agg.gather",
    "agg.keysum",
    "agg.pairing",
    "agg.accumulate",
    "agg.snapshot",
)

#: every registered span stage name (what ``span("...")`` /
#: ``rec.add("...")`` call sites are checked against)
SPAN_STAGES: frozenset = frozenset(
    SPAN_LEAF_STAGES
    + SPAN_PARENT_STAGES
    + SPAN_ANNOTATION_STAGES
    + SPAN_AGG_STAGES
)

# ---- journal edges (telemetry/journal.py records) --------------------------

#: block-lifecycle edges: ``traces.py`` folds these into per-block
#: cross-node timelines (propose anchor, receive fan-out, vote, QC,
#: commit)
BLOCK_EDGES: tuple = (
    "propose",
    "recv.propose",
    "vote.send",
    "recv.vote",
    "qc.form",
    "qc",
    "commit",
)

#: control-plane edges: journaled for the SUMMARY/debugging but
#: excluded from per-block reconstruction (several carry no digest)
CONTROL_EDGES: tuple = (
    "tc",
    "round.enter",
    "recv.timeout",
    "recv.tc",
    "sync.req",
    "sync.reply",
    "sync.done",
    "sync.expire",
    "sync.serve",
    "sync.manifest",
    "sync.chunk",
    "sync.adopt",
    "recv.sync_req",
    "recv.state_req",
    "state.apply",
    "recv.reconfig",
)

#: producer-channel edges: leader-side payload wait attribution
PAYLOAD_EDGES: tuple = ("recv.producer", "payload.first")

#: admission-plane edges: value records (shed count / credit window in
#: the ``u`` field), rendered as the ingest-plane track
INGEST_EDGES: tuple = ("ingest.shed", "ingest.credit")

#: zero-copy ingest metrics: registry counter names for
#: waves the verify service adopted straight from a native staging
#: arena vs. vote-overlapping waves that had to fall back to the
#: Python flatten path (disjoint non-vote waves count as neither).
#: The hit rate zc/(zc+fb) is surfaced on the verify stats line
#: (``zc=``/``fb=``).
INGEST_COUNTERS: tuple = ("ingest_zero_copy_waves", "ingest_fallback_waves")

#: standalone edges: local timeout complaints, the profiler fan-out
#: record (stage in ``p``, duration in ``u``), and each ring segment's
#: identity line
MISC_EDGES: tuple = ("timeout", "span", "meta")

#: dynamic edge families: the chaos plane journals ``fault.<kind>``,
#: the adversary plane ``byz.<kind>``, the health plane
#: ``health.<kind>`` (telemetry/health.py detector incidents, open/close
#: in the peer field; the fleet-level ``health.epoch_skew`` rides the
#: same family) with scenario-/detector-defined kinds, and the live
#: reconfiguration plane ``reconfig.<step>`` (submit/commit/activate/
#: retire/link — consensus/core.py, reconfig.py); an f-string edge is
#: registered iff its constant prefix is listed here
FAULT_PREFIX = "fault."
BYZ_PREFIX = "byz."
INGEST_PREFIX = "ingest."
HEALTH_PREFIX = "health."
RECONFIG_PREFIX = "reconfig."
NET_PREFIX = "net."
JOURNAL_EDGE_PREFIXES: tuple = (
    FAULT_PREFIX,
    BYZ_PREFIX,
    HEALTH_PREFIX,
    RECONFIG_PREFIX,
    NET_PREFIX,
)

# ---- wire-level flow classes (telemetry/flows.py) --------------------------

#: every message class the flow accounting plane charges a frame to —
#: derived from the wire-tag taxonomy (consensus/wire.py first byte;
#: ``telemetry/flows.py`` owns the byte->class map, and
#: ``tests/test_torch_flows.py`` cross-checks it against the live wire
#: constants so tag drift is a test failure, not a silently-mislabelled
#: flow).  ``qc-compact`` wire cost rides inside ``propose`` frames and
#: is reported from the aggregator telemetry next to these classes.
FLOW_CLASSES: tuple = (
    "propose",
    "vote",
    "timeout",
    "tc",
    "sync-req",
    "producer-v1",
    "producer-v2",
    "ingest-ack",
    "state-sync",
    "reconfig",
    "ack",
    "other",
)

#: flow directions: every accounted frame is charged to exactly one
#: ``(peer, direction, class)`` flow at its send and its receive site
FLOW_DIRECTIONS: tuple = ("tx", "rx")

#: every registered static journal edge name (what ``journal.record``
#: call sites are checked against)
JOURNAL_EDGES: frozenset = frozenset(
    BLOCK_EDGES + CONTROL_EDGES + PAYLOAD_EDGES + INGEST_EDGES + MISC_EDGES
)


# ---- commit critical-path stages (telemetry/critpath.py) -------------------

#: critical-path stage taxonomy: every stage the commit critical-path
#: engine (``telemetry/critpath.py``) attributes latency to.  Two-round
#: chained-HotStuff commit means the per-round stages (net.propose,
#: vote.local, net.vote, agg.form) each appear once per chained round
#: and sum into one bucket.  ``unattributed`` is the residual between
#: the measured propose->commit wall and the sum of reconstructed
#: segments — rendered, never hidden.
CRITPATH_STAGES: tuple = (
    "ingest.wait",  # leader payload wait: producer recv -> propose
    "net.propose",  # propose broadcast -> quorum-th replica receive
    "vote.local",  # replica receive -> vote send (verify + sign)
    "net.vote",  # vote send -> receive at the aggregating node
    "agg.form",  # quorum-th vote receive -> QC assembled
    "lead.handoff",  # QC formed -> next-round proposal broadcast
    "commit.exec",  # chained QC formed -> commit observed at the node
    "unattributed",  # residual: measured total minus reconstructed sum
)

#: regime classification: which stage buckets vote for which regime —
#: the argmax group over attributed milliseconds names the run
CRITPATH_REGIMES: dict = {
    "ingest-bound": ("ingest.wait",),
    "network-bound": ("net.propose", "net.vote", "commit.exec"),
    "verify-bound": ("vote.local",),
    "aggregation-bound": ("agg.form", "lead.handoff"),
}


def is_registered_edge(name: str) -> bool:
    """Is ``name`` a registered journal edge (static or dynamic)?"""
    return name in JOURNAL_EDGES or name.startswith(JOURNAL_EDGE_PREFIXES)


def is_registered_stage(name: str) -> bool:
    """Is ``name`` a registered verify-pipeline span stage?"""
    return name in SPAN_STAGES


__all__ = [
    "SPAN_LEAF_STAGES",
    "SPAN_PARENT_STAGES",
    "SPAN_ANNOTATION_STAGES",
    "SPAN_AGG_STAGES",
    "SPAN_STAGES",
    "BLOCK_EDGES",
    "CONTROL_EDGES",
    "PAYLOAD_EDGES",
    "INGEST_EDGES",
    "INGEST_COUNTERS",
    "MISC_EDGES",
    "FAULT_PREFIX",
    "BYZ_PREFIX",
    "INGEST_PREFIX",
    "HEALTH_PREFIX",
    "RECONFIG_PREFIX",
    "NET_PREFIX",
    "FLOW_CLASSES",
    "FLOW_DIRECTIONS",
    "JOURNAL_EDGE_PREFIXES",
    "JOURNAL_EDGES",
    "CRITPATH_STAGES",
    "CRITPATH_REGIMES",
    "is_registered_edge",
    "is_registered_stage",
]
