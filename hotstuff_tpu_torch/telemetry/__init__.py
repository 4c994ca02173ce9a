"""hotstuff_tpu_torch.telemetry — the permanent attribution layer.

A copy of ``hotstuff_tpu.telemetry``: the registry and its switches,
the node handles, the snapshot, export and trace documents, the
flight-recorder directory, the health switch, the network, store and
work-stats wiring, and the wire-level flow accounting
(``attach_flows``, ``telemetry/flows.py``).

Three pieces:

1. **Per-round trace recorder** (``trace.py``): timestamps each block's
   lifecycle edges (proposed -> first-vote -> QC-formed -> committed,
   plus view-change/timeout edges) into a bounded ring buffer with
   fixed log-bucket latency histograms.
2. **Component gauges/counters** (``metrics.py`` instruments): the
   crypto verify services, the network senders/pools, and the store
   self-register into one process-wide :class:`Registry`, labelled per
   node (co-located committees share the process).
3. **Export** (``exporter.py``): an optional stdlib-only HTTP
   ``/metrics`` endpoint (Prometheus text format, off by default) plus
   a periodic ``Telemetry snapshot: {json}`` log line whose document is
   a superset of the ``Work stats:`` one (the scaling harness's scrape
   contract is subsumed, not broken).

Enablement: ``HOTSTUFF_TELEMETRY=1``, or setting a metrics port
(``--metrics-port`` / ``HOTSTUFF_METRICS_PORT`` — a scrape endpoint
implies collection), or :func:`enable` from code.  Disabled (the
default), ``for_node`` returns ``None`` and every consensus hook is a
single ``if tel is not None`` — no per-message allocation, no writes.

Overhead budget when enabled: each lifecycle mark is a dict lookup plus
scalar stores; each histogram observe is a bisect over a static bound
tuple plus three scalar updates; gauges are pull-model (evaluated at
scrape/snapshot time only).  Nothing on the hot path allocates
per-message; per-*proposal* records (one small list each) are the only
steady-state allocation and both record maps are bounded.
"""

from __future__ import annotations

import os
from typing import Callable

from .metrics import (
    LATENCY_BOUNDS_S,
    SIZE_BOUNDS,
    Counter,
    FloatCounter,
    Gauge,
    Histogram,
    Registry,
)
from .trace import EDGES, TraceRecorder
from . import spans

_REGISTRY = Registry()
_NODES: dict[str, "NodeTelemetry"] = {}
_FORCED = False
_JOURNAL_DIR: str | None = None  # forced via --journal-dir

#: per-PEER network gauges (``net_peer_*``) are registered for at most
#: this many peers per sender role — label cardinality stays bounded at
#: any committee size.  Peers beyond the cap are NEVER silently dropped
#: (no silent caps): a ``net_peers_elided`` gauge counts them, the
#: snapshot's ``net.peer`` block ranks ALL peers by flow bytes and shows
#: the top-K, and byte totals always cover everyone.
PEER_GAUGE_MAX_COMMITTEE = 8


def registry() -> Registry:
    """The process-wide instrument registry (what /metrics renders)."""
    return _REGISTRY


def enable() -> None:
    """Force-enable telemetry for this process (the CLI calls this when
    a metrics port is configured)."""
    global _FORCED
    _FORCED = True


def enabled() -> bool:
    if _FORCED:
        return True
    if journal_enabled():
        # the flight recorder rides on the NodeTelemetry handle, so
        # journaling implies collection
        return True
    if spans.enabled():
        # the span profiler feeds verify_stage_ms histograms, so
        # profiling implies collection too
        return True
    env = os.environ.get("HOTSTUFF_TELEMETRY")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no", "off")
    return bool(os.environ.get("HOTSTUFF_METRICS_PORT"))


def set_journal_dir(path: str | None) -> None:
    """Force-enable journaling into ``path`` (the CLI's --journal-dir)."""
    global _JOURNAL_DIR
    _JOURNAL_DIR = path


def journal_enabled() -> bool:
    """Is the flight recorder (telemetry/journal.py) on?  Off by
    default: ``HOTSTUFF_JOURNAL=1``, ``HOTSTUFF_JOURNAL_DIR=<dir>``, or
    ``--journal-dir`` enable it."""
    if _JOURNAL_DIR is not None:
        return True
    env = os.environ.get("HOTSTUFF_JOURNAL")
    if env is not None and env.strip().lower() not in (
        "", "0", "false", "no", "off",
    ):
        return True
    return bool(os.environ.get("HOTSTUFF_JOURNAL_DIR"))


def journal_dir(store_path: str) -> str | None:
    """The journal directory for a node at ``store_path``, or None when
    journaling is off.  Resolution: --journal-dir, then
    HOTSTUFF_JOURNAL_DIR, then ``<store_path>.journal`` (the "under the
    node's store path" default)."""
    if not journal_enabled():
        return None
    if _JOURNAL_DIR is not None:
        return _JOURNAL_DIR
    env = os.environ.get("HOTSTUFF_JOURNAL_DIR", "").strip()
    if env:
        return env
    return f"{store_path}.journal"


def for_node(name) -> "NodeTelemetry | None":
    """The node's telemetry handle, or None when telemetry is off —
    callers guard every hook with ``if tel is not None``."""
    if not enabled():
        return None
    key = str(name)
    tel = _NODES.get(key)
    if tel is None:
        tel = _NODES[key] = NodeTelemetry(key)
    return tel


def snapshot_all() -> dict:
    """One snapshot document per node in this process (/snapshot)."""
    return {n: t.snapshot() for n, t in _NODES.items()}


def health_enabled() -> bool:
    """Is the per-node health monitor (telemetry/health.py) on?  Off by
    default: ``HOTSTUFF_HEALTH=1`` / ``--health`` enable it."""
    env = os.environ.get("HOTSTUFF_HEALTH")
    return env is not None and env.strip().lower() not in (
        "", "0", "false", "no", "off",
    )


def export_doc() -> dict:
    """The health-plane export document (``/delta``): every node's
    snapshot sections (state-root cursor, ingest, trace) plus every
    node-labelled registry instrument under a ``metrics`` block — the
    nested doc the DeltaStream flattens into delta frames."""
    doc = snapshot_all()
    for inst in _REGISTRY:
        labels = getattr(inst, "labels", None) or {}
        node = labels.get("node")
        if node is None or node not in doc:
            continue
        key = inst.name
        extra = sorted(
            (k, v) for k, v in labels.items() if k != "node"
        )
        if extra:
            key += "{" + ",".join(f"{k}={v}" for k, v in extra) + "}"
        doc[node].setdefault("metrics", {})[key] = inst.to_json()
    return doc


def trace_all(n: int = 32) -> dict:
    """The newest completed per-round trace records per node (/trace)."""
    return {name: t.trace.recent(n) for name, t in _NODES.items()}


def reset() -> None:
    """Drop all registered instruments and node handles (tests only)."""
    global _REGISTRY, _FORCED, _JOURNAL_DIR
    _REGISTRY = Registry()
    _NODES.clear()
    _FORCED = False
    _JOURNAL_DIR = None
    spans.disable()


async def maybe_start_server(port: int | None, host: str = "0.0.0.0"):
    """Start the /metrics endpoint when ``port`` is configured (0 =
    ephemeral, logged at startup); returns the server or None."""
    if port is None:
        return None
    from .exporter import MetricsServer

    enable()
    return await MetricsServer(_REGISTRY, host=host, port=port).start()


class NodeTelemetry:
    """Per-node facade over the shared registry: the trace recorder,
    node-labelled instrument constructors, and the snapshot document.

    Components contribute to the snapshot either through instruments
    (labelled with this node) or through ``add_section(name, fn)`` —
    ``fn`` is evaluated at snapshot time (pull model)."""

    def __init__(self, node: str, registry: Registry | None = None):
        self.node = str(node)
        self.registry = registry if registry is not None else _REGISTRY
        self.labels = {"node": self.node}
        self.trace = TraceRecorder(self.registry, self.labels)
        self.workstats = None  # utils.workstats.WorkStats, attached by Node
        self.journal = None  # telemetry.journal.Journal, attached by Node
        self.flows = None  # telemetry.flows.FlowAccounting, attached by Consensus.spawn
        self._sections: dict[str, Callable[[], dict]] = {}
        self._senders: list[tuple[str, object]] = []
        # peer short-name -> [(sender, address)]: feeds the per-peer
        # snapshot block at small committee sizes (register_network)
        self._peer_conns: dict[str, list[tuple[object, object]]] = {}

    # ---- instrument constructors (node-labelled) -----------------------

    def counter(self, name: str, help_: str = "") -> Counter:
        return self.registry.counter(name, help_, dict(self.labels))

    def float_counter(self, name: str, help_: str = "") -> FloatCounter:
        return self.registry.float_counter(name, help_, dict(self.labels))

    def gauge(self, name: str, help_: str = "", fn=None) -> Gauge:
        return self.registry.gauge(name, help_, dict(self.labels), fn=fn)

    def histogram(
        self, name: str, help_: str = "", bounds=LATENCY_BOUNDS_S
    ) -> Histogram:
        return self.registry.histogram(
            name, help_, dict(self.labels), bounds=bounds
        )

    # ---- component registration ----------------------------------------

    def attach_workstats(self, stats) -> None:
        self.workstats = stats

    def attach_journal(self, journal) -> None:
        """Attach the node's flight recorder (telemetry/journal.py);
        consensus actors pick it up as ``telemetry.journal`` at boot."""
        self.journal = journal
        self.add_section("journal", journal.stats)

    def attach_flows(self, flows) -> None:
        """Attach the node's wire-level flow accountant
        (telemetry/flows.py): snapshot section, /metrics byte gauges,
        and the sampled ``net.tx``/``net.rx`` journal records."""
        self.flows = flows
        flows.bind_journal(lambda: self.journal)
        self.add_section("flows", flows.snapshot)
        if not flows.enabled:
            return
        self.gauge(
            "net_tx_bytes",
            "Wire bytes written across all links (frames + prefixes)",
            fn=flows.tx_bytes,
        )
        self.gauge(
            "net_rx_bytes",
            "Wire bytes read across all links (frames + prefixes)",
            fn=flows.rx_bytes,
        )
        self.gauge(
            "net_retx_bytes",
            "Wire bytes retransmitted by reliable links (subset of tx)",
            fn=flows.retx_bytes,
        )

    def add_section(self, name: str, fn: Callable[[], dict]) -> None:
        self._sections[name] = fn

    def register_store(self, store) -> None:
        engine = getattr(store, "engine", None)
        if engine is not None and hasattr(engine, "__len__"):
            self.gauge(
                "store_keys",
                "Live keys in the node's store engine",
                fn=lambda e=engine: len(e),
            )

    def register_network(self, role: str, sender, peers=None) -> None:
        """Wire pull gauges over a sender's pool: occupancy, idle-LRU
        evictions, per-peer retry/backoff state, pacing stalls.  Counts
        from evicted connections age out with them (live-peer view).

        ``peers``: optional [(public key, address)] of this sender's
        live peers (wired by Consensus.spawn at EVERY committee size) —
        per-PEER gauges are exported under ``net_peer_*`` in /metrics
        for the first PEER_GAUGE_MAX_COMMITTEE peers, the rest counted
        by ``net_peers_elided`` (never silently dropped), and a ranked
        ``net.peer`` block appears in the snapshot."""
        self._senders.append((role, sender))
        labels = {**self.labels, "role": role}
        reg = self.registry

        def conns(s=sender):
            return getattr(s, "_connections", {}).values()

        reg.gauge(
            "net_pool_connections",
            "Live connections in the sender's pool",
            labels,
            fn=lambda: len(conns()),
        )
        reg.gauge(
            "net_pool_evictions",
            "Idle connections LRU-evicted by the pool bound",
            labels,
            fn=lambda s=sender: getattr(s, "pool_evictions", 0),
        )
        reg.gauge(
            "net_peers_retrying",
            "Live peers currently disconnected (connect-retry/backoff)",
            labels,
            fn=lambda: sum(
                1 for c in conns() if getattr(c, "_writer", None) is None
            ),
        )
        reg.gauge(
            "net_connect_failures",
            "Connect attempts failed across live connections",
            labels,
            fn=lambda: sum(
                getattr(c, "connect_failures", 0) for c in conns()
            ),
        )
        reg.gauge(
            "net_queued_messages",
            "Messages queued across the sender's connections",
            labels,
            fn=lambda: sum(c.queue.qsize() for c in conns()),
        )
        if hasattr(type(sender), "pacing_stalls"):
            reg.gauge(
                "net_broadcast_pacing_stalls",
                "Bounded-pool broadcast chunks that waited for drain",
                labels,
                fn=lambda s=sender: s.pacing_stalls,
            )
        reg.gauge(
            "net_backoff_jitter",
            "Reconnect retries whose backoff sleep was jittered "
            "(stampede-avoided reconnects)",
            labels,
            # asyncio reliable connections count per connection; the
            # native reliable sender keeps one process-wide counter
            fn=lambda s=sender: sum(
                getattr(c, "jittered_retries", 0)
                for c in getattr(s, "_connections", {}).values()
            )
            + getattr(s, "jittered_retries", 0),
        )
        if peers:
            peers = list(peers)
            reg.gauge(
                "net_peers_elided",
                "Peers beyond the per-peer gauge cap (still fully "
                "counted in flow totals and the ranked snapshot block)",
                labels,
                fn=lambda n=max(
                    0, len(peers) - PEER_GAUGE_MAX_COMMITTEE
                ): n,
            )
            for peer_name, address in peers[:PEER_GAUGE_MAX_COMMITTEE]:
                self._register_peer(role, sender, peer_name, address)
            # beyond the gauge cap: no registry instruments, but the
            # snapshot's ranked peer block still tracks the connection
            for peer_name, address in peers[PEER_GAUGE_MAX_COMMITTEE:]:
                short = str(peer_name)[:8]
                self._peer_conns.setdefault(short, []).append(
                    (sender, address)
                )

    def _register_peer(self, role: str, sender, peer_name, address) -> None:
        """Per-peer gauges over one sender's connection to ``address``.
        The connection is looked up lazily (pull model) — senders create
        connections on first send, so it may not exist yet."""
        short = str(peer_name)[:8]
        labels = {**self.labels, "role": role, "peer": short}
        reg = self.registry

        def conn(s=sender, a=address):
            return getattr(s, "_connections", {}).get(a)

        def queued():
            c = conn()
            return c.queue.qsize() if c is not None else 0

        def retrying():
            c = conn()
            return int(c is not None and getattr(c, "_writer", None) is None)

        def failures():
            c = conn()
            return getattr(c, "connect_failures", 0) if c is not None else 0

        def jittered():
            c = conn()
            return getattr(c, "jittered_retries", 0) if c is not None else 0

        reg.gauge(
            "net_peer_backoff_jitter",
            "Jittered reconnect retries toward this peer",
            labels,
            fn=jittered,
        )
        reg.gauge(
            "net_peer_queued",
            "Messages queued toward this peer",
            labels,
            fn=queued,
        )
        reg.gauge(
            "net_peer_retrying",
            "1 while this peer is disconnected (connect-retry/backoff)",
            labels,
            fn=retrying,
        )
        reg.gauge(
            "net_peer_connect_failures",
            "Connect attempts failed toward this peer",
            labels,
            fn=failures,
        )
        self._peer_conns.setdefault(short, []).append((sender, address))

    # ---- snapshot -------------------------------------------------------

    def _net_section(self) -> dict:
        out = {}
        for role, s in self._senders:
            conns = list(getattr(s, "_connections", {}).values())
            entry = {
                "conns": len(conns),
                "queued": sum(c.queue.qsize() for c in conns),
                "retrying": sum(
                    1 for c in conns if getattr(c, "_writer", None) is None
                ),
                "connect_failures": sum(
                    getattr(c, "connect_failures", 0) for c in conns
                ),
                "jittered_retries": sum(
                    getattr(c, "jittered_retries", 0) for c in conns
                )
                + getattr(s, "jittered_retries", 0),
                "evictions": getattr(s, "pool_evictions", 0),
            }
            if hasattr(type(s), "pacing_stalls"):
                entry["pacing_stalls"] = s.pacing_stalls
            out[role] = entry
        if self._peer_conns:
            # rank by flow bytes when the accountant is attached so the
            # top-K block shows the peers that actually matter; the
            # rest are an explicit count, never a silent drop
            shorts = list(self._peer_conns)
            flow_bytes: dict[str, int] = {}
            if self.flows is not None and self.flows.enabled:
                flow_bytes = {
                    p: tx + rx for p, tx, rx in self.flows.peer_totals()
                }
                shorts.sort(key=lambda s: (-flow_bytes.get(s, 0), s))
            shown = shorts[:PEER_GAUGE_MAX_COMMITTEE]
            peer_out = {}
            for short in shown:
                queued = failures = retrying = 0
                for sender, address in self._peer_conns[short]:
                    c = getattr(sender, "_connections", {}).get(address)
                    if c is None:
                        continue
                    queued += c.queue.qsize()
                    failures += getattr(c, "connect_failures", 0)
                    retrying = max(
                        retrying,
                        int(getattr(c, "_writer", None) is None),
                    )
                peer_out[short] = {
                    "queued": queued,
                    "retrying": retrying,
                    "connect_failures": failures,
                }
                if short in flow_bytes:
                    peer_out[short]["bytes"] = flow_bytes[short]
            out["peer"] = peer_out
            out["peers_elided"] = len(shorts) - len(shown)
        return out

    def snapshot(self) -> dict:
        """The ``Telemetry snapshot:`` document.  A strict superset of
        ``WorkStats.to_json()`` (the ``Work stats:`` scrape contract) —
        its keys stay at the top level."""
        doc: dict = {"node": self.node}
        if self.workstats is not None:
            doc.update(self.workstats.to_json())
        doc["trace"] = self.trace.to_json()
        if self._senders:
            doc["net"] = self._net_section()
        for name, fn in self._sections.items():
            try:
                doc[name] = fn()
            except Exception as e:  # noqa: BLE001 — snapshots never throw
                doc[name] = {"error": str(e)}
        return doc


__all__ = [
    "Counter",
    "FloatCounter",
    "Gauge",
    "Histogram",
    "Registry",
    "TraceRecorder",
    "NodeTelemetry",
    "EDGES",
    "LATENCY_BOUNDS_S",
    "SIZE_BOUNDS",
    "PEER_GAUGE_MAX_COMMITTEE",
    "spans",
    "registry",
    "enable",
    "enabled",
    "set_journal_dir",
    "journal_enabled",
    "journal_dir",
    "for_node",
    "snapshot_all",
    "health_enabled",
    "export_doc",
    "trace_all",
    "reset",
    "maybe_start_server",
]
