"""FaultPlane: seeded, deterministic network fault injection.

A copy of ``hotstuff_tpu.faults.plane``.  The plane is an interception layer threaded through the network stack
the same way ``wan.py``'s ``delay_fn`` is: each sender resolves a
per-directed-link :class:`LinkFaults` view once per connection and
consults it per frame; the receiver consults the plane for inbound
cuts.  Four frame-level faults per directed peer pair — drop, delay,
duplicate, corrupt — gated by a **scenario schedule** (timeline of
partition/heal windows, asymmetric links, flapping links) parsed from a
small JSON spec and replayable from a single RNG seed.

Determinism contract (the seeded-chaos acceptance bar): every random
choice a link ever makes is drawn from a per-link ``random.Random``
seeded from ``(scenario seed, src index, dst index)`` — str seeding
hashes through SHA-512, so the stream is identical across processes and
runs regardless of PYTHONHASHSEED.  ``decide()`` consumes a FIXED
number of draws per call, so the n-th decision on a link is a pure
function of (seed, scenario, n); wall-clock only gates which scenario
windows are active, never the draw stream.

Crash/restart directives (``crashes`` in the spec) are process-level:
a chaos runner executes them by killing and respawning node
subprocesses; the in-node plane ignores them.
"""

from __future__ import annotations

import json
import logging
import random
from typing import NamedTuple

from ..utils.clock import default_clock

log = logging.getLogger(__name__)

Address = tuple[str, int]

#: poll interval while a reliable link holds frames through a hard cut
BARRIER_POLL_S = 0.05


class Decision(NamedTuple):
    """One frame's fate.  ``drop`` wins over everything; the others
    compose (a frame can be delayed AND duplicated AND corrupted)."""

    drop: bool = False
    delay_s: float = 0.0
    duplicate: bool = False
    corrupt: bool = False


#: the no-fault decision (shared instance: the common case allocates nothing)
PASS = Decision()


def corrupt_frame(data: bytes) -> bytes:
    """Deterministically flip one byte mid-frame (receivers must treat
    the result as a malformed message and drop it)."""
    if not data:
        return data
    i = len(data) // 2
    return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1 :]


def _addr_key(address) -> str:
    if isinstance(address, str):
        return address
    return f"{address[0]}:{address[1]}"


class FaultRule:
    """One primitive scenario rule: an active window over a set of
    directed links with fault probabilities/parameters."""

    __slots__ = (
        "label",
        "at",
        "until",
        "src",
        "dst",
        "drop",
        "delay_s",
        "jitter_pct",
        "duplicate",
        "corrupt",
        "every",
        "for_",
    )

    def __init__(
        self,
        label: str,
        at: float,
        until: float | None,
        src,  # "*" or frozenset[int]
        dst,
        drop: float = 0.0,
        delay_s: float = 0.0,
        jitter_pct: float = 0.0,
        duplicate: float = 0.0,
        corrupt: float = 0.0,
        every: float | None = None,
        for_: float | None = None,
    ):
        self.label = label
        self.at = float(at)
        self.until = None if until is None else float(until)
        self.src = src
        self.dst = dst
        self.drop = float(drop)
        self.delay_s = float(delay_s)
        self.jitter_pct = float(jitter_pct)
        self.duplicate = float(duplicate)
        self.corrupt = float(corrupt)
        self.every = every
        self.for_ = for_

    def matches(self, src: int, dst: int) -> bool:
        if self.src != "*" and src not in self.src:
            return False
        return self.dst == "*" or dst in self.dst

    def active(self, t: float) -> bool:
        """Is the rule live at scenario time ``t`` (seconds from epoch)?"""
        if t < self.at:
            return False
        if self.until is not None and t >= self.until:
            return False
        if self.every:
            # flapping sugar: within the window, on for `for_` seconds
            # out of every `every`
            return ((t - self.at) % self.every) < (self.for_ or 0.0)
        return True

    def reps(self) -> list[tuple[float, float]]:
        """The rule's on-windows as [(open, close)] in scenario time —
        the journal/clock edge list.  Unbounded rules close at +inf."""
        end = self.until if self.until is not None else float("inf")
        if not self.every:
            return [(self.at, end)]
        out = []
        t = self.at
        while t < end:
            out.append((t, min(t + (self.for_ or 0.0), end)))
            t += self.every
        return out


def _selector(value, n_hint: int | None = None):
    """Parse a from/to selector: "*" or a list of node indexes."""
    if value in ("*", None):
        return "*"
    if isinstance(value, int):
        return frozenset((value,))
    return frozenset(int(v) for v in value)


def expand_rules(spec: dict) -> tuple[list[FaultRule], list[FaultRule]]:
    """Expand the spec's ``rules`` (sugar included) into primitive
    link rules plus inbound-cut rules (``isolate`` only).

    Sugar forms:
      {"partition": [[0,1],[2,3]], "at": 5, "until": 13}
          -> drop=1.0 on every cross-group link, both directions
      {"isolate": 2, "at": 5, "until": 9}
          -> drop=1.0 on k->* and *->k, PLUS an inbound cut on k (so
             frames from senders with no plane — clients — die too)
    """
    link_rules: list[FaultRule] = []
    inbound_rules: list[FaultRule] = []
    for i, raw in enumerate(spec.get("rules", ())):
        label = raw.get("label") or f"rule-{i}"
        window = dict(
            at=raw.get("at", 0.0),
            until=raw.get("until"),
            every=raw.get("every"),
            for_=raw.get("for"),
        )
        if "partition" in raw:
            groups = [frozenset(int(v) for v in g) for g in raw["partition"]]
            for gi, g in enumerate(groups):
                others = frozenset().union(
                    *(h for gj, h in enumerate(groups) if gj != gi)
                ) if len(groups) > 1 else frozenset()
                if others:
                    link_rules.append(
                        FaultRule(label, src=g, dst=others, drop=1.0, **window)
                    )
            continue
        if "isolate" in raw:
            k = frozenset((int(raw["isolate"]),))
            link_rules.append(
                FaultRule(label, src=k, dst="*", drop=1.0, **window)
            )
            link_rules.append(
                FaultRule(label, src="*", dst=k, drop=1.0, **window)
            )
            inbound_rules.append(
                FaultRule(label, src="*", dst=k, drop=1.0, **window)
            )
            continue
        link_rules.append(
            FaultRule(
                label,
                src=_selector(raw.get("from")),
                dst=_selector(raw.get("to")),
                drop=raw.get("drop", 0.0),
                delay_s=raw.get("delay_ms", 0.0) / 1000.0,
                jitter_pct=raw.get("jitter_pct", 0.0),
                duplicate=raw.get("duplicate", 0.0),
                corrupt=raw.get("corrupt", 0.0),
                **window,
            )
        )
    return link_rules, inbound_rules


class LinkFaults:
    """Per directed (self -> dst) view of the plane.  One per sender
    connection, resolved once like wan.py's ``delay_fn``."""

    __slots__ = ("_rng", "_rules", "_plane", "seq", "dropped")

    def __init__(self, plane: "FaultPlane", rules: list[FaultRule], seed_key: str):
        self._plane = plane
        self._rules = rules
        self._rng = random.Random(seed_key)
        self.seq = 0  # decisions drawn on this link
        self.dropped = 0

    def barrier(self, now: float | None = None) -> bool:
        """True while a hard cut (drop >= 1.0 window) is live on this
        link.  Consumes NO draws — reliable senders poll it to hold
        frames through a partition instead of burning loss decisions."""
        t = self._plane._t(now)
        return any(r.drop >= 1.0 and r.active(t) for r in self._rules)

    def decide(self, now: float | None = None) -> Decision:
        """The next frame's fate.  Always consumes exactly 4 draws so
        decision n is a pure function of (seed, scenario, n)."""
        rng = self._rng
        r_drop = rng.random()
        r_dup = rng.random()
        r_cor = rng.random()
        r_jit = rng.random()
        self.seq += 1
        t = self._plane._t(now)
        active = [r for r in self._rules if r.active(t)]
        if not active:
            return PASS
        counts = self._plane.counts
        drop_p = max(r.drop for r in active)
        if drop_p > 0.0 and r_drop < drop_p:
            self.dropped += 1
            counts["dropped"] += 1
            return Decision(drop=True)
        delay_s = 0.0
        for r in active:
            if r.delay_s > 0.0:
                d = r.delay_s
                if r.jitter_pct:
                    d *= 1.0 + (r.jitter_pct / 100.0) * (2.0 * r_jit - 1.0)
                delay_s = max(delay_s, d)
        dup_p = max(r.duplicate for r in active)
        cor_p = max(r.corrupt for r in active)
        duplicate = dup_p > 0.0 and r_dup < dup_p
        corrupt = cor_p > 0.0 and r_cor < cor_p
        if not (delay_s or duplicate or corrupt):
            return PASS
        if delay_s:
            counts["delayed"] += 1
        if duplicate:
            counts["duplicated"] += 1
        if corrupt:
            counts["corrupted"] += 1
        return Decision(False, max(delay_s, 0.0), duplicate, corrupt)


class FaultPlane:
    """One node's view of the scenario: resolves per-link fault views
    for its outbound connections plus the node's inbound cut state.

    ``spec`` keys: ``seed`` (int), ``nodes`` ("host:port" -> index),
    ``rules`` (see :func:`expand_rules`), optional ``epoch_unix``
    (shared scenario t=0 across the committee; defaults to plane
    construction time), optional ``name``/``crashes``/``liveness``
    (runner-side, carried through for the invariant checker).
    """

    def __init__(self, spec: dict, self_address, now: float | None = None):
        self.spec = spec
        self.seed = int(spec.get("seed", 0))
        self.name = spec.get("name", "custom")
        self.nodes: dict[str, int] = {
            k: int(v) for k, v in spec.get("nodes", {}).items()
        }
        self.self_id = self.nodes.get(_addr_key(self_address))
        self.rules, self._inbound_rules = expand_rules(spec)
        clock = default_clock()
        wall0 = clock.time()
        mono0 = clock.monotonic()
        boot = wall0 if now is None else now
        epoch = spec.get("epoch_unix")
        # a stale epoch (config written long before boot, or clock skew)
        # would put the whole timeline in the past; fall back to boot
        self.epoch = float(epoch) if epoch is not None else boot
        if self.epoch < boot - 3600.0:
            log.warning(
                "fault spec epoch is stale (%.0fs old); using boot time",
                boot - self.epoch,
            )
            self.epoch = boot
        # Anchor the window timeline to the MONOTONIC clock: the wall
        # epoch is only used once, here, to compute the monotonic value
        # of scenario t=0.  An NTP step after construction can therefore
        # never shift partition/heal windows mid-run.
        self._mono_epoch = mono0 - (wall0 - self.epoch)
        self.counts = {
            "dropped": 0,
            "delayed": 0,
            "duplicated": 0,
            "corrupted": 0,
            "inbound_dropped": 0,
        }
        self._links: dict[str, LinkFaults | None] = {}
        self._my_inbound = [
            r
            for r in self._inbound_rules
            if self.self_id is not None and r.matches(0, self.self_id)
        ]

    @classmethod
    def load(cls, spec_or_path: str, self_address, now: float | None = None):
        """Build a plane from an inline JSON object or a spec file path
        (the ``HOTSTUFF_FAULTS`` knob accepts both)."""
        text = spec_or_path.strip()
        if text.startswith("{"):
            spec = json.loads(text)
        else:
            with open(spec_or_path) as f:
                spec = json.load(f)
        return cls(spec, self_address, now=now)

    def _t(self, now: float | None = None) -> float:
        if now is None:
            return default_clock().monotonic() - self._mono_epoch
        return now - self.epoch

    def describe(self) -> str:
        return (
            f"scenario {self.name!r} seed {self.seed} "
            f"(node index {self.self_id}, {len(self.rules)} link rules)"
        )

    def link(self, address) -> LinkFaults | None:
        """The fault view of the directed link self -> ``address``, or
        None when no scenario rule can ever touch it (fast path: the
        sender skips all fault logic on that connection)."""
        key = _addr_key(address)
        if key in self._links:
            return self._links[key]
        lf = None
        dst = self.nodes.get(key)
        if self.self_id is not None and dst is not None:
            rules = [r for r in self.rules if r.matches(self.self_id, dst)]
            if rules:
                lf = LinkFaults(
                    self, rules, f"{self.seed}|{self.self_id}->{dst}"
                )
        self._links[key] = lf
        return lf

    def inbound_cut(self, now: float | None = None) -> bool:
        """True while this node is inside an ``isolate`` window: the
        receiver drops every inbound frame (covers senders with no
        plane of their own, e.g. clients)."""
        if not self._my_inbound:
            return False
        t = self._t(now)
        if any(r.active(t) for r in self._my_inbound):
            self.counts["inbound_dropped"] += 1
            return True
        return False

    def window_edges(self) -> list[tuple[float, str, str]]:
        """Every scenario window edge as (t_rel, "open"|"close", label),
        sorted — the journal clock task walks this list.  Deduplicated
        (partition/isolate sugar expands to several rules per label)."""
        edges: set[tuple[float, str, str]] = set()
        for rule in self.rules:
            for t_open, t_close in rule.reps():
                edges.add((t_open, "open", rule.label))
                if t_close != float("inf"):
                    edges.add((t_close, "close", rule.label))
        order = {"close": 0, "open": 1}
        return sorted(edges, key=lambda e: (e[0], order[e[1]], e[2]))

    def stats(self) -> dict:
        """Telemetry snapshot section."""
        return {
            "scenario": self.name,
            "seed": self.seed,
            "node": self.self_id,
            **self.counts,
            "links": {
                key: {"seq": lf.seq, "dropped": lf.dropped}
                for key, lf in self._links.items()
                if lf is not None
            },
        }


async def run_clock(plane: FaultPlane, journal=None) -> None:
    """Walk the scenario's window edges in real time, logging each and
    journaling ``fault.open`` / ``fault.close`` records so traces
    render partition spans.  Spawned by
    Consensus.spawn when a plane is active; cancelled at shutdown."""
    for t_rel, kind, label in plane.window_edges():
        delay = (plane._mono_epoch + t_rel) - default_clock().monotonic()
        if delay > 0:
            await default_clock().sleep(delay)
        log.info("Fault window %s: %s (t=%.1fs)", kind, label, t_rel)
        if journal is not None:
            journal.record(f"fault.{kind}", 0, None, label)


__all__ = [
    "Address",
    "BARRIER_POLL_S",
    "Decision",
    "FaultPlane",
    "FaultRule",
    "LinkFaults",
    "PASS",
    "corrupt_frame",
    "expand_rules",
    "run_clock",
]
