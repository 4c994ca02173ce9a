"""Wire-level flow accounting.

A copy of ``hotstuff_tpu.telemetry.flows``.  Every frame that crosses a
link is charged — at its send site and at its receive site — to a
``(peer, direction, message_class)`` flow.  The message class is
derived from the frame's first byte (the wire-tag taxonomy of
``consensus/wire.py``); the class list itself is registered in
``telemetry/taxonomy.py`` (``FLOW_CLASSES``), and the tests hold the
byte->class map against the live wire constants of both packages.

The accountant is a pure-Python counter table with no lock on the hot
path beyond one ``dict`` update per frame (every transport drives it
from the node's event loop).  A frame's wire cost is always
``FRAME_OVERHEAD + len(payload)`` — the u32 length prefix of
``network/framing.py`` / ``native/transport.cpp`` plus the payload —
so accounted bytes equal the exact encoded frame length.

Two byte ledgers per node:

- **wire** bytes per ``(peer, dir, class)`` flow: what actually crossed
  (or arrived from) each link, retransmissions included and ALSO
  tallied separately (``retx``) so amplification is never conflated
  with retry overhead;
- **logical** bytes per class: one frame charged per public
  ``send``/``broadcast`` API call, regardless of fan-out.  The ratio
  ``wire / logical`` per class is the node's amplification factor —
  a leader's ``propose`` broadcast to n-1 followers reads exactly
  ``n-1``.

The table is insertion-ordered plain data, so two runs that charge the
same frames in the same order have equal tables.

Knobs: ``HOTSTUFF_NET`` (set to ``0`` to disable accounting),
``HOTSTUFF_NET_TOPK`` (peers exported per snapshot, default 8, the rest
folded into an explicit ``peers_elided`` count — no silent caps),
``HOTSTUFF_NET_SAMPLE`` (journal a ``net.tx``/``net.rx`` cumulative
byte record every Nth accounting event, default 64; 0 disables).
"""

from __future__ import annotations

import os

#: u32 length prefix bytes prepended to every payload on the wire
#: (network/framing.py ``_LEN`` / native/transport.cpp ``frame_into``)
FRAME_OVERHEAD = 4

#: first wire byte -> message class.  Tag values mirror
#: consensus/wire.py (TAG_PROPOSE..TAG_RECONFIG, ACK[0], INGEST_ACK_TAG,
#: STATE_VALUE_TAG); kept as literals so this module stays a telemetry
#: leaf with no consensus import — the tests pin the parity.
_TAG_CLASS: dict = {
    0: "propose",
    1: "vote",
    2: "timeout",
    3: "tc",
    4: "sync-req",
    5: "producer-v1",
    6: "producer-v2",
    7: "state-sync",  # TAG_STATE_REQUEST
    8: "state-sync",  # TAG_STATE_MANIFEST
    9: "state-sync",  # TAG_STATE_CHUNK
    10: "state-sync",  # TAG_STATE_READ
    11: "reconfig",
    0x41: "ack",  # ACK = b"Ack"
    0xA2: "ingest-ack",  # INGEST_ACK_TAG
    0xA3: "state-sync",  # STATE_VALUE_TAG (state-read reply)
}


def frame_class(payload: bytes) -> str:
    """Message class of one wire payload (its first byte's tag family);
    ``"other"`` for unknown tags and empty frames — every frame lands in
    exactly one registered class, so per-class shares always cover 100%
    of accounted bytes."""
    if not payload:
        return "other"
    return _TAG_CLASS.get(payload[0], "other")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FlowAccounting:
    """Per-node wire/logical byte ledgers.

    One instance per node (a co-located committee gives each of its
    nodes its own).  Transports call
    :meth:`tx` / :meth:`rx` / :meth:`retx` with the raw payload at the
    moment bytes actually cross; public sender APIs call
    :meth:`logical` once per send/broadcast call.
    """

    def __init__(self, node: str = "", enabled: bool | None = None):
        self.node = node
        if enabled is None:
            enabled = os.environ.get("HOTSTUFF_NET", "1") not in (
                "0",
                "false",
                "off",
            )
        self.enabled = enabled
        self.topk = _env_int("HOTSTUFF_NET_TOPK", 8)
        self.sample = _env_int("HOTSTUFF_NET_SAMPLE", 64)
        #: (peer, dir, class) -> [wire_bytes, frames, retx_bytes,
        #: retx_frames]
        self._flows: dict[tuple[str, str, str], list[int]] = {}
        #: class -> [logical_bytes, logical_frames]
        self._logical: dict[str, list[int]] = {}
        #: address -> peer label (committee names where known); the
        #: fallback label is the address's host component
        self._labels: dict = {}
        self._events = 0
        #: journal provider: a zero-arg callable returning the node's
        #: journal (or None) — bound by NodeTelemetry.attach_flows so
        #: the journal can attach after the accountant
        self._journal_fn = None

    # ---- wiring ----------------------------------------------------------

    def label_peers(self, pairs) -> None:
        """Register committee peer labels: ``pairs`` is an iterable of
        ``(name, address)``.  Unlabelled addresses degrade to their host
        component — attribution is then per-host, never dropped."""
        for name, address in pairs:
            self._labels[address] = name

    def bind_journal(self, journal_fn) -> None:
        self._journal_fn = journal_fn

    def peer_label(self, address) -> str:
        label = self._labels.get(address)
        if label is not None:
            return label
        if isinstance(address, tuple) and address:
            return str(address[0])
        return str(address)

    # ---- hot path --------------------------------------------------------

    def _row(self, peer: str, direction: str, cls: str) -> list[int]:
        key = (peer, direction, cls)
        row = self._flows.get(key)
        if row is None:
            row = self._flows[key] = [0, 0, 0, 0]
        return row

    def _note(self, direction: str, cls: str, total: int) -> None:
        self._events += 1
        if not self.sample or self._events % self.sample:
            return
        fn = self._journal_fn
        j = fn() if fn is not None else None
        if j is not None:
            # class rides the peer field, cumulative direction bytes in
            # the value field — the Perfetto net lanes render both
            j.record(f"net.{direction}", peer=cls, dur_ns=total)

    def tx(self, address, payload: bytes, retx: bool = False) -> None:
        """Charge one frame actually written toward ``address`` (called
        at the transmit site, after fault decisions — a dropped frame is
        never charged, a corrupted one is: its bytes hit the wire)."""
        if not self.enabled:
            return
        cls = frame_class(payload)
        wire = FRAME_OVERHEAD + len(payload)
        row = self._row(self.peer_label(address), "tx", cls)
        row[0] += wire
        row[1] += 1
        if retx:
            row[2] += wire
            row[3] += 1
        self._note("tx", cls, self.tx_bytes())

    def rx(self, peer, payload: bytes) -> None:
        """Charge one frame read off a link (``peer`` is the remote
        peername; ephemeral client ports carry no identity, so receive
        flows attribute per remote host)."""
        if not self.enabled:
            return
        cls = frame_class(payload)
        row = self._row(self.peer_label(peer), "rx", cls)
        row[0] += FRAME_OVERHEAD + len(payload)
        row[1] += 1
        self._note("rx", cls, self.rx_bytes())

    def logical(self, payload: bytes, calls: int = 1) -> None:
        """Charge one API-level message (a ``send`` or a whole
        ``broadcast``): the denominator of the amplification factor."""
        if not self.enabled:
            return
        cls = frame_class(payload)
        row = self._logical.get(cls)
        if row is None:
            row = self._logical[cls] = [0, 0]
        row[0] += calls * (FRAME_OVERHEAD + len(payload))
        row[1] += calls

    # ---- derived views ---------------------------------------------------

    def tx_bytes(self) -> int:
        return sum(
            r[0] for (_, d, _c), r in self._flows.items() if d == "tx"
        )

    def rx_bytes(self) -> int:
        return sum(
            r[0] for (_, d, _c), r in self._flows.items() if d == "rx"
        )

    def retx_bytes(self) -> int:
        return sum(
            r[2] for (_, d, _c), r in self._flows.items() if d == "tx"
        )

    def class_totals(self) -> dict:
        """class -> {tx_bytes, tx_frames, rx_bytes, rx_frames,
        retx_bytes, retx_frames}, sorted by class name."""
        out: dict = {}
        for (_peer, d, cls), row in self._flows.items():
            ent = out.setdefault(
                cls,
                {
                    "tx_bytes": 0,
                    "tx_frames": 0,
                    "rx_bytes": 0,
                    "rx_frames": 0,
                    "retx_bytes": 0,
                    "retx_frames": 0,
                },
            )
            ent[f"{d}_bytes"] += row[0]
            ent[f"{d}_frames"] += row[1]
            if d == "tx":
                ent["retx_bytes"] += row[2]
                ent["retx_frames"] += row[3]
        return {cls: out[cls] for cls in sorted(out)}

    def amplification(self) -> dict:
        """class -> wire-egress / logical-egress byte ratio, for classes
        with any logical bytes charged.  A propose broadcast to n-1
        followers reads n-1; retransmissions push a class above its
        fan-out (which is the point of keeping retx separate)."""
        tx_by_cls: dict[str, int] = {}
        for (_peer, d, cls), row in self._flows.items():
            if d == "tx":
                tx_by_cls[cls] = tx_by_cls.get(cls, 0) + row[0]
        return {
            cls: round(tx_by_cls.get(cls, 0) / logical[0], 3)
            for cls, logical in sorted(self._logical.items())
            if logical[0]
        }

    def peer_totals(self) -> list[tuple[str, int, int]]:
        """(peer, tx_bytes, rx_bytes) sorted by total bytes descending
        (ties by name, so the ordering is deterministic)."""
        by_peer: dict[str, list[int]] = {}
        for (peer, d, _cls), row in self._flows.items():
            ent = by_peer.setdefault(peer, [0, 0])
            ent[0 if d == "tx" else 1] += row[0]
        return sorted(
            ((p, tx, rx) for p, (tx, rx) in by_peer.items()),
            key=lambda e: (-(e[1] + e[2]), e[0]),
        )

    def table(self) -> dict:
        """The full JSON-stable flow table (the determinism
        artifact): integer ledgers only, keys sorted."""
        return {
            "flows": {
                f"{peer}|{d}|{cls}": list(row)
                for (peer, d, cls), row in sorted(self._flows.items())
            },
            "logical": {
                cls: list(row)
                for cls, row in sorted(self._logical.items())
            },
        }

    def snapshot(self) -> dict:
        """The ``flows`` telemetry section (pull-model; lands in the
        node's snapshot log line, /metrics export and the /delta
        stream).  Peers beyond the top-K by bytes are folded into an
        explicit ``peers_elided`` count — never silently dropped."""
        if not self.enabled:
            return {"enabled": False}
        retx_b = retx_f = tx_f = rx_f = 0
        for (_p, d, _c), row in self._flows.items():
            if d == "tx":
                tx_f += row[1]
                retx_b += row[2]
                retx_f += row[3]
            else:
                rx_f += row[1]
        peers = self.peer_totals()
        shown = peers[: self.topk] if self.topk > 0 else peers
        return {
            "enabled": True,
            "tx_bytes": self.tx_bytes(),
            "rx_bytes": self.rx_bytes(),
            "tx_frames": tx_f,
            "rx_frames": rx_f,
            "retx_bytes": retx_b,
            "retx_frames": retx_f,
            "classes": self.class_totals(),
            "amp": self.amplification(),
            "peers": {
                p: {"tx_bytes": tx, "rx_bytes": rx}
                for p, tx, rx in shown
            },
            "peers_elided": max(0, len(peers) - len(shown)),
        }


__all__ = ["FRAME_OVERHEAD", "FlowAccounting", "frame_class"]
