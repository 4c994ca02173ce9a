"""Live fleet health plane: the delta half.

A copy of the delta-frame half of ``hotstuff_tpu.telemetry.health``:
:func:`flatten` + :class:`DeltaStream` / :class:`DeltaDecoder`, the
``/delta`` wire format.  A node flattens its export document into
dot-keyed scalars and serves **delta frames** against a short frame
history, keyed by a monotonic sequence number, so a scraper pulls
O(changed keys) per tick instead of the whole document.  A decoder that
misses a frame (sequence gap, node restart) drops its state and re-pulls
a full frame — resync is one extra round trip, never a wrong merge.

The rest of the reference module — the online anomaly detectors, the
incident records, the campaign recorder and the per-node monitor behind
``--health`` — comes with the next slice of the port.

This module is a stdlib-only leaf, with no imports from the rest of the
package.
"""

from __future__ import annotations

from collections import deque

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


__all__ = ["flatten", "DeltaStream", "DeltaDecoder", "DELTA_HISTORY"]
