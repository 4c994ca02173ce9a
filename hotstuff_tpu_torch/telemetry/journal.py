"""Flight recorder: a bounded, allocation-light consensus event journal.

A copy of ``hotstuff_tpu.telemetry.journal``: the same record format,
segment names and ring bounds, so ``benchmark/traces.py`` merges a port
node's journal with a JAX node's.  ``Journal(..., clock=)`` takes the
clock explicitly; by default it binds the ambient clock at construction,
as the reference does (the simulator's virtual clock inside a sim run).

Every node appends its consensus lifecycle events — propose / receive /
vote-sent / vote-received / QC-formed / commit, timeout / TC, sync
request / reply, and the network send/recv edges those imply — to a
per-node :class:`Journal`.  Each record carries (event, round, block
digest, peer, monotonic ns, wall ns) and is persisted as JSONL ring
segments under the node's store path (or ``--journal-dir`` /
``HOTSTUFF_JOURNAL_DIR``).  ``benchmark/traces.py`` merges the per-node
journals of a run, estimates per-node clock offsets from the matched
send/recv pairs, and reconstructs the committee-wide timeline of every
committed (and timed-out) round.

Design constraints:

- **Hot path is append-only**: ``record()`` is two clock reads, one
  tuple, one list append, and a length check.  JSON formatting and file
  I/O happen at flush time only (buffer threshold, force-flush points,
  or close) — never per event.
- **Bounded on disk**: segments rotate at ``segment_bytes`` and the ring
  keeps the newest ``segments`` files; a run that outlives the ring
  loses its OLDEST events (a flight recorder, not an archive).
- **Crash durable**: the core force-flushes on timeout and view-change
  (the interesting failures), and module-level atexit + SIGTERM/SIGINT
  hooks flush every live journal on the way down — a bench harness
  killing the committee with SIGTERM still yields complete journals.
- **Off by default**: with journaling off no Journal is constructed and
  every emission site is a single ``if journal is not None``.

Record wire format (one JSON object per line)::

    {"e":"commit","r":12,"d":"wT2Fq1p...","p":"","m":123456789,"w":1699...,"s":41}

``e`` event name, ``r`` round (0 = n/a), ``d`` block digest (16-char
base64 prefix, the same display the node logs use; "" = n/a), ``p``
peer (8-char node id, "" = n/a / broadcast), ``m`` monotonic ns, ``w``
wall-clock ns, ``s`` per-node record sequence number (monotonic across
segments and — with ``resume=True`` — across restarts; the merge in
``benchmark/traces.py`` dedups replayed records by (node, s)).  Each
segment opens with a ``{"e":"meta",...}`` line naming the node
(filenames are sanitized and must not be trusted) and carrying the
cumulative ``tot``/``drop`` record counters, so trace-time consumers
can report journal coverage instead of silently attributing from a
truncated ring.

Timestamps route through the clock seam (``utils/clock.py``): production
reads real time; a test hands the same fake clock to both packages'
journals and compares their segment files byte for byte.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import signal
import threading
import time

from ..utils.clock import SYSTEM_CLOCK, default_clock

log = logging.getLogger(__name__)

SEGMENT_BYTES = 4 << 20  # rotate segments at ~4 MiB
SEGMENTS = 8  # ring depth: <= ~32 MiB per node on disk
BUFFER_RECORDS = 256  # hot-path buffer length before an opportunistic flush

# ---- crash-flush hooks (module level, one set per process) --------------

_JOURNALS: list["Journal"] = []
_HOOKS_INSTALLED = False
_PREV_HANDLERS: dict[int, object] = {}


def flush_all() -> None:
    """Flush every live journal in this process (atexit/signal path —
    must never raise)."""
    for j in list(_JOURNALS):
        try:
            j.flush()
        except Exception:  # noqa: BLE001 — a crash hook must not crash
            pass


def _signal_flush(signum, frame) -> None:
    flush_all()
    prev = _PREV_HANDLERS.get(signum)
    if callable(prev):
        prev(signum, frame)
    else:
        # restore the default disposition and re-deliver so the process
        # dies with the correct signal exit status (the bench harness
        # SIGTERMs the committee and checks nothing hung)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def _install_crash_hooks() -> None:
    global _HOOKS_INSTALLED
    if _HOOKS_INSTALLED:
        return
    _HOOKS_INSTALLED = True
    atexit.register(flush_all)
    # signal handlers only from the main thread (signal module contract);
    # elsewhere the atexit hook still covers orderly exits
    if threading.current_thread() is not threading.main_thread():
        return
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev = signal.getsignal(sig)
            if prev is _signal_flush:
                continue
            _PREV_HANDLERS[sig] = prev
            signal.signal(sig, _signal_flush)
        except (ValueError, OSError):  # non-main thread race / exotic env
            pass


def _sanitize(name: str) -> str:
    """Filename-safe node id (node ids are base64 prefixes and may
    contain '/' or '+'); the authoritative id lives in the meta line."""
    return "".join(c if c.isalnum() else "_" for c in name) or "node"


class Journal:
    """One node's bounded JSONL ring-segment event journal."""

    __slots__ = (
        "node",
        "dir",
        "segment_bytes",
        "segments",
        "buffer_records",
        "records_total",
        "segments_rotated",
        "dropped_records_total",
        "_prefix",
        "_buf",
        "_file",
        "_bytes",
        "_seq",
        "_rec_seq",
        "_paths",
        "_path_records",
        "_closed",
        "_mono_ns",
        "_wall_ns",
    )

    def __init__(
        self,
        node: str,
        dir_path: str,
        *,
        segment_bytes: int = SEGMENT_BYTES,
        segments: int = SEGMENTS,
        buffer_records: int = BUFFER_RECORDS,
        resume: bool = False,
        clock=None,
    ):
        self.node = str(node)
        self.dir = dir_path
        self.segment_bytes = max(1, int(segment_bytes))
        self.segments = max(1, int(segments))
        self.buffer_records = max(1, int(buffer_records))
        self.records_total = 0
        self.segments_rotated = 0
        self.dropped_records_total = 0
        self._prefix = _sanitize(self.node)
        self._buf: list[tuple] = []
        self._file = None
        self._bytes = 0
        self._seq = 0
        self._rec_seq = 0
        self._paths: list[str] = []
        self._path_records: list[int] = []
        self._closed = False
        # Bind the clock once at boot: real time in production, or the
        # clock the caller passed (deterministic journal content).
        clk = clock if clock is not None else default_clock()
        self._mono_ns = clk.monotonic_ns
        wall_ns = getattr(clk, "time_ns", None)
        if wall_ns is None:
            if clk is SYSTEM_CLOCK:
                wall_ns = time.time_ns
            else:
                wall_ns = lambda c=clk: int(c.time() * 1e9)  # noqa: E731
        self._wall_ns = wall_ns
        os.makedirs(self.dir, exist_ok=True)
        if resume:
            # crash-restart: keep the previous boot's segments and keep
            # numbering (segments AND record seqs) after them, so the
            # merge sees one continuous, dedupable per-node stream
            self._resume_scan()
        else:
            # a previous run's segments under the same prefix would
            # merge into this run's timeline at trace time — drop them
            for fname in os.listdir(self.dir):
                if fname.startswith(self._prefix + "-") and fname.endswith(
                    ".jsonl"
                ):
                    try:
                        os.unlink(os.path.join(self.dir, fname))
                    except OSError:
                        pass
        _JOURNALS.append(self)
        _install_crash_hooks()

    def _resume_scan(self) -> None:
        """Adopt pre-existing ring segments (crash-restart): re-enter
        them into the ring accounting and continue the segment / record
        sequence numbering after the highest persisted values.  A torn
        tail line may hide the true max seq — restart records then reuse
        seq values, which the (node, seq) merge dedup resolves by
        keeping the first occurrence."""
        seg_re = re.compile(
            re.escape(self._prefix) + r"-(\d{6})\.jsonl$"
        )
        found: list[tuple[int, str]] = []
        for fname in os.listdir(self.dir):
            m = seg_re.match(fname)
            if m:
                found.append((int(m.group(1)), os.path.join(self.dir, fname)))
        found.sort()
        max_s = -1
        for seg_no, path in found:
            nrec = 0
            try:
                with open(path) as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except ValueError:  # torn tail line
                            continue
                        if rec.get("e") == "meta":
                            self.dropped_records_total = max(
                                self.dropped_records_total,
                                int(rec.get("drop", 0)),
                            )
                            continue
                        nrec += 1
                        s = rec.get("s")
                        if isinstance(s, int) and s > max_s:
                            max_s = s
            except OSError:
                continue
            self._paths.append(path)
            self._path_records.append(nrec)
            self.records_total += nrec
            self._seq = max(self._seq, seg_no + 1)
        self._rec_seq = max_s + 1

    # ---- hot path --------------------------------------------------------

    def record(
        self,
        event: str,
        round_: int = 0,
        digest=None,
        peer: str = "",
        dur_ns: int | None = None,
    ) -> None:
        """Append one event.  ``digest`` is a crypto value object (or
        None); its base64 rendering is deferred to flush time.
        ``dur_ns`` (optional) marks a DURATION record — a span ending at
        this record's timestamps (the verify-pipeline profiler's
        ``span`` events); it lands in the wire format as ``"u"``."""
        s = self._rec_seq
        self._rec_seq = s + 1
        buf = self._buf
        buf.append(
            (
                event,
                round_,
                digest,
                peer,
                self._mono_ns(),
                self._wall_ns(),
                s,
                dur_ns,
            )
        )
        if len(buf) >= self.buffer_records:
            self.flush()

    # ---- flush / rotation ------------------------------------------------

    def flush(self) -> None:
        """Format and persist the buffered records (force-flush points:
        local timeout, TC advance, shutdown, crash hooks)."""
        buf = self._buf
        if not buf or self._closed:
            return
        self._buf = []
        parts = []
        for e, r, d, p, m, w, s, u in buf:
            ds = d.encode_base64()[:16] if d is not None else ""
            tail = f',"u":{u}' if u is not None else ""
            parts.append(
                f'{{"e":"{e}","r":{r},"d":"{ds}","p":"{p}","m":{m},"w":{w},'
                f'"s":{s}{tail}}}\n'
            )
        data = "".join(parts)
        try:
            f = self._file
            if f is None:
                f = self._open_segment()
            f.write(data)
            f.flush()
        except OSError as exc:
            log.warning("journal flush failed for %s: %s", self.node, exc)
            return
        self._bytes += len(data)
        self.records_total += len(buf)
        if self._path_records:
            self._path_records[-1] += len(buf)
        if self._bytes >= self.segment_bytes:
            self._rotate()

    def _open_segment(self):
        # enforce the ring bound before adding a segment (rotation also
        # trims, but a resumed ring can already be at capacity here)
        while len(self._paths) >= self.segments:
            self._drop_oldest()
        path = os.path.join(
            self.dir, f"{self._prefix}-{self._seq:06d}.jsonl"
        )
        f = open(path, "w")
        self._file = f
        self._bytes = 0
        self._paths.append(path)
        self._path_records.append(0)
        meta = (
            f'{{"e":"meta","n":"{self.node}","seg":{self._seq},'
            f'"pid":{os.getpid()},"m":{self._mono_ns()},'
            f'"w":{self._wall_ns()},"tot":{self.records_total},'
            f'"drop":{self.dropped_records_total}}}\n'
        )
        f.write(meta)
        self._bytes += len(meta)
        return f

    def _drop_oldest(self) -> None:
        """Unlink the oldest ring segment, counting its records as
        dropped — the no-silent-caps counter behind ``journal coverage``
        in the + CRITPATH block and ``journal.dropped`` in /delta."""
        oldest = self._paths.pop(0)
        self.dropped_records_total += self._path_records.pop(0)
        try:
            os.unlink(oldest)
        except OSError:
            pass

    def _rotate(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        self._file = None
        self._seq += 1
        self.segments_rotated += 1
        while len(self._paths) >= self.segments:
            self._drop_oldest()

    # ---- lifecycle -------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._closed = True
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        try:
            _JOURNALS.remove(self)
        except ValueError:
            pass

    def stats(self) -> dict:
        """Snapshot-document section (telemetry pull model)."""
        return {
            "records": self.records_total,
            "buffered": len(self._buf),
            "segments": len(self._paths),
            "rotated": self.segments_rotated,
            "dropped": self.dropped_records_total,
            "dir": self.dir,
        }


__all__ = [
    "Journal",
    "flush_all",
    "SEGMENT_BYTES",
    "SEGMENTS",
    "BUFFER_RECORDS",
]
