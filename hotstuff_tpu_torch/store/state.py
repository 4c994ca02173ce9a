"""Deterministic replicated execution layer applied at commit.

Commits used to stop at payload digests — nothing was ever *applied* —
so crash recovery and the chaos/byz planes could only check digest-log
agreement.  This module is the missing state machine: a versioned
KV/ledger deterministically derived from the committed block stream and
summarized per commit by an incremental **state root**, the strictly
stronger safety invariant the invariant layer asserts across nodes.

Determinism boundary.  Payload *bodies* are node-local: the producer
plane stores a body only on the node(s) the client submitted it to
(``--payload-homes``, default 1), while every committee member sees only
the payload *digests* carried by committed blocks.  The replicated core
therefore folds exactly the data all honest nodes share at commit time:

- per committed block: one ledger entry per payload digest
  (``s/l<digest>`` -> commit round + position), and
- the chained root ``root' = H(root || round || block_digest ||
  payload_digests...)`` — since a payload digest is the content address
  of its body, folding digests is equivalent to folding bodies.

Bodies that ARE locally present and decode as typed operations
(``encode_ops``/``decode_ops``) additionally materialize a user-KV view
(``s/u<key>``) served by the read path with read-your-writes semantics
at the ingest node; that view rides the same WAL and snapshots but is a
local materialization, not part of the root.

All keys live under the ``s/`` prefix, disjoint from every consensus
namespace (``consensus_state``, ``latest_round``, 8-byte round keys,
32-byte block digests, ``p<digest>`` payload bodies).

Value layouts (little-endian):
- meta   ``s/meta``      : u64 version | u64 last_round | root[32] |
                           u64 applied_payloads
- ledger ``s/l<digest>`` : u64 round | u32 seq
- user   ``s/u<key>``    : u64 round | u8 alive | value bytes

The ``round`` prefix on every entry is what makes delta state-sync a
pure value filter, and ``alive=0`` keeps deletions visible to both
snapshots and deltas (a bare engine delete would silently vanish from a
delta log).

A copy of ``hotstuff_tpu.store.state``, whole: the same keys, values,
roots and snapshot chunks byte for byte, so a store or a snapshot
written by either package is read by the other.  Added to the copy:
``apply_block`` writes a block's records inside the engine's
``batch()`` where it has one (the native engine: one write a block,
not one a payload; the log's bytes are unchanged).
"""

from __future__ import annotations

import contextlib
import struct

from ..crypto import Digest
from ..crypto.digest import sha512_trunc

META_KEY = b"s/meta"
LEDGER_PREFIX = b"s/l"
USER_PREFIX = b"s/u"
STATE_PREFIX = b"s/"

#: root before any block is applied (all-zero, version 0)
GENESIS_ROOT = b"\x00" * 32

#: typed-operation body framing: bodies the execution layer decodes
#: into put/del operations start with this magic after the producer
#: plane's 8-byte uniqueness counter
OP_MAGIC = b"SOP1"
OP_PUT = 0
OP_DEL = 1
#: producer bodies carry an 8-byte uniqueness counter first; typed ops
#: start right after it
OP_BODY_OFFSET = 8
MAX_OP_KEY = 256
MAX_OPS_PER_BODY = 64

#: entries per snapshot chunk frame (bounds frame size: worst-case user
#: values are producer-body sized)
SNAPSHOT_CHUNK_ENTRIES = 256

_META = struct.Struct("<QQ32sQ")
_LEDGER_VAL = struct.Struct("<QI")
_USER_HDR = struct.Struct("<QB")
_OP_HDR = struct.Struct("<BHI")


class StateError(Exception):
    pass


def encode_ops(ops) -> bytes:
    """Typed-op body payload (appended after the producer counter):
    ``OP_MAGIC`` then per op ``u8 kind | u16 klen | u32 vlen | key |
    value``.  ``ops`` is a list of ("put", key, value) / ("del", key)."""
    out = [OP_MAGIC]
    for op in ops:
        if op[0] == "put":
            _, key, value = op
            out.append(_OP_HDR.pack(OP_PUT, len(key), len(value)))
            out.append(key)
            out.append(value)
        elif op[0] == "del":
            key = op[1]
            out.append(_OP_HDR.pack(OP_DEL, len(key), 0))
            out.append(key)
        else:
            raise StateError(f"unknown op kind {op[0]!r}")
    return b"".join(out)


def decode_ops(body: bytes):
    """Decode the typed operations of a payload body, or None when the
    body is not a typed-op body (no magic — opaque payloads are legal).
    Malformed typed bodies also decode to None: commit-time apply must
    never raise on attacker-controlled payload content."""
    blob = body[OP_BODY_OFFSET:]
    if not blob.startswith(OP_MAGIC):
        return None
    ops = []
    off = len(OP_MAGIC)
    n = len(blob)
    try:
        while off < n:
            if len(ops) >= MAX_OPS_PER_BODY:
                return None
            kind, klen, vlen = _OP_HDR.unpack_from(blob, off)
            off += _OP_HDR.size
            if klen == 0 or klen > MAX_OP_KEY:
                return None
            if off + klen > n:
                return None
            key = blob[off : off + klen]
            off += klen
            if kind == OP_PUT:
                if off + vlen > n:
                    return None
                ops.append(("put", key, blob[off : off + vlen]))
                off += vlen
            elif kind == OP_DEL:
                if vlen:
                    return None
                ops.append(("del", key))
            else:
                return None
    except struct.error:
        return None
    return ops


def fold_root(root: bytes, round_: int, block_digest: bytes,
              payload_digests) -> bytes:
    """One incremental root step — shared by the apply path and the
    shadow-reporting path so a colluder's claimed root chains exactly
    like an honest one (just over the shadow digests)."""
    h = [root, round_.to_bytes(8, "little"), block_digest]
    h.extend(d if isinstance(d, bytes) else d.to_bytes()
             for d in payload_digests)
    return sha512_trunc(b"".join(h))


class SnapshotManifest:
    """The QC-anchored header of a snapshot: what version/root the
    server's state is at and how many chunks carry it.  The wire layer
    (consensus/wire.py) serializes this next to the server's high QC."""

    __slots__ = ("version", "root", "last_round", "applied_payloads",
                 "chunk_count")

    def __init__(self, version: int, root: bytes, last_round: int,
                 applied_payloads: int, chunk_count: int):
        self.version = version
        self.root = root
        self.last_round = last_round
        self.applied_payloads = applied_payloads
        self.chunk_count = chunk_count

    def __repr__(self) -> str:
        return (f"SnapshotManifest(v{self.version} @ r{self.last_round}"
                f" root={Digest(self.root)} chunks={self.chunk_count})")


class StateMachine:
    """The deterministic execution layer over one node's store engine.

    Single-writer discipline: every mutation happens inline on the event
    loop from the commit path (the same discipline the Store actor
    documents), so plain engine access needs no locking."""

    def __init__(self, store, committee_size: int = 0):
        self.store = store
        self.committee_size = committee_size
        self.version = 0
        self.root = GENESIS_ROOT
        #: what this node CLAIMS its root is — identical to ``root``
        #: except under the collude adversary's shadow committer, where
        #: it chains over the reported (shadow) digests instead
        self.reported_root = GENESIS_ROOT
        self.last_round = 0
        self.applied_payloads = 0
        self.applied_blocks = 0
        self.typed_ops = 0
        self.snapshots_served = 0
        self.synced_from_snapshot = False
        self._load_meta()

    # ---- meta cursor ----------------------------------------------------

    def _load_meta(self) -> None:
        raw = self.store.engine.get(META_KEY)
        if raw is None or len(raw) != _META.size + 32:
            return
        self.version, self.last_round, self.root, self.applied_payloads = (
            _META.unpack(raw[: _META.size])
        )
        self.reported_root = raw[_META.size :]

    def _persist_meta(self) -> None:
        self.store.engine.put(
            META_KEY,
            _META.pack(self.version, self.last_round, self.root,
                       self.applied_payloads) + self.reported_root,
        )

    # ---- apply ----------------------------------------------------------

    def apply_block(self, block, reported_digest=None) -> bytes | None:
        """Apply one committed block (called in commit order).  Returns
        the root this node REPORTS for the commit — equal to the real
        root unless ``reported_digest`` (the collude adversary's shadow
        digest) diverges, in which case the claimed root chains over the
        shadow history while the real state stays honest.  Returns None
        (nothing applied, nothing to report) for an already-applied
        round."""
        if block.round <= self.last_round:
            # crash-recovery overlap: the consensus cursor can trail the
            # state cursor by one commit (state writes land in the WAL
            # before the end-of-loop consensus_state persist)
            return None
        engine = self.store.engine
        batch = getattr(engine, "batch", None)
        with batch() if batch is not None else contextlib.nullcontext():
            return self._apply(engine, block, reported_digest)

    def _apply(self, engine, block, reported_digest) -> bytes:
        real_digest = block.digest()
        round_ = block.round
        for seq, digest in enumerate(block.payloads):
            raw = digest.to_bytes()
            engine.put(LEDGER_PREFIX + raw, _LEDGER_VAL.pack(round_, seq))
            self.applied_payloads += 1
            body = engine.get(b"p" + raw)
            if body is not None:
                ops = decode_ops(body)
                if ops:
                    self._apply_ops(round_, ops)
        self.version += 1
        self.applied_blocks += 1
        self.last_round = round_
        self.root = fold_root(self.root, round_, real_digest.to_bytes(),
                              block.payloads)
        if reported_digest is None or reported_digest == real_digest:
            reported = real_digest.to_bytes()
        else:
            reported = reported_digest.to_bytes()
        self.reported_root = fold_root(self.reported_root, round_,
                                       reported, block.payloads)
        self._persist_meta()
        return self.reported_root

    def _apply_ops(self, round_: int, ops) -> None:
        engine = self.store.engine
        for op in ops:
            if op[0] == "put":
                _, key, value = op
                engine.put(USER_PREFIX + key,
                           _USER_HDR.pack(round_, 1) + value)
            else:
                engine.put(USER_PREFIX + op[1], _USER_HDR.pack(round_, 0))
            self.typed_ops += 1

    # ---- read path ------------------------------------------------------

    def anchor(self) -> tuple[int, bytes, int]:
        """(version, root, last_round) — the stale-read anchor a lagging
        node serves at while it catches up."""
        return self.version, self.root, self.last_round

    def read_user(self, key: bytes):
        raw = self.store.engine.get(USER_PREFIX + key)
        if raw is None or len(raw) < _USER_HDR.size:
            return None
        round_, alive = _USER_HDR.unpack_from(raw)
        if not alive:
            return None
        return round_, raw[_USER_HDR.size :]

    def read_ledger(self, digest: bytes):
        raw = self.store.engine.get(LEDGER_PREFIX + digest)
        if raw is None or len(raw) != _LEDGER_VAL.size:
            return None
        return _LEDGER_VAL.unpack(raw)  # (round, seq)

    # ---- snapshots ------------------------------------------------------

    def _entries(self, from_round: int = 0):
        """Deterministically ordered (key, value) state entries newer
        than ``from_round`` (0 = full snapshot).  Meta is excluded — the
        manifest carries the cursor."""
        engine = self.store.engine
        out = []
        for key in engine.keys():
            if not key.startswith(STATE_PREFIX) or key == META_KEY:
                continue
            value = engine.get(key)
            if value is None or len(value) < 8:
                continue
            if int.from_bytes(value[:8], "little") > from_round:
                out.append((key, value))
        out.sort()
        return out

    def manifest(self, from_round: int = 0) -> SnapshotManifest:
        entries = self._entries(from_round)
        chunks = -(-len(entries) // SNAPSHOT_CHUNK_ENTRIES) if entries else 0
        return SnapshotManifest(self.version, self.root, self.last_round,
                                self.applied_payloads, chunks)

    def chunk(self, index: int, from_round: int = 0):
        """Entries of snapshot chunk ``index`` (deterministic ordering,
        recomputed per request — snapshot serving is a recovery path,
        not a hot path)."""
        entries = self._entries(from_round)
        lo = index * SNAPSHOT_CHUNK_ENTRIES
        return entries[lo : lo + SNAPSHOT_CHUNK_ENTRIES]

    def adopt(self, manifest: SnapshotManifest, entries) -> None:
        """Install a fetched snapshot: write every entry, then jump the
        cursor to the manifest's (version, root, round).  The root is
        adopted, not recomputed — a chained root summarizes history the
        snapshot deliberately omits; trust comes from the QC anchor and
        manifest quorum the sync client verified before calling this."""
        engine = self.store.engine
        for key, value in entries:
            if not key.startswith(STATE_PREFIX) or key == META_KEY:
                raise StateError(f"snapshot entry outside state namespace: "
                                 f"{key[:16]!r}")
            engine.put(key, value)
        self.version = manifest.version
        self.root = manifest.root
        self.reported_root = manifest.root
        self.last_round = manifest.last_round
        self.applied_payloads = manifest.applied_payloads
        self.synced_from_snapshot = True
        self._persist_meta()

    # ---- telemetry ------------------------------------------------------

    def stats(self) -> dict:
        return {
            "version": self.version,
            "last_round": self.last_round,
            "root": str(Digest(self.root)),
            "applied_blocks": self.applied_blocks,
            "applied_payloads": self.applied_payloads,
            "typed_ops": self.typed_ops,
            "snapshots_served": self.snapshots_served,
            "synced_from_snapshot": self.synced_from_snapshot,
        }


__all__ = [
    "GENESIS_ROOT", "OP_MAGIC", "SNAPSHOT_CHUNK_ENTRIES",
    "SnapshotManifest", "StateError", "StateMachine",
    "decode_ops", "encode_ops", "fold_root",
]
