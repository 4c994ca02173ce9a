"""The consensus wire protocol: the tagged message union.

Parity target: ``ConsensusMessage`` (reference consensus/src/consensus.rs:
30-38): Propose(Block), Vote, Timeout, TC, SyncRequest(digest, origin),
Producer(digest) — the fork's payload-ingest message.

A copy of ``hotstuff_tpu.consensus.wire``, whole, the state-sync frames
(tags 7-10) and the state-read reply included: every frame encodes and
decodes to the same bytes and objects as in the JAX package, so the two
packages' nodes serve each other snapshots.
"""

from __future__ import annotations

from ..crypto import Digest, PublicKey
from ..utils.codec import CodecError, Decoder, Encoder
from .errors import SerializationError
from .messages import (
    MAX_SIGNER_BITMAP,
    QC,
    TC,
    Block,
    Timeout,
    Vote,
    _vote_struct,
    decode_pk,
    encode_pk,
)
from .reconfig import ReconfigOp

TAG_PROPOSE = 0
TAG_VOTE = 1
TAG_TIMEOUT = 2
TAG_TC = 3
TAG_SYNC_REQUEST = 4
TAG_PRODUCER = 5
TAG_PRODUCER_V2 = 6
TAG_STATE_REQUEST = 7
TAG_STATE_MANIFEST = 8
TAG_STATE_CHUNK = 9
TAG_STATE_READ = 10
TAG_RECONFIG = 11

ACK = b"Ack"

#: producer frame v2 (ingest plane, docs/LOAD.md): versioned batched
#: payload submission.  The version byte is explicit so a v3 layout can
#: change the body without a new tag; any other value is a CodecError.
PRODUCER_FRAME_VERSION = 2
#: payload items per v2 frame (wire sanity bound: a full batch of
#: maximum bodies stays well under framing.MAX_FRAME)
MAX_PRODUCER_BATCH = 512

# Committee-scheme wire sizes for key/signature fields: (pk, sig) bytes.
# One committee never mixes schemes, so the network decode path narrows
# the accepted sizes to its own scheme (ADVICE r2: don't rely on later
# stake/crypto checks to reject the other scheme's material).
SCHEME_WIRE_SIZES = {"ed25519": (32, 64), "bls": (96, 48)}

# Compact-certificate narrowing, same contract: (aggregate-sig size,
# signer-bitmap byte cap) per scheme, or None when the scheme has no
# aggregate form — then any compact certificate off the wire is a
# CodecError, not something later stake/crypto checks must catch.  Only
# BLS aggregates; the bitmap cap admits committees up to 4096 members
# (messages.MAX_SIGNER_BITMAP).
SCHEME_COMPACT_SIZES = {
    "ed25519": None,
    "bls": (48, MAX_SIGNER_BITMAP),
}


_PROPOSE_PREFIX = bytes([TAG_PROPOSE])


def encode_propose(block: Block) -> bytes:
    # serialize() is wire-cached on the block (messages.py), so the
    # helper/synchronizer re-sends and the store write share one
    # encoding with the original broadcast
    return _PROPOSE_PREFIX + block.serialize()


_VOTE_PREFIX = bytes([TAG_VOTE])


def encode_vote(vote: Vote) -> bytes:
    # packed fast path — identical bytes to Encoder + Vote.encode (the
    # struct layouts are shared with the decode fast path)
    pk = vote.author.data
    sig = vote.signature.data
    s = _vote_struct(len(pk), len(sig))
    return _VOTE_PREFIX + s.pack(
        vote.hash.data, vote.round, len(pk), pk, len(sig), sig
    )


def encode_timeout(timeout: Timeout) -> bytes:
    enc = Encoder().u8(TAG_TIMEOUT)
    timeout.encode(enc)
    return enc.finish()


def encode_tc(tc: TC) -> bytes:
    enc = Encoder().u8(TAG_TC)
    tc.encode(enc)
    return enc.finish()


def encode_sync_request(missing: Digest, origin: PublicKey) -> bytes:
    enc = Encoder().u8(TAG_SYNC_REQUEST).raw(missing.to_bytes())
    encode_pk(enc, origin)
    return enc.finish()


# Per-payload body cap (wire sanity bound; the reference's WAN config
# uses 512-byte transactions, data/2-chain/README.md:42-57).
MAX_PAYLOAD_BODY = 65_536


def encode_producer(payload: Digest, body: bytes = b"") -> bytes:
    """The fork's ingest message (consensus.rs:37), extended with an
    optional payload BODY: the reference's 512-byte transactions flow
    through its (deleted) mempool; here the producer may attach the
    body so nodes store real bytes and the harness measures BPS
    (VERDICT r3 item 4).  An empty body preserves the digest-only
    producer contract (dissemination stays the producer's job, as in
    the reference fork)."""
    enc = Encoder().u8(TAG_PRODUCER).raw(payload.to_bytes())
    enc.var_bytes(body)
    return enc.finish()


def encode_producer_batch(items) -> bytes:
    """Producer frame v2: ``items`` is a sequence of (Digest, body)
    pairs submitted in one frame.  Batching amortizes the per-frame
    syscall/decode cost for high-rate clients; the ingest ACK the node
    replies with carries the admission decision for the whole batch
    (accepted prefix / shed suffix — the decode side preserves order)."""
    if not items or len(items) > MAX_PRODUCER_BATCH:
        raise ValueError(
            f"producer batch must carry 1..{MAX_PRODUCER_BATCH} items"
        )
    enc = Encoder().u8(TAG_PRODUCER_V2).u8(PRODUCER_FRAME_VERSION)
    enc.u32(len(items))
    for digest, body in items:
        enc.raw(digest.to_bytes())
        enc.var_bytes(body)
    return enc.finish()


# ---- ingest ACK (the reply frame on the producer socket) -------------------

#: first byte of an ingest ACK — disjoint from the legacy ``b"Ack"``
#: (0x41) so a reply frame's kind is decidable from one byte
INGEST_ACK_TAG = 0xA2
INGEST_OK = 0
INGEST_BUSY = 1


class IngestAck:
    """Typed producer ACK: the admission decision for one frame.

    ``status`` is INGEST_BUSY when anything was shed; ``credit`` is the
    node's current credit window (payloads the client may have in
    flight before the next ACK); ``retry_after_ms`` is the node's
    drain-rate-derived pause hint (0 unless busy)."""

    __slots__ = ("status", "accepted", "shed", "credit", "retry_after_ms")

    def __init__(self, status, accepted, shed, credit, retry_after_ms):
        self.status = status
        self.accepted = accepted
        self.shed = shed
        self.credit = credit
        self.retry_after_ms = retry_after_ms

    @property
    def busy(self) -> bool:
        return self.status == INGEST_BUSY


def encode_ingest_ack(
    accepted: int, shed: int, credit: int, retry_after_ms: int
) -> bytes:
    status = INGEST_BUSY if shed else INGEST_OK
    u32max = (1 << 32) - 1
    return (
        Encoder()
        .u8(INGEST_ACK_TAG)
        .u8(PRODUCER_FRAME_VERSION)
        .u8(status)
        .u32(min(u32max, max(0, accepted)))
        .u32(min(u32max, max(0, shed)))
        .u32(min(u32max, max(0, credit)))
        .u32(min(u32max, max(0, retry_after_ms)))
        .finish()
    )


def decode_ingest_ack(data: bytes) -> IngestAck | None:
    """Reply-frame decode for producer clients: None for the legacy
    ``b"Ack"`` (or any frame that isn't an ingest ACK), the typed ACK
    otherwise.  Raises SerializationError on a malformed ingest ACK."""
    if not data or data[0] != INGEST_ACK_TAG:
        return None
    try:
        dec = Decoder(data)
        dec.u8()
        version = dec.u8()
        if version != PRODUCER_FRAME_VERSION:
            raise CodecError(f"unknown ingest ACK version {version}")
        status = dec.u8()
        if status not in (INGEST_OK, INGEST_BUSY):
            raise CodecError(f"invalid ingest ACK status {status}")
        ack = IngestAck(status, dec.u32(), dec.u32(), dec.u32(), dec.u32())
        dec.finish()
        return ack
    except CodecError as e:
        raise SerializationError(str(e)) from e


# ---- reconfiguration submission (docs/RECONFIG.md) -------------------------


def encode_reconfig(op: ReconfigOp) -> bytes:
    """Operator-facing submission frame: a sponsored ReconfigOp sent to
    any current member's consensus port.  The receiving node validates
    it (sponsor membership + signature, epoch succession, margin and
    continuity bounds) and buffers it for its next leader slot — the op
    only takes effect once 2-chain committed inside a block."""
    enc = Encoder().u8(TAG_RECONFIG)
    op.encode(enc)
    return enc.finish()


# ---- state-sync frames (docs/STATE.md) -------------------------------------

#: versioned like the producer v2 frame: the byte is explicit so a v2
#: snapshot layout can change the body without new tags; any other
#: value is a CodecError.  v2: the manifest carries the certified
#: committee-schedule links (one committed reconfig block + its QC per
#: epoch change) so a joiner can verify the schedule it never saw.
STATE_FRAME_VERSION = 2
#: decode-time cap on schedule links in one manifest (one per epoch
#: change since genesis — 32 epoch changes is far beyond any run)
MAX_SCHEDULE_LINKS = 32
#: decode-time cap on one serialized link element (a reconfig block or
#: its certifying QC; a 128-member committee plus a full certificate
#: stays well under this)
MAX_SCHEDULE_LINK_BYTES = 131_072
def encode_schedule_links(links) -> bytes:
    """Store form of the certified schedule-link list (core persists one
    ``(reconfig block bytes, certifying QC bytes)`` pair per committed
    epoch change; the state-sync server serves them in the manifest)."""
    enc = Encoder().u16(len(links))
    for block_bytes, qc_bytes in links:
        enc.var_bytes(block_bytes)
        enc.var_bytes(qc_bytes)
    return enc.finish()


def decode_schedule_links(data: bytes) -> list:
    dec = Decoder(data)
    n = dec.u16()
    if n > MAX_SCHEDULE_LINKS:
        raise CodecError(
            f"schedule link count {n} exceeds cap {MAX_SCHEDULE_LINKS}"
        )
    out = [
        (
            dec.var_bytes(MAX_SCHEDULE_LINK_BYTES),
            dec.var_bytes(MAX_SCHEDULE_LINK_BYTES),
        )
        for _ in range(n)
    ]
    dec.finish()
    return out


#: request kinds: full-snapshot manifest, one chunk, or a delta
#: manifest restricted to entries newer than ``from_round`` (what a
#: crash-recovered node with surviving state asks for)
STATE_REQ_MANIFEST = 0
STATE_REQ_CHUNK = 1
STATE_REQ_DELTA = 2
#: read spaces for TAG_STATE_READ (store/state.py namespaces)
STATE_READ_LEDGER = 0
STATE_READ_USER = 1

#: wire sanity bounds for snapshot entries: keys are namespace prefix +
#: digest or a typed-op key (<= 256), values are headers + at most one
#: producer body
MAX_STATE_KEY = 512
MAX_STATE_VALUE = MAX_PAYLOAD_BODY + 64
MAX_STATE_CHUNK_ENTRIES = 1024


class StateRequest:
    __slots__ = ("kind", "index", "from_round", "origin")

    def __init__(self, kind: int, index: int, from_round: int,
                 origin: PublicKey):
        self.kind = kind
        self.index = index
        self.from_round = from_round
        self.origin = origin


class StateManifestMsg:
    """A peer's snapshot offer: its state cursor plus the high QC that
    anchors it (the client checks ``qc.round >= last_round`` and
    verifies the certificate against its own committee before trusting
    the offered root).  ``origin`` names the offering peer so chunk
    requests go back to the same snapshot, not a random committee
    member at a different version."""

    __slots__ = ("version", "root", "last_round", "applied_payloads",
                 "chunk_count", "from_round", "qc", "origin", "links")

    def __init__(self, version, root, last_round, applied_payloads,
                 chunk_count, from_round, qc, origin, links=()):
        self.version = version
        self.root = root
        self.last_round = last_round
        self.applied_payloads = applied_payloads
        self.chunk_count = chunk_count
        self.from_round = from_round
        self.qc = qc
        self.origin = origin
        # certified schedule links: (reconfig block bytes, certifying QC
        # bytes) per committed epoch change, oldest first — the joiner
        # verifies each link against the previous epoch's committee
        # before splicing (statesync.py)
        self.links = links


class StateChunkMsg:
    __slots__ = ("version", "index", "from_round", "entries")

    def __init__(self, version, index, from_round, entries):
        self.version = version
        self.index = index
        self.from_round = from_round
        self.entries = entries  # tuple of (key, value) bytes pairs


def encode_state_request(kind: int, origin: PublicKey, index: int = 0,
                         from_round: int = 0) -> bytes:
    enc = (
        Encoder().u8(TAG_STATE_REQUEST).u8(STATE_FRAME_VERSION)
        .u8(kind).u32(index).u64(from_round)
    )
    encode_pk(enc, origin)
    return enc.finish()


def encode_state_manifest(version: int, root: bytes, last_round: int,
                          applied_payloads: int, chunk_count: int,
                          from_round: int, qc, origin: PublicKey,
                          links=()) -> bytes:
    if len(links) > MAX_SCHEDULE_LINKS:
        raise ValueError(
            f"manifest carries {len(links)} schedule links "
            f"(cap {MAX_SCHEDULE_LINKS})"
        )
    enc = (
        Encoder().u8(TAG_STATE_MANIFEST).u8(STATE_FRAME_VERSION)
        .u64(version).raw(root).u64(last_round).u64(applied_payloads)
        .u32(chunk_count).u64(from_round)
    )
    qc.encode(enc)
    encode_pk(enc, origin)
    enc.u16(len(links))
    for block_bytes, qc_bytes in links:
        enc.var_bytes(block_bytes)
        enc.var_bytes(qc_bytes)
    return enc.finish()


def encode_state_chunk(version: int, index: int, from_round: int,
                       entries) -> bytes:
    if len(entries) > MAX_STATE_CHUNK_ENTRIES:
        raise ValueError(
            f"state chunk carries {len(entries)} entries "
            f"(cap {MAX_STATE_CHUNK_ENTRIES})"
        )
    enc = (
        Encoder().u8(TAG_STATE_CHUNK).u8(STATE_FRAME_VERSION)
        .u64(version).u32(index).u64(from_round).u32(len(entries))
    )
    for key, value in entries:
        enc.var_bytes(key)
        enc.var_bytes(value)
    return enc.finish()


def encode_state_read(space: int, key: bytes) -> bytes:
    """Client-facing read at the node's last applied version (QC-anchored
    stale read — the reply carries the version/root anchor)."""
    return (
        Encoder().u8(TAG_STATE_READ).u8(STATE_FRAME_VERSION)
        .u8(space).var_bytes(key).finish()
    )


def _decode_state_version(dec: Decoder) -> None:
    version = dec.u8()
    if version != STATE_FRAME_VERSION:
        raise CodecError(f"unknown state frame version {version}")


# ---- state read reply (the reply frame on the read socket) -----------------

#: first byte of a state-read reply — disjoint from INGEST_ACK_TAG and
#: the legacy ``b"Ack"`` so reply kinds stay decidable from one byte
STATE_VALUE_TAG = 0xA3


class StateValue:
    """Typed read reply: the value (if found) plus the server's stale-
    read anchor — its applied version, state root and last applied
    round, so the client knows exactly how stale the answer is."""

    __slots__ = ("found", "state_version", "root", "last_round",
                 "entry_round", "value")

    def __init__(self, found, state_version, root, last_round,
                 entry_round, value):
        self.found = found
        self.state_version = state_version
        self.root = root
        self.last_round = last_round
        self.entry_round = entry_round
        self.value = value


def encode_state_value(found: bool, state_version: int, root: bytes,
                       last_round: int, entry_round: int,
                       value: bytes) -> bytes:
    return (
        Encoder().u8(STATE_VALUE_TAG).u8(STATE_FRAME_VERSION)
        .flag(found).u64(state_version).raw(root).u64(last_round)
        .u64(entry_round).var_bytes(value).finish()
    )


def decode_state_value(data: bytes) -> StateValue | None:
    """Reply-frame decode for read clients: None for any frame that is
    not a state-read reply; SerializationError on a malformed one."""
    if not data or data[0] != STATE_VALUE_TAG:
        return None
    try:
        dec = Decoder(data)
        dec.u8()
        _decode_state_version(dec)
        found = dec.flag()
        out = StateValue(
            found, dec.u64(), dec.raw(32), dec.u64(), dec.u64(),
            dec.var_bytes(MAX_STATE_VALUE),
        )
        dec.finish()
        return out
    except CodecError as e:
        raise SerializationError(str(e)) from e


def decode_message(data: bytes, scheme: str | None = None):
    """bytes -> (tag, payload). Raises SerializationError on malformed input.

    Payload by tag: Propose -> Block, Vote -> Vote, Timeout -> Timeout,
    TC -> TC, SyncRequest -> (Digest, PublicKey), Producer ->
    (Digest, body), ProducerV2 -> tuple of (Digest, body) pairs,
    StateRequest -> StateRequest, StateManifest -> StateManifestMsg,
    StateChunk -> StateChunkMsg, StateRead -> (space, key),
    Reconfig -> ReconfigOp.

    ``scheme`` (the committee's signature scheme) narrows accepted
    key/signature wire sizes to that scheme's; None accepts the union.
    An unknown scheme is a caller bug — raised as ValueError at once,
    never per-message from inside the codec error path.
    """
    sizes = None
    if scheme is not None:
        sizes = SCHEME_WIRE_SIZES.get(scheme)
        if sizes is None:
            raise ValueError(f"unknown committee scheme '{scheme}'")
    try:
        dec = Decoder(data)
        if sizes is not None:
            dec.pk_size, dec.sig_size = sizes
            compact = SCHEME_COMPACT_SIZES.get(scheme)
            if compact is None:
                dec.compact_sig_size = 0  # scheme has no compact form
            else:
                dec.compact_sig_size, dec.compact_bitmap_max = compact
        tag = dec.u8()
        if tag == TAG_PROPOSE:
            out = Block.decode(dec)
        elif tag == TAG_VOTE:
            out = Vote.decode(dec)
        elif tag == TAG_TIMEOUT:
            out = Timeout.decode(dec)
        elif tag == TAG_TC:
            out = TC.decode(dec)
        elif tag == TAG_SYNC_REQUEST:
            out = (Digest(dec.raw(Digest.SIZE)), decode_pk(dec))
        elif tag == TAG_PRODUCER:
            out = (Digest(dec.raw(Digest.SIZE)), dec.var_bytes(MAX_PAYLOAD_BODY))
        elif tag == TAG_PRODUCER_V2:
            version = dec.u8()
            if version != PRODUCER_FRAME_VERSION:
                raise CodecError(f"unknown producer frame version {version}")
            count = dec.u32()
            if not 1 <= count <= MAX_PRODUCER_BATCH:
                raise CodecError(
                    f"producer batch count {count} outside "
                    f"1..{MAX_PRODUCER_BATCH}"
                )
            out = tuple(
                (Digest(dec.raw(Digest.SIZE)), dec.var_bytes(MAX_PAYLOAD_BODY))
                for _ in range(count)
            )
        elif tag == TAG_STATE_REQUEST:
            _decode_state_version(dec)
            kind = dec.u8()
            if kind not in (STATE_REQ_MANIFEST, STATE_REQ_CHUNK,
                            STATE_REQ_DELTA):
                raise CodecError(f"invalid state request kind {kind}")
            out = StateRequest(kind, dec.u32(), dec.u64(), decode_pk(dec))
        elif tag == TAG_STATE_MANIFEST:
            _decode_state_version(dec)
            out = StateManifestMsg(
                dec.u64(), dec.raw(32), dec.u64(), dec.u64(),
                dec.u32(), dec.u64(), QC.decode(dec), decode_pk(dec),
            )
            n_links = dec.u16()
            if n_links > MAX_SCHEDULE_LINKS:
                raise CodecError(
                    f"manifest link count {n_links} exceeds cap "
                    f"{MAX_SCHEDULE_LINKS}"
                )
            out.links = tuple(
                (
                    dec.var_bytes(MAX_SCHEDULE_LINK_BYTES),
                    dec.var_bytes(MAX_SCHEDULE_LINK_BYTES),
                )
                for _ in range(n_links)
            )
        elif tag == TAG_STATE_CHUNK:
            _decode_state_version(dec)
            version, index, from_round = dec.u64(), dec.u32(), dec.u64()
            count = dec.u32()
            if count > MAX_STATE_CHUNK_ENTRIES:
                raise CodecError(
                    f"state chunk count {count} exceeds cap "
                    f"{MAX_STATE_CHUNK_ENTRIES}"
                )
            entries = tuple(
                (dec.var_bytes(MAX_STATE_KEY), dec.var_bytes(MAX_STATE_VALUE))
                for _ in range(count)
            )
            out = StateChunkMsg(version, index, from_round, entries)
        elif tag == TAG_STATE_READ:
            _decode_state_version(dec)
            space = dec.u8()
            if space not in (STATE_READ_LEDGER, STATE_READ_USER):
                raise CodecError(f"invalid state read space {space}")
            out = (space, dec.var_bytes(MAX_STATE_KEY))
        elif tag == TAG_RECONFIG:
            out = ReconfigOp.decode(dec)
        else:
            raise CodecError(f"unknown message tag {tag}")
        dec.finish()
        return tag, out
    except CodecError as e:
        raise SerializationError(str(e)) from e
