"""The consensus wire protocol: the tagged message union.

Parity target: ``ConsensusMessage`` (reference consensus/src/consensus.rs:
30-38): Propose(Block), Vote, Timeout, TC, SyncRequest(digest, origin),
Producer(digest) — the fork's payload-ingest message.

A copy of ``hotstuff_tpu.consensus.wire`` without the producer ingest
ACK and the state-sync frames (tags 7-10), which belong to the network
and store layers the port does not have yet: a frame with one of those
tags is an unknown tag here.  Every other frame encodes and decodes to
the same bytes and objects as in the JAX package.
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
# tags 7-10 are the state-sync frames (not ported yet)
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


def decode_message(data: bytes, scheme: str | None = None):
    """bytes -> (tag, payload). Raises SerializationError on malformed input.

    Payload by tag: Propose -> Block, Vote -> Vote, Timeout -> Timeout,
    TC -> TC, SyncRequest -> (Digest, PublicKey), Producer ->
    (Digest, body), ProducerV2 -> tuple of (Digest, body) pairs,
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
        elif tag == TAG_RECONFIG:
            out = ReconfigOp.decode(dec)
        else:
            raise CodecError(f"unknown message tag {tag}")
        dec.finish()
        return tag, out
    except CodecError as e:
        raise SerializationError(str(e)) from e
