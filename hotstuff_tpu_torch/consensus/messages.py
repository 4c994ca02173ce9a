"""Protocol messages: Block, Vote, QC, Timeout, TC.

Parity target: reference ``consensus/src/messages.rs`` (16-324). Same
protocol objects and verification rules, restructured for the TPU crypto
backend: every ``verify`` takes a ``VerifierBackend`` so certificate
signature checks ship as *batches* (QC: one shared digest, the
``verify_shared_msg`` shape; TC: distinct digests, the ``verify_many``
shape) instead of a sequential per-signature loop — the BASELINE.json
accumulate-then-dispatch rewrite.

Digest preimages (all SHA-512 truncated to 32 bytes):
- block:   author ‖ round_le8 ‖ payload ‖ qc.hash   (messages.rs:80-87)
- vote:    block_hash ‖ round_le8                   (messages.rs:148-153)
- qc:      hash ‖ round_le8                         (messages.rs:205-210)
- timeout: round_le8 ‖ high_qc.round_le8            (messages.rs:266-271)
TC entries sign the timeout digest for (tc.round, entry.high_qc_round)
(messages.rs:305-311).

A copy of ``hotstuff_tpu.consensus.messages``: the same digests, wire
bytes and verification rules.  A compact (aggregated BLS) certificate
verifies through ``BlsVerifier.verify_aggregate_msg``; the Ed25519
backends have none, so under them it never verifies, as in the JAX
package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..crypto import Digest, PublicKey, Signature, sha512_trunc
from ..crypto.service import VerifierBackend
from ..utils.codec import CodecError, Decoder, Encoder
from .config import Committee
from .errors import (
    AuthorityReuse,
    InvalidSignature,
    MalformedBlock,
    QCRequiresQuorum,
    TCRequiresQuorum,
    UnknownAuthority,
)
from .reconfig import ReconfigOp, validate_reconfig

Round = int

# Wire cap for length-prefixed key/signature fields (largest scheme:
# BLS 96-byte public keys; Ed25519 is 32/64).  One committee uses one
# scheme; the length prefix lets both coexist in the one wire format.
_MAX_KEYSIG = 96

# Compact-certificate wire form (aggregated BLS committees): inside the
# certificate's wire slot the vote count carries this sentinel, followed
# by a version byte, one aggregated G1 signature and a committee signer
# bitmap — constant-size in committee membership (48 + ceil(n/8) bytes
# vs n x 144 for the vote list).  ed25519 committees never emit it and
# scheme-pinned decoders reject it (wire.SCHEME_COMPACT_SIZES sets
# ``Decoder.compact_sig_size`` to 0 = forbidden).
COMPACT_SENTINEL = 0xFFFFFFFF
COMPACT_VERSION = 1
#: decode-time cap on the signer bitmap (bytes) — committees up to 4096
MAX_SIGNER_BITMAP = 512
#: decode-time cap on compact-TC groups (distinct high_qc_rounds)
MAX_COMPACT_GROUPS = 64
#: decode-time cap on vote-list entries in a QC/TC — one vote per
#: committee member, same 4096-member ceiling the signer bitmap encodes.
#: Without it a 4-byte wire count of 2**32 drives the vote decode loop
#: (an allocation bomb the codec's truncation check does not stop,
#: because each iteration reads only a few valid bytes before failing).
MAX_CERT_VOTES = 8 * MAX_SIGNER_BITMAP

#: process-wide QC-verify memo hits/misses — the ``qc_verify_cache_hit``
#: telemetry counter reads these (co-located committees share the
#: process, so the split is per-process, not per-node)
QC_CACHE_STATS = {"hits": 0, "misses": 0}


def make_signer_bitmap(authors, ordered: list[PublicKey]) -> bytes:
    """Bitmap over ``ordered`` (the round committee's ``sorted_keys()``)
    with one bit set per author; unknown authors raise."""
    index = {pk: i for i, pk in enumerate(ordered)}
    bits = bytearray((len(ordered) + 7) // 8)
    for pk in authors:
        i = index.get(pk)
        if i is None:
            raise UnknownAuthority(pk)
        bits[i // 8] |= 1 << (i % 8)
    return bytes(bits)


def bitmap_indices(bitmap: bytes):
    """Set-bit positions of a signer bitmap, ascending."""
    for byte_idx, b in enumerate(bitmap):
        while b:
            low = b & -b
            yield byte_idx * 8 + low.bit_length() - 1
            b ^= low


def bitmap_keys(bitmap: bytes, ordered: list[PublicKey]) -> list[PublicKey]:
    """Resolve a signer bitmap against the committee key order.  Bits
    beyond the committee size take the UnknownAuthority path — the same
    rule an unknown vote author hits in the vote-list form."""
    out = []
    for i in bitmap_indices(bitmap):
        if i >= len(ordered):
            raise UnknownAuthority(f"signer bit {i} of {len(ordered)}")
        out.append(ordered[i])
    return out


def _popcount(bitmap: bytes) -> int:
    return int.from_bytes(bitmap, "little").bit_count()


def _compact_allowed(dec: Decoder) -> None:
    if dec.compact_sig_size == 0:
        raise CodecError(
            "compact certificate not valid under this committee scheme"
        )


def _decode_agg_and_bitmap(dec: Decoder) -> tuple[Signature, bytes]:
    agg = dec.var_bytes(_MAX_KEYSIG)
    want = dec.compact_sig_size
    if want is not None and len(agg) != want:
        raise CodecError(
            f"aggregate signature must be {want} bytes under the "
            f"committee scheme, got {len(agg)}"
        )
    bitmap = dec.var_bytes(dec.compact_bitmap_max or MAX_SIGNER_BITMAP)
    try:
        return Signature(agg), bitmap
    except ValueError as e:
        raise CodecError(str(e)) from e


def _decode_compact_version(dec: Decoder) -> None:
    _compact_allowed(dec)
    version = dec.u8()
    if version != COMPACT_VERSION:
        raise CodecError(f"unknown compact-certificate version {version}")


# Precompiled struct layouts for the two hottest wire shapes (per-scheme
# pk/sig sizes).  When the decoder carries the committee's sizes
# (wire.decode_message sets them from the scheme), QC and Vote decoding
# collapses ~10 generic codec calls into one-or-two struct unpacks —
# byte-identical format, just fewer interpreter frames.  The generic
# Encoder/Decoder path remains for unpinned decoders (loopback, store
# deserialize, mixed-size tests).
def _qc_structs(ps: int, ss: int):
    key = (ps, ss)
    cached = _QC_STRUCTS.get(key)
    if cached is None:
        cached = (
            struct.Struct("<32sQI"),
            struct.Struct(f"<I{ps}sI{ss}s"),
        )
        _QC_STRUCTS[key] = cached
    return cached


def _vote_struct(ps: int, ss: int):
    key = (ps, ss)
    cached = _VOTE_STRUCTS.get(key)
    if cached is None:
        cached = struct.Struct(f"<32sQI{ps}sI{ss}s")
        _VOTE_STRUCTS[key] = cached
    return cached


_QC_STRUCTS: dict = {}
_VOTE_STRUCTS: dict = {}


def _round_le(r: Round) -> bytes:
    return struct.pack("<Q", r)


def encode_pk(enc: Encoder, pk: PublicKey) -> None:
    enc.var_bytes(pk.to_bytes())


def decode_pk(dec: Decoder) -> PublicKey:
    data = dec.var_bytes(_MAX_KEYSIG)
    if dec.pk_size is not None and len(data) != dec.pk_size:
        raise CodecError(
            f"public key must be {dec.pk_size} bytes under the "
            f"committee scheme, got {len(data)}"
        )
    try:
        return PublicKey(data)
    except ValueError as e:
        raise CodecError(str(e)) from e


def encode_sig(enc: Encoder, sig: Signature) -> None:
    enc.var_bytes(sig.to_bytes())


def decode_sig(dec: Decoder) -> Signature:
    data = dec.var_bytes(_MAX_KEYSIG)
    if dec.sig_size is not None and len(data) != dec.sig_size:
        raise CodecError(
            f"signature must be {dec.sig_size} bytes under the "
            f"committee scheme, got {len(data)}"
        )
    try:
        return Signature(data)
    except ValueError as e:
        raise CodecError(str(e)) from e


def _check_certificate_weight(
    votes_authors: list[PublicKey], committee: Committee, quorum_error
) -> None:
    """Shared QC/TC stake rule: no authority reuse, all known, 2f+1 stake."""
    weight = 0
    used: set[PublicKey] = set()
    for name in votes_authors:
        if name in used:
            raise AuthorityReuse(name)
        stake = committee.stake(name)
        if stake <= 0:
            raise UnknownAuthority(name)
        used.add(name)
        weight += stake
    if weight < committee.quorum_threshold():
        raise quorum_error()


@dataclass
class QC:
    """Quorum certificate: 2f+1 vote signatures over one block digest."""

    hash: Digest = field(default_factory=Digest)
    round: Round = 0
    votes: list[tuple[PublicKey, Signature]] = field(default_factory=list)
    # compact (aggregated) form: one G1 aggregate over the shared vote
    # digest plus a signer bitmap over the round committee's
    # sorted_keys() order.  ``votes`` is empty in this form; either form
    # proves the same 2f+1 statement and both coexist on the wire
    # (versioned sentinel encoding below).
    agg_sig: Signature | None = None
    signers: bytes | None = None
    # memoized wire encoding (same contract as Block._wire): the
    # committee's current high_qc is re-encoded on every ConsensusState
    # persist (once-plus per round per node) and in every block carrying
    # it; certificates never mutate after construction/decode.
    _wire: bytes | None = field(
        default=None, init=False, repr=False, compare=False
    )

    @classmethod
    def genesis(cls) -> "QC":
        return cls()

    def is_genesis(self) -> bool:
        return (
            self.hash == Digest()
            and self.round == 0
            and not self.votes
            and self.agg_sig is None
        )

    @property
    def is_compact(self) -> bool:
        return self.agg_sig is not None

    def signer_keys(self, committee: Committee) -> list[PublicKey]:
        """The compact form's signers, resolved against the round
        committee's canonical key order."""
        return bitmap_keys(
            self.signers, committee.for_round(self.round).sorted_keys()
        )

    def wire_size(self) -> int:
        """Encoded certificate size in bytes (the qc_bytes metric)."""
        enc = Encoder()
        self.encode(enc)
        return len(enc.finish())

    def timeout(self) -> bool:
        return self.hash == Digest() and self.round != 0

    def digest(self) -> Digest:
        return Digest(sha512_trunc(self.hash.to_bytes() + _round_le(self.round)))

    def _cache_key(self) -> bytes:
        """Identity of this certificate's full contents (hash, round and
        every vote) — two QCs with the same key are byte-identical, so a
        successful verification of one covers the other.

        The hashed material must be INJECTIVE in the vote list, not just
        the concatenated bytes: pk/sig accept multiple wire sizes (32/96
        and 64/48 for ed25519/BLS), so an unframed concatenation lets a
        different partitioning of the same byte stream (e.g. two 96+48
        votes vs three 32+64 chunks, both 288 bytes) collide with a
        verified QC's key and skip verification for a crafted
        certificate.  Hence the vote count and a u32 length prefix per
        field.  The compact form gets its own discriminator byte so an
        aggregate certificate can never collide with a vote-list one."""
        if self.is_compact:
            agg = self.agg_sig.to_bytes()
            parts = [
                b"\x01",
                self.hash.to_bytes(),
                _round_le(self.round),
                len(agg).to_bytes(4, "little"),
                agg,
                len(self.signers).to_bytes(4, "little"),
                self.signers,
            ]
            return sha512_trunc(b"".join(parts))
        parts = [
            b"\x00",
            self.hash.to_bytes(),
            _round_le(self.round),
            len(self.votes).to_bytes(4, "little"),
        ]
        for pk, sig in self.votes:
            parts.append(len(pk.data).to_bytes(4, "little"))
            parts.append(pk.data)
            parts.append(len(sig.data).to_bytes(4, "little"))
            parts.append(sig.data)
        return sha512_trunc(b"".join(parts))

    def check_weight(self, committee: Committee) -> None:
        """The stake/structure rules alone (no signatures): authority
        reuse, unknown authorities, 2f+1 stake — under this
        certificate's own round's committee.  The compact form resolves
        its bitmap first: a bit per member makes reuse structurally
        impossible, but sub-quorum bitmaps and out-of-range bits fail
        here exactly like their vote-list counterparts."""
        committee = committee.for_round(self.round)  # epoch seam
        if self.is_compact:
            _check_certificate_weight(
                bitmap_keys(self.signers, committee.sorted_keys()),
                committee,
                QCRequiresQuorum,
            )
            return
        _check_certificate_weight(
            [pk for pk, _ in self.votes], committee, QCRequiresQuorum
        )

    def claims(
        self, cache: set | None = None, committee: Committee | None = None
    ) -> list:
        """The signature claims an async preverifier must discharge for
        this certificate (crypto/async_service.py): one shared-message
        claim (vote-list form) or one aggregate claim (compact form —
        needs ``committee`` to resolve the signer bitmap), or none when
        genesis / already memoized in ``cache``.

        SAFETY: a successful claim verdict proves only the SIGNATURES.
        A caller that memoizes this certificate as verified (the core's
        qc_cache — ``verify`` early-returns on a hit) must check
        ``check_weight`` FIRST, or a sub-quorum certificate with one
        valid self-signature would enter the cache and bypass the
        quorum rule forever."""
        if self.is_genesis():
            return []
        if cache is not None and self._cache_key() in cache:
            QC_CACHE_STATS["hits"] += 1
            return []
        if self.is_compact:
            if committee is None:
                raise ValueError(
                    "compact QC claims need the committee to resolve "
                    "the signer bitmap"
                )
            return [
                (
                    "agg",
                    self.digest().to_bytes(),
                    self.agg_sig.to_bytes(),
                    tuple(
                        pk.to_bytes() for pk in self.signer_keys(committee)
                    ),
                )
            ]
        return [
            (
                "shared",
                self.digest().to_bytes(),
                tuple((pk.to_bytes(), sig.to_bytes()) for pk, sig in self.votes),
            )
        ]

    def verify(
        self,
        committee: Committee,
        verifier: VerifierBackend,
        cache: set | None = None,
        sigs_verified: bool = False,
    ) -> None:
        """``cache`` (per-core, optional) memoizes certificates that
        already verified against THIS committee: under a view-change
        storm every one of n timeouts carries the same high_qc, and
        without the memo the node re-runs the identical batch
        verification n times (n x the most expensive check in the
        protocol).  Only successes are cached; the set is bounded by the
        owner (core.py).

        ``sigs_verified=True``: the caller already discharged this
        certificate's signature ``claims()`` through the async
        preverifier — only the stake/structure rules run here."""
        key = None
        if cache is not None:
            key = self._cache_key()
            if key in cache:
                QC_CACHE_STATS["hits"] += 1
                return
            QC_CACHE_STATS["misses"] += 1
        self.check_weight(committee)
        if not sigs_verified:
            if self.is_compact:
                # Bitmap-selected public keys summed + ONE pairing,
                # regardless of committee size (verify_aggregate_msg —
                # BLS backends only; a backend without it cannot accept
                # an aggregate certificate).
                fn = getattr(verifier, "verify_aggregate_msg", None)
                pks = [pk.to_bytes() for pk in self.signer_keys(committee)]
                if fn is None or not fn(
                    self.digest(), pks, self.agg_sig.to_bytes()
                ):
                    raise InvalidSignature(
                        f"bad aggregate signature in QC for {self.hash}"
                    )
            # One batched verification over the shared vote digest — the
            # hot kernel (reference messages.rs:195 → crypto verify_batch).
            elif not verifier.verify_shared_msg(self.digest(), self.votes):
                raise InvalidSignature(f"bad signature in QC for {self.hash}")
        if cache is not None:
            cache.add(key)

    # equality on (hash, round) only, like the reference (messages.rs:213-217)
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, QC)
            and self.hash == other.hash
            and self.round == other.round
        )

    def __hash__(self) -> int:
        return hash((self.hash, self.round))

    def encode(self, enc: Encoder) -> None:
        w = self._wire
        if w is None:
            e = Encoder()
            e.raw(self.hash.to_bytes()).u64(self.round)
            if self.is_compact:
                e.u32(COMPACT_SENTINEL).u8(COMPACT_VERSION)
                e.var_bytes(self.agg_sig.to_bytes())
                e.var_bytes(self.signers)
            else:
                e.u32(len(self.votes))
                for pk, sig in self.votes:
                    encode_pk(e, pk)
                    encode_sig(e, sig)
            w = e.finish()
            self._wire = w
        enc.raw(w)

    @classmethod
    def decode(cls, dec: Decoder) -> "QC":
        ps, ss = dec.pk_size, dec.sig_size
        if ps is not None and ss is not None:
            return cls._decode_fast(dec, ps, ss)
        start = dec.mark()
        h = Digest(dec.raw(Digest.SIZE))
        rnd = dec.u64()
        n = dec.u32()
        if n == COMPACT_SENTINEL:
            _decode_compact_version(dec)
            agg, signers = _decode_agg_and_bitmap(dec)
            qc = cls(hash=h, round=rnd, agg_sig=agg, signers=signers)
            qc._wire = dec.since(start)
            return qc
        if n > MAX_CERT_VOTES:
            raise CodecError(f"QC vote count {n} exceeds cap {MAX_CERT_VOTES}")
        votes = [(decode_pk(dec), decode_sig(dec)) for _ in range(n)]
        qc = cls(hash=h, round=rnd, votes=votes)
        qc._wire = dec.since(start)
        return qc

    @classmethod
    def _decode_fast(cls, dec: Decoder, ps: int, ss: int) -> "QC":
        # struct fast path for a scheme-pinned decoder; byte-identical
        # wire layout to the generic path above (incl. the per-field
        # u32 length prefixes), same CodecError semantics
        head, entry = _qc_structs(ps, ss)
        data, start = dec._data, dec._pos
        try:
            h, rnd, n = head.unpack_from(data, start)
        except struct.error as e:
            raise CodecError(f"truncated QC header: {e}") from e
        if n == COMPACT_SENTINEL:
            # compact certificate under a scheme-pinned decoder: hand
            # the tail back to the generic codec (scheme gating and
            # size narrowing live in _decode_agg_and_bitmap)
            dec._pos = start + head.size
            _decode_compact_version(dec)
            agg, signers = _decode_agg_and_bitmap(dec)
            qc = cls(hash=Digest(h), round=rnd, agg_sig=agg, signers=signers)
            qc._wire = data[start : dec._pos]
            return qc
        pos = start + head.size
        end = pos + n * entry.size
        if end > len(data):
            raise CodecError(
                f"truncated: QC claims {n} votes past end of input"
            )
        votes = []
        for off in range(pos, end, entry.size):
            lp, pkb, ls, sgb = entry.unpack_from(data, off)
            if lp != ps or ls != ss:
                raise CodecError(
                    f"key/signature sizes ({lp}/{ls}) do not match the "
                    f"committee scheme ({ps}/{ss})"
                )
            votes.append((PublicKey(pkb), Signature(sgb)))
        qc = cls(hash=Digest(h), round=rnd, votes=votes)
        dec._pos = end
        qc._wire = data[start:end]
        return qc

    def __repr__(self) -> str:
        return f"QC({self.hash}, {self.round})"


@dataclass
class TC:
    """Timeout certificate: 2f+1 timeout signatures for one round."""

    round: Round = 0
    # (author, signature, author's high_qc round)
    votes: list[tuple[PublicKey, Signature, Round]] = field(default_factory=list)
    # compact (aggregated) form: per distinct high_qc_round, one G1
    # aggregate over timeout_digest(round, hq_round) plus a signer
    # bitmap; ``votes`` is empty in this form
    groups: list[tuple[Round, Signature, bytes]] | None = None

    @property
    def is_compact(self) -> bool:
        return self.groups is not None

    def high_qc_rounds(self) -> list[Round]:
        if self.is_compact:
            out: list[Round] = []
            for hq, _, bitmap in self.groups:
                out.extend([hq] * _popcount(bitmap))
            return out
        return [r for _, _, r in self.votes]

    def claims(self, committee: Committee | None = None) -> list:
        """Signature claims for the async preverifier: entries signing
        the SAME timeout digest (same high_qc_round — the common storm
        shape) group into shared claims so aggregate-preferring backends
        (BLS) pay one check per group; distinct rounds become single
        claims.  The compact form emits one aggregate claim per group
        (needs ``committee`` to resolve the signer bitmaps)."""
        if self.is_compact:
            if committee is None:
                raise ValueError(
                    "compact TC claims need the committee to resolve "
                    "the signer bitmaps"
                )
            ordered = committee.for_round(self.round).sorted_keys()
            return [
                (
                    "agg",
                    timeout_digest(self.round, hq).to_bytes(),
                    agg.to_bytes(),
                    tuple(
                        pk.to_bytes() for pk in bitmap_keys(bitmap, ordered)
                    ),
                )
                for hq, agg, bitmap in self.groups
            ]
        groups: dict[Round, list] = {}
        for pk, sig, hq_round in self.votes:
            groups.setdefault(hq_round, []).append((pk, sig))
        out = []
        for hq_round, members in groups.items():
            digest = timeout_digest(self.round, hq_round).to_bytes()
            if len(members) == 1:
                pk, sig = members[0]
                out.append(("one", digest, pk.to_bytes(), sig.to_bytes()))
            else:
                out.append(
                    (
                        "shared",
                        digest,
                        tuple(
                            (pk.to_bytes(), sig.to_bytes())
                            for pk, sig in members
                        ),
                    )
                )
        return out

    def verify(
        self,
        committee: Committee,
        verifier: VerifierBackend,
        sigs_verified: bool = False,
    ) -> None:
        committee = committee.for_round(self.round)  # epoch seam
        if self.is_compact:
            ordered = committee.sorted_keys()
            authors: list[PublicKey] = []
            for _, _, bitmap in self.groups:
                authors.extend(bitmap_keys(bitmap, ordered))
            # a node in two groups is authority reuse, caught here
            _check_certificate_weight(authors, committee, TCRequiresQuorum)
            if sigs_verified:
                return
            fn = getattr(verifier, "verify_aggregate_msg", None)
            for hq, agg, bitmap in self.groups:
                pks = [pk.to_bytes() for pk in bitmap_keys(bitmap, ordered)]
                if fn is None or not fn(
                    timeout_digest(self.round, hq), pks, agg.to_bytes()
                ):
                    raise InvalidSignature(
                        f"bad aggregate signature in TC for round {self.round}"
                    )
            return
        _check_certificate_weight(
            [pk for pk, _, _ in self.votes], committee, TCRequiresQuorum
        )
        if sigs_verified:
            return  # claims() discharged by the async preverifier
        # Each entry signs a different digest (its own high_qc_round), so
        # this is the distinct-message batch shape (reference verifies these
        # sequentially, messages.rs:305-311 — here one dispatched batch).
        digests = [
            timeout_digest(self.round, hq_round).to_bytes()
            for _, _, hq_round in self.votes
        ]
        ok = verifier.verify_many(
            digests,
            [pk.to_bytes() for pk, _, _ in self.votes],
            [sig.to_bytes() for _, sig, _ in self.votes],
            aggregate_ok=True,
        )
        if not all(ok):
            raise InvalidSignature(f"bad signature in TC for round {self.round}")

    def encode(self, enc: Encoder) -> None:
        if self.is_compact:
            enc.u64(self.round).u32(COMPACT_SENTINEL).u8(COMPACT_VERSION)
            enc.u8(len(self.groups))
            for hq, agg, bitmap in self.groups:
                enc.u64(hq)
                enc.var_bytes(agg.to_bytes())
                enc.var_bytes(bitmap)
            return
        enc.u64(self.round).u32(len(self.votes))
        for pk, sig, hq in self.votes:
            encode_pk(enc, pk)
            encode_sig(enc, sig)
            enc.u64(hq)

    @classmethod
    def decode(cls, dec: Decoder) -> "TC":
        rnd = dec.u64()
        n = dec.u32()
        if n == COMPACT_SENTINEL:
            _decode_compact_version(dec)
            count = dec.u8()
            if count > MAX_COMPACT_GROUPS:
                raise CodecError(
                    f"compact TC groups {count} exceed cap "
                    f"{MAX_COMPACT_GROUPS}"
                )
            groups = []
            for _ in range(count):
                hq = dec.u64()
                agg, bitmap = _decode_agg_and_bitmap(dec)
                groups.append((hq, agg, bitmap))
            return cls(round=rnd, groups=groups)
        if n > MAX_CERT_VOTES:
            raise CodecError(f"TC vote count {n} exceeds cap {MAX_CERT_VOTES}")
        votes = [
            (decode_pk(dec), decode_sig(dec), dec.u64()) for _ in range(n)
        ]
        return cls(round=rnd, votes=votes)

    def __repr__(self) -> str:
        return f"TC({self.round}, {self.high_qc_rounds()})"


def timeout_digest(round_: Round, high_qc_round: Round) -> Digest:
    """The digest a Timeout (and thus each TC entry) signs."""
    return Digest(sha512_trunc(_round_le(round_) + _round_le(high_qc_round)))


# Protocol-level cap on payload digests per block, enforced on RECEIVED
# blocks in Block.verify (a Byzantine leader must not be able to ship a
# frame-limit-sized block and wedge every node's store path).  The honest
# proposer uses the same constant when draining its buffer.
MAX_BLOCK_PAYLOADS = 512


@dataclass
class Block:
    """A proposal: extends the block certified by ``qc`` with a list of
    payload digests.

    The reference fork narrowed upstream's ``Vec<Digest>`` payload to a
    single digest (reference messages.rs:16-23); this build restores the
    vector form — one round can drain the whole producer backlog, so
    committed-payload throughput is round-rate x batch-size instead of
    being capped at one payload per round."""

    qc: QC = field(default_factory=QC)
    tc: TC | None = None
    author: PublicKey = field(default_factory=PublicKey)
    round: Round = 0
    payloads: tuple[Digest, ...] = ()
    signature: Signature = field(default_factory=Signature)
    # Typed epoch-change payload (consensus/reconfig.py): at most one
    # per block; covered by the block digest (votes certify the op),
    # validated in ``verify`` so a forged epoch change never earns an
    # honest vote, and applied by the commit path via
    # ``CommitteeSchedule.splice``.
    reconfig: ReconfigOp | None = None
    # memoized digest — blocks are immutable after construction and the
    # digest is recomputed on the hot path (signature check, store key,
    # commit walk, log lines): ~20 us of SHA-512 + joins per call
    _digest: Digest | None = field(
        default=None, init=False, repr=False, compare=False
    )
    # memoized wire encoding — a received block is decoded from wire
    # bytes and then re-serialized for the store write (core store_block
    # path); capturing the decode slice makes serialize() a cached
    # return.  Safe for the same reason _digest is: blocks never mutate
    # after construction.
    _wire: bytes | None = field(
        default=None, init=False, repr=False, compare=False
    )

    @classmethod
    def genesis(cls) -> "Block":
        return cls()

    @property
    def parent(self) -> Digest:
        return self.qc.hash

    def digest(self) -> Digest:
        d = self._digest
        if d is None:
            # The reconfig op digest is appended only when present, so
            # every reconfig-free block keeps the pre-reconfiguration
            # preimage byte-for-byte.
            d = Digest(
                sha512_trunc(
                    self.author.to_bytes()
                    + _round_le(self.round)
                    + b"".join(p.to_bytes() for p in self.payloads)
                    + self.qc.hash.to_bytes()
                    + (
                        self.reconfig.digest()
                        if self.reconfig is not None
                        else b""
                    )
                )
            )
            self._digest = d
        return d

    def claims(
        self,
        qc_cache: set | None = None,
        committee: Committee | None = None,
    ) -> list:
        """Signature claims for the async preverifier: the author
        signature, the embedded QC (unless memoized), and the embedded
        TC's entries.  ``committee`` is required when the embedded
        certificates are compact (signer-bitmap resolution)."""
        out = [
            (
                "one",
                self.digest().to_bytes(),
                self.author.to_bytes(),
                self.signature.to_bytes(),
            )
        ]
        out.extend(self.qc.claims(cache=qc_cache, committee=committee))
        if self.tc is not None:
            out.extend(self.tc.claims(committee=committee))
        return out

    def verify(
        self,
        committee: Committee,
        verifier: VerifierBackend,
        qc_cache: set | None = None,
        sigs_verified: bool = False,
    ) -> None:
        # Epoch seam: the author is judged by the block round's
        # committee; each embedded certificate routes ITSELF to its own
        # round's committee inside QC.verify/TC.verify (at an epoch
        # boundary the first new-epoch block carries a QC formed by the
        # previous epoch's validators).  for_round is the identity on a
        # bare Committee.
        com = committee.for_round(self.round)
        if com.stake(self.author) <= 0:
            raise UnknownAuthority(self.author)
        if len(self.payloads) > MAX_BLOCK_PAYLOADS:
            raise MalformedBlock(self.digest())
        if self.reconfig is not None:
            # Raises InvalidReconfig: a block carrying a forged or
            # unauthorized epoch change never earns an honest vote.
            validate_reconfig(
                self.reconfig, committee, self.round, verifier=verifier
            )
        if not sigs_verified and not verifier.verify_one(
            self.digest(), self.author, self.signature
        ):
            raise InvalidSignature(f"bad author signature on block {self}")
        if not self.qc.is_genesis():
            self.qc.verify(
                committee, verifier, cache=qc_cache, sigs_verified=sigs_verified
            )
        if self.tc is not None:
            self.tc.verify(committee, verifier, sigs_verified=sigs_verified)

    def encode(self, enc: Encoder) -> None:
        self.qc.encode(enc)
        enc.flag(self.tc is not None)
        if self.tc is not None:
            self.tc.encode(enc)
        encode_pk(enc, self.author)
        enc.u64(self.round)
        enc.u32(len(self.payloads))
        for p in self.payloads:
            enc.raw(p.to_bytes())
        enc.flag(self.reconfig is not None)
        if self.reconfig is not None:
            self.reconfig.encode(enc)
        encode_sig(enc, self.signature)

    @classmethod
    def decode(cls, dec: Decoder) -> "Block":
        start = dec.mark()
        qc = QC.decode(dec)
        tc = TC.decode(dec) if dec.flag() else None
        author = decode_pk(dec)
        rnd = dec.u64()
        n = dec.u32()
        if n > MAX_BLOCK_PAYLOADS:
            # Block.verify re-checks this for protocol attribution, but
            # the decode-time cap stops a forged count from sizing the
            # digest-vector read at all
            raise CodecError(
                f"block payload count {n} exceeds cap {MAX_BLOCK_PAYLOADS}"
            )
        # one bounds-checked read for the whole digest vector (a block
        # carries up to 512 payload digests — the per-digest raw() call
        # was the hottest decode loop in the profile)
        raw = dec.raw(Digest.SIZE * n)
        payloads = tuple(
            Digest(raw[i : i + Digest.SIZE])
            for i in range(0, Digest.SIZE * n, Digest.SIZE)
        )
        reconfig = ReconfigOp.decode(dec) if dec.flag() else None
        sig = decode_sig(dec)
        block = cls(
            qc=qc,
            tc=tc,
            author=author,
            round=rnd,
            payloads=payloads,
            signature=sig,
            reconfig=reconfig,
        )
        block._wire = dec.since(start)
        return block

    def serialize(self) -> bytes:
        w = self._wire
        if w is None:
            enc = Encoder()
            self.encode(enc)
            w = enc.finish()
            self._wire = w
        return w

    @classmethod
    def deserialize(cls, data: bytes) -> "Block":
        dec = Decoder(data)
        block = cls.decode(dec)
        dec.finish()
        return block

    def __repr__(self) -> str:
        return (
            f"{self.digest()}: B({self.author}, {self.round}, "
            f"{self.qc!r}, {len(self.payloads)} payloads)"
        )

    def __str__(self) -> str:
        return f"B{self.round}"


@dataclass
class Vote:
    """A vote over a block digest, addressed to the next leader."""

    hash: Digest
    round: Round
    author: PublicKey
    signature: Signature = field(default_factory=Signature)
    _digest: Digest | None = field(
        default=None, init=False, repr=False, compare=False
    )

    @classmethod
    def for_block(cls, block: Block, author: PublicKey) -> "Vote":
        """Unsigned vote; the caller signs ``digest()`` via SignatureService."""
        return cls(hash=block.digest(), round=block.round, author=author)

    def digest(self) -> Digest:
        d = self._digest
        if d is None:
            d = Digest(
                sha512_trunc(self.hash.to_bytes() + _round_le(self.round))
            )
            self._digest = d
        return d

    def claim(self) -> tuple:
        """This vote's signature claim for the async preverifier."""
        return (
            "one",
            self.digest().to_bytes(),
            self.author.to_bytes(),
            self.signature.to_bytes(),
        )

    def verify(self, committee: Committee, verifier: VerifierBackend) -> None:
        if committee.for_round(self.round).stake(self.author) <= 0:
            raise UnknownAuthority(self.author)
        if not verifier.verify_one(self.digest(), self.author, self.signature):
            raise InvalidSignature(f"bad signature on vote {self}")

    def encode(self, enc: Encoder) -> None:
        enc.raw(self.hash.to_bytes()).u64(self.round)
        encode_pk(enc, self.author)
        encode_sig(enc, self.signature)

    @classmethod
    def decode(cls, dec: Decoder) -> "Vote":
        ps, ss = dec.pk_size, dec.sig_size
        if ps is not None and ss is not None:
            # struct fast path (scheme-pinned decoder) — same layout and
            # CodecError semantics as the generic path below
            s = _vote_struct(ps, ss)
            try:
                h, rnd, lp, pkb, ls, sgb = s.unpack_from(
                    dec._data, dec._pos
                )
            except struct.error as e:
                raise CodecError(f"truncated vote: {e}") from e
            if lp != ps or ls != ss:
                raise CodecError(
                    f"key/signature sizes ({lp}/{ls}) do not match the "
                    f"committee scheme ({ps}/{ss})"
                )
            dec._pos += s.size
            return cls(
                hash=Digest(h),
                round=rnd,
                author=PublicKey(pkb),
                signature=Signature(sgb),
            )
        return cls(
            hash=Digest(dec.raw(Digest.SIZE)),
            round=dec.u64(),
            author=decode_pk(dec),
            signature=decode_sig(dec),
        )

    def __repr__(self) -> str:
        return f"V({self.author}, {self.round}, {self.hash})"


@dataclass
class Timeout:
    """A round-timeout complaint carrying the sender's highest QC."""

    high_qc: QC
    round: Round
    author: PublicKey
    signature: Signature = field(default_factory=Signature)

    def digest(self) -> Digest:
        return timeout_digest(self.round, self.high_qc.round)

    def verify(
        self,
        committee: Committee,
        verifier: VerifierBackend,
        qc_cache: set | None = None,
        sig_verified: bool = False,
    ) -> None:
        """``sig_verified=True`` skips only the author-signature check —
        for callers that already verified it as part of a burst
        aggregate (Core's timeout-flood batching); the authority/stake
        check and the embedded-QC verification always run."""
        if committee.for_round(self.round).stake(self.author) <= 0:
            raise UnknownAuthority(self.author)
        if not sig_verified and not verifier.verify_one(
            self.digest(), self.author, self.signature
        ):
            raise InvalidSignature(f"bad signature on timeout {self}")
        if not self.high_qc.is_genesis():
            # QC.verify routes itself to its own round's committee
            self.high_qc.verify(committee, verifier, cache=qc_cache)

    def encode(self, enc: Encoder) -> None:
        self.high_qc.encode(enc)
        enc.u64(self.round)
        encode_pk(enc, self.author)
        encode_sig(enc, self.signature)

    @classmethod
    def decode(cls, dec: Decoder) -> "Timeout":
        return cls(
            high_qc=QC.decode(dec),
            round=dec.u64(),
            author=decode_pk(dec),
            signature=decode_sig(dec),
        )

    def __repr__(self) -> str:
        return f"TV({self.author}, {self.round}, {self.high_qc!r})"
