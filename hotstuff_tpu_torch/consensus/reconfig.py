"""Consensus-driven committee reconfiguration: the typed epoch-change op.

BEYOND reference parity (the reference fleet is frozen at boot): a
``ReconfigOp`` carries the NEXT epoch's full committee plus an
activation margin Δ.  It is sponsored (signed) by a current member,
proposed inside a block, 2-chain committed like any other block, and
applied by every node's commit path — which splices
``(commit_round + Δ, new_committee)`` into the shared, mutable
``CommitteeSchedule``.  Certificates formed at the boundary keep
verifying under their own epoch (the ``for_round`` seam); leader
election, stake checks and wire-scheme narrowing roll forward at the
activation round.

Wire form (versioned; decode-time caps on every attacker-sized field):

    u8  version (RECONFIG_OP_VERSION)
    u64 epoch                     -- must be current epoch + 1
    var scheme (<= 16 bytes)      -- "ed25519" | "bls"
    u32 margin                    -- activation delay Δ in rounds
    u16 member count              -- capped at MAX_RECONFIG_MEMBERS
    per member:
        var pk (<= 96)  u64 stake  var host (<= 255)  u32 port
        flag pop?  [var pop (<= 96)]
    var sponsor pk (<= 96)
    var sponsor signature (<= 96)  -- over digest() of everything above

The sponsor rule is the submission-authorization gate: only a member of
the committee in effect at the proposing round may introduce an epoch
change, and every voter re-checks the sponsor signature inside
``Block.verify`` — a forged or out-of-protocol reconfiguration dies at
verification (the ``byz-reconfig`` adversary policy exercises exactly
this path).

A copy of ``hotstuff_tpu.consensus.reconfig``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import Digest, PublicKey, Signature, sha512_trunc
from ..utils.codec import CodecError, Decoder, Encoder
from .config import Authority, Committee, InvalidCommittee
from .errors import InvalidReconfig

#: wire version byte of the reconfiguration op
RECONFIG_OP_VERSION = 1
#: decode-time cap on the proposed committee's member count
MAX_RECONFIG_MEMBERS = 128
#: activation margin bounds: the lower bound keeps the boundary past the
#: 2-chain commit depth of the op's own block (every node must be able
#: to commit-and-splice before certificates for the new epoch arrive);
#: the upper bound rejects a margin that would park the epoch change
#: beyond any practical run.
RECONFIG_MIN_MARGIN = 2
RECONFIG_MAX_MARGIN = 1_000_000

_MAX_SCHEME = 16
_MAX_HOST = 255
_MAX_KEYSIG = 96
_KNOWN_SCHEMES = ("ed25519", "bls")


def encode_committee(enc: Encoder, committee: Committee) -> None:
    """Canonical wire form of one epoch's committee (sorted key order —
    two nodes encoding the same committee must produce identical bytes,
    the op digest depends on it)."""
    enc.u64(committee.epoch)
    enc.var_bytes(committee.scheme.encode())
    names = committee.sorted_keys()
    enc.u16(len(names))
    for name in names:
        auth = committee.authorities[name]
        enc.var_bytes(name.to_bytes())
        enc.u64(auth.stake)
        host, port = auth.address
        enc.var_bytes(host.encode())
        enc.u32(port)
        enc.flag(auth.pop is not None)
        if auth.pop is not None:
            enc.var_bytes(auth.pop)


def decode_committee(dec: Decoder) -> Committee:
    epoch = dec.u64()
    scheme_raw = dec.var_bytes(_MAX_SCHEME)
    try:
        scheme = scheme_raw.decode("ascii")
    except UnicodeDecodeError as e:
        raise CodecError(f"non-ascii committee scheme: {e}") from e
    if scheme not in _KNOWN_SCHEMES:
        raise CodecError(f"unknown committee scheme '{scheme}'")
    n = dec.u16()
    if n > MAX_RECONFIG_MEMBERS:
        raise CodecError(
            f"reconfig member count {n} exceeds cap {MAX_RECONFIG_MEMBERS}"
        )
    authorities: dict[PublicKey, Authority] = {}
    for _ in range(n):
        pk_raw = dec.var_bytes(_MAX_KEYSIG)
        try:
            pk = PublicKey(pk_raw)
        except ValueError as e:
            raise CodecError(str(e)) from e
        stake = dec.u64()
        host_raw = dec.var_bytes(_MAX_HOST)
        try:
            host = host_raw.decode("ascii")
        except UnicodeDecodeError as e:
            raise CodecError(f"non-ascii member host: {e}") from e
        port = dec.u32()
        pop = dec.var_bytes(_MAX_KEYSIG) if dec.flag() else None
        if pk in authorities:
            raise CodecError(f"duplicate member {pk} in reconfig committee")
        authorities[pk] = Authority(stake, (host, port), pop=pop)
    return Committee(authorities=authorities, epoch=epoch, scheme=scheme)


@dataclass
class ReconfigOp:
    """A sponsored epoch change: the next epoch's committee + margin Δ."""

    new_committee: Committee
    margin: int
    sponsor: PublicKey = field(default_factory=PublicKey)
    signature: Signature = field(default_factory=Signature)
    _digest: bytes | None = field(
        default=None, init=False, repr=False, compare=False
    )

    def digest(self) -> bytes:
        """Digest of the op body (everything the sponsor signs; the
        sponsor fields themselves are excluded)."""
        d = self._digest
        if d is None:
            enc = Encoder()
            self._encode_body(enc)
            d = sha512_trunc(enc.finish())
            self._digest = d
        return d

    def _encode_body(self, enc: Encoder) -> None:
        enc.u8(RECONFIG_OP_VERSION)
        encode_committee(enc, self.new_committee)
        enc.u32(self.margin)

    def encode(self, enc: Encoder) -> None:
        self._encode_body(enc)
        enc.var_bytes(self.sponsor.to_bytes())
        enc.var_bytes(self.signature.to_bytes())

    @classmethod
    def decode(cls, dec: Decoder) -> "ReconfigOp":
        version = dec.u8()
        if version != RECONFIG_OP_VERSION:
            raise CodecError(f"unknown reconfig op version {version}")
        committee = decode_committee(dec)
        margin = dec.u32()
        try:
            sponsor = PublicKey(dec.var_bytes(_MAX_KEYSIG))
            signature = Signature(dec.var_bytes(_MAX_KEYSIG))
        except ValueError as e:
            raise CodecError(str(e)) from e
        return cls(
            new_committee=committee,
            margin=margin,
            sponsor=sponsor,
            signature=signature,
        )

    def serialize(self) -> bytes:
        enc = Encoder()
        self.encode(enc)
        return enc.finish()

    @classmethod
    def deserialize(cls, data: bytes) -> "ReconfigOp":
        dec = Decoder(data)
        op = cls.decode(dec)
        dec.finish()
        return op

    def __repr__(self) -> str:
        return (
            f"ReconfigOp(epoch {self.new_committee.epoch}, "
            f"{len(self.new_committee.authorities)} members, "
            f"margin {self.margin})"
        )


def newest_epoch(committee) -> int:
    """Highest epoch number anywhere in the schedule (a bare Committee
    is its own single epoch)."""
    return max(c.epoch for c in committee.committees())


def validate_reconfig(op: ReconfigOp, committee, round_, verifier=None):
    """The verification gate every honest node applies to a reconfig op
    — at submission, at ``Block.verify`` (so a Byzantine leader's forged
    epoch change dies before any honest vote), and again defensively at
    apply.  ``committee`` is the node's committee/schedule; ``round_``
    the round the op is proposed in.  ``verifier`` (when given) also
    checks the sponsor signature.  Raises ``InvalidReconfig``.
    """
    current = committee.for_round(round_)
    new = op.new_committee
    if not (RECONFIG_MIN_MARGIN <= op.margin <= RECONFIG_MAX_MARGIN):
        raise InvalidReconfig(
            f"activation margin {op.margin} outside "
            f"[{RECONFIG_MIN_MARGIN}, {RECONFIG_MAX_MARGIN}]"
        )
    if not new.authorities:
        raise InvalidReconfig("proposed committee is empty")
    if len(new.authorities) > MAX_RECONFIG_MEMBERS:
        raise InvalidReconfig(
            f"proposed committee has {len(new.authorities)} members "
            f"(cap {MAX_RECONFIG_MEMBERS})"
        )
    if new.scheme not in _KNOWN_SCHEMES:
        raise InvalidReconfig(f"unknown scheme '{new.scheme}'")
    if any(a.stake <= 0 for a in new.authorities.values()):
        raise InvalidReconfig("proposed committee has a zero-stake member")
    if new.epoch != newest_epoch(committee) + 1:
        raise InvalidReconfig(
            f"proposed epoch {new.epoch} does not succeed newest "
            f"scheduled epoch {newest_epoch(committee)}"
        )
    # Continuity: the carried-over members must hold at least f+1 of the
    # CURRENT epoch's stake, so at least one honest current member is
    # guaranteed to survive into the new epoch (a forged committee of
    # attacker-only keys fails here even if structurally well-formed).
    overlap = sum(
        current.stake(name)
        for name in new.authorities
        if current.stake(name) > 0
    )
    if overlap < current.validity_threshold():
        raise InvalidReconfig(
            f"carried-over stake {overlap} below the current epoch's "
            f"validity threshold {current.validity_threshold()}"
        )
    if current.stake(op.sponsor) <= 0:
        raise InvalidReconfig(
            f"sponsor {op.sponsor} is not a member of the current epoch"
        )
    if verifier is not None and not verifier.verify_one(
        Digest(op.digest()), op.sponsor, op.signature
    ):
        raise InvalidReconfig("bad sponsor signature on reconfig op")
    # Rogue-key hardening carries over: a BLS successor committee must
    # prove possession per member before it can ever be spliced.
    try:
        new.verify_pops()
    except InvalidCommittee as e:
        raise InvalidReconfig(str(e)) from e


def splice_schedule_links(
    links,
    committee,
    verifier,
    qc_cache: set | None = None,
    journal=None,
    log=None,
) -> int:
    """Verified-successor acceptance (docs/RECONFIG.md): walk a certified
    ``(reconfig block bytes, certifying QC bytes)`` chain — served in a
    state-sync manifest or replayed from the local store at boot — and
    splice every epoch change not yet present into the schedule.

    Each link is self-certifying: the op is re-validated against the
    schedule *as extended so far*, and the QC must certify exactly that
    block under the committee in effect at its round.  A node that
    started from only the genesis committee file therefore ends up with
    the same schedule a live witness holds, or the chain is rejected.

    Returns the number of links spliced; raises :class:`InvalidReconfig`
    on the first link that fails verification (callers discard the whole
    chain — a partial splice is still safe, since every applied link was
    individually certified)."""
    from ..utils.codec import CodecError, Decoder
    from .errors import ConsensusError
    from .messages import QC, Block

    if not links:
        return 0
    if not hasattr(committee, "splice"):
        raise InvalidReconfig(
            "static committee cannot accept schedule links"
        )
    spliced = 0
    for raw_block, raw_qc in links:
        try:
            block = Block.deserialize(raw_block)
            dec = Decoder(raw_qc)
            qc = QC.decode(dec)
            dec.finish()
        except (CodecError, ConsensusError, ValueError) as e:
            raise InvalidReconfig(f"corrupt schedule link: {e}") from e
        op = block.reconfig
        if op is None:
            raise InvalidReconfig("schedule link carries no reconfig op")
        if op.new_committee.epoch <= newest_epoch(committee):
            continue  # already spliced (earlier chain, or live witness)
        validate_reconfig(op, committee, block.round, verifier=verifier)
        if qc.hash != block.digest() or qc.round != block.round:
            raise InvalidReconfig(
                "schedule link QC does not certify its block"
            )
        try:
            qc.verify(committee, verifier, cache=qc_cache)
        except ConsensusError as e:
            raise InvalidReconfig(
                f"schedule link QC failed to verify: {e}"
            ) from e
        activation = block.round + op.margin
        try:
            committee.splice(activation, op.new_committee)
        except InvalidCommittee as e:
            raise InvalidReconfig(str(e)) from e
        spliced += 1
        if journal is not None:
            journal.record("reconfig.link", block.round)
        if log is not None:
            log.info(
                "Verified schedule link: epoch %d activates at round %d",
                op.new_committee.epoch,
                activation,
            )
    return spliced
