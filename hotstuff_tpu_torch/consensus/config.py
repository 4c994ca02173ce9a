"""Committee and protocol parameters.

Parity target: reference ``consensus/src/config.rs:10-85`` — ``Parameters``
{timeout_delay: 5000 ms, sync_retry_delay: 10000 ms}, ``Committee`` mapping
public keys to {stake, address} with epoch number and the BFT quorum rule
``2N/3 + 1`` (= N - f for N = 3f + 1 + k).

A copy of ``hotstuff_tpu.consensus.config``, whole (the BLS
proof-of-possession check included).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..crypto import PublicKey

log = logging.getLogger(__name__)

Address = tuple[str, int]


def parse_address(s: str) -> Address:
    host, _, port = s.rpartition(":")
    return host, int(port)


def format_address(a: Address) -> str:
    return f"{a[0]}:{a[1]}"


#: (public key, proof of possession) pairs that passed
#: ``Committee.verify_pops`` in this process, bounded
_VERIFIED_POPS: set[tuple[bytes, bytes]] = set()
_VERIFIED_POPS_CAP = 4096


@dataclass
class Parameters:
    """Protocol timing knobs (milliseconds), JSON round-trippable.

    ``timeout_backoff``/``timeout_cap_ms`` drive the core's exponential
    view-change backoff (beyond reference parity — its timeout is fixed,
    config.rs:16-23): after k CONSECUTIVE local timeouts the round timer
    runs at ``timeout_delay * timeout_backoff^k`` (capped), snapping back
    to the base on progress (a newer QC).  This makes a small base delay
    safe — crash-faulted committees recover dead-leader rounds in ~one
    base delay while a genuinely slow network still converges.
    ``timeout_backoff = 1.0`` restores the reference's fixed timer."""

    timeout_delay: int = 5_000
    sync_retry_delay: int = 10_000
    timeout_backoff: float = 2.0
    # None = derived: max(60 s, timeout_delay) — so a large base delay
    # never collides with the fixed default cap.
    timeout_cap_ms: int | None = None
    # Byte budget for UNCOMMITTED producer payload bodies persisted by
    # the receiver (advisor r4): without it, any peer reaching the open
    # consensus port could fill the disk with unique content-addressed
    # bodies.  Oldest uncommitted bodies are evicted when the budget
    # overflows; committed bodies are history and never evicted.
    payload_body_budget: int = 256 * 1024 * 1024

    def __post_init__(self) -> None:
        # A backoff below 1 would make consecutive timeouts geometrically
        # SHRINK the round timer toward zero — a self-inflicted
        # view-change storm from a mistyped config.  A cap below the base
        # delay is equally incoherent (the cap would override the base).
        if self.timeout_backoff < 1.0:
            raise InvalidParameters(
                f"timeout_backoff must be >= 1.0, got {self.timeout_backoff}"
            )
        if self.timeout_cap_ms is None:
            self.timeout_cap_ms = max(60_000, self.timeout_delay)
        if self.timeout_cap_ms < self.timeout_delay:
            raise InvalidParameters(
                f"timeout_cap_ms ({self.timeout_cap_ms}) must be >= "
                f"timeout_delay ({self.timeout_delay})"
            )
        # must admit at least one maximum-size body or every producer
        # submission with a body would be silently rejected
        from .wire import MAX_PAYLOAD_BODY  # noqa: PLC0415 — cycle guard

        if self.payload_body_budget < MAX_PAYLOAD_BODY:
            raise InvalidParameters(
                f"payload_body_budget ({self.payload_body_budget}) must "
                f"be >= one maximum body ({MAX_PAYLOAD_BODY})"
            )

    def log(self) -> None:
        # NOTE: these log entries are used to compute performance
        # (reference config.rs:26-30 — the harness scrapes them).
        log.info("Timeout delay set to %s ms", self.timeout_delay)
        log.info("Sync retry delay set to %s ms", self.sync_retry_delay)
        # echoed so result files record which backoff configuration
        # produced a (fault) run — without this, runs at backoff 1.0
        # (reference-parity fixed timer) vs 2.0 are indistinguishable
        log.info(
            "Timeout backoff set to %s (cap %s ms)",
            self.timeout_backoff,
            self.timeout_cap_ms,
        )

    def to_json(self) -> dict:
        return {
            "timeout_delay": self.timeout_delay,
            "sync_retry_delay": self.sync_retry_delay,
            "timeout_backoff": self.timeout_backoff,
            "timeout_cap_ms": self.timeout_cap_ms,
            "payload_body_budget": self.payload_body_budget,
        }

    @classmethod
    def from_json(cls, data: dict) -> "Parameters":
        default = cls()
        return cls(
            timeout_delay=int(data.get("timeout_delay", default.timeout_delay)),
            sync_retry_delay=int(
                data.get("sync_retry_delay", default.sync_retry_delay)
            ),
            timeout_backoff=float(
                data.get("timeout_backoff", default.timeout_backoff)
            ),
            timeout_cap_ms=(
                int(data["timeout_cap_ms"])
                if data.get("timeout_cap_ms") is not None
                else None
            ),
            payload_body_budget=int(
                data.get("payload_body_budget", default.payload_body_budget)
            ),
        )


class InvalidParameters(ValueError):
    """A parameters file that must not be allowed to run (incoherent
    timing knobs that would destroy liveness)."""


class InvalidCommittee(ValueError):
    """A committee file that must not be allowed to run (missing/bad
    BLS proofs of possession)."""


@dataclass
class Authority:
    stake: int
    address: Address
    # BLS proof of possession (48-byte G1, scheme="bls" only).  REQUIRED
    # for BLS committees: aggregate (sum-of-public-keys) QC verification
    # is forgeable by an adversarially chosen "rogue" key otherwise —
    # pk_m = a·G2 − Σ pk_honest lets one member fabricate a QC carrying
    # honest authorities' names.  A PoP proves knowledge of the secret,
    # which rules the construction out.  Enforced at Consensus.spawn via
    # ``Committee.verify_pops``.
    pop: bytes | None = None


@dataclass
class Committee:
    """The validator set: voting power and network address per authority.

    ``scheme`` is the committee-wide signature scheme ("ed25519" default,
    "bls" for the BLS12-381 aggregate-signature variant) — a committee
    never mixes schemes; nodes dispatch signing/verification on it
    (crypto/scheme.py)."""

    authorities: dict[PublicKey, Authority] = field(default_factory=dict)
    epoch: int = 1
    scheme: str = "ed25519"
    #: membership-change counter (CommitteeSchedule interface): a bare
    #: Committee never mutates, so this is the constant 0 — consumers
    #: that cache derived views (wire-scheme narrowing, peer sets) key
    #: their cache on it and revalidate when it moves.
    generation: int = 0

    @classmethod
    def new(
        cls,
        info: list[tuple[PublicKey, int, Address]],
        epoch: int = 1,
        scheme: str = "ed25519",
        pops: dict[PublicKey, bytes] | None = None,
    ) -> "Committee":
        pops = pops or {}
        return cls(
            authorities={
                name: Authority(stake, address, pop=pops.get(name))
                for name, stake, address in info
            },
            epoch=epoch,
            scheme=scheme,
        )

    def verify_pops(self) -> None:
        """BLS committees: require a valid proof of possession per
        authority (see ``Authority.pop``); no-op for ed25519 (per-vote
        signatures there already prove key possession).  Raises
        ``InvalidCommittee``.  Cost: one pairing equality per member,
        paid once at spawn, and once a process: a (key, proof) pair that
        verified is remembered (``_VERIFIED_POPS``), so the co-located
        nodes of one committee (``run-many``) do not each repeat every
        member's check, which the JAX package does (64 nodes x 64
        pairings at boot).  The verdict is the same: only pairs that
        passed are kept, and verification is deterministic."""
        if self.scheme != "bls":
            return
        from ..crypto.bls import BlsPublicKey, BlsSignature, verify_possession

        for pk, auth in self.authorities.items():
            if auth.pop is None:
                raise InvalidCommittee(
                    f"BLS committee member {pk} has no proof of possession"
                )
            key = (pk.to_bytes(), bytes(auth.pop))
            if key in _VERIFIED_POPS:
                continue
            pub = BlsPublicKey.from_bytes(pk.to_bytes())
            proof = BlsSignature.from_bytes(auth.pop)
            if pub is None or proof is None or not verify_possession(pub, proof):
                raise InvalidCommittee(
                    f"invalid BLS proof of possession for {pk}"
                )
            if len(_VERIFIED_POPS) >= _VERIFIED_POPS_CAP:
                _VERIFIED_POPS.clear()
            _VERIFIED_POPS.add(key)

    def for_round(self, round_: int) -> "Committee":
        """Committee in effect for ``round_``.  A bare Committee is a
        one-epoch schedule: every round maps to itself.  This is the
        seam that makes every verification/election call site epoch-
        aware for free — ``CommitteeSchedule`` implements the same
        method with a real lookup."""
        return self

    # one-epoch-schedule views (the CommitteeSchedule interface; call
    # sites must never need hasattr checks to handle either type)
    def committees(self) -> list["Committee"]:
        return [self]

    def wire_scheme(self) -> str | None:
        return self.scheme

    def size(self) -> int:
        return len(self.authorities)

    def stake(self, name: PublicKey) -> int:
        auth = self.authorities.get(name)
        return auth.stake if auth is not None else 0

    def total_votes(self) -> int:
        return sum(a.stake for a in self.authorities.values())

    def quorum_threshold(self) -> int:
        # If N = 3f + 1 + k (0 <= k < 3) then 2N/3 + 1 = 2f + 1 + k = N - f
        # (reference config.rs:67-72).
        return 2 * self.total_votes() // 3 + 1

    def validity_threshold(self) -> int:
        # f + 1: the smallest stake that must contain at least one honest
        # authority.  If N = 3f + 1 + k (0 <= k < 3) then
        # ceil(N/3) = f + 1.
        return (self.total_votes() + 2) // 3

    def address(self, name: PublicKey) -> Address | None:
        auth = self.authorities.get(name)
        return auth.address if auth is not None else None

    def broadcast_addresses(
        self, myself: PublicKey
    ) -> list[tuple[PublicKey, Address]]:
        """Every authority's (key, address) except our own."""
        return [
            (name, auth.address)
            for name, auth in self.authorities.items()
            if name != myself
        ]

    def sorted_keys(self) -> list[PublicKey]:
        return sorted(self.authorities.keys())

    def to_json(self) -> dict:
        import base64

        return {
            "authorities": {
                pk.encode_base64(): {
                    "stake": a.stake,
                    "address": format_address(a.address),
                    **(
                        {"pop": base64.b64encode(a.pop).decode()}
                        if a.pop is not None
                        else {}
                    ),
                }
                for pk, a in self.authorities.items()
            },
            "epoch": self.epoch,
            "scheme": self.scheme,
        }

    @classmethod
    def from_json(cls, data: dict) -> "Committee":
        import base64

        return cls(
            authorities={
                PublicKey.decode_base64(pk): Authority(
                    stake=int(entry["stake"]),
                    address=parse_address(entry["address"]),
                    pop=(
                        base64.b64decode(entry["pop"])
                        if "pop" in entry
                        else None
                    ),
                )
                for pk, entry in data["authorities"].items()
            },
            epoch=int(data.get("epoch", 1)),
            scheme=data.get("scheme", "ed25519"),
        )


class CommitteeSchedule:
    """Epoch reconfiguration: committees keyed by activation round.

    BEYOND reference parity (the reference has no reconfiguration at
    all): a schedule maps round ranges to committees — rounds in
    [from_round_i, from_round_{i+1}) run under committee i.  Everything
    that verifies a certificate, elects a leader, or checks stake asks
    ``for_round(r)``, so certificates formed under epoch e verify under
    epoch e's committee forever (a block at the boundary carries a QC
    from the previous epoch — each is checked against its own round's
    validator set).  A bare ``Committee`` implements the same
    ``for_round`` as a one-epoch schedule, so all single-epoch call
    sites are unchanged.

    The handoff itself needs no extra protocol: votes for the last
    round of epoch e route to the leader of round+1 — an epoch-e+1
    member — exactly like any other round; it assembles the QC and
    proposes.  Members only of older epochs simply stop being elected
    or counted.
    """

    def __init__(self, entries: list[tuple[int, Committee]]):
        if not entries:
            raise InvalidCommittee("empty committee schedule")
        entries = sorted(entries, key=lambda e: e[0])
        if entries[0][0] > 1:
            raise InvalidCommittee(
                "schedule must cover round 1 (first from_round > 1)"
            )
        froms = [f for f, _ in entries]
        if len(set(froms)) != len(froms):
            raise InvalidCommittee("duplicate from_round in schedule")
        self.entries: list[tuple[int, Committee]] = entries
        #: bumped on every successful ``splice`` — consumers caching
        #: schedule-derived views (wire-scheme narrowing, peer sets)
        #: key their cache on it
        self.generation: int = 0

    # ---- the epoch seam ----------------------------------------------------

    def splice(self, from_round: int, committee: Committee) -> bool:
        """Append a committed epoch change: rounds >= ``from_round`` run
        under ``committee``.  The ONE mutation a schedule supports — the
        commit path applies it atomically (a single list append; every
        actor shares this object, so leader election, stake checks and
        certificate routing all roll forward together while older
        entries keep verifying boundary certificates).

        Returns False for an exact replay (same activation round and
        epoch — crash-recovery re-applies committed reconfig ops
        idempotently); raises ``InvalidCommittee`` for a genuinely
        conflicting splice (non-monotonic activation or epoch)."""
        last_from, last_com = self.entries[-1]
        for f, c in self.entries:
            if f == from_round and c.epoch == committee.epoch:
                return False  # idempotent re-apply
        if from_round <= last_from or committee.epoch <= last_com.epoch:
            raise InvalidCommittee(
                f"splice (round {from_round}, epoch {committee.epoch}) "
                f"does not extend the schedule (newest: round "
                f"{last_from}, epoch {last_com.epoch})"
            )
        self.entries.append((from_round, committee))
        self.generation += 1
        return True

    def for_round(self, round_: int) -> Committee:
        current = self.entries[0][1]
        for from_round, committee in self.entries:
            if round_ >= from_round:
                current = committee
            else:
                break
        return current

    # ---- union views (round-less call sites) -------------------------------

    def committees(self) -> list[Committee]:
        return [c for _, c in self.entries]

    def address(self, name: PublicKey) -> Address | None:
        """A member's address, from the NEWEST epoch that knows it
        (members keep one address across epochs in practice; newest wins
        if they move)."""
        for _, committee in reversed(self.entries):
            addr = committee.address(name)
            if addr is not None:
                return addr
        return None

    def broadcast_addresses(
        self, myself: PublicKey
    ) -> list[tuple[PublicKey, Address]]:
        """Union of every epoch's members except us (sync retries and
        boundary-crossing certificates must be able to reach members of
        adjacent epochs), deduplicated by key."""
        seen: dict[PublicKey, Address] = {}
        for _, committee in self.entries:
            for name, auth in committee.authorities.items():
                if name != myself:
                    seen[name] = auth.address
        return list(seen.items())

    def stake(self, name: PublicKey) -> int:
        """Round-less stake checks should not exist for schedules —
        kept for duck-type compatibility: the stake in the newest epoch
        that knows the member."""
        for _, committee in reversed(self.entries):
            if name in committee.authorities:
                return committee.stake(name)
        return 0

    # Round-less threshold/size views (duck-type compatibility with a
    # bare Committee): delegated to the NEWEST epoch.  Protocol call
    # sites must use ``for_round(r)`` — these exist for diagnostics and
    # boot-time sizing only.
    def size(self) -> int:
        return self.entries[-1][1].size()

    def total_votes(self) -> int:
        return self.entries[-1][1].total_votes()

    def quorum_threshold(self) -> int:
        return self.entries[-1][1].quorum_threshold()

    def validity_threshold(self) -> int:
        return self.entries[-1][1].validity_threshold()

    def sorted_keys(self) -> list[PublicKey]:
        return self.entries[-1][1].sorted_keys()

    @property
    def authorities(self) -> dict[PublicKey, Authority]:
        """Union membership across epochs (newest epoch wins per key) —
        round-less duck-type surface for kernel warmup, clients feeding
        the committee, and diagnostics."""
        merged: dict[PublicKey, Authority] = {}
        for _, committee in self.entries:
            merged.update(committee.authorities)
        return merged

    @property
    def scheme(self) -> str:
        """The committee-wide signature scheme when it is uniform across
        every epoch; mixed schedules raise — per-round dispatch must use
        ``for_round(r).scheme`` and the wire decode must accept the
        union (wire_scheme())."""
        schemes = {c.scheme for c in self.committees()}
        if len(schemes) == 1:
            return next(iter(schemes))
        raise InvalidCommittee(
            "schedule mixes signature schemes; use for_round(r).scheme"
        )

    def wire_scheme(self) -> str | None:
        """The scheme to narrow wire decode to: the uniform scheme, or
        None (accept the union) for mixed-scheme schedules."""
        schemes = {c.scheme for c in self.committees()}
        return next(iter(schemes)) if len(schemes) == 1 else None

    def verify_pops(self) -> None:
        for _, committee in self.entries:
            committee.verify_pops()

    # ---- JSON --------------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schedule": [
                {"from_round": from_round, **committee.to_json()}
                for from_round, committee in self.entries
            ]
        }

    @classmethod
    def from_json(cls, data: dict) -> "CommitteeSchedule":
        return cls(
            [
                (int(entry["from_round"]), Committee.from_json(entry))
                for entry in data["schedule"]
            ]
        )


def committee_from_json(data: dict):
    """Polymorphic committee-file payload: a plain Committee or a
    CommitteeSchedule (``schedule`` key)."""
    if "schedule" in data:
        return CommitteeSchedule.from_json(data)
    return Committee.from_json(data)
