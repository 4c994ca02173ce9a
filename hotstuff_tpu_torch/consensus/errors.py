"""Consensus error taxonomy.

Parity target: reference ``ConsensusError`` (consensus/src/error.rs:6-65).
Errors raised by message verification / protocol handlers are caught by the
core's run loop and logged, never fatal — mirroring the reference's
per-iteration ``match result`` (core.rs:478-483).

A copy of ``hotstuff_tpu.consensus.errors``.
"""

from __future__ import annotations


class ConsensusError(Exception):
    """Base class for all protocol-level failures."""


class SerializationError(ConsensusError):
    pass


class StoreError(ConsensusError):
    pass


class NotInCommittee(ConsensusError):
    def __init__(self, name):
        super().__init__(f"Node {name} is not in the committee")
        self.name = name


class InvalidSignature(ConsensusError):
    pass


class AuthorityReuse(ConsensusError):
    def __init__(self, name):
        super().__init__(f"Received more than one vote from {name}")
        self.name = name


class UnknownAuthority(ConsensusError):
    def __init__(self, name):
        super().__init__(f"Received vote from unknown authority {name}")
        self.name = name


class QCRequiresQuorum(ConsensusError):
    def __init__(self):
        super().__init__("Received QC without a quorum")


class TCRequiresQuorum(ConsensusError):
    def __init__(self):
        super().__init__("Received TC without a quorum")


class MalformedBlock(ConsensusError):
    def __init__(self, digest):
        super().__init__(f"Malformed block {digest}")
        self.digest = digest


class WrongLeader(ConsensusError):
    def __init__(self, digest, leader, round_):
        super().__init__(
            f"Received block {digest} from leader {leader} at round {round_}"
        )
        self.digest = digest
        self.leader = leader
        self.round = round_


class InvalidPayload(ConsensusError):
    def __init__(self):
        super().__init__("Invalid payload")


class InvalidReconfig(ConsensusError):
    """A reconfiguration op that must die at verification: bad epoch
    succession, out-of-bounds margin, insufficient carried-over stake,
    unauthorized sponsor, or a bad sponsor signature."""

    def __init__(self, reason: str):
        super().__init__(f"Invalid reconfiguration op: {reason}")
