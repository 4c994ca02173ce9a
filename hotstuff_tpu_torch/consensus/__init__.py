"""The certificate layer of the consensus protocol: messages, committee
configuration and the vote/timeout aggregators, copied from
``hotstuff_tpu.consensus``.  The protocol engine itself (core, proposer,
synchronizer, helper and their wiring) is not ported yet."""

from .aggregator import Aggregator, QCMaker, TCMaker
from .config import Authority, Committee, CommitteeSchedule, Parameters
from .errors import (
    AuthorityReuse,
    ConsensusError,
    InvalidSignature,
    QCRequiresQuorum,
    SerializationError,
    TCRequiresQuorum,
    UnknownAuthority,
    WrongLeader,
)
from .messages import QC, TC, Block, Round, Timeout, Vote, timeout_digest

__all__ = [
    "Aggregator",
    "QCMaker",
    "TCMaker",
    "Authority",
    "Committee",
    "CommitteeSchedule",
    "Parameters",
    "AuthorityReuse",
    "ConsensusError",
    "InvalidSignature",
    "QCRequiresQuorum",
    "SerializationError",
    "TCRequiresQuorum",
    "UnknownAuthority",
    "WrongLeader",
    "QC",
    "TC",
    "Block",
    "Round",
    "Timeout",
    "Vote",
    "timeout_digest",
]
