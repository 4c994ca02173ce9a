"""Consensus layer: the 2-chain HotStuff protocol engine, copied from
``hotstuff_tpu.consensus``.

Parity map (SURVEY.md §2.4): messages (Block/Vote/QC/Timeout/TC), config
(Committee/Parameters), aggregator (QCMaker/TCMaker), leader elector,
timer, core state machine, proposer, synchronizer, helper, and the
Consensus wiring — reference crate ``consensus/`` — and state sync
(``statesync``), and Handel aggregation (``handel``).
"""

from .aggregator import Aggregator, QCMaker, TCMaker
from .config import Authority, Committee, CommitteeSchedule, Parameters
from .consensus import CHANNEL_CAPACITY, Consensus, ConsensusReceiverHandler
from .core import ConsensusState, Core, ProposerMessage
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
from .helper import Helper
from .leader import LeaderElector, RoundRobinLeaderElector
from .messages import QC, TC, Block, Round, Timeout, Vote, timeout_digest
from .proposer import Proposer
from .synchronizer import Synchronizer
from .timer import Timer

__all__ = [
    "Aggregator",
    "QCMaker",
    "TCMaker",
    "Authority",
    "Committee",
    "CommitteeSchedule",
    "Parameters",
    "CHANNEL_CAPACITY",
    "Consensus",
    "ConsensusReceiverHandler",
    "ConsensusState",
    "Core",
    "ProposerMessage",
    "AuthorityReuse",
    "ConsensusError",
    "InvalidSignature",
    "QCRequiresQuorum",
    "SerializationError",
    "TCRequiresQuorum",
    "UnknownAuthority",
    "WrongLeader",
    "Helper",
    "LeaderElector",
    "RoundRobinLeaderElector",
    "QC",
    "TC",
    "Block",
    "Round",
    "Timeout",
    "Vote",
    "timeout_digest",
    "Proposer",
    "Synchronizer",
    "Timer",
]
