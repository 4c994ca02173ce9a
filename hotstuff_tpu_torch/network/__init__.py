"""Network layer: length-delimited TCP receiver and senders.

A copy of ``hotstuff_tpu.network``: the asyncio transport and the native
C++ reactor (``native``: ``NativeReceiver``, ``NativeSimpleSender``,
``NativeReliableSender``), with WAN emulation (``wan``), the chaos
plane's seams (``fault_plane=``, ``faults/plane.py``) and flow
accounting (``flows=``).  Parity map (SURVEY.md §2.3): Receiver/MessageHandler/Writer, SimpleSender
(best-effort), ReliableSender (ACK-paired with backoff retransmit) —
reference crate ``network/``.
"""

from .errors import (
    AckError,
    ConnectError,
    ListenError,
    NetworkError,
    ReceiveError,
    SendError,
)
from .framing import FramingError, read_frame, send_frame, write_frame
from .native import (
    NativeReceiver,
    NativeReliableSender,
    NativeSimpleSender,
    NativeWriter,
    Reactor,
)
from .receiver import MessageHandler, Receiver, Writer, dispatch_ingest
from .reliable_sender import CancelHandler, ReliableSender
from .simple_sender import SimpleSender

__all__ = [
    "NetworkError",
    "ConnectError",
    "ListenError",
    "SendError",
    "ReceiveError",
    "AckError",
    "FramingError",
    "read_frame",
    "send_frame",
    "write_frame",
    "MessageHandler",
    "Receiver",
    "Writer",
    "dispatch_ingest",
    "NativeReceiver",
    "NativeReliableSender",
    "NativeSimpleSender",
    "NativeWriter",
    "Reactor",
    "CancelHandler",
    "ReliableSender",
    "SimpleSender",
]
