"""Network error taxonomy.

Parity target: ``NetworkError`` (reference network/src/error.rs:6-25) —
a typed connect/listen/send/receive/ACK error family, so callers can
classify failures programmatically instead of string-matching log
lines.  The asyncio layers historically surfaced raw OSError/
ConnectionError; these wrappers carry the peer address and operation,
and ``classify`` maps any raw transport exception into the taxonomy
(used by diagnostics and tests; the hot paths keep catching the raw
tuple for speed — every wrapper here IS also an OSError subclass, so
both styles interoperate)."""

from __future__ import annotations

from .framing import FramingError

Address = tuple[str, int]


class NetworkError(OSError):
    """Base of the taxonomy (reference error.rs:6)."""

    op = "network"

    def __init__(self, address: Address | None = None, detail: str = ""):
        self.address = address
        where = f" to {address[0]}:{address[1]}" if address else ""
        super().__init__(f"failed to {self.op}{where}: {detail}")


class ConnectError(NetworkError):
    """Could not establish a connection (error.rs FailedToConnect)."""

    op = "connect"


class ListenError(NetworkError):
    """Could not bind/listen on the address (error.rs FailedToListen)."""

    op = "listen"


class SendError(NetworkError):
    """A frame could not be written (error.rs FailedToSendMessage)."""

    op = "send a message"


class ReceiveError(NetworkError):
    """A frame could not be read (error.rs FailedToReceiveMessage)."""

    op = "receive a message"


class AckError(NetworkError):
    """The ACK pairing broke (error.rs FailedToReceiveAck)."""

    op = "receive an ack"


class UnexpectedAckError(NetworkError):
    """An ACK arrived with no sent frame awaiting one (error.rs
    UnexpectedAck) — a protocol desync the reliable sender surfaces as
    a diagnostic rather than silently consuming."""

    op = "pair an unexpected ack"


def classify(
    exc: BaseException, op: str, address: Address | None = None
) -> NetworkError:
    """Wrap a raw transport exception into the taxonomy.

    ``op``: one of connect/listen/send/receive/ack."""
    cls = {
        "connect": ConnectError,
        "listen": ListenError,
        "send": SendError,
        "receive": ReceiveError,
        "ack": AckError,
    }.get(op, NetworkError)
    return cls(address, f"{type(exc).__name__}: {exc}")


__all__ = [
    "NetworkError",
    "ConnectError",
    "ListenError",
    "SendError",
    "ReceiveError",
    "AckError",
    "UnexpectedAckError",
    "FramingError",
    "classify",
]
