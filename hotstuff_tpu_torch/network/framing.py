"""Length-delimited TCP framing.

Parity target: the reference frames every message with a 4-byte length
prefix via tokio's ``LengthDelimitedCodec`` (reference
network/src/receiver.rs:70). Same wire format here: u32 big-endian length,
then the payload.
"""

from __future__ import annotations

import asyncio
import socket
import struct

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024


def set_nodelay(writer: asyncio.StreamWriter) -> None:
    """Disable Nagle on the stream's socket.  Consensus frames are
    kilobyte-scale and latency-bound; letting the kernel coalesce them
    costs milliseconds per protocol hop."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # e.g. unix sockets in tests
            pass


class FramingError(Exception):
    pass


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise FramingError(f"frame of {length} bytes exceeds limit")
    return await reader.readexactly(length)


def write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(_LEN.pack(len(payload)) + payload)


async def send_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    write_frame(writer, payload)
    await writer.drain()
