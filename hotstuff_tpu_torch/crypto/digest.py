"""Hash digests and the Hash protocol.

Parity target: the reference's ``Digest`` / ``Hash`` pair
(reference ``crypto/src/lib.rs:22-69``): a 32-byte value displayed as
base64, produced by SHA-512 truncated to its first 32 bytes.
"""

from __future__ import annotations

import hashlib
import os
from typing import Protocol, runtime_checkable

from ..utils.fixed_bytes import FixedBytes

DIGEST_SIZE = 32


def sha512_trunc(data: bytes) -> bytes:
    """SHA-512 truncated to 32 bytes — the digest function every signable
    message uses (reference ``crypto/src/lib.rs:67-69`` +
    ``consensus/src/messages.rs`` digest impls)."""
    return hashlib.sha512(data).digest()[:DIGEST_SIZE]


class Digest(FixedBytes):
    """A 32-byte hash value. Ordered, hashable, base64-displayed."""

    SIZE = DIGEST_SIZE
    __slots__ = ()

    @classmethod
    def of(cls, data: bytes) -> "Digest":
        return cls(sha512_trunc(data))

    @classmethod
    def random(cls) -> "Digest":
        # Parity: Digest::random (reference crypto/src/lib.rs:32-38).
        return cls(os.urandom(DIGEST_SIZE))


@runtime_checkable
class Hashable(Protocol):
    """Implemented by every signable message (reference's ``Hash`` trait)."""

    def digest(self) -> Digest: ...
