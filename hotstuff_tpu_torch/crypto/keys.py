"""Ed25519 key material and key generation.

Parity target: ``PublicKey`` / ``SecretKey`` / keygen in the reference
(``crypto/src/lib.rs:73-182``): 32-byte public keys with base64
(de)serialization, 64-byte secret keypair bytes wiped on drop, and
seeded deterministic key generation.

Deterministic keygen here is defined language-independently (SURVEY.md §7
"hard parts": cross-language seeded fixtures): key *i* from a 32-byte seed
is the ed25519 seed ``SHA-512(seed || u64_le(i))[:32]``.
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import Iterator

try:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pure-Python fallback (ed25519_ref) below
    HAVE_CRYPTOGRAPHY = False

from ..utils.fixed_bytes import FixedBytes

PUBLIC_KEY_SIZE = 32
SECRET_KEY_SIZE = 64  # ed25519 seed (32) || public key (32)


BLS_PUBLIC_KEY_SIZE = 96  # compressed G2 (crypto/bls)


class PublicKey(FixedBytes):
    """An authority identity key, base64-encoded for configs/wire.

    32 bytes under the default Ed25519 scheme, 96 (compressed G2) under
    the BLS12-381 scheme (``crypto/scheme.py``); a committee never mixes
    schemes, and pk fields are length-prefixed on the wire."""

    SIZE = PUBLIC_KEY_SIZE
    SIZES = frozenset({PUBLIC_KEY_SIZE, BLS_PUBLIC_KEY_SIZE})
    __slots__ = ()


class WipeableSecret:
    """Secret bytes with a best-effort wipe contract.

    Python cannot guarantee memory zeroing the way the reference's ``Drop``
    impl does (``crypto/src/lib.rs:160-168``); ``wipe()`` is the best-effort
    equivalent and is called by signing-service teardown. Every accessor
    raises after ``wipe()`` so a zeroed key can never be silently used or
    serialized.  Subclasses set ``SIZE`` (None = any length — opaque
    scheme-specific secrets, crypto/scheme.py)."""

    SIZE: int | None = None
    __slots__ = ("_data", "_wiped")

    def __init__(self, data: bytes):
        if self.SIZE is not None and len(data) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} must be {self.SIZE} bytes"
            )
        self._data = bytearray(data)
        self._wiped = False

    def _check_live(self) -> None:
        if self._wiped:
            raise RuntimeError(f"{type(self).__name__} has been wiped")

    def to_bytes(self) -> bytes:
        self._check_live()
        return bytes(self._data)

    def encode_base64(self) -> str:
        return base64.b64encode(self.to_bytes()).decode()

    @classmethod
    def decode_base64(cls, s: str):
        return cls(base64.b64decode(s))

    def wipe(self) -> None:
        for i in range(len(self._data)):
            self._data[i] = 0
        self._wiped = True

    @property
    def wiped(self) -> bool:
        return self._wiped

    def __repr__(self) -> str:  # never print key material
        return f"{type(self).__name__}(<redacted>)"


class SecretKey(WipeableSecret):
    """64 bytes: ed25519 seed || derived public key."""

    SIZE = SECRET_KEY_SIZE
    __slots__ = ()

    @property
    def seed(self) -> bytes:
        self._check_live()
        return bytes(self._data[:32])

    @property
    def public_bytes(self) -> bytes:
        self._check_live()
        return bytes(self._data[32:])


def _keypair_from_seed(seed32: bytes) -> tuple[PublicKey, SecretKey]:
    if HAVE_CRYPTOGRAPHY:
        sk = Ed25519PrivateKey.from_private_bytes(seed32)
        pub = sk.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
    else:
        from .ed25519_ref import public_from_seed

        pub = public_from_seed(seed32)
    return PublicKey(pub), SecretKey(seed32 + pub)


def generate_production_keypair() -> tuple[PublicKey, SecretKey]:
    """OS-RNG keypair (reference ``generate_production_keypair``,
    crypto/src/lib.rs:170-173)."""
    return _keypair_from_seed(os.urandom(32))


def generate_keypair(seed: bytes, index: int = 0) -> tuple[PublicKey, SecretKey]:
    """Deterministic keypair *index* from a 32-byte seed (reference
    ``generate_keypair<R: CryptoRng>``, crypto/src/lib.rs:176-182 — here with
    a language-independent derivation instead of Rust's StdRng stream)."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    material = hashlib.sha512(seed + struct.pack("<Q", index)).digest()[:32]
    return _keypair_from_seed(material)


def keypair_stream(seed: bytes) -> Iterator[tuple[PublicKey, SecretKey]]:
    """Infinite deterministic keypair stream — test-fixture committees
    (reference ``tests/common.rs:17-20`` seeded-StdRng equivalent)."""
    i = 0
    while True:
        yield generate_keypair(seed, i)
        i += 1
