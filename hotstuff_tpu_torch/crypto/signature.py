"""Ed25519 signatures over digests, with batch verification.

Parity target: the reference ``Signature`` (``crypto/src/lib.rs:186-227``):
sign the 32 digest bytes, verify one signature, and ``verify_batch`` many
(public_key, signature) pairs over one shared digest — the QC-verify hot
kernel (called from ``consensus/src/messages.rs:195``).

The default backend is CPU (OpenSSL via ``cryptography`` where it is
installed, else the native library's single verify, or the pure-Python
``ed25519_ref`` with ``HOTSTUFF_ED25519_NATIVE=0``); the CUDA batch backend
(``hotstuff_tpu_torch.gpu.ed25519``) implements the same verify surface.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterable, Sequence

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pure-Python RFC 8032 fallback (ed25519_ref)
    HAVE_CRYPTOGRAPHY = False

    class InvalidSignature(Exception):  # type: ignore[no-redef]
        pass

from ..utils.fixed_bytes import FixedBytes
from .digest import Digest
from .keys import PublicKey, SecretKey

SIGNATURE_SIZE = 64


class CryptoError(Exception):
    """Signature verification / malformed key errors."""


if HAVE_CRYPTOGRAPHY:

    @lru_cache(maxsize=4096)
    def _parsed_pk(pk_bytes: bytes) -> "Ed25519PublicKey":
        """Parsed-key cache: EVP_PKEY construction costs roughly as much
        as the verify itself, and committees reuse a fixed key set —
        profiled ~2x on the consensus CPU verify path.  Raises ValueError
        on malformed keys (not cached)."""
        return Ed25519PublicKey.from_public_bytes(pk_bytes)

else:

    class _RefParsedPk:
        """ed25519_ref-backed stand-in for a parsed OpenSSL key: same
        ``verify(sig, msg)`` surface, raising InvalidSignature."""

        __slots__ = ("_pk",)

        def __init__(self, pk_bytes: bytes):
            from .ed25519_ref import point_decompress

            if len(pk_bytes) != 32 or point_decompress(pk_bytes) is None:
                raise ValueError("malformed ed25519 public key")
            self._pk = pk_bytes

        def verify(self, sig: bytes, msg: bytes) -> None:
            # fast path: the native batch library's single-verify entry
            # point (cofactored acceptance); the pure-Python ladder only
            # with the batch path off (HOTSTUFF_ED25519_NATIVE=0)
            from . import native_ed25519

            if native_ed25519.available():
                if not native_ed25519.verify_one(msg, self._pk, sig):
                    raise InvalidSignature("signature mismatch")
                return
            from .ed25519_ref import verify as _ref_verify

            if not _ref_verify(sig, self._pk, msg):
                raise InvalidSignature("signature mismatch")

    @lru_cache(maxsize=4096)
    def _parsed_pk(pk_bytes: bytes) -> "_RefParsedPk":  # type: ignore[misc]
        return _RefParsedPk(pk_bytes)


BLS_SIGNATURE_SIZE = 48  # compressed G1 (crypto/bls)


class Signature(FixedBytes):
    """A signature over a digest: 64 bytes (R || s) under Ed25519, 48
    (compressed G1) under the BLS12-381 scheme.  The ed25519-specific
    class methods below are only reached through the Ed25519 scheme's
    signing service / verifier (``crypto/scheme.py``)."""

    SIZE = SIGNATURE_SIZE
    SIZES = frozenset({SIGNATURE_SIZE, BLS_SIGNATURE_SIZE})
    __slots__ = ()

    @classmethod
    def new(cls, digest: Digest, secret: SecretKey) -> "Signature":
        if HAVE_CRYPTOGRAPHY:
            sk = Ed25519PrivateKey.from_private_bytes(secret.seed)
            return cls(sk.sign(digest.to_bytes()))
        from .ed25519_ref import sign as _ref_sign

        return cls(_ref_sign(secret.seed, digest.to_bytes()))

    # R / s halves — the reference serializes the signature as two 32-byte
    # parts (crypto/src/lib.rs:186-189); we expose them for the device kernel.
    @property
    def r_bytes(self) -> bytes:
        return self.data[:32]

    @property
    def s_bytes(self) -> bytes:
        return self.data[32:]

    def verify(self, digest: Digest, public_key: PublicKey) -> None:
        """Raise CryptoError unless this signature over ``digest`` is valid."""
        try:
            _parsed_pk(public_key.to_bytes()).verify(
                self.data, digest.to_bytes()
            )
        except (InvalidSignature, ValueError) as e:
            raise CryptoError(f"invalid signature: {e}") from e

    @staticmethod
    def verify_batch(
        digest: Digest, votes: Iterable[tuple[PublicKey, "Signature"]]
    ) -> None:
        """Verify many (pk, sig) pairs over one digest; raise on any failure.

        CPU path: per-signature OpenSSL verifies (OpenSSL has no batch API;
        dalek's batch verification is ~2x a verify loop, and the real batch
        win here is the device backend — see gpu/ed25519.py)."""
        msg = digest.to_bytes()
        for pk, sig in votes:
            try:
                _parsed_pk(pk.to_bytes()).verify(sig.data, msg)
            except (InvalidSignature, ValueError) as e:
                raise CryptoError(f"invalid signature in batch: {e}") from e


def batch_verify_arrays(
    digests: Sequence[bytes],
    pks: Sequence[bytes],
    sigs: Sequence[bytes],
) -> list[bool]:
    """Vectorized-API CPU batch verify over *distinct* messages.

    Returns per-item validity instead of raising — the accumulate-then-
    dispatch aggregator (consensus/aggregator.py) uses this shape, and the
    CUDA backend implements the same interface on device.
    """
    if not (len(digests) == len(pks) == len(sigs)):
        raise ValueError(
            f"length mismatch: {len(digests)} digests, {len(pks)} pks, "
            f"{len(sigs)} sigs"
        )
    out: list[bool] = []
    for msg, pk, sig in zip(digests, pks, sigs):
        try:
            _parsed_pk(pk).verify(sig, msg)
            out.append(True)
        except (InvalidSignature, ValueError):
            out.append(False)
    return out
