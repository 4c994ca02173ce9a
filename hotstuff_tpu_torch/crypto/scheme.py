"""Crypto scheme registry, Ed25519 half.

A copy of the Ed25519 side of ``hotstuff_tpu.crypto.scheme``: the scheme
is a committee-level property, and a node asks here for its key
generation, the decoding of its key file's secret, its signing service
and its CPU verifier backend.  The BLS12-381 scheme is known by
name (committee files may carry it) but its host crypto is not ported
yet, so its factories raise.  Device verifiers are built by
``node.node.make_verifier``.
"""

from __future__ import annotations

from .keys import (
    PublicKey,
    SecretKey,
    generate_keypair,
    generate_production_keypair,
)
from .service import CpuVerifier, SignatureService, VerifierBackend

SCHEMES = ("ed25519", "bls")
DEFAULT_SCHEME = "ed25519"


class UnknownScheme(ValueError):
    def __init__(self, name: str):
        super().__init__(
            f"unknown crypto scheme '{name}' (expected one of {SCHEMES})"
        )


def check_scheme(name: str) -> str:
    if name not in SCHEMES:
        raise UnknownScheme(name)
    return name


def _ed25519_only(scheme: str) -> None:
    if check_scheme(scheme) != "ed25519":
        raise NotImplementedError(f"the {scheme} scheme is not ported yet")


def keygen_production(scheme: str) -> tuple[PublicKey, SecretKey]:
    """OS-RNG keypair for the scheme; the secret supports wipe()/base64."""
    _ed25519_only(scheme)
    return generate_production_keypair()


def keygen_deterministic(
    scheme: str, seed: bytes, index: int = 0
) -> tuple[PublicKey, SecretKey]:
    _ed25519_only(scheme)
    return generate_keypair(seed, index)


def read_secret(scheme: str, b64: str) -> SecretKey:
    """Decode a key-file secret for the scheme (the typed 64-byte
    Ed25519 ``SecretKey``)."""
    _ed25519_only(scheme)
    return SecretKey.decode_base64(b64)


def make_signing_service(scheme: str, secret) -> SignatureService:
    _ed25519_only(scheme)
    return SignatureService(secret)


def make_cpu_verifier(scheme: str) -> VerifierBackend:
    _ed25519_only(scheme)
    return CpuVerifier()
