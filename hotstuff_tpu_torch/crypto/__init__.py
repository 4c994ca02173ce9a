"""Host crypto for the port: the Ed25519 oracle, digests, keys,
signatures, the CPU verifier backend, the signing service, the scheme
registry (``scheme``) and the async wave service (``async_service``).
The package root exports what ``hotstuff_tpu.crypto`` exports."""

from .digest import DIGEST_SIZE, Digest, Hashable, sha512_trunc
from .keys import (
    PUBLIC_KEY_SIZE,
    SECRET_KEY_SIZE,
    PublicKey,
    SecretKey,
    generate_keypair,
    generate_production_keypair,
    keypair_stream,
)
from .service import CpuVerifier, SignatureService, VerifierBackend
from .signature import (
    SIGNATURE_SIZE,
    CryptoError,
    Signature,
    batch_verify_arrays,
)

__all__ = [
    "DIGEST_SIZE",
    "Digest",
    "Hashable",
    "sha512_trunc",
    "PUBLIC_KEY_SIZE",
    "SECRET_KEY_SIZE",
    "PublicKey",
    "SecretKey",
    "generate_keypair",
    "generate_production_keypair",
    "keypair_stream",
    "CpuVerifier",
    "SignatureService",
    "VerifierBackend",
    "SIGNATURE_SIZE",
    "CryptoError",
    "Signature",
    "batch_verify_arrays",
]
