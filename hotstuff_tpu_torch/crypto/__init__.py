"""Host crypto for the port: the Ed25519 oracle, digests, keys,
signatures, the CPU verifier backend, the signing service, the scheme
registry (``scheme``) and the async wave service (``async_service``)."""

from .digest import Digest, sha512_trunc
from .keys import PublicKey, SecretKey, generate_keypair
from .service import CpuVerifier, SignatureService, VerifierBackend
from .signature import CryptoError, Signature, batch_verify_arrays

__all__ = [
    "CpuVerifier",
    "CryptoError",
    "Digest",
    "PublicKey",
    "SecretKey",
    "Signature",
    "SignatureService",
    "VerifierBackend",
    "batch_verify_arrays",
    "generate_keypair",
    "sha512_trunc",
]
