"""Crypto scheme registry: Ed25519 (default) and BLS12-381.

A copy of ``hotstuff_tpu.crypto.scheme``, whole.  The BLS device
verifier is ``make_device_verifier("bls", "cuda")``: the G1 signature sums
on the card's hand kernels (``gpu/bls.py``), the pairing on the host.

The reference hard-codes ed25519-dalek behind its ``SignatureService``
boundary (crypto/src/lib.rs:232-257).  This framework makes the scheme a
committee-level property so a BLS-signed committee (BASELINE config 5 —
constant-cost QC verification via signature aggregation, device G1 sum) is
selectable end-to-end from the node CLI: ``keys --scheme bls`` writes a
BLS keypair file, the committee file records the scheme, and ``Node.new``
dispatches here for the signing service and verifier backend.

A scheme bundles:
- key/signature byte formats (PublicKey 32 vs 96, Signature 64 vs 48 —
  protocol wire fields are length-prefixed, so both coexist);
- deterministic + OS keygen;
- the signing-service factory (actor holding the secret key);
- the verifier-backend factory (cpu / device variants).
"""

from __future__ import annotations

import hashlib
import os
import struct

from ..telemetry import spans as _spans
from .keys import (
    PublicKey,
    SecretKey,
    WipeableSecret,
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


class OpaqueSecret(WipeableSecret):
    """Scheme-agnostic secret bytes (BLS scalar, etc.) — any length,
    same wipe contract as SecretKey."""

    __slots__ = ()


def bls_keygen(seed: bytes | None = None, index: int = 0) -> tuple[PublicKey, bytes]:
    """(96-byte G2 public key, 32-byte big-endian scalar secret).

    Deterministic derivation mirrors the Ed25519 fixture convention
    (keys.py): scalar_i = SHA-512("bls-keygen" ‖ seed ‖ u64_le(i)) mod
    (R−1) + 1."""
    from .bls.fields import R as BLS_R

    if seed is None:
        material = os.urandom(64)
    else:
        material = hashlib.sha512(
            b"bls-keygen" + seed + struct.pack("<Q", index)
        ).digest()
    scalar = (int.from_bytes(material, "big") % (BLS_R - 1)) + 1
    from .bls import BlsSecretKey

    sk = BlsSecretKey(scalar)
    pk = PublicKey(sk.public_key().to_bytes())
    return pk, scalar.to_bytes(32, "big")


def bls_pop(secret_bytes: bytes) -> bytes:
    """48-byte proof of possession for a BLS secret — REQUIRED committee
    material (``consensus.config.Authority.pop``): sum-of-keys QC
    verification is rogue-key forgeable without it."""
    from .bls import BlsSecretKey, prove_possession

    sk = BlsSecretKey(int.from_bytes(secret_bytes, "big"))
    return prove_possession(sk).to_bytes()


def check_scheme(name: str) -> str:
    if name not in SCHEMES:
        raise UnknownScheme(name)
    return name


def keygen_production(scheme: str) -> tuple[PublicKey, OpaqueSecret | SecretKey]:
    """OS-RNG keypair for the scheme; the secret supports wipe()/base64."""
    check_scheme(scheme)
    if scheme == "ed25519":
        return generate_production_keypair()
    pk, secret = bls_keygen()
    return pk, OpaqueSecret(secret)


def keygen_deterministic(
    scheme: str, seed: bytes, index: int = 0
) -> tuple[PublicKey, OpaqueSecret | SecretKey]:
    check_scheme(scheme)
    if scheme == "ed25519":
        return generate_keypair(seed, index)
    pk, secret = bls_keygen(seed, index)
    return pk, OpaqueSecret(secret)


def read_secret(scheme: str, b64: str) -> OpaqueSecret | SecretKey:
    """Decode a key-file secret for the scheme (ed25519 keeps the typed
    64-byte SecretKey; BLS secrets are opaque 32-byte scalars)."""
    check_scheme(scheme)
    if scheme == "ed25519":
        return SecretKey.decode_base64(b64)
    return OpaqueSecret.decode_base64(b64)


def make_signing_service(scheme: str, secret):
    check_scheme(scheme)
    if scheme == "ed25519":
        return SignatureService(secret)
    from .bls.service import BlsSigningService

    return BlsSigningService(secret.to_bytes())


def make_cpu_verifier(scheme: str) -> VerifierBackend:
    check_scheme(scheme)
    if scheme == "ed25519":
        return CpuVerifier()
    from .bls.service import BlsVerifier

    return BlsVerifier()


def make_device_verifier(
    scheme: str, kind: str, device=None
) -> VerifierBackend:
    """Device-backed verifier: the Ed25519 batch kernel (with the
    lazy-import hybrid handled by the caller, node/node.py) or the BLS
    verifier with its G1 aggregation on the card.  ``device`` defaults to
    ``cuda`` (it raises without a card); ``device="cpu"`` runs the G1
    kernels' plain versions."""
    check_scheme(scheme)
    if scheme == "bls":
        from .bls.service import BlsVerifier

        # 'cuda': the single-device G1 tree sum; 'tpu-sharded' (the
        # batch sharded over a mesh) waits on the mesh and raises.
        # BlsVerifier rejects anything else.
        v = BlsVerifier(aggregator=kind, device=device)
        if not hasattr(v, "dispatch_deadline_s"):
            # the pure-Python pairing (HOTSTUFF_BLS_NATIVE=0): one
            # equality legitimately takes ~100 ms — the dispatch
            # pipeline's default 100 ms deadline would demote every
            # healthy wave back onto the loop it exists to protect
            v.dispatch_deadline_s = 30.0
        return v
    raise ValueError(
        "ed25519 device verifiers are constructed by node.make_verifier "
        "(lazy-import hybrid)"
    )


class DualSchemeVerifier:
    """Verifier for mixed-scheme CommitteeSchedules (a scheme changeover
    across an epoch boundary): routes each check to the per-scheme
    backend by key wire size (32 = ed25519, 96 = BLS compressed G2).

    One certificate never mixes schemes (a committee is single-scheme
    and authority/stake checks against the round's committee run before
    signatures), so routing by the first key is sound; a hostile
    mixed-material certificate simply fails verification in whichever
    backend it lands."""

    name = "dual"
    # Shared-message claims must route through verify_shared_msg so the
    # BLS side keeps its one-pairing aggregate (flattening a BLS QC into
    # per-item checks costs two pairings per SIGNATURE); the ed25519
    # side's verify_shared_msg is the same per-signature work either way.
    prefers_aggregate = True
    # Never advertise wave padding here even when the ed25519 member
    # does: the pad filler is an ed25519 claim, and a padded wave whose
    # real claims are BLS would then mis-route on the filler's 32-byte
    # key.  Fixed-shape buckets only make sense below the scheme split.
    supports_wave_padding = False

    def __init__(self, backends: dict[str, "VerifierBackend"]):
        self.backends = backends

    def _route(self, pk_bytes: bytes) -> "VerifierBackend":
        return self.backends["bls" if len(pk_bytes) == 96 else "ed25519"]

    def verify_one(self, digest, pk, sig) -> bool:
        return self._route(pk.data).verify_one(digest, pk, sig)

    def verify_shared_msg(self, digest, votes) -> bool:
        if not votes:
            return False
        with _spans.span("scheme.route"):
            backend = self._route(votes[0][0].data)
        return backend.verify_shared_msg(digest, votes)

    def verify_many(
        self, digests, pks, sigs, aggregate_ok: bool = False
    ) -> list[bool]:
        if not pks:
            return []
        with _spans.span("scheme.route"):
            backend = self._route(pks[0])
        return backend.verify_many(
            digests, pks, sigs, aggregate_ok=aggregate_ok
        )

    def verify_aggregate_msg(self, digest, pks, agg_sig) -> bool:
        """Compact-certificate verify (one agg sig + signer keys).  Only
        the BLS side has an aggregate form, but route by key size anyway:
        an ed25519 key set lands on a backend without the method and is
        rejected, same as everywhere else in this class."""
        if not pks:
            return False
        pk0 = pks[0] if isinstance(pks[0], bytes) else pks[0].to_bytes()
        with _spans.span("scheme.route"):
            backend = self._route(pk0)
        fn = getattr(backend, "verify_aggregate_msg", None)
        return fn is not None and fn(digest, pks, agg_sig)

    # boot-time hooks forwarded so device backends still warm up
    def precompute(self, pubkeys: list[bytes]) -> None:
        for pk in pubkeys:
            backend = self._route(pk)
            if hasattr(backend, "precompute"):
                backend.precompute([pk])

    def warmup(self, batch: int | None = None) -> None:
        for backend in self.backends.values():
            if hasattr(backend, "warmup"):
                backend.warmup(batch)


def make_dual_verifier(make_one) -> DualSchemeVerifier:
    """Compose a mixed-scheme verifier from per-scheme factories
    (``make_one(scheme) -> VerifierBackend``)."""
    return DualSchemeVerifier({s: make_one(s) for s in SCHEMES})
