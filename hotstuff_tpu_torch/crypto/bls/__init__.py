"""A copy of ``hotstuff_tpu.crypto.bls``, whole.

BLS12-381 signatures: aggregation + threshold — the alternate crypto
backend (BASELINE config 5; reference boundary crypto/src/lib.rs:232-257).

Scheme (min-signature variant):
  secret key  x  in Z_r
  public key  PK = x·G2            (96-byte compressed)
  signature   sig = x·H(m) in G1   (48-byte compressed)
  verify      e(sig, G2) == e(H(m), PK)

Aggregation (same message — the QC shape): signatures ADD in G1 and
public keys ADD in G2, so a 2f+1-vote QC verifies with ONE pairing
equality regardless of committee size:
  e(sum sig_i, G2) == e(H(m), sum PK_i)
This additive structure is what the device path exploits: the port sums
the G1 signatures with hand CUDA kernels (``gpu/bls.py``).

Threshold (t-of-n): Shamir shares of x over Z_r; partial signatures
combine by Lagrange interpolation at zero in the exponent:
  sig = sum_i lambda_i · sig_i  for any t valid partials.

This is the CPU reference implementation; proof-of-possession (PoP) is
required against rogue-key attacks when aggregating adversarial keys —
``prove_possession``/``verify_possession`` implement the standard PoP
over the public key encoding.
"""

from __future__ import annotations

import hashlib
import secrets

from .curve import G1Point, G2Point, hash_to_g1
from .fields import R
from .pairing import pairings_equal

__all__ = [
    "BlsSecretKey",
    "BlsPublicKey",
    "BlsSignature",
    "keygen",
    "aggregate_signatures",
    "aggregate_public_keys",
    "verify_aggregate",
    "split_secret",
    "combine_partials",
    "lagrange_at_zero",
    "prove_possession",
    "verify_possession",
]


class BlsSecretKey:
    def __init__(self, scalar: int):
        self.scalar = scalar % R
        if self.scalar == 0:
            raise ValueError("zero secret key")

    def sign(self, message: bytes) -> "BlsSignature":
        return BlsSignature(hash_to_g1(message).mul(self.scalar))

    def public_key(self) -> "BlsPublicKey":
        return BlsPublicKey(G2Point.generator().mul(self.scalar))


class BlsPublicKey:
    def __init__(self, point: G2Point):
        self.point = point

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlsPublicKey | None":
        pt = G2Point.from_bytes(data)
        return None if pt is None else cls(pt)

    def verify(self, message: bytes, sig: "BlsSignature") -> bool:
        if sig.point.inf or self.point.inf:
            return False
        return pairings_equal(
            sig.point, G2Point.generator(), hash_to_g1(message), self.point
        )

    def __eq__(self, o: object) -> bool:
        return isinstance(o, BlsPublicKey) and self.point == o.point

    def __hash__(self) -> int:
        return hash(self.point)


class BlsSignature:
    def __init__(self, point: G1Point):
        self.point = point

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlsSignature | None":
        pt = G1Point.from_bytes(data)
        return None if pt is None else cls(pt)


def keygen(seed: bytes | None = None) -> tuple[BlsPublicKey, BlsSecretKey]:
    if seed is None:
        scalar = secrets.randbelow(R - 1) + 1
    else:
        scalar = (
            int.from_bytes(hashlib.sha512(b"bls-keygen" + seed).digest(), "big")
            % (R - 1)
        ) + 1
    sk = BlsSecretKey(scalar)
    return sk.public_key(), sk


def aggregate_signatures(sigs: list[BlsSignature]) -> BlsSignature:
    # Jacobian accumulation: no per-addition field inversion.
    return BlsSignature(G1Point.sum([s.point for s in sigs]))


def aggregate_public_keys(pks: list[BlsPublicKey]) -> BlsPublicKey:
    return BlsPublicKey(G2Point.sum([pk.point for pk in pks]))


def verify_aggregate(
    message: bytes, pks: list[BlsPublicKey], agg_sig: BlsSignature
) -> bool:
    """Shared-message aggregate verify: ONE pairing equality for the
    whole vote set (the reference's QC-verify batch, messages.rs:195,
    collapsed to constant pairing cost)."""
    if not pks:
        return False
    return aggregate_public_keys(pks).verify(message, agg_sig)


# -- proof of possession (rogue-key defence) --------------------------------

_POP_DST = b"HOTSTUFF_TPU_BLS_POP"


def prove_possession(sk: BlsSecretKey) -> BlsSignature:
    pk_bytes = sk.public_key().to_bytes()
    return BlsSignature(hash_to_g1(_POP_DST + pk_bytes).mul(sk.scalar))


def verify_possession(pk: BlsPublicKey, proof: BlsSignature) -> bool:
    if proof.point.inf:
        return False
    return pairings_equal(
        proof.point,
        G2Point.generator(),
        hash_to_g1(_POP_DST + pk.to_bytes()),
        pk.point,
    )


# -- threshold (t-of-n Shamir in Z_r) ---------------------------------------


def split_secret(
    sk: BlsSecretKey, t: int, n: int, seed: bytes | None = None
) -> list[tuple[int, BlsSecretKey]]:
    """Shamir shares (index_i, share_i), indices 1..n; any t reconstruct."""
    if not (1 <= t <= n):
        raise ValueError("need 1 <= t <= n")
    coeffs = [sk.scalar]
    for i in range(1, t):
        if seed is None:
            coeffs.append(secrets.randbelow(R))
        else:
            coeffs.append(
                int.from_bytes(
                    hashlib.sha512(b"bls-share" + seed + bytes([i])).digest(),
                    "big",
                )
                % R
            )
    shares = []
    for idx in range(1, n + 1):
        acc = 0
        for j, c in enumerate(coeffs):
            acc = (acc + c * pow(idx, j, R)) % R
        shares.append((idx, BlsSecretKey(acc)))
    return shares


def lagrange_at_zero(indices: list[int]) -> list[int]:
    """lambda_i = prod_{j != i} x_j / (x_j - x_i) mod R."""
    coeffs = []
    for i, xi in enumerate(indices):
        num, den = 1, 1
        for j, xj in enumerate(indices):
            if i == j:
                continue
            num = num * xj % R
            den = den * ((xj - xi) % R) % R
        coeffs.append(num * pow(den, R - 2, R) % R)
    return coeffs


def combine_partials(
    partials: list[tuple[int, BlsSignature]],
) -> BlsSignature:
    """Combine >= t partial signatures into the group signature."""
    indices = [idx for idx, _ in partials]
    lams = lagrange_at_zero(indices)
    acc = G1Point.identity()
    for (_, sig), lam in zip(partials, lams):
        acc = acc + sig.point.mul(lam)
    return BlsSignature(acc)
