"""The verifier backend protocol, the CPU backend and the signing service.

Copied from ``hotstuff_tpu.crypto.service``.  The CPU backend verifies
batches of two or more signatures with the native batch equation
(``native_ed25519``, cofactored) and single signatures, and the items of
a failing batch, through ``signature.py`` (OpenSSL where
``cryptography`` is installed, the pure-Python oracle otherwise).  The
CUDA backend, ``gpu.ed25519.BatchVerifier``, implements the same
protocol.
"""

from __future__ import annotations

from typing import Protocol

from ..telemetry import spans as _spans
from . import native_ed25519
from .digest import Digest
from .keys import PublicKey, SecretKey
from .signature import CryptoError, Signature


class VerifierBackend(Protocol):
    """Where batched verification work executes.

    Beyond the three methods, a dispatcher may read OPTIONAL capability
    attributes via ``getattr``; absence means the default shown:

    - ``name = "?"`` — backend label for stats/telemetry tags;
    - ``supports_flat_batch = False`` — ``eval_claims_sync`` may
      collapse a whole claim wave into one native batch equation;
    - ``async_kind`` (unset) — advertises the off-loop coalescing claim
      path (``crypto/async_service.py``); one shared service per (event
      loop, kind);
    - ``device_ready = True`` — the device verifier is warm; the service
      never routes to a backend that would build kernels mid-consensus;
    - ``dispatch_deadline_s = 0.1`` — floor for the per-dispatch
      deadline (raised adaptively from the dispatch EWMA);
    - ``device_key_cache = False`` — committee key tables are staged
      device-resident once per rebuild and gathered by row id per wave;
    - ``supports_wave_padding = False`` — device-routed waves may be
      pre-padded to fixed bucket shapes with always-valid filler claims
      (only backends whose per-claim verdicts are independent of the
      other claims in the batch may opt in);
    - ``wave_bucket_shapes`` (unset) — the backend's own bucket ladder
      for that padding, overriding the default (but not an explicit
      ``HOTSTUFF_WAVE_BUCKETS``).
    """

    def verify_one(self, digest: Digest, pk: PublicKey, sig: Signature) -> bool: ...

    def verify_shared_msg(
        self, digest: Digest, votes: list[tuple[PublicKey, Signature]]
    ) -> bool:
        """All signatures over one shared digest (QC verify shape)."""
        ...

    def verify_many(
        self,
        digests: list[bytes],
        pks: list[bytes],
        sigs: list[bytes],
        aggregate_ok: bool = False,
    ) -> list[bool]:
        """Per-item validity over distinct messages (TC verify shape).
        ``aggregate_ok=True`` permits aggregate acceptance within
        same-digest groups; callers that make per-entry decisions leave
        it False."""
        ...


class CpuVerifier:
    """Default backend: OpenSSL per-signature verification, with the
    native dalek-parity batch equation (``native_ed25519``) as the fast
    path for batches of ``NATIVE_BATCH_MIN`` (2) or more — the QC-verify
    shape, reference crypto/src/lib.rs:213-226."""

    name = "cpu"
    # eval_claims_sync may collapse a whole claim wave into one native
    # batch equation (all-or-nothing, per-item attribution on failure)
    supports_flat_batch = True

    def verify_one(self, digest: Digest, pk: PublicKey, sig: Signature) -> bool:
        try:
            sig.verify(digest, pk)
            return True
        except CryptoError:
            return False

    def precompute(self, pubkeys: list[bytes]) -> None:
        """Warm the native committee-key tables (node boot, epoch setup)
        so QC-shaped batches only pay point decompression for the
        per-signature R points.  No-op with the batch path off."""
        native_ed25519.precompute(pubkeys)

    def verify_shared_msg(
        self, digest: Digest, votes: list[tuple[PublicKey, Signature]]
    ) -> bool:
        with _spans.span("host.verify"):
            if len(votes) >= native_ed25519.NATIVE_BATCH_MIN:
                if native_ed25519.available():
                    # cofactored batch acceptance — dalek-batch parity;
                    # the certificate verdict is all-or-nothing, as the
                    # reference's QC::verify
                    return native_ed25519.batch_verify_shared(
                        digest.to_bytes(),
                        [
                            (pk.to_bytes(), sig.to_bytes())
                            for pk, sig in votes
                        ],
                    )
            try:
                Signature.verify_batch(digest, votes)
                return True
            except CryptoError:
                return False

    def verify_many(
        self,
        digests: list[bytes],
        pks: list[bytes],
        sigs: list[bytes],
        aggregate_ok: bool = False,
    ) -> list[bool]:
        from .signature import batch_verify_arrays

        with _spans.span("host.verify"):
            n = len(digests)
            if aggregate_ok and n >= native_ed25519.NATIVE_BATCH_MIN:
                # certificate-shaped call (TC verify): the all-pass
                # verdict may be established collectively.  One batch
                # equation replaces n verifies; on a failure the loop
                # below attributes each item.
                if (
                    native_ed25519.available()
                    and all(len(d) == Digest.SIZE for d in digests)
                    and native_ed25519.batch_verify(
                        b"".join(digests),
                        Digest.SIZE,
                        b"".join(pks),
                        b"".join(sigs),
                        n,
                        shared=False,
                    )
                ):
                    return [True] * n
            return batch_verify_arrays(digests, pks, sigs)


class SignatureService:
    """The service owning the node's secret key (reference
    ``SignatureService``, crypto/src/lib.rs:232-257).  Signs inline: under
    asyncio's single thread an actor hop would cost more than the sign.
    ``shutdown()`` drops the key and wipes the secret, after which
    requests raise."""

    def __init__(self, secret: SecretKey):
        self._secret = secret
        self._closed = False

    async def request_signature(self, digest: Digest) -> Signature:
        return self.sign_sync(digest)

    def sign_sync(self, digest: Digest) -> Signature:
        if self._closed:
            raise RuntimeError("SignatureService is shut down")
        return Signature.new(digest, self._secret)

    def shutdown(self) -> None:
        self._closed = True
        self._secret.wipe()
