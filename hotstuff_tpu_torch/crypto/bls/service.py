"""BLS backend behind the framework's verifier/signing boundaries.

A copy of ``hotstuff_tpu.crypto.bls.service``.  Differences: the device
aggregator is ``aggregator="cuda"`` (``gpu/bls.py`` ``G1Aggregator``,
the hand G1 kernels) in place of ``"tpu"``, with an explicit ``device``
(``"cpu"`` runs the kernels' plain versions); ``"tpu-sharded"`` waits on
the mesh and raises; the native library is the port's build
(``crypto/bls/native.py``), and a failed build raises instead of falling
back to the Python pairing (``HOTSTUFF_BLS_NATIVE=0`` selects that).

Mirrors the Ed25519 ``VerifierBackend`` protocol
(hotstuff_tpu/crypto/service.py) over BLS12-381 keys (96-byte G2
pubkeys) and signatures (48-byte G1 points), and adds what only BLS can
offer: constant-cost shared-message verification via signature
aggregation — ``verify_shared_msg`` does ONE pairing equality however
many votes are in the QC, instead of a batch over 2f+1 Ed25519
signatures.

Drop-in point (reference parity): the SignatureService boundary at
crypto/src/lib.rs:232-257; BASELINE config 5's threshold variant uses
``split_secret``/``combine_partials`` from the package root.
"""

from __future__ import annotations

from ...telemetry import spans as _spans
from . import (
    BlsPublicKey,
    BlsSecretKey,
    BlsSignature,
    aggregate_public_keys,
    keygen,
)


#: public-key bytes -> decoded key (None: undecodable), for every
#: BlsVerifier of the process.  The JAX package keeps one cache a
#: verifier, so n co-located nodes decode every committee key n times
#: (a G2 square root and a subgroup ladder each, in Python); a
#: decode is deterministic, so sharing changes no verdict.
_PK_CACHE: dict[bytes, BlsPublicKey | None] = {}


def _parse_points(points_raw: bytes, count: int):
    """``count`` uncompressed affine G1 points (96 B each, from the
    native library) -> ``G1Point``s; None if a coordinate is not < q."""
    from .curve import G1Point
    from .fields import P as FIELD_P

    out = []
    for i in range(count):
        x = int.from_bytes(points_raw[96 * i : 96 * i + 48], "big")
        y = int.from_bytes(points_raw[96 * i + 48 : 96 * i + 96], "big")
        if x >= FIELD_P or y >= FIELD_P:
            return None
        out.append(G1Point(x, y))
    return out


class BlsVerifier:
    """VerifierBackend over BLS bytes; caches decoded public keys.

    ``aggregator="cuda"`` runs the G1 signature sum on the card
    (``gpu/bls.py``, the tree-sum kernel); the pairing equality stays on
    the host in both modes, one constant-cost call per QC.

    Async-claims integration (crypto/async_service.py):

    - ``prefers_aggregate``: shared-message claims (QCs, grouped timeout
      floods) MUST go through ``verify_shared_msg`` — one pairing
      equality per claim; flattening them into per-item checks would
      cost two pairings per SIGNATURE;
    - the worker-thread offload (``async_kind``/``always_offload``):
      pairing work runs through the native C++ library via ctypes,
      which releases the GIL — so an adversarial all-distinct-digest
      TC storm (n+1 Miller loops) runs off the event
      loop instead of stalling every round timer mid-view-change."""

    name = "bls-cpu"
    prefers_aggregate = True

    def __init__(self, aggregator: str = "cpu", device=None):
        # decoded keys are shared by every verifier of the process
        # (``_PK_CACHE``): co-located nodes (run-many) hold one committee
        self._pk_cache = _PK_CACHE
        # signer-set digest -> aggregated G2 key (compact-QC verify);
        # bounded in verify_aggregate_msg
        self._agg_pk_cache: dict[bytes, BlsPublicKey] = {}
        self._dev_agg = None
        # Native pairing (the C++ port of this package): per-signature
        # checks and point aggregation, unless HOTSTUFF_BLS_NATIVE=0; a
        # library that fails to build or selftest raises here
        from . import native as _native

        if _native.available():
            self._native = _native
            self._native_verify = _native.verify_one
        else:
            self._native = None
            self._native_verify = None
        self._storm = None  # StormOffload (device ladders), warmed on demand
        if aggregator == "cuda":
            from ...gpu.bls import G1Aggregator

            self._dev_agg = G1Aggregator(device="cuda" if device is None else device)
            self.name = "bls-cuda"
        elif aggregator == "tpu-sharded":
            raise NotImplementedError(
                "the sharded G1 aggregate waits on the mesh: not ported yet"
            )
        elif aggregator != "cpu":
            raise ValueError(f"unknown BLS aggregator '{aggregator}'")
        # Worker-thread offload via AsyncVerifyService: only worthwhile
        # when the native library carries the pairing work (ctypes
        # releases the GIL during C calls; the pure-Python fallback
        # would hold it and gain nothing from a thread).
        if self._native is not None:
            self.async_kind = f"{self.name}-offload"
            self.always_offload = True
            self.device_ready = True
            self.async_backend = self  # the offload target is this object
            self.cpu_backend = self  # inline fallback: same object
            # an adversarial all-distinct TC storm is legitimately long
            # (off-loop) pairing work — never deadline it back onto the
            # loop
            self.dispatch_deadline_s = 30.0

    def warmup_storm_offload(self, n: int = 171) -> None:
        """Run the device ladder/aggregation shapes of an n-entry
        distinct-digest storm once (the kernels build on first use).
        Only meaningful on the device-aggregation variant; call at node
        boot, never mid-consensus."""
        if self._dev_agg is None or self._native is None:
            return
        from ...gpu.bls import StormOffload

        if self._storm is None:
            self._storm = StormOffload(device=self._dev_agg.device)
        self._storm.warmup(n)

    def storm_offload_engaged(self, n: int) -> bool:
        """True iff an n-entry all-distinct TC batch would actually run
        through the device ladder offload in ``verify_many`` — the same
        gate that method applies (warmed shapes AND the n >= 16 floor
        below which the dispatch fixed cost can't amortize).  Public so
        the storm harness can refuse to label a host-route measurement
        as the offload row."""
        return (
            self._storm is not None
            and self._storm.ready
            and self._storm.shape_ready(n)
            and n >= 16
        )

    def _storm_verify(self, db, pb, sb) -> bool:
        """Device-offloaded all-distinct batch: host hashes/decompresses
        (native), device runs all 3n G1 ladders + the wsig aggregation,
        host runs the pairing product over the returned points.  False
        verdicts (or any malformed input) fall back to the caller's
        per-item attribution path."""
        import secrets

        n = len(db)
        bases_raw = self._native.hash_base_many(db)
        sigs_raw = self._native.g1_decompress_many(sb)
        if bases_raw is None or sigs_raw is None:
            return False
        bases = _parse_points(bases_raw, n)
        sigs = _parse_points(sigs_raw, n)
        if bases is None or sigs is None:
            return False
        weights = [secrets.randbits(128) | 1 for _ in range(n)]
        whm, agg, subgroup_ok = self._storm.batch_points(weights, bases, sigs)
        if not subgroup_ok:
            return False

        def ser(pt) -> bytes:
            if pt.inf:
                return bytes(96)
            return pt.x.to_bytes(48, "big") + pt.y.to_bytes(48, "big")

        return self._native.verify_batch_points(
            b"".join(ser(p) for p in whm), pb, ser(agg)
        )

    def _pk(self, pk_bytes: bytes) -> BlsPublicKey | None:
        if pk_bytes not in self._pk_cache:
            self._pk_cache[pk_bytes] = BlsPublicKey.from_bytes(pk_bytes)
        return self._pk_cache[pk_bytes]

    def precompute(self, pubkeys: list[bytes]) -> None:
        for pk in pubkeys:
            self._pk(pk)

    def verify_one(self, digest, pk, sig) -> bool:
        pk_b = pk if isinstance(pk, bytes) else pk.to_bytes()
        sig_b = sig if isinstance(sig, bytes) else sig.to_bytes()
        msg = digest if isinstance(digest, bytes) else digest.to_bytes()
        if self._native_verify is not None:
            return self._native_verify(msg, pk_b, sig_b)
        pub = self._pk(pk_b)
        s = BlsSignature.from_bytes(sig_b)
        return pub is not None and s is not None and pub.verify(msg, s)

    def verify_shared_msg(self, digest, votes) -> bool:
        """One pairing equality for the whole vote set (aggregation).

        Per-signature decode skips the r-torsion ladder; the SUM is
        subgroup-checked once instead (matching the device aggregator's
        check on the aggregate).  Sound: honest signatures
        carry no cofactor component, so any attack using per-vote
        cofactor components that cancel in the sum is equivalent to one
        using clean signatures — and a non-cancelling component makes
        the aggregate fail the single check."""
        from .curve import G1Point

        msg = digest if isinstance(digest, bytes) else digest.to_bytes()
        if not votes:
            return False
        if self._native is not None and self._dev_agg is None:
            # mixed path, fastest measured: signatures aggregate in C
            # (decompress + Jacobian sum, no per-sig subgroup ladders —
            # the aggregate is checked by the native verifier); public
            # keys sum over the CACHED decoded points (a native pk
            # aggregate would re-run the expensive G2 sqrt per key that
            # the cache already paid once per epoch)
            pubs, sig_bytes = [], []
            for pk, sig in votes:
                pub = self._pk(pk if isinstance(pk, bytes) else pk.to_bytes())
                if pub is None:
                    return False
                pubs.append(pub)
                sig_bytes.append(
                    sig if isinstance(sig, bytes) else sig.to_bytes()
                )
            agg_sig = self._native.aggregate_sigs(sig_bytes)
            if agg_sig is None:
                return False
            agg_pk = aggregate_public_keys(pubs)
            with _spans.span("host.pairing"):
                return self._native.verify_one(
                    msg, agg_pk.to_bytes(), agg_sig, check_pk_subgroup=False
                )
        pks, sig_bytes = [], []
        for pk, sig in votes:
            pub = self._pk(pk if isinstance(pk, bytes) else pk.to_bytes())
            if pub is None:
                return False
            pks.append(pub)
            sig_bytes.append(sig if isinstance(sig, bytes) else sig.to_bytes())
        sig_points = self._decode_sigs(sig_bytes)
        if sig_points is None:
            return False
        if self._dev_agg is not None:
            agg = self._dev_agg.aggregate(sig_points)
        else:
            agg = G1Point.sum(sig_points)
        agg_pk = aggregate_public_keys(pks)
        if self._native_verify is not None:
            # the native verifier subgroup-checks the aggregate SIGNATURE
            # itself; the aggregate PK is a sum of individually
            # subgroup-checked cached keys, so its ladder is skipped
            with _spans.span("host.pairing"):
                return self._native_verify(
                    msg,
                    agg_pk.to_bytes(),
                    BlsSignature(agg).to_bytes(),
                    check_pk_subgroup=False,
                )
        # ONE subgroup check on the aggregate (the device kernel has no
        # r-ladder, so the host checks its result — once per QC)
        if not agg.in_subgroup():
            return False
        with _spans.span("host.pairing"):
            return agg_pk.verify(msg, BlsSignature(agg))

    def _decode_sigs(self, sig_bytes: list[bytes]):
        """Compressed signatures -> on-curve ``G1Point``s without the
        r-torsion ladder (the sum is checked once); None if one does not
        decode.  One native call when the library is loaded (the Python
        square roots cost more than the device sum they feed), else
        ``G1Point.from_bytes``."""
        from .curve import G1Point

        if self._native is not None:
            raw = self._native.g1_decompress_many(sig_bytes)
            return None if raw is None else _parse_points(raw, len(sig_bytes))
        out = []
        for b in sig_bytes:
            pt = G1Point.from_bytes(b, subgroup_check=False)
            if pt is None:
                return None
            out.append(pt)
        return out

    def verify_aggregate_msg(self, digest, pks, agg_sig) -> bool:
        """Compact-certificate verify (QC.verify / TC.verify over the
        aggregated wire form): the signers' public keys — gathered from
        the signer bitmap by the caller — are summed once, then ONE
        pairing equality checks the pre-aggregated 48-byte signature,
        regardless of committee size.

        Unlike ``verify_shared_msg`` the aggregate signature arrives
        off the WIRE (adversary-controlled), so it is subgroup-checked
        here: the native verifier r-ladders the signature itself, and
        the pure path decodes with the default subgroup check on.  The
        key SUM is memoized by signer-set digest — under steady state
        every QC carries the same (or one of a few) quorum bitmaps, so
        repeat certificates skip the G2 sum and pay only the pairing."""
        msg = digest if isinstance(digest, bytes) else digest.to_bytes()
        sig_b = (
            agg_sig if isinstance(agg_sig, bytes) else agg_sig.to_bytes()
        )
        if not pks or len(sig_b) != 48:
            return False
        pk_bytes = [
            p if isinstance(p, bytes) else p.to_bytes() for p in pks
        ]
        import hashlib

        set_key = hashlib.blake2b(
            b"".join(pk_bytes), digest_size=16
        ).digest()
        agg_pk = self._agg_pk_cache.get(set_key)
        if agg_pk is None:
            with _spans.span("agg.gather"):
                pubs = []
                for pb in pk_bytes:
                    pub = self._pk(pb)
                    if pub is None:
                        return False
                    pubs.append(pub)
            with _spans.span("agg.keysum"):
                agg_pk = aggregate_public_keys(pubs)
            if len(self._agg_pk_cache) >= 256:
                # bounded: distinct quorum bitmaps per view are few; an
                # adversary churning bitmaps just degrades to no-cache
                self._agg_pk_cache.clear()
            self._agg_pk_cache[set_key] = agg_pk
        if self._native_verify is not None:
            # the native verifier subgroup-checks the (wire) aggregate
            # signature itself; the key sum is over subgroup-checked
            # cached committee points (closure), so its ladder is skipped
            with _spans.span("agg.pairing"):
                return self._native_verify(
                    msg, agg_pk.to_bytes(), sig_b, check_pk_subgroup=False
                )
        sig = BlsSignature.from_bytes(sig_b)  # default: subgroup-checked
        if sig is None:
            return False
        with _spans.span("agg.pairing"):
            return agg_pk.verify(msg, sig)

    def _grouped_batch(self, db, pb, sb):
        """Group a distinct-message batch by digest and aggregate each
        group (Σ pk over cached decoded points, Σ sig natively).
        Returns (digests, agg_pks96, agg_sigs48) per group, or None if
        grouping buys nothing (all digests distinct) or any key/sig is
        undecodable (caller falls back per item)."""
        groups: dict[bytes, list[int]] = {}
        for i, d in enumerate(db):
            groups.setdefault(d, []).append(i)
        if len(groups) == len(db):
            return None
        g_db, g_pb, g_sb = [], [], []
        for d, idxs in groups.items():
            pubs = []
            for i in idxs:
                pub = self._pk(pb[i])
                if pub is None:
                    return None
                pubs.append(pub)
            agg_sig = self._native.aggregate_sigs([sb[i] for i in idxs])
            if agg_sig is None:
                return None
            g_db.append(d)
            # sum of subgroup-checked cached points stays in-subgroup
            # (closure) — the native layer is told so
            # (check_pk_subgroup=False), which also keeps these one-shot
            # aggregate keys out of its prepared-coefficient cache
            g_pb.append(aggregate_public_keys(pubs).to_bytes())
            g_sb.append(agg_sig)
        return g_db, g_pb, g_sb

    def verify_many(
        self, digests, pks, sigs, aggregate_ok: bool = False
    ) -> list[bool]:
        """Distinct-message batch (the TC-verify shape): one multi-pairing
        with random 128-bit weights sharing a single final exponentiation
        — Π e(rᵢ·H(mᵢ), pkᵢ) · e(−Σ rᵢ·sigᵢ, G2) == 1.  The random
        weights make cross-entry cancellation infeasible (standard
        small-exponents batching), so a passing product implies every
        entry verifies; on failure, fall back per-item to report WHICH
        entries are invalid.  Cost: n+1 Miller loops + 1 final exp
        vs n full pairing equalities (2n Miller loops, n final exps) —
        this is the view-change-storm path (TC.verify, BASELINE
        config 4), which runs on the event loop while round timers are
        already firing."""
        import secrets

        from .curve import G1Point, G2Point, hash_to_g1
        from .fields import Fq12
        from .pairing import final_exponentiation, miller_loop

        n = len(digests)
        if n == 0:
            return []
        if self._native is not None:
            db = [
                d if isinstance(d, bytes) else d.to_bytes() for d in digests
            ]
            pb = [p if isinstance(p, bytes) else p.to_bytes() for p in pks]
            sb = [s if isinstance(s, bytes) else s.to_bytes() for s in sigs]
            if n > 1 and all(len(d) == 32 for d in db):
                # TC shape.  The storm's timeout digests collapse to a
                # handful of DISTINCT values (every node signing the
                # same (round, high_qc_round) produces the same digest),
                # so first GROUP BY DIGEST and aggregate each group the
                # QC way — Π e(r_i·H(m), pk_i) = e(r·H(m), Σ pk_i) —
                # then run the native random-weight multi-pairing over
                # the G group aggregates: G+1 Miller loops instead of
                # n+1.  Within-group aggregation leans on the same
                # trust base as QC aggregation (PoP-checked keys,
                # subgroup-checked summands; committee/stake rules run
                # BEFORE signatures in TC.verify), and the RANDOM
                # WEIGHTS still apply per group, so cross-group
                # cancellation stays infeasible.  Worst adversarial
                # case (all digests distinct) degrades to exactly the
                # old per-entry multi-pairing.
                grouped = (
                    self._grouped_batch(db, pb, sb) if aggregate_ok else None
                )
                if grouped is not None:
                    g_db, g_pb, g_sb = grouped
                    # check_pk_subgroup=False: the aggregates are sums
                    # of subgroup-checked cached committee points
                    # (closure), and the flag also tells the native
                    # layer these one-shot keys must not enter the
                    # prepared-line-coefficient cache
                    ok = (
                        self._native.verify_batch(
                            g_db, g_pb, g_sb, check_pk_subgroup=False
                        )
                        if len(g_db) > 1
                        else self._native.verify_one(
                            g_db[0], g_pb[0], g_sb[0],
                            check_pk_subgroup=False,
                        )
                    )
                    if ok:
                        return [True] * n
                elif (
                    aggregate_ok
                    and self.storm_offload_engaged(n)
                    and self._storm_verify(db, pb, sb)
                ):
                    # all-distinct worst case with the G1 ladders on
                    # the device; False verdicts fall through to per-item
                    # attribution below
                    return [True] * n
                elif self._native.verify_batch(db, pb, sb):
                    return [True] * n
                # re-check per item to pinpoint the invalid entries
            return [
                self.verify_one(d, p, s) for d, p, s in zip(db, pb, sb)
            ]
        entries = []
        for d, p, s in zip(digests, pks, sigs):
            pub = self._pk(p if isinstance(p, bytes) else p.to_bytes())
            sig = BlsSignature.from_bytes(
                s if isinstance(s, bytes) else s.to_bytes()
            )
            msg = d if isinstance(d, bytes) else d.to_bytes()
            if pub is None or sig is None or pub.point.inf or sig.point.inf:
                entries = None  # malformed entry: no batch shortcut
                break
            entries.append((msg, pub.point, sig.point))
        if entries is not None and n > 1:
            weights = [secrets.randbits(128) | 1 for _ in range(n)]
            agg = G1Point.sum(
                [sig_pt._mul_raw(r) for (_, _, sig_pt), r in zip(entries, weights)]
            )
            f = Fq12.ONE
            for (msg, pk_pt, _), r in zip(entries, weights):
                f = f * miller_loop(hash_to_g1(msg)._mul_raw(r), pk_pt)
            f = f * miller_loop(-agg, G2Point.generator())
            if final_exponentiation(f) == Fq12.ONE:
                return [True] * n
        return [
            self.verify_one(d, p, s) for d, p, s in zip(digests, pks, sigs)
        ]


class BlsSigningService:
    """The BLS signing service behind the SignatureService API surface
    (reference crypto/src/lib.rs:232-257).  Signing is inline — the
    single-threaded loop already serializes access to the key, the same
    argument as the Ed25519 service (a sign is a hash-to-G1 and one G1
    scalar multiply).  Returns the scheme-agnostic consensus
    ``Signature`` wrapper (48-byte compressed G1) so votes/blocks carry
    BLS material through the identical protocol types."""

    def __init__(self, secret: BlsSecretKey | bytes):
        if isinstance(secret, (bytes, bytearray)):
            secret = BlsSecretKey(int.from_bytes(bytes(secret), "big"))
        self._sk: BlsSecretKey | None = secret
        self._closed = False

    async def request_signature(self, digest) -> "Signature":
        return self.sign_sync(digest)

    def sign_sync(self, digest) -> "Signature":
        from ..signature import Signature

        if self._closed or self._sk is None:
            raise RuntimeError("BlsSigningService is shut down")
        msg = digest if isinstance(digest, bytes) else digest.to_bytes()
        return Signature(self._sk.sign(msg).to_bytes())

    def shutdown(self) -> None:
        self._closed = True
        self._sk = None


__all__ = ["BlsVerifier", "BlsSigningService", "keygen"]
