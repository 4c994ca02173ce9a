"""The port's BLS12-381 host crypto (hotstuff_tpu_torch/crypto/bls) against
the JAX package's (hotstuff_tpu/crypto/bls) on seeded inputs: field and
curve arithmetic, the wire bytes of points, keys and signatures, the
pairing, proofs of possession, threshold split/combine, the port's native
library (its own build of native/bls_pairing.cpp) against its Python
pairing, and the ``HOTSTUFF_BLS_NATIVE=0`` route.

Tolerance: none — integers, bytes and verdicts are compared exactly."""

import hashlib
import random

import pytest

from hotstuff_tpu.crypto import bls as jbls
from hotstuff_tpu.crypto.bls import curve as jcurve, fields as jfields, pairing as jpairing
from hotstuff_tpu_torch import _native_build
from hotstuff_tpu_torch.crypto import bls as tbls
from hotstuff_tpu_torch.crypto.bls import curve as tcurve, fields as tfields, native, pairing as tpairing
from hotstuff_tpu_torch.crypto.bls.service import BlsSigningService, BlsVerifier

SEED = 1017
P = tfields.P


def _seeded(n: int):
    rng = random.Random(SEED)
    return [rng.randrange(1, tfields.R) for _ in range(n)]


def test_fields_equal_jax():
    rng = random.Random(SEED)
    assert (tfields.P, tfields.R, tfields.X) == (jfields.P, jfields.R, jfields.X)
    for _ in range(5):
        a = [rng.randrange(P) for _ in range(2)]
        b = [rng.randrange(P) for _ in range(2)]
        ta, tb = tfields.Fq2(*a), tfields.Fq2(*b)
        ja, jb = jfields.Fq2(*a), jfields.Fq2(*b)
        for op in (lambda x, y: x * y, lambda x, y: x + y, lambda x, y: x - y):
            got, want = op(ta, tb), op(ja, jb)
            assert (got.c0, got.c1) == (want.c0, want.c1)
        inv_t, inv_j = ta.inverse(), ja.inverse()
        assert (inv_t.c0, inv_t.c1) == (inv_j.c0, inv_j.c1)
        assert tfields.fq_inv(a[0]) == jfields.fq_inv(a[0])


def test_curve_points_and_bytes_equal_jax():
    """G1 and G2 multiples, sums and their compressed bytes; decoding with
    and without the subgroup check, as the JAX package decodes."""
    for k in _seeded(4):
        t1, j1 = tcurve.G1Point.generator().mul(k), jcurve.G1Point.generator().mul(k)
        assert (t1.x, t1.y, t1.inf) == (j1.x, j1.y, j1.inf)
        assert t1.to_bytes() == j1.to_bytes()
        for check in (True, False):
            assert tcurve.G1Point.from_bytes(t1.to_bytes(), subgroup_check=check).to_bytes() == \
                jcurve.G1Point.from_bytes(j1.to_bytes(), subgroup_check=check).to_bytes()
        t2, j2 = tcurve.G2Point.generator().mul(k), jcurve.G2Point.generator().mul(k)
        assert t2.to_bytes() == j2.to_bytes()
        assert tcurve.G2Point.from_bytes(t2.to_bytes()).to_bytes() == t2.to_bytes()
        assert (t1 + t1 + (-t1)).to_bytes() == (j1 + j1 + (-j1)).to_bytes()
    pts_t = [tcurve.G1Point.generator().mul(k) for k in _seeded(6)]
    pts_j = [jcurve.G1Point.generator().mul(k) for k in _seeded(6)]
    assert tcurve.G1Point.sum(pts_t).to_bytes() == jcurve.G1Point.sum(pts_j).to_bytes()
    assert tcurve.G1Point.identity().to_bytes() == jcurve.G1Point.identity().to_bytes()
    for msg in (b"", b"m", b"\x07" * 32):
        assert tcurve.hash_to_g1(msg).to_bytes() == jcurve.hash_to_g1(msg).to_bytes()
    # malformed encodings: both refuse
    for blob in (b"\x00" * 48, b"\xc0" + b"\x01" * 47, b"\x80" + b"\xff" * 47, b"short"):
        assert tcurve.G1Point.from_bytes(blob) is None and jcurve.G1Point.from_bytes(blob) is None


def test_a_non_subgroup_point_is_refused_by_both():
    counter = 0
    while True:
        h = hashlib.sha256(b"raw-port" + counter.to_bytes(4, "big")).digest()
        x = int.from_bytes(h + h[:16], "big") % P
        y2 = (x**3 + 4) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P == y2 and not tcurve.G1Point(x, y).in_subgroup():
            break
        counter += 1
    raw = tcurve.G1Point(x, y).to_bytes()
    assert tcurve.G1Point.from_bytes(raw) is None and jcurve.G1Point.from_bytes(raw) is None
    assert tcurve.G1Point.from_bytes(raw, subgroup_check=False) is not None


def _fq12_ints(f) -> list[int]:
    return [c for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.c0, f2.c1)]


def test_pairing_equals_jax():
    k1, k2 = _seeded(2)
    tp, tq = tcurve.G1Point.generator().mul(k1), tcurve.G2Point.generator().mul(k2)
    jp, jq = jcurve.G1Point.generator().mul(k1), jcurve.G2Point.generator().mul(k2)
    assert _fq12_ints(tpairing.pairing(tp, tq)) == _fq12_ints(jpairing.pairing(jp, jq))
    assert _fq12_ints(tpairing.miller_loop(tp, tq)) == _fq12_ints(jpairing.miller_loop(jp, jq))
    g1, g2 = tcurve.G1Point.generator(), tcurve.G2Point.generator()
    assert tpairing.pairings_equal(g1.mul(6), g2, g1.mul(2), g2.mul(3))
    assert not tpairing.pairings_equal(g1.mul(6), g2, g1.mul(2), g2.mul(4))


def test_keys_signatures_pop_and_aggregates_equal_jax():
    seeds = [bytes([i]) * 8 for i in range(4)]
    msg = b"port bls parity"
    tpairs = [tbls.keygen(s) for s in seeds]
    jpairs = [jbls.keygen(s) for s in seeds]
    for (tpk, tsk), (jpk, jsk) in zip(tpairs, jpairs):
        assert tsk.scalar == jsk.scalar
        assert tpk.to_bytes() == jpk.to_bytes()
        tsig, jsig = tsk.sign(msg), jsk.sign(msg)
        assert tsig.to_bytes() == jsig.to_bytes()
        assert tpk.verify(msg, tsig) and not tpk.verify(b"other", tsig)
        tpop, jpop = tbls.prove_possession(tsk), jbls.prove_possession(jsk)
        assert tpop.to_bytes() == jpop.to_bytes()
        assert tbls.verify_possession(tpk, tpop)
    # a proof of another key is refused by both
    assert not tbls.verify_possession(tpairs[0][0], tbls.prove_possession(tpairs[1][1]))
    assert not jbls.verify_possession(jpairs[0][0], jbls.prove_possession(jpairs[1][1]))
    tsigs = [sk.sign(msg) for _, sk in tpairs]
    jsigs = [sk.sign(msg) for _, sk in jpairs]
    assert tbls.aggregate_signatures(tsigs).to_bytes() == jbls.aggregate_signatures(jsigs).to_bytes()
    assert tbls.aggregate_public_keys([pk for pk, _ in tpairs]).to_bytes() == \
        jbls.aggregate_public_keys([pk for pk, _ in jpairs]).to_bytes()
    assert tbls.verify_aggregate(msg, [pk for pk, _ in tpairs], tbls.aggregate_signatures(tsigs))
    assert not tbls.verify_aggregate(msg, [pk for pk, _ in tpairs[:3]], tbls.aggregate_signatures(tsigs))


def test_threshold_split_and_combine_equal_jax():
    _, tsk = tbls.keygen(b"threshold")
    _, jsk = jbls.keygen(b"threshold")
    tshares = tbls.split_secret(tsk, 3, 5, seed=b"shares")
    jshares = jbls.split_secret(jsk, 3, 5, seed=b"shares")
    assert [(i, s.scalar) for i, s in tshares] == [(i, s.scalar) for i, s in jshares]
    assert tbls.lagrange_at_zero([1, 3, 5]) == jbls.lagrange_at_zero([1, 3, 5])
    msg = b"threshold message"
    tparts = [(i, s.sign(msg)) for i, s in tshares[1:4]]
    jparts = [(i, s.sign(msg)) for i, s in jshares[1:4]]
    tgroup = tbls.combine_partials(tparts)
    assert tgroup.to_bytes() == jbls.combine_partials(jparts).to_bytes()
    assert tgroup.to_bytes() == tsk.sign(msg).to_bytes()
    with pytest.raises(ValueError):
        tbls.split_secret(tsk, 6, 5)


def test_signing_service_signs_as_jax():
    from hotstuff_tpu.crypto.bls.service import BlsSigningService as JSigner
    from hotstuff_tpu_torch.crypto import Digest

    _, sk = tbls.keygen(b"signer")
    secret = sk.scalar.to_bytes(32, "big")
    d = Digest.of(b"signed digest")
    got = BlsSigningService(secret).sign_sync(d)
    assert got.to_bytes() == JSigner(secret).sign_sync(d.to_bytes()).to_bytes()
    svc = BlsSigningService(secret)
    svc.shutdown()
    with pytest.raises(RuntimeError):
        svc.sign_sync(d)


# ---- the native library -----------------------------------------------------------


def test_native_library_is_the_ports_own_build():
    assert native.available()
    path = _native_build.library_path("bls")
    assert path.parent == _native_build.BUILD_DIR and path.name.startswith("libhs_bls_")
    assert "bls_constants.h" in _native_build.LIBRARIES["bls"].headers


def test_native_verify_parity_with_the_python_pairing():
    """The vectors of tests/test_bls.py: valid signatures verify,
    tampered ones, other messages, other keys and malformed operands are
    refused — by the library and by the Python pairing alike."""
    for i in range(4):
        pk, sk = tbls.keygen(bytes([120 + i]))
        msg = b"native parity %d" % i
        sig = sk.sign(msg)
        cases = [(msg, pk.to_bytes(), sig.to_bytes(), True)]
        bad = bytearray(sig.to_bytes())
        bad[17] ^= 0x04
        cases.append((msg, pk.to_bytes(), bytes(bad), False))
        cases.append((b"other", pk.to_bytes(), sig.to_bytes(), False))
        pk2, _ = tbls.keygen(bytes([200 + i]))
        cases.append((msg, pk2.to_bytes(), sig.to_bytes(), False))
        for m, p, s, want in cases:
            assert native.verify_one(m, p, s) is want
            pub, sg = tbls.BlsPublicKey.from_bytes(p), tbls.BlsSignature.from_bytes(s)
            python = pub is not None and sg is not None and pub.verify(m, sg)
            assert python is want
    pk, sk = tbls.keygen(b"native-malformed")
    sig = sk.sign(b"m").to_bytes()
    assert not native.verify_one(b"m", b"\x00" * 96, sig)
    assert not native.verify_one(b"m", pk.to_bytes(), b"\x00" * 48)
    assert not native.verify_one(b"m", pk.to_bytes()[:95], sig)
    assert not native.verify_one(b"m", pk.to_bytes(), tcurve.G1Point.identity().to_bytes())


def test_native_aggregation_and_batch_match_python():
    msg = b"native aggregation"
    pairs = [tbls.keygen(bytes([160 + i])) for i in range(5)]
    sigs = [sk.sign(msg) for _, sk in pairs]
    want = tbls.aggregate_signatures(sigs).to_bytes()
    assert native.aggregate_sigs([s.to_bytes() for s in sigs]) == want
    assert native.aggregate_sigs([s.to_bytes() for s in sigs] + [tcurve.G1Point.identity().to_bytes()]) == want
    assert native.aggregate_sigs([b"\x00" * 48]) is None
    digests = [bytes([i]) * 32 for i in range(5)]
    dsigs = [sk.sign(d).to_bytes() for (_, sk), d in zip(pairs, digests)]
    pks = [pk.to_bytes() for pk, _ in pairs]
    assert native.verify_batch(digests, pks, dsigs)
    assert not native.verify_batch(digests, pks, dsigs[:4] + [dsigs[0]])
    assert not native.verify_batch(digests[:4], pks, dsigs)


def test_native_offload_split_apis():
    """The host ends of the storm offload, as tests/test_tpu_bls.py holds
    the JAX package's: the pre-cofactor hash map, decompression, and the
    pairing product over weighted points."""
    from hotstuff_tpu_torch.crypto import Digest

    n = 4
    db, pb, sb = [], [], []
    for i in range(n):
        pk, sk = tbls.keygen(bytes([77, i]) + b"\x00" * 30)
        d = Digest.of(bytes([i]) * 7)
        db.append(d.to_bytes())
        pb.append(pk.to_bytes())
        sb.append(BlsSigningService(sk).sign_sync(d).to_bytes())

    def parse(raw):
        return [tcurve.G1Point(int.from_bytes(raw[96 * i: 96 * i + 48], "big"),
                               int.from_bytes(raw[96 * i + 48: 96 * i + 96], "big")) for i in range(n)]

    bases = parse(native.hash_base_many(db))
    for d, base in zip(db, bases):
        assert base._mul_raw(tcurve.H1) == tcurve.hash_to_g1(d)
    sigs = parse(native.g1_decompress_many(sb))
    assert [s.to_bytes() for s in sigs] == sb
    ws = [3, 5, 7, 11]
    whm = [bases[i]._mul_raw(ws[i] * tcurve.H1) for i in range(n)]
    agg = tcurve.G1Point.sum([sigs[i]._mul_raw(ws[i]) for i in range(n)])

    def ser(pt):
        return pt.x.to_bytes(48, "big") + pt.y.to_bytes(48, "big")

    whm_bytes = b"".join(ser(p) for p in whm)
    assert native.verify_batch_points(whm_bytes, pb, ser(agg))
    bad = bytearray(whm_bytes)
    bad[50] ^= 1
    assert not native.verify_batch_points(bytes(bad), pb, ser(agg))


def test_bls_native_0_takes_the_python_route(monkeypatch):
    """HOTSTUFF_BLS_NATIVE=0: no native hook, no worker-thread offload, and
    the same verdicts as the native route."""
    monkeypatch.setenv("HOTSTUFF_BLS_NATIVE", "0")
    assert not native.available()
    v_py = BlsVerifier()
    assert v_py._native is None and v_py._native_verify is None
    assert not hasattr(v_py, "async_kind")
    monkeypatch.delenv("HOTSTUFF_BLS_NATIVE")
    v_native = BlsVerifier()
    assert v_native._native_verify is not None and v_native.always_offload
    msg = b"native vs python verifier"
    pairs = [tbls.keygen(bytes([140 + i])) for i in range(3)]
    votes = [(pk.to_bytes(), sk.sign(msg).to_bytes()) for pk, sk in pairs]
    forged = votes[:2] + [(votes[2][0], votes[0][1])]
    for v in (v_native, v_py):
        assert v.verify_shared_msg(msg, votes)
        assert not v.verify_shared_msg(msg, forged)
        assert v.verify_one(msg, *votes[0])


def test_the_verifier_equals_jax_verdict_for_verdict():
    """The port's BlsVerifier and the JAX package's on the same claims:
    shared-message QCs, distinct-digest batches (with a forged entry),
    the compact aggregate form, and the grouped TC shape."""
    from hotstuff_tpu.crypto.bls.service import BlsVerifier as JVerifier

    pairs = [tbls.keygen(bytes([180 + i])) for i in range(5)]
    pks = [pk.to_bytes() for pk, _ in pairs]
    msg = b"\x42" * 32
    votes = [(pk, sk.sign(msg).to_bytes()) for (_, sk), pk in zip(pairs, pks)]
    digests = [bytes([i + 1]) * 32 for i in range(5)]
    dsigs = [sk.sign(d).to_bytes() for (_, sk), d in zip(pairs, digests)]
    agg = tbls.aggregate_signatures([tbls.BlsSignature.from_bytes(s) for _, s in votes]).to_bytes()
    t, j = BlsVerifier(), JVerifier()
    for v in (t, j):
        v.precompute(pks)
    cases = [
        ("shared", (msg, votes)),
        ("shared", (msg, votes[:4] + [(votes[4][0], votes[0][1])])),
        ("many", (digests, pks, dsigs)),
        ("many", (digests, pks, dsigs[:4] + [dsigs[0]])),
        ("grouped", ([msg] * 5, pks, [s for _, s in votes])),
        ("agg", (msg, pks, agg)),
        ("agg", (msg, pks[:4], agg)),
        ("agg", (msg, pks, b"\x00" * 48)),
    ]
    for kind, args in cases:
        if kind == "shared":
            got, want = t.verify_shared_msg(*args), j.verify_shared_msg(*args)
        elif kind == "many":
            got, want = t.verify_many(*args), j.verify_many(*args)
        elif kind == "grouped":
            got = t.verify_many(*args, aggregate_ok=True)
            want = j.verify_many(*args, aggregate_ok=True)
        else:
            got, want = t.verify_aggregate_msg(*args), j.verify_aggregate_msg(*args)
        assert got == want, kind


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "python"])
def test_the_cuda_aggregator_route_equals_jax_on_shared_claims(monkeypatch, native_on):
    """``BlsVerifier(aggregator="cuda")`` (here on the kernels' plain
    versions) decodes a vote set's signatures natively when the library
    is loaded and in Python under HOTSTUFF_BLS_NATIVE=0; either way its
    verdicts on shared-message QCs (valid, a swapped signature, bytes off
    the curve, a wrong length) are the JAX package's."""
    from hotstuff_tpu.crypto.bls.service import BlsVerifier as JVerifier

    if not native_on:
        monkeypatch.setenv("HOTSTUFF_BLS_NATIVE", "0")
    t = BlsVerifier(aggregator="cuda", device="cpu")
    assert (t._native is not None) == native_on
    j = JVerifier()
    pairs = [tbls.keygen(bytes([200 + i])) for i in range(3)]
    pks = [pk.to_bytes() for pk, _ in pairs]
    msg = b"\x24" * 32
    votes = [(pk, sk.sign(msg).to_bytes()) for (_, sk), pk in zip(pairs, pks)]
    off_curve = bytes([votes[0][1][0]]) + bytes(47)
    cases = [
        votes,
        votes[:2] + [(votes[2][0], votes[0][1])],
        votes[:2] + [(votes[2][0], off_curve)],
        votes[:2] + [(votes[2][0], votes[2][1][:47])],
    ]
    for vs in cases:
        assert t.verify_shared_msg(msg, vs) == j.verify_shared_msg(msg, vs)
    assert t.verify_shared_msg(msg, votes)
