"""The port's certificate layer (hotstuff_tpu_torch/consensus/) against
the JAX package's on the same inputs: message digests, wire bytes in both
directions, ``claims()``, certificate verdicts and error types, and the
QC/TC the aggregators emit.  Everything compared is bytes, booleans or
exception types, so every comparison is exact.

Port objects are built from JAX objects through the wire: a JAX encoding
decodes in the port to an equal object that re-encodes to the same
bytes."""

from types import SimpleNamespace

import pytest
import torch

import hotstuff_tpu.consensus as jcons
import hotstuff_tpu.crypto as jcrypto
import hotstuff_tpu_torch.consensus as pcons
import hotstuff_tpu_torch.crypto as pcrypto
from hotstuff_tpu.consensus import wire as jwire
from hotstuff_tpu.consensus.messages import timeout_digest as j_timeout_digest
from hotstuff_tpu.utils import codec as jcodec
from hotstuff_tpu_torch.consensus import wire as pwire
from hotstuff_tpu_torch.consensus.messages import timeout_digest as p_timeout_digest
from hotstuff_tpu_torch.gpu.ed25519 import BatchVerifier
from hotstuff_tpu_torch.utils import codec as pcodec

torch.set_num_threads(1)

N = 16
QUORUM = 2 * N // 3 + 1  # 11
SEED = b"\x44" * 32

JAX = SimpleNamespace(
    c=jcons, k=jcrypto, wire=jwire, codec=jcodec, timeout_digest=j_timeout_digest
)
PORT = SimpleNamespace(
    c=pcons, k=pcrypto, wire=pwire, codec=pcodec, timeout_digest=p_timeout_digest
)


def _keys(lib, n=N):
    return [lib.k.generate_keypair(SEED, i) for i in range(n)]


def _committee(lib, keys):
    return lib.c.Committee.new(
        [(pk, 1, ("127.0.0.1", 30_000 + i)) for i, (pk, _) in enumerate(keys)]
    )


def _sign(lib, digest, sk):
    return lib.k.Signature.new(digest, sk)


def _qc(lib, keys, block_digest, rnd, signers):
    d = lib.c.Vote(hash=block_digest, round=rnd, author=keys[0][0]).digest()
    return lib.c.QC(
        hash=block_digest, round=rnd, votes=[(keys[i][0], _sign(lib, d, keys[i][1])) for i in signers]
    )


def _tc(lib, keys, rnd, hq_rounds):
    return lib.c.TC(
        round=rnd,
        votes=[
            (keys[i][0], _sign(lib, lib.timeout_digest(rnd, hq), keys[i][1]), hq)
            for i, hq in enumerate(hq_rounds)
        ],
    )


def _build(lib, kind):
    """One message of ``kind``, built from the seed alone with ``lib``'s
    classes (Ed25519 signing is deterministic, so both libraries sign to
    the same bytes)."""
    keys = _keys(lib)
    c, k = lib.c, lib.k
    parent = k.Digest.of(b"parent block")
    qc = _qc(lib, keys, parent, 4, range(QUORUM))
    if kind == "vote":
        v = c.Vote(hash=parent, round=5, author=keys[2][0])
        v.signature = _sign(lib, v.digest(), keys[2][1])
        return v
    if kind == "qc":
        return qc
    if kind == "tc":  # distinct high_qc rounds: single claims
        return _tc(lib, keys, 6, range(QUORUM))
    if kind == "tc_grouped":  # shared high_qc rounds: grouped claims
        return _tc(lib, keys, 6, [4] * 7 + [3] * 3 + [2])
    if kind == "timeout":
        t = c.Timeout(high_qc=qc, round=6, author=keys[1][0])
        t.signature = _sign(lib, t.digest(), keys[1][1])
        return t
    if kind == "block":
        b = c.Block(
            qc=qc,
            tc=_tc(lib, keys, 5, [4] * QUORUM),
            author=keys[3][0],
            round=6,
            payloads=tuple(k.Digest.of(b"payload %d" % i) for i in range(3)),
        )
        b.signature = _sign(lib, b.digest(), keys[3][1])
        return b
    raise ValueError(kind)


def _encode(lib, kind, obj) -> bytes:
    if kind == "qc":
        enc = lib.codec.Encoder()
        obj.encode(enc)
        return enc.finish()
    fn = {
        "vote": lib.wire.encode_vote,
        "tc": lib.wire.encode_tc,
        "tc_grouped": lib.wire.encode_tc,
        "timeout": lib.wire.encode_timeout,
        "block": lib.wire.encode_propose,
    }[kind]
    return fn(obj)


def _decode(lib, kind, data, scheme):
    if kind == "qc":
        dec = lib.codec.Decoder(data)
        if scheme is not None:
            dec.pk_size, dec.sig_size = 32, 64
        obj = lib.c.QC.decode(dec)
        dec.finish()
        return obj
    return lib.wire.decode_message(data, scheme)[1]


def _digests(lib, kind, obj) -> list[bytes]:
    if kind in ("tc", "tc_grouped"):
        return [lib.timeout_digest(obj.round, hq).to_bytes() for _, _, hq in obj.votes]
    return [obj.digest().to_bytes()]


def _claims(kind, obj):
    if kind == "vote":
        return [obj.claim()]
    if kind == "timeout":
        return obj.high_qc.claims()
    return obj.claims()


def _port_from_jax(kind, jobj, scheme=None):
    return _decode(PORT, kind, _encode(JAX, kind, jobj), scheme)


KINDS = ["vote", "qc", "tc", "tc_grouped", "timeout", "block"]


@pytest.mark.parametrize("kind", KINDS)
def test_digests_wire_bytes_and_claims_match_both_ways(kind):
    jobj, pobj = _build(JAX, kind), _build(PORT, kind)
    assert _digests(PORT, kind, pobj) == _digests(JAX, kind, jobj)
    jbytes, pbytes = _encode(JAX, kind, jobj), _encode(PORT, kind, pobj)
    assert pbytes == jbytes
    assert _claims(kind, pobj) == _claims(kind, jobj)
    for scheme in (None, "ed25519"):
        from_jax = _decode(PORT, kind, jbytes, scheme)  # JAX bytes -> port
        assert type(from_jax) is type(pobj) and from_jax == pobj
        assert _encode(PORT, kind, from_jax) == jbytes
        assert _claims(kind, from_jax) == _claims(kind, jobj)
        from_port = _decode(JAX, kind, pbytes, scheme)  # port bytes -> JAX
        assert _encode(JAX, kind, from_port) == pbytes
    if kind == "qc":
        assert [(pk.to_bytes(), s.to_bytes()) for pk, s in from_jax.votes] == [
            (pk.to_bytes(), s.to_bytes()) for pk, s in jobj.votes
        ]


def test_compact_certificates_keep_the_wire_form():
    """The compact (BLS) forms are a wire format the port keeps: same
    bytes both ways, and an Ed25519 committee's decoder rejects them."""
    jqc = jcons.QC(
        hash=jcrypto.Digest.of(b"c"), round=3, agg_sig=jcrypto.Signature(b"\x07" * 48), signers=b"\xff\x07"
    )
    jtc = jcons.TC(round=4, groups=[(3, jcrypto.Signature(b"\x08" * 48), b"\xff\x07")])
    jt = jcons.Timeout(high_qc=jqc, round=4, author=_keys(JAX, 1)[0][0], signature=jcrypto.Signature(b"\x01" * 64))
    for kind, obj in (("qc", jqc), ("tc", jtc), ("timeout", jt)):
        data = _encode(JAX, kind, obj)
        assert _encode(PORT, kind, _decode(PORT, kind, data, None)) == data
        if kind != "qc":  # a bare QC has no frame to pin the scheme on
            with pytest.raises(pcons.SerializationError):
                _decode(PORT, kind, data, "ed25519")
            with pytest.raises(jcons.SerializationError):
                _decode(JAX, kind, data, "ed25519")
    pqc = _decode(PORT, "qc", _encode(JAX, "qc", jqc), None)
    com = _committee(PORT, _keys(PORT))
    assert pqc.claims(committee=com) == jqc.claims(committee=_committee(JAX, _keys(JAX)))
    with pytest.raises(pcons.InvalidSignature):  # no Ed25519 aggregate verify
        pqc.verify(com, pcrypto.CpuVerifier())


@pytest.mark.parametrize(
    "data",
    [b"", b"\x63", bytes([pwire.TAG_VOTE]) + b"\x00" * 10, bytes([pwire.TAG_TC]) + b"\x01" * 12 + b"\xff" * 4],
)
def test_malformed_frames_fail_alike(data):
    def outcome(lib):
        try:
            lib.wire.decode_message(data, "ed25519")
        except Exception as e:  # noqa: BLE001 — the type is what is compared
            return type(e).__name__
        return "ok"

    assert outcome(PORT) == outcome(JAX) == "SerializationError"


# ---- verdicts and errors ----------------------------------------------------


def _forge(lib, kind):
    """(message, committee) for one valid or forged certificate case,
    built with ``lib``."""
    keys = _keys(lib)
    outsider = lib.k.generate_keypair(b"\x99" * 32, 0)
    com = _committee(lib, keys)
    c, k = lib.c, lib.k
    parent = k.Digest.of(b"parent block")

    def bad_sig(sig):
        b = sig.to_bytes()
        return k.Signature(b[:5] + bytes([b[5] ^ 1]) + b[6:])

    if kind.startswith("vote"):
        v = c.Vote(hash=parent, round=5, author=keys[2][0])
        v.signature = _sign(lib, v.digest(), keys[2][1])
        if kind == "vote_bad_sig":
            v.signature = bad_sig(v.signature)
        if kind == "vote_unknown_author":
            v = c.Vote(hash=parent, round=5, author=outsider[0])
            v.signature = _sign(lib, v.digest(), outsider[1])
        return v, com
    if kind.startswith("qc") or kind.startswith("timeout"):
        qc = _qc(lib, keys, parent, 4, range(QUORUM))
        if kind == "qc_bad_sig":
            qc.votes[7] = (qc.votes[7][0], bad_sig(qc.votes[7][1]))
        if kind in ("qc_sub_quorum", "timeout_sub_quorum_high_qc"):
            qc = _qc(lib, keys, parent, 4, range(QUORUM - 1))
        if kind == "qc_unknown_author":
            d = c.Vote(hash=parent, round=4, author=outsider[0]).digest()
            qc.votes[0] = (outsider[0], _sign(lib, d, outsider[1]))
        if kind == "qc_duplicate_author":
            qc.votes[1] = qc.votes[0]
        if kind == "qc_empty":
            qc = c.QC(hash=parent, round=4, votes=[])
        if kind.startswith("qc"):
            return qc, com
        t = c.Timeout(high_qc=qc, round=6, author=keys[1][0])
        t.signature = _sign(lib, t.digest(), keys[1][1])
        if kind == "timeout_bad_sig":
            t.signature = bad_sig(t.signature)
        return t, com
    if kind.startswith("tc"):
        tc = _tc(lib, keys, 6, range(QUORUM))
        if kind == "tc_bad_sig":
            pk, sig, hq = tc.votes[9]
            tc.votes[9] = (pk, bad_sig(sig), hq)
        if kind == "tc_empty":
            tc = c.TC(round=6, votes=[])
        if kind == "tc_duplicate_author":
            tc.votes[2] = tc.votes[1]
        if kind == "tc_unknown_author":
            tc.votes[0] = (outsider[0], _sign(lib, lib.timeout_digest(6, 0), outsider[1]), 0)
        return tc, com
    if kind.startswith("block"):
        b = _build(lib, "block")
        if kind == "block_bad_sig":
            b.signature = bad_sig(b.signature)
        if kind == "block_bad_tc":
            pk, sig, hq = b.tc.votes[3]
            b = c.Block(qc=b.qc, tc=b.tc, author=b.author, round=b.round, payloads=b.payloads)
            b.tc.votes[3] = (pk, bad_sig(sig), hq)
            b.signature = _sign(lib, b.digest(), keys[3][1])
        return b, com
    raise ValueError(kind)


def _wire_kind(kind):
    return "qc" if kind.startswith("qc") else kind.split("_")[0]


def _outcome(msg, com, verifier):
    try:
        msg.verify(com, verifier)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__
    return "ok"


@pytest.fixture(scope="module")
def device_verifier():
    """The port's verifier backend on its device path (plain versions)."""
    return BatchVerifier(min_device_batch=0, device="cpu")


CASES = {
    "vote": "ok",
    "vote_bad_sig": "InvalidSignature",
    "vote_unknown_author": "UnknownAuthority",
    "qc": "ok",
    "qc_bad_sig": "InvalidSignature",
    "qc_sub_quorum": "QCRequiresQuorum",
    "qc_unknown_author": "UnknownAuthority",
    "qc_duplicate_author": "AuthorityReuse",
    "qc_empty": "QCRequiresQuorum",
    "timeout": "ok",
    "timeout_bad_sig": "InvalidSignature",
    "timeout_sub_quorum_high_qc": "QCRequiresQuorum",
    "tc": "ok",
    "tc_bad_sig": "InvalidSignature",
    "tc_empty": "TCRequiresQuorum",
    "tc_duplicate_author": "AuthorityReuse",
    "tc_unknown_author": "UnknownAuthority",
    "block": "ok",
    "block_bad_sig": "InvalidSignature",
    "block_bad_tc": "InvalidSignature",
}
# the certificate cases whose signatures the device path checks (the
# others fail on stake or structure before any signature)
ON_DEVICE = ("qc", "qc_bad_sig", "tc", "tc_bad_sig")


@pytest.mark.parametrize("kind", sorted(CASES))
def test_verdicts_and_errors_match(kind, device_verifier):
    jmsg, jcom = _forge(JAX, kind)
    want = _outcome(jmsg, jcom, jcrypto.CpuVerifier())
    assert want == CASES[kind]
    pmsg = _port_from_jax(_wire_kind(kind), jmsg)
    pcom = _committee(PORT, _keys(PORT))
    assert _outcome(pmsg, pcom, pcrypto.CpuVerifier()) == want
    assert _outcome(_forge(PORT, kind)[0], pcom, pcrypto.CpuVerifier()) == want
    if kind in ON_DEVICE:
        assert _outcome(pmsg, pcom, device_verifier) == want


def test_qc_memo_skips_only_verified_certificates():
    keys = _keys(PORT)
    com = _committee(PORT, keys)
    qc, _ = _forge(PORT, "qc")
    cache: set = set()
    qc.verify(com, pcrypto.CpuVerifier(), cache=cache)
    assert qc._cache_key() in cache and qc.claims(cache=cache) == []
    bad, _ = _forge(PORT, "qc_bad_sig")
    with pytest.raises(pcons.InvalidSignature):
        bad.verify(com, pcrypto.CpuVerifier(), cache=cache)
    assert bad._cache_key() not in cache


# ---- aggregators -----------------------------------------------------------


def _vote_stream(lib):
    """Votes for one block with a spoofed signature racing an honest
    vote, a duplicate, an unknown author, a second (equivocating) digest
    cell and a spoof whose author never votes (evicted at quorum) — then
    enough honest votes for a quorum."""
    keys = _keys(lib)
    outsider = lib.k.generate_keypair(b"\x99" * 32, 0)
    block = lib.k.Digest.of(b"aggregated block")
    other = lib.k.Digest.of(b"equivocated block")

    def vote(i, digest=block, key=None):
        pk, sk = key or keys[i]
        v = lib.c.Vote(hash=digest, round=7, author=pk)
        v.signature = _sign(lib, v.digest(), sk)
        return v

    def spoof(i):
        v = vote(i)
        v.signature = _sign(lib, v.digest(), keys[i + 1][1])  # wrong key
        return v

    out = [vote(0), spoof(3), vote(1), vote(1), vote(0, key=outsider), vote(2, other)]
    out += [spoof(14)] + [vote(i) for i in range(2, QUORUM + 2)]
    return out


def _timeout_stream(lib):
    keys = _keys(lib)
    qc = _qc(lib, keys, lib.k.Digest.of(b"hq"), 4, range(QUORUM))
    out = []
    for i in list(range(QUORUM)) + [0]:
        t = lib.c.Timeout(high_qc=qc, round=8, author=keys[i][0])
        t.signature = _sign(lib, t.digest(), keys[i][1])
        out.append(t)
    return out


def _aggregate(lib, vote_verifier):
    keys = _keys(lib)
    agg = lib.c.Aggregator(_committee(lib, keys), vote_verifier, self_key=keys[0][0])
    events = []
    for v in _vote_stream(lib):
        try:
            qc = agg.add_vote(v, current_round=7)
        except Exception as e:  # noqa: BLE001 — the type is what is compared
            events.append(type(e).__name__)
            continue
        events.append(None if qc is None else _encode(lib, "qc", qc))
    for t in _timeout_stream(lib):
        try:
            tc = agg.add_timeout(t, current_round=8)
        except Exception as e:  # noqa: BLE001
            events.append(type(e).__name__)
            continue
        events.append(None if tc is None else _encode(lib, "tc", tc))
    return events, (agg.qc_rejects, agg.vote_conflicts, agg.qc_wire_bytes)


def test_aggregators_emit_the_same_certificates():
    want, jstats = _aggregate(JAX, jcrypto.CpuVerifier())
    got, pstats = _aggregate(PORT, pcrypto.CpuVerifier())
    assert got == want and pstats == jstats
    assert sum(isinstance(e, bytes) for e in want) == 2  # one QC, one TC
    assert "AuthorityReuse" in want and "UnknownAuthority" in want
    assert jstats[0] == 1  # the never-replaced spoof was evicted


def test_bls_committees_check_pops_and_aggregate_as_jax():
    """A BLS committee: without proofs of possession both packages refuse
    it (``InvalidCommittee``), with them both accept it, a forged proof is
    refused by both, and both packages' aggregators take it."""
    from hotstuff_tpu.consensus.config import InvalidCommittee as JInvalid
    from hotstuff_tpu.crypto.scheme import bls_keygen as j_keygen, bls_pop as j_pop
    from hotstuff_tpu_torch.consensus.config import InvalidCommittee as PInvalid
    from hotstuff_tpu_torch.crypto.scheme import bls_keygen, bls_pop

    pkeys = [bls_keygen(SEED, i) for i in range(4)]
    jkeys = [j_keygen(SEED, i) for i in range(4)]
    assert [pk.to_bytes() for pk, _ in pkeys] == [pk.to_bytes() for pk, _ in jkeys]
    pops = {pk: bls_pop(sk) for pk, sk in pkeys}
    assert [pops[pk] for pk, _ in pkeys] == [j_pop(sk) for _, sk in jkeys]
    for lib, keys, invalid in ((PORT, pkeys, PInvalid), (JAX, jkeys, JInvalid)):
        members = [(pk, 1, ("127.0.0.1", 1 + i)) for i, (pk, _) in enumerate(keys)]
        bare = lib.c.Committee.new(members, scheme="bls")
        with pytest.raises(invalid, match="no proof of possession"):
            bare.verify_pops()
        proven = lib.c.Committee.new(
            members, scheme="bls", pops={pk: bls_pop(sk) for pk, sk in keys}
        )
        proven.verify_pops()
        forged = lib.c.Committee.new(
            members, scheme="bls",
            pops={pk: bls_pop(keys[(i + 1) % 4][1]) for i, (pk, _) in enumerate(keys)},
        )
        with pytest.raises(invalid, match="invalid BLS proof of possession"):
            forged.verify_pops()
        agg = lib.c.Aggregator(proven, lib.k.CpuVerifier())
        assert agg.compact_qcs == agg.compact_tcs == 0


def test_scheme_registry_and_signing_service_match():
    from hotstuff_tpu.crypto.scheme import make_signing_service as j_make
    from hotstuff_tpu_torch.crypto import scheme

    digest = pcrypto.Digest.of(b"signed")
    (_, psk), (_, jsk) = _keys(PORT, 1)[0], _keys(JAX, 1)[0]
    signer = scheme.make_signing_service("ed25519", psk)
    sig = signer.sign_sync(digest)
    assert sig.to_bytes() == j_make("ed25519", jsk).sign_sync(jcrypto.Digest(digest.to_bytes())).to_bytes()
    assert isinstance(scheme.make_cpu_verifier("ed25519"), pcrypto.CpuVerifier)
    # the BLS scheme: the same keys, proofs and signatures as JAX's
    from hotstuff_tpu.crypto import scheme as jscheme

    bpk, bsecret = scheme.keygen_deterministic("bls", SEED, 2)
    jpk, jsecret = jscheme.keygen_deterministic("bls", SEED, 2)
    assert bpk.to_bytes() == jpk.to_bytes() and len(bpk.to_bytes()) == 96
    assert bsecret.to_bytes() == jsecret.to_bytes()
    assert scheme.bls_pop(bsecret.to_bytes()) == jscheme.bls_pop(jsecret.to_bytes())
    bsig = scheme.make_signing_service("bls", bsecret).sign_sync(digest)
    assert bsig.to_bytes() == jscheme.make_signing_service("bls", jsecret).sign_sync(
        jcrypto.Digest(digest.to_bytes())).to_bytes()
    verifier = scheme.make_cpu_verifier("bls")
    assert verifier.name == jscheme.make_cpu_verifier("bls").name == "bls-cpu"
    assert verifier.verify_one(digest, bpk, bsig)
    assert scheme.read_secret("bls", bsecret.encode_base64()).to_bytes() == bsecret.to_bytes()
    for make in (scheme.make_cpu_verifier, lambda s: scheme.make_signing_service(s, psk)):
        with pytest.raises(scheme.UnknownScheme):
            make("rsa")
    signer.shutdown()
    assert psk.wiped
    with pytest.raises(RuntimeError):
        signer.sign_sync(digest)
