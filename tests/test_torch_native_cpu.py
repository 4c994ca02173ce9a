"""The port's native CPU verify path against the JAX package's.

Both packages build their own ``libhs_ed25519`` from
``native/ed25519_batch.cpp`` (the JAX package with ``make -C native``,
the port into ``build/torch_native/``), so every case here runs the same
C++ through two loaders: ``batch_verify`` (shared and distinct digests),
``batch_verify_shared``, ``batch_verify_columns`` from each package's
own ingest arena, ``verify_one`` and the counts ``precompute`` returns,
on the RFC 8032 vectors, the adversarial cases of the JAX tests (and a
signature with a small-order R, where the cofactored batch equation and
the cofactorless checks part), and seeded random batches with 0, 1 or 3
forged entries.  Then ``CpuVerifier``, ``eval_claims_sync`` and
``eval_claims_arena`` verdict for verdict, the router's CPU estimate for
every wave size and its choice for a scripted device EWMA, the
``HOTSTUFF_ED25519_NATIVE=0`` switch, a library that cannot build, two
packages' libraries in one process, and the verifier bench's CPU half.
The batch equation is randomised: tests compare verdicts, never its
random coefficients.  Booleans, counts and bytes: the tolerance is zero.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from hotstuff_tpu.crypto import async_service as jsvc
from hotstuff_tpu.crypto import native_ed25519 as jne
from hotstuff_tpu.crypto import service as jservice
from hotstuff_tpu_torch import _native_build
from hotstuff_tpu_torch.bench import verifier as pbench
from hotstuff_tpu_torch.consensus import Vote
from hotstuff_tpu_torch.consensus import wire as pwire
from hotstuff_tpu_torch.crypto import Digest, PublicKey, Signature, generate_keypair
from hotstuff_tpu_torch.crypto import async_service as psvc
from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.crypto import native_ed25519 as pne
from hotstuff_tpu_torch.crypto import service as pservice

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

RFC_VECTORS = [
    (
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


@pytest.fixture(scope="module", autouse=True)
def _both_libraries():
    # the JAX loader builds the JAX package's own library (make -C native)
    assert jne.available() and pne.available()


def _signed(seed: int, i: int, msg: bytes):
    pk, sk = generate_keypair(bytes([seed]) * 32, i)
    return msg, pk.to_bytes(), Signature.new(Digest(msg), sk).to_bytes()


def _adversarial():
    """(name, msg, pk, sig): the cases of tests/test_tpu_ed25519.py and
    tests/test_crypto.py, chip_smoke.py's small-order R, and wrong
    lengths the loaders must refuse before the C call."""
    msg, pk, sig = _signed(0x21, 0, Digest.of(b"adversarial").to_bytes())
    s_int = int.from_bytes(sig[32:], "little")
    stranger = ref.public_from_seed(b"\xaa" * 32)
    return [
        ("valid", msg, pk, sig),
        ("bad R", msg, pk, bytes([sig[0] ^ 1]) + sig[1:]),
        ("flipped s", msg, pk, sig[:40] + bytes([sig[40] ^ 0x80]) + sig[41:]),
        ("wrong message", Digest.of(b"tampered").to_bytes(), pk, sig),
        ("wrong key", msg, stranger, sig),
        ("s + L", msg, pk, sig[:32] + (s_int + ref.L).to_bytes(32, "little")),
        ("undecodable key", msg, (ref.P + 1).to_bytes(32, "little"), sig),
        ("non-canonical R", msg, pk, (ref.P + 3).to_bytes(32, "little") + sig[32:]),
        ("swapped halves", msg, pk, sig[32:] + sig[:32]),
        ("small-order R", *chip_smoke.small_order_case(b"\x77" * 32, msg)),
        ("48-byte signature", msg, pk, sig[:48]),
        ("31-byte key", msg, pk[:31], sig),
    ]


ADVERSARIAL = _adversarial()


# ---- the libraries ---------------------------------------------------------


@pytest.mark.parametrize("name", ["ed25519", "store"])
def test_the_ports_library_is_its_own_build_named_by_its_sources(name):
    loaded = Path(_native_build.load(name)._name)
    assert loaded == ROOT / "build" / "torch_native" / f"libhs_{name}_{_native_build.source_hash(name)}.so"
    assert loaded == _native_build.library_path(name)
    assert _native_build.LIBRARIES[name].flags == (("-O3",) if name == "ed25519" else ())


# ---- the batch equation, case by case ----------------------------------------


@pytest.mark.parametrize("seed,pub,msg,sig", RFC_VECTORS)
def test_rfc8032_vectors_through_both_packages(seed, pub, msg, sig):
    pub, msg, sig = bytes.fromhex(pub), bytes.fromhex(msg), bytes.fromhex(sig)
    bad = bytes([sig[0] ^ 1]) + sig[1:]
    for lib in (pne, jne):
        assert lib.batch_verify(msg, len(msg), pub, sig, 1, shared=True)
        assert not lib.batch_verify(msg, len(msg), pub, bad, 1, shared=True)
        assert lib.verify_one(msg, pub, sig) and not lib.verify_one(msg, pub, bad)
        assert lib.batch_verify_shared(msg, [(pub, sig), (pub, sig)])


@pytest.mark.parametrize("case", ADVERSARIAL, ids=[c[0] for c in ADVERSARIAL])
def test_adversarial_cases_give_the_cofactored_verdict_in_both_packages(case):
    name, msg, pk, sig = case
    want = chip_smoke.cofactored_verify(sig, pk, msg)
    assert want == (name in ("valid", "small-order R"))
    assert ref.verify(sig, pk, msg) == (name == "valid")
    _, vmsg, vpk, vsig = ADVERSARIAL[0]
    _, spk, ssig = _signed(0x22, 0, msg)  # a valid signature over this digest
    for lib in (pne, jne):
        assert lib.verify_one(msg, pk, sig) == want
        # beside a valid entry, distinct digests and one shared digest
        assert lib.batch_verify(msg + vmsg, 32, pk + vpk, sig + vsig, 2, shared=False) == want
        assert lib.batch_verify_shared(msg, [(spk, ssig), (pk, sig)]) == want


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "distinct"])
@pytest.mark.parametrize("forged", [0, 1, 3])
def test_random_batches_with_forged_entries(shared, forged):
    rng = np.random.default_rng(100 + 10 * forged + shared)
    n = 48
    bad = set(rng.choice(n, size=forged, replace=False).tolist())
    msgs, pks, sigs = [], [], []
    common = Digest.of(rng.bytes(16)).to_bytes()
    for i in range(n):
        m = common if shared else Digest.of(rng.bytes(16)).to_bytes()
        _, pk, sig = _signed(0x31, int(rng.integers(0, 256)), m)
        if i in bad:
            pos = int(rng.integers(0, 64))
            sig = sig[:pos] + bytes([sig[pos] ^ int(rng.integers(1, 256))]) + sig[pos + 1:]
        msgs.append(m)
        pks.append(pk)
        sigs.append(sig)
    flat = (common if shared else b"".join(msgs), 32, b"".join(pks), b"".join(sigs), n)
    per_item = [ref.verify(s, p, m) for m, p, s in zip(msgs, pks, sigs)]
    assert per_item.count(False) == forged
    for lib, service in ((pne, pservice), (jne, jservice)):
        assert lib.batch_verify(*flat, shared=shared) == (forged == 0)
        cpu = service.CpuVerifier()
        assert cpu.verify_many(msgs, pks, sigs, aggregate_ok=True) == per_item
        assert cpu.verify_many(msgs, pks, sigs) == per_item
        if shared:
            assert lib.batch_verify_shared(common, list(zip(pks, sigs))) == (forged == 0)
            votes = [(PublicKey(p), Signature(s)) for p, s in zip(pks, sigs)]
            assert cpu.verify_shared_msg(Digest(common), votes) == (forged == 0)


def test_precompute_counts_equal():
    good = [generate_keypair(b"\x41" * 32, i)[0].to_bytes() for i in range(20)]
    off_curve = [(ref.P + 1).to_bytes(32, "little"), (2).to_bytes(32, "little")]
    off_curve = [k for k in off_curve if ref.point_decompress(k) is None]
    assert off_curve
    # an off-curve key counts once it is in the table (the library's own
    # rule): the lists run in an order that shows it, in both packages
    lists = [good, good + off_curve, good[:3] + [b"\x01" * 31] + off_curve, [], [b"short"]]
    counts = [(pne.precompute(keys), jne.precompute(keys)) for keys in lists]
    assert [p for p, _ in counts] == [j for _, j in counts]
    assert counts[0][0] == len(good) and counts[-2:] == [(0, 0), (0, 0)]
    pservice.CpuVerifier().precompute(good)  # the backend reaches the same tables
    assert pne.precompute(good) == len(good)


# ---- the arena route -----------------------------------------------------------


def _signed_votes(n: int, forged=()):
    """Real signed votes from seeded keys (row i in ``forged`` gets a
    flipped signature byte).  Returns (frames, claims)."""
    frames, claims = [], []
    for i in range(n):
        pk, sk = generate_keypair(b"\x3d" * 32, i)
        vote = Vote(hash=Digest.of(b"native cpu block %d" % i), round=3 + i, author=pk)
        sig = Signature.new(vote.digest(), sk).to_bytes()
        if i in forged:
            sig = sig[:20] + bytes([sig[20] ^ 0x08]) + sig[21:]
        vote.signature = Signature(sig)
        frames.append(pwire.encode_vote(vote))
        claims.append(vote.claim())
    return frames, claims


def _adopted(svc, frames, claims):
    ing = svc.ZeroCopyIngest(capacity=64, ring_depth=2)
    for frame in frames:
        assert ing.note_vote_frame(frame)
    wave = ing.try_adopt(claims, svc.DEFAULT_WAVE_BUCKETS)
    assert wave is not None and wave.n == len(claims)
    return ing, wave


@pytest.mark.parametrize("forged", [(), (3,), (0, 7, 11)], ids=["valid", "one", "three"])
def test_batch_verify_columns_from_each_packages_arena(forged):
    frames, claims = _signed_votes(16, forged)
    got = {}
    for svc, lib in ((psvc, pne), (jsvc, jne)):
        ing, wave = _adopted(svc, frames, claims)
        try:
            got[svc] = lib.batch_verify_columns(wave.dig_addr, wave.pk_addr, wave.sig_addr, wave.n)
        finally:
            wave.release()
            ing.packer.close()
    assert got[psvc] == got[jsvc] == (not forged)


class _Counting:
    """A CPU backend of either package that counts its per-item calls."""

    def __init__(self, service):
        self.cpu = service.CpuVerifier()
        self.many = 0
        self.supports_flat_batch = True

    def verify_many(self, *args, **kwargs):
        self.many += 1
        return self.cpu.verify_many(*args, **kwargs)


@pytest.mark.parametrize("forged", [(), (2, 5)], ids=["valid", "forged"])
def test_eval_claims_arena_on_a_cpu_verifier_matches_jax(forged):
    frames, claims = _signed_votes(16, forged)
    oracle = [ref.verify(c[3], c[2], c[1]) for c in claims]
    verdicts, calls = {}, {}
    for svc, service in ((psvc, pservice), (jsvc, jservice)):
        backend = _Counting(service)
        ing, wave = _adopted(svc, frames, claims)
        try:
            verdicts[svc] = svc.eval_claims_arena(backend, wave, claims)
            assert wave._released
        finally:
            ing.packer.close()
        calls[svc] = backend.many
    assert verdicts[psvc] == verdicts[jsvc] == oracle
    # all valid: one batch equation from the columns, no per-item loop
    assert calls[psvc] == calls[jsvc] == (1 if forged else 0)


def _claims(rng, forged: int):
    """A mixed wave: single claims, QC-shaped shared claims, an empty
    shared claim; ``forged`` signatures corrupted at seeded positions."""
    out = []
    for i in range(6):
        m, pk, sig = _signed(0x51, i, Digest.of(rng.bytes(8)).to_bytes())
        out.append(("one", m, pk, sig))
    for j in range(2):
        m = Digest.of(rng.bytes(8)).to_bytes()
        out.append(("shared", m, tuple(_signed(0x52, 10 * j + k, m)[1:] for k in range(5))))
    out.append(("shared", Digest.of(b"empty").to_bytes(), ()))
    slots = [(c, None) for c in range(6)] + [(c, k) for c in (6, 7) for k in range(5)]
    for pick in rng.choice(len(slots), size=forged, replace=False):
        c, k = slots[pick]
        if k is None:
            kind, m, pk, sig = out[c]
            out[c] = (kind, m, pk, bytes([sig[0] ^ 4]) + sig[1:])
        else:
            kind, m, votes = out[c]
            votes = list(votes)
            votes[k] = (votes[k][0], votes[k][1][:63] + bytes([votes[k][1][63] ^ 1]))
            out[c] = (kind, m, tuple(votes))
    return out


@pytest.mark.parametrize("forged", [0, 1, 3])
def test_eval_claims_sync_on_a_cpu_verifier_matches_jax(forged):
    claims = _claims(np.random.default_rng(7 + forged), forged)
    want = [chip_smoke.oracle(c) for c in claims]
    got = [svc.eval_claims_sync(service.CpuVerifier(), claims)
           for svc, service in ((psvc, pservice), (jsvc, jservice))]
    assert got[0] == got[1] == want
    # the empty shared claim always fails; a forged signature fails its claim
    assert (want.count(False) > 1) == (forged > 0)


# ---- routing ---------------------------------------------------------------------


class _ReadyDevice:
    """A device backend as the router sees it: warm, no packed path."""

    device_ready = True
    async_kind = "routing-test"

    def verify_many(self, digests, pks, sigs, aggregate_ok=False):
        raise AssertionError("the router test dispatches nothing")


def _services():
    return psvc.AsyncVerifyService(_ReadyDevice(), device=True), jsvc.AsyncVerifyService(
        _ReadyDevice(), device=True
    )


@pytest.mark.parametrize("native", [True, False], ids=["native", "switched-off"])
def test_cpu_estimate_equal_for_every_wave_size(native, monkeypatch):
    if not native:
        monkeypatch.setenv("HOTSTUFF_ED25519_NATIVE", "0")
        monkeypatch.setattr(jne, "_lib", None)  # the JAX loader caches its answer
    mine, theirs = _services()
    try:
        for n in range(1, 4097):
            assert mine._cpu_estimate_s(n) == theirs._cpu_estimate_s(n), n
        assert mine._cpu_estimate_s(36) == (
            psvc.cpu_batch_estimate_s(36) if native else 36 * psvc.CPU_US_PER_SIG * 1e-6
        )
    finally:
        mine.close()
        theirs.close()
    assert "cpu_batch_estimate_s" in psvc.__all__


@pytest.mark.parametrize("ewma_ms", [0.5, 2.3, 6.6, 11.1, 40.0])
def test_the_router_chooses_as_jax_for_a_scripted_ewma(ewma_ms):
    """Every wave size, with the pipeline empty, one wave in flight and
    full, a probe due or not: the same route in both packages."""
    mine, theirs = _services()
    chosen = set()
    try:
        assert mine.pipeline_depth == theirs.pipeline_depth == 2
        for svc in (mine, theirs):
            svc._device_ewma_s = ewma_ms / 1e3
        for n in (1, 2, 16, 36, 53, 64, 130, 230, 256, 1024, 4096):
            for occupancy in (0, 1, 2):
                for probe_due in (False, True):
                    for svc in (mine, theirs):
                        svc._last_probe = 0.0 if probe_due else float("inf")
                        svc._inflight = {k: float("inf") for k in range(occupancy)}
                    route = mine._route_device(n)
                    assert route == theirs._route_device(n), (ewma_ms, n, occupancy, probe_due)
                    chosen.add(route)
        for svc in (mine, theirs):
            svc._inflight = {}
        assert chosen <= {"device", "cpu", "probe", "wait"}
    finally:
        mine.close()
        theirs.close()


# ---- the switch and a failed build ---------------------------------------------


def test_the_per_signature_route_needs_the_switch(monkeypatch):
    """The small-order R passes the batch equation (cofactored) and
    fails the per-signature loop (cofactorless): only
    ``HOTSTUFF_ED25519_NATIVE=0`` takes a QC to the loop."""
    msg, pk, sig = chip_smoke.small_order_case(b"\x78" * 32, Digest.of(b"qc").to_bytes())
    votes = [(PublicKey(pk), Signature(sig))]
    for i in range(3):
        _, vpk, vsig = _signed(0x61, i, msg)
        votes.append((PublicKey(vpk), Signature(vsig)))
    assert pservice.CpuVerifier().verify_shared_msg(Digest(msg), votes)
    monkeypatch.setenv("HOTSTUFF_ED25519_NATIVE", "0")
    assert not pne.available() and pne.precompute([pk]) == 0
    assert not pservice.CpuVerifier().verify_shared_msg(Digest(msg), votes)
    monkeypatch.setattr(jne, "_lib", None)
    assert not jservice.CpuVerifier().verify_shared_msg(Digest(msg), votes)


@pytest.fixture
def isolated_build(tmp_path, monkeypatch):
    """A build directory of this test's own, with nothing loaded."""
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(_native_build, "_LIBS", {})
    monkeypatch.delenv("HOTSTUFF_ED25519_NATIVE", raising=False)
    return tmp_path


@pytest.mark.parametrize("fault", ["no compiler", "broken source"])
def test_an_ed25519_library_that_cannot_build_raises(isolated_build, monkeypatch, fault):
    if fault == "no compiler":
        monkeypatch.setenv("CXX", str(isolated_build / "no-such-compiler"))
        match = "cannot build libhs_ed25519"
    else:
        copy = isolated_build / "native"
        copy.mkdir()
        source = (ROOT / "native" / "ed25519_batch.cpp").read_text()
        (copy / "ed25519_batch.cpp").write_text(source + "\nthis is not C++;\n")
        monkeypatch.setattr(_native_build, "NATIVE_DIR", copy)
        match = "failed \\(1\\) building libhs_ed25519:(.|\\n)*error"
    with pytest.raises(RuntimeError, match=match):
        pne.available()
    d = Digest.of(b"qc")
    votes = [(PublicKey(pk), Signature(sig)) for _, pk, sig in (_signed(0x62, i, d.to_bytes()) for i in range(2))]
    with pytest.raises(RuntimeError, match=match):
        pservice.CpuVerifier().verify_shared_msg(d, votes)
    assert not list((isolated_build / "torch_native").glob("*.so"))
    monkeypatch.setenv("HOTSTUFF_ED25519_NATIVE", "0")  # the switch needs no library
    assert pservice.CpuVerifier().verify_shared_msg(d, votes)


# ---- two packages, one process -------------------------------------------------

_TWO_PACKAGES = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {root!r})
    from hotstuff_tpu.crypto import native_ed25519 as jne
    from hotstuff_tpu.store import native as jstore
    from hotstuff_tpu_torch.crypto import native_ed25519 as pne
    from hotstuff_tpu_torch.store.native import NativeEngine
    from hotstuff_tpu_torch import _native_build

    assert jne.available() and pne.available()
    jstore._get_lib()
    NativeEngine({db!r}).close()
    maps = open("/proc/self/maps").read()
    paths = sorted({{line.split()[-1] for line in maps.splitlines()
                    if "libhs_ed25519" in line or "libhs_store" in line}})
    # fill the port's key table to its cap (4096 entries, any 32 bytes),
    # then cache one more key in the JAX table only
    filler = [i.to_bytes(4, "little") * 8 for i in range(4096)]
    pne.precompute(filler)
    key = bytes.fromhex("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
    print(json.dumps({{
        "paths": paths,
        "port_lib": str(_native_build.library_path("ed25519")),
        "jax_counts": jne.precompute([key]),
        "port_counts": pne.precompute([key]),
        "port_filler_again": pne.precompute(filler[:8]) > 0,
    }}))
    """
)


def test_both_packages_libraries_in_one_process(tmp_path):
    """The JAX package's and the port's ``libhs_ed25519`` and
    ``libhs_store`` load side by side from different paths, and their
    ``hs_ed25519_precompute`` key tables are separate: with the port's
    table full, a key the JAX table caches is not counted by the port's."""
    proc = subprocess.run(
        [sys.executable, "-c", _TWO_PACKAGES.format(root=str(ROOT), db=str(tmp_path / "db"))],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out["paths"]) == sorted([
        str(ROOT / "native" / "build" / "libhs_ed25519.so"),
        str(ROOT / "native" / "build" / "libhs_store.so"),
        out["port_lib"],
        str(_native_build.library_path("store")),
    ])
    assert out["jax_counts"] == 1 and out["port_counts"] == 0
    assert out["port_filler_again"]


# ---- the verifier bench's CPU half ---------------------------------------------


def test_the_bench_batches_are_bench_pys():
    import bench

    assert pbench.make_qc_batch(6) == tuple(map(list, bench.make_qc_batch(6)))
    assert pbench.make_tc_batch(6) == tuple(map(list, bench.make_tc_batch(6)))


@pytest.mark.parametrize("native", [True, False], ids=["native", "switched-off"])
def test_the_bench_cpu_baseline_names_its_backend(native, monkeypatch):
    if not native:
        monkeypatch.setenv("HOTSTUFF_ED25519_NATIVE", "0")
    msgs, pks, sigs = pbench.make_qc_batch(8)
    rate, prov = pbench.bench_cpu(msgs, pks, sigs, pbench.make_tc_batch(8))
    assert prov["batch"] == 8 and prov["loop_sigs_per_s"] > 0
    if native:
        assert prov["backend"].startswith("native-batch")
        assert prov["batch_sigs_per_s"] > 0 and prov["batch_distinct_sigs_per_s"] > 0
        assert rate == max(prov["batch_sigs_per_s"], prov["loop_sigs_per_s"]) or rate > 0
    else:
        assert "HOTSTUFF_ED25519_NATIVE=0" in prov["backend"] and "batch_sigs_per_s" not in prov


def test_the_bench_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pbench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err
