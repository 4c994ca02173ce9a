"""The port's BatchVerifier (hotstuff_tpu_torch/gpu/ed25519.py) on the CPU
against the JAX BatchVerifier and the oracle, the port's staging against
the JAX staging bit for bit, and the package's rules: no JAX, no import
of hotstuff_tpu, no quiet CPU fallback.  Verdicts are booleans and
staged arrays integers, so every comparison is exact."""

import ast
import hashlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hotstuff_tpu.tpu.ed25519 import BatchVerifier as JaxBatchVerifier
from hotstuff_tpu_torch.crypto import (
    CpuVerifier,
    Digest,
    PublicKey,
    Signature,
    ed25519_ref as ref,
    generate_keypair,
)
from hotstuff_tpu_torch.gpu import dsm
from hotstuff_tpu_torch.gpu.ed25519 import BatchVerifier
from hotstuff_tpu_torch.telemetry import spans

# The operands are small: intra-op threads would only contend with the
# other test workers.
torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / "hotstuff_tpu_torch"


@pytest.fixture(scope="module")
def port():
    return BatchVerifier(min_device_batch=0, device="cpu")


@pytest.fixture(scope="module")
def jaxv():
    return JaxBatchVerifier(min_device_batch=0, use_pallas=False)


def _sign_many(n, msg_fn, seed0=0):
    items = []
    for i in range(n):
        seed = bytes([seed0 + i]) * 32
        msg = msg_fn(i)
        items.append((msg, ref.public_from_seed(seed), ref.sign(seed, msg)))
    return [list(x) for x in zip(*items)]


def _adversarial():
    """The adversarial set of tests/test_tpu_ed25519.py plus s = L and a
    non-canonical R (y >= p)."""
    msgs, pks, sigs = _sign_many(10, lambda i: b"payload-%d" % i)
    sigs[1] = bytes([sigs[1][0] ^ 1]) + sigs[1][1:]  # bad R
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 0x80]) + sigs[2][41:]  # flipped s
    msgs[3] = b"tampered"  # wrong message
    pks[4] = ref.public_from_seed(b"\xaa" * 32)  # wrong key
    s_int = int.from_bytes(sigs[5][32:], "little") + ref.L  # s + L
    sigs[5] = sigs[5][:32] + s_int.to_bytes(32, "little")
    pks[6] = (ref.P + 1).to_bytes(32, "little")  # undecodable key
    sigs[7] = (ref.P + 3).to_bytes(32, "little") + sigs[7][32:]  # R with y >= p
    sigs[8] = sigs[8][:32] + ref.L.to_bytes(32, "little")  # s = L
    return msgs, pks, sigs


def _oracle(msgs, pks, sigs):
    return [ref.verify(s, p, m) for m, p, s in zip(msgs, pks, sigs)]


# RFC 8032 section 7.1, tests 1-3: (secret key, public key, message, signature)
RFC8032 = [
    (
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


def test_rfc8032_vectors(port, jaxv):
    msgs, pks, sigs = [], [], []
    for sk, pk, msg, sig in RFC8032:
        seed, pk, msg, sig = map(bytes.fromhex, (sk, pk, msg, sig))
        assert ref.public_from_seed(seed) == pk
        assert ref.sign(seed, msg) == sig
        msgs.append(msg)
        pks.append(pk)
        sigs.append(sig)
    got = port.verify(msgs, pks, sigs).tolist()
    assert got == jaxv.verify(msgs, pks, sigs).tolist() == [True] * 3


def test_adversarial_set_matches_jax_and_oracle(port, jaxv):
    msgs, pks, sigs = _adversarial()
    got = port.verify(msgs, pks, sigs).tolist()
    assert got == jaxv.verify(msgs, pks, sigs).tolist() == _oracle(msgs, pks, sigs)
    assert got == [True] + [False] * 8 + [True]


def test_qc_shape_and_backend_methods(port, jaxv):
    """The QC shape (many signers, one digest) through the verifier
    backend methods a node calls."""
    digest = Digest.of(b"block")
    keys = [generate_keypair(b"\x33" * 32, i) for i in range(7)]
    votes = [(pk, Signature.new(digest, sk)) for pk, sk in keys]
    assert port.verify_shared_msg(digest, votes)
    assert jaxv.verify_shared_msg(digest, votes)
    bad = votes[3][1].to_bytes()
    votes[3] = (votes[3][0], Signature(bad[:10] + bytes([bad[10] ^ 1]) + bad[11:]))
    assert not port.verify_shared_msg(digest, votes)
    assert not CpuVerifier().verify_shared_msg(digest, votes)
    assert port.verify_one(digest, *votes[0]) and not port.verify_one(digest, *votes[3])
    tc = [Digest.of(b"timeout %d" % i) for i in range(5)]
    args = (
        [d.to_bytes() for d in tc],
        [pk.to_bytes() for pk, _ in keys[:5]],
        [Signature.new(d, sk).to_bytes() for d, (_, sk) in zip(tc, keys)],
    )
    assert port.verify_many(*args) == jaxv.verify_many(*args) == CpuVerifier().verify_many(*args)
    assert port.verify_many(*args) == [True] * 5
    assert (port.name, port.supports_wave_padding, port.device_key_cache) == ("cuda", True, True)


def test_verify_packed_matches_verify_device(port):
    digests = [hashlib.sha512(b"packed %d" % i).digest()[:32] for i in range(12)]
    msgs, pks, sigs = _sign_many(12, lambda i: digests[i], seed0=40)
    sigs[5] = bytes([sigs[5][0] ^ 1]) + sigs[5][1:]
    pks[9] = (ref.P + 1).to_bytes(32, "little")
    want = _oracle(msgs, pks, sigs)
    cols = [bytearray(b"".join(x)) for x in (msgs, pks, sigs)]
    assert port.verify_packed(*cols, 12).tolist() == want
    assert port.verify_device(msgs, pks, sigs).tolist() == want
    assert port.verify_packed(b"", b"", b"", 0).tolist() == []


def test_oversize_batches_chunk_at_the_largest_pad():
    v = BatchVerifier(min_device_batch=0, device="cpu")
    v.pad_sizes = (128,)
    msgs, pks, sigs = _sign_many(130, lambda i: b"chunk-%d" % i)
    sigs[129] = bytes([sigs[129][0] ^ 1]) + sigs[129][1:]
    assert v.verify_device(msgs, pks, sigs).tolist() == [True] * 129 + [False]


def test_prepare_is_bit_identical_after_load_jax_tables():
    """Both verifiers stage the same claims from the same committee rows:
    every kernel operand and the host validity agree bit for bit."""
    msgs, pks, sigs = _adversarial()
    jv = JaxBatchVerifier(min_device_batch=0, use_pallas=True)  # pads to 128 as the port
    jv.precompute(pks)
    j_valid, j_arrays = jv.prepare(msgs, pks, sigs)
    tables, row_index = jv._tables
    v = BatchVerifier(min_device_batch=0, device="cpu")
    v.load_jax_tables(tables, row_index)
    p_valid, p_arrays = v.prepare(msgs, pks, sigs)
    assert v._tables[1] == row_index
    assert all((a == b).all() for a, b in zip(v._tables[0], tables))
    assert p_valid.tolist() == j_valid.tolist()
    assert len(p_arrays) == len(j_arrays) == 8
    for p, j in zip(p_arrays, j_arrays):
        assert p.numpy().tolist() == np.asarray(j).tolist()


def test_load_jax_tables_rejects_malformed_builds():
    v = BatchVerifier(min_device_batch=0, device="cpu")
    good = tuple(np.zeros((2, 20), np.int32) for _ in range(4))
    with pytest.raises(ValueError):
        v.load_jax_tables(good[:3], {})
    with pytest.raises(ValueError):
        v.load_jax_tables(good, {b"k" * 32: 2})


def test_challenge_memo_and_hybrid_routing():
    v = BatchVerifier(min_device_batch=0, device="cpu")
    msgs, pks, sigs = _sign_many(4, lambda i: b"memo-%d" % i)
    assert v.verify(msgs, pks, sigs).all()
    assert len(v._challenge_memo) == 4
    assert v.verify(msgs, pks, sigs).all()  # served from the memo
    assert len(v._challenge_memo) == 4
    host = BatchVerifier(min_device_batch=64, device="cpu")
    sigs[2] = bytes([sigs[2][0] ^ 1]) + sigs[2][1:]
    assert host.verify(msgs, pks, sigs).tolist() == [True, True, False, True]
    assert host._tables is None  # the host route staged nothing


def test_profiling_spans_name_the_stages():
    v = BatchVerifier(min_device_batch=0, device="cpu")
    msgs, pks, sigs = _sign_many(2, lambda i: b"span-%d" % i)
    rec = spans.enable()
    try:
        assert v.verify(msgs, pks, sigs).all()
        names = [s[0] for s in rec.drain()]
    finally:
        spans.disable()
    assert names == ["prepare", "dispatch", "device.execute", "readback"]


def test_warmup_runs_every_reachable_pad_size():
    v = BatchVerifier(min_device_batch=0, device="cpu")
    v.warmup(100)
    assert set(v._scratch.pool) == {128}


def test_default_device_is_cuda_and_never_quietly_the_cpu():
    if torch.cuda.is_available():
        assert BatchVerifier().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchVerifier(device="cuda")
    assert BatchVerifier(device="cpu").device.type == "cpu"


def test_cpu_runs_launch_no_kernel(port):
    dsm.reset_launches()
    msgs, pks, sigs = _sign_many(2, lambda i: b"count-%d" % i)
    assert port.verify(msgs, pks, sigs).all()
    assert dsm.launches == {"verify_compressed": 0, "dual_scalar_mult": 0}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


#: JAX, the JAX package, and the reference harness (``benchmark/``, which
#: imports the JAX package): the port keeps its own copies of all three
FORBIDDEN_ROOTS = ("jax", "jaxlib", "hotstuff_tpu", "benchmark")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 15
    for path in sources:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN_ROOTS, f"{path}: imports {mod}"
    modules = [
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in sources
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN_ROOTS!r})\n"
        "print(len([m for m in sys.modules if m.startswith('hotstuff_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= len(modules)


def _relative_imports(path):
    """(level, module, names) of every relative import in ``path``,
    including those inside functions."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            yield node.level, node.module, [a.name for a in node.names]


def test_every_relative_import_resolves_to_a_port_module():
    """A lazy import left pointing at a module the port does not have
    (native_ed25519, bls, the telemetry registry) fails only when its
    branch runs; here every relative import of the package, at any
    depth, must name a module of the port and names it defines."""
    import importlib

    seen = 0
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        package = parts[:-1]  # the package a module's relative imports start from
        for level, module, names in _relative_imports(path):
            base = package[: len(package) - (level - 1)]
            target = base + (tuple(module.split(".")) if module else ())
            where = PKG.parent.joinpath(*target)
            is_pkg = (where / "__init__.py").exists()
            assert is_pkg or where.with_suffix(".py").exists(), f"{path}: no module {'.'.join(target)}"
            mod = importlib.import_module(".".join(target))
            for name in names:
                sub = where / f"{name}.py"
                assert (is_pkg and (sub.exists() or (where / name).is_dir())) or hasattr(mod, name), (
                    f"{path}: {'.'.join(target)} has no {name}"
                )
            seen += 1
    assert seen >= 60


def test_keys_and_digest_copies_match_the_reference():
    from hotstuff_tpu.crypto import Digest as JDigest, generate_keypair as jgen

    pk, sk = generate_keypair(b"\x07" * 32, 3)
    jpk, jsk = jgen(b"\x07" * 32, 3)
    assert pk.to_bytes() == jpk.to_bytes() and sk.to_bytes() == jsk.to_bytes()
    assert Digest.of(b"x").to_bytes() == JDigest.of(b"x").to_bytes()
    assert PublicKey.decode_base64(pk.encode_base64()) == pk
