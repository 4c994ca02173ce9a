"""A BLS12-381 committee on the port: a 4-node committee of
``Consensus.spawn`` stacks (through ``bench.committee.run_committee``)
commits agreeing chains with compact certificates; the compact QC and the
compact TC the port's ``QCMaker`` / ``TCMaker`` build from a vote set are
the JAX package's bytes for the same votes (host sum, and the device-sum
branch of ``_SigAccumulator`` on the G1 kernels' plain versions);
``HOTSTUFF_AGG_DEVICE_SUM=1`` without a card raises; a rogue-key
committee without valid proofs of possession is refused at spawn; key
files cross between the packages; and a mixed-scheme schedule boots a
``Node`` on the dual verifier.

Tolerance: none — wire bytes, chains and verdicts are compared exactly.
Every listener port comes from the OS (``reserve_ports``), every wait has
a deadline, every teardown runs in ``finally``."""

import asyncio

import pytest
import torch

import hotstuff_tpu.consensus as jcons
import hotstuff_tpu.crypto as jcrypto
import hotstuff_tpu_torch.consensus as pcons
import hotstuff_tpu_torch.crypto as pcrypto
from hotstuff_tpu.consensus import wire as jwire
from hotstuff_tpu.crypto import scheme as jscheme
from hotstuff_tpu.utils import codec as jcodec
from hotstuff_tpu_torch.bench.committee import reserve_ports, run_committee
from hotstuff_tpu_torch.consensus import aggregator as paggregator, wire as pwire
from hotstuff_tpu_torch.crypto import scheme as pscheme
from hotstuff_tpu_torch.utils import codec as pcodec

torch.set_num_threads(1)

SEED = b"\x61" * 32
N = 4
QUORUM = 2 * N // 3 + 1


def _os_ports(n):
    socks = reserve_ports(n)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _bls_committee(cons, scheme, ports=None, epoch=1, seed=SEED):
    keys = [scheme.bls_keygen(seed, i) for i in range(N)]
    ports = ports or [40_000 + i for i in range(N)]
    com = cons.Committee.new(
        [(pk, 1, ("127.0.0.1", p)) for (pk, _), p in zip(keys, ports)],
        epoch=epoch,
        scheme="bls",
        pops={pk: scheme.bls_pop(secret) for pk, secret in keys},
    )
    return com, keys


@pytest.mark.parametrize("verifier,device", [("cpu", None), ("cuda", "cpu")])
def test_a_bls_committee_commits_agreeing_chains(verifier, device, monkeypatch):
    """Four co-located stacks of a BLS committee under the producer
    load: every node commits, the chains agree, and the wave service
    verified compact certificates (``agg`` claims, one pairing each).
    ``cuda`` with ``device="cpu"``: the BLS device verifier on the G1
    kernels' plain versions."""
    monkeypatch.setenv("HOTSTUFF_AGG_DEVICE_SUM", "0")
    r = run_committee(nodes=N, rate=100, duration=4, verifier=verifier, device=device,
                      scheme="bls", timeout_delay=1_000, sync_retry_delay=1_000)
    assert min(r["blocks"]) >= 3
    assert r["chains_agree"] and r["roots_agree"]
    assert r["committed_payloads"] > 0
    stats = r["service"]["stats_line"]
    assert "bls-" in stats and int(stats.split(" agg=")[1].split()[0]) > 0


def _votes(lib, scheme, keys, block_digest, rnd):
    out = []
    for pk, secret in keys[:QUORUM]:
        v = lib.Vote(hash=block_digest, round=rnd, author=pk)
        signer = scheme.make_signing_service("bls", scheme.OpaqueSecret(secret))
        v.signature = signer.sign_sync(v.digest())
        out.append(v)
    return out


def _certificates(side):
    """Feed one package's Aggregator a BLS vote set and a timeout set with
    two distinct high-QC rounds; return the encoded compact QC and TC."""
    cons, crypto, wire, scheme, codec = side
    com, keys = _bls_committee(cons, scheme)
    agg = cons.Aggregator(com, scheme.make_cpu_verifier("bls"), self_key=keys[0][0])
    block = crypto.Digest.of(b"compact block")
    qc = None
    for v in _votes(cons, scheme, keys, block, 7):
        qc = agg.add_vote(v, current_round=7, sig_verified=True) or qc
    assert qc is not None and qc.is_compact and qc.votes == []
    qc.verify(com, scheme.make_cpu_verifier("bls"))
    hq = cons.QC(hash=block, round=7, votes=[])
    tc = None
    for i, (pk, secret) in enumerate(keys[:QUORUM]):
        t = cons.Timeout(high_qc=hq, round=9, author=pk)
        # two distinct high-QC rounds: two signer groups in the compact TC
        hq_round = 6 if i % 2 else 7
        t.high_qc = cons.QC(hash=block, round=hq_round, votes=[])
        signer = scheme.make_signing_service("bls", scheme.OpaqueSecret(secret))
        t.signature = signer.sign_sync(t.digest())
        tc = agg.add_timeout(t, current_round=9) or tc
    assert tc is not None and tc.votes == [] and len(tc.groups) == 2
    enc = codec.Encoder()
    qc.encode(enc)
    return enc.finish(), wire.encode_tc(tc), (agg.compact_qcs, agg.compact_tcs)


PORT = (pcons, pcrypto, pwire, pscheme, pcodec)
JAX = (jcons, jcrypto, jwire, jscheme, jcodec)


def test_compact_qc_and_tc_bytes_equal_jax(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_AGG_DEVICE_SUM", "0")
    want = _certificates(JAX)
    got = _certificates(PORT)
    assert got == want
    assert got[2] == (1, 1)


def test_the_device_sum_branch_gives_the_same_bytes(monkeypatch):
    """``_SigAccumulator`` on its device branch (one ``running_add_`` a
    vote; here the kernel's plain version, as a CUDA tensor would launch
    the kernel) emits the compact QC the host sum and the JAX package do."""
    from hotstuff_tpu_torch.gpu import bls as gbls

    class CpuRunningSum(gbls.G1RunningSum):
        def __init__(self, device="cuda"):
            super().__init__(device="cpu")

    monkeypatch.setenv("HOTSTUFF_AGG_DEVICE_SUM", "0")
    want = _certificates(JAX)
    monkeypatch.setenv("HOTSTUFF_AGG_DEVICE_SUM", "1")
    monkeypatch.setattr(gbls, "G1RunningSum", CpuRunningSum)
    acc = paggregator._SigAccumulator()
    assert isinstance(acc._device, CpuRunningSum) and acc._host is None
    assert _certificates(PORT) == want


def test_device_sum_forced_without_a_card_raises(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_AGG_DEVICE_SUM", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paggregator._SigAccumulator()
    monkeypatch.setenv("HOTSTUFF_AGG_DEVICE_SUM", "0")
    assert paggregator._SigAccumulator()._device is None


def test_device_sum_forced_raises_before_torch_is_loaded():
    """``HOTSTUFF_AGG_DEVICE_SUM=1`` means the card whatever was imported
    first: in a fresh process that has not loaded torch yet, the first
    accumulator still chooses the device sum and raises without a card."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from hotstuff_tpu_torch.consensus import aggregator\n"
        "print('torch loaded:', 'torch' in sys.modules)\n"
        "try:\n"
        "    aggregator._SigAccumulator()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
    )
    env = {**os.environ, "HOTSTUFF_AGG_DEVICE_SUM": "1", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert "raised: no CUDA device" in out, out


def test_a_rogue_key_committee_is_refused_at_spawn(tmp_path):
    """Consensus.spawn refuses (a) a PoP-less BLS committee and (b) one
    whose rogue member (pk = a*G2 - sum of two honest keys) replays an
    honest member's proof, as the JAX package does."""
    from hotstuff_tpu_torch.consensus.config import InvalidCommittee
    from hotstuff_tpu_torch.crypto.bls import BlsPublicKey
    from hotstuff_tpu_torch.crypto.bls.curve import G2Point
    from hotstuff_tpu_torch.crypto.bls.service import BlsSigningService
    from hotstuff_tpu_torch.store import Store

    pairs = [pscheme.bls_keygen(SEED, 100 + i) for i in range(3)]
    honest = G2Point.sum([BlsPublicKey.from_bytes(pk.to_bytes()).point for pk, _ in pairs[:2]])
    rogue = pcrypto.PublicKey(BlsPublicKey(G2Point.generator().mul(0xD15EA5E) + (-honest)).to_bytes())
    ports = _os_ports(4)
    members = [(pk, 1, ("127.0.0.1", p)) for (pk, _), p in zip(pairs, ports)]
    members.append((rogue, 1, ("127.0.0.1", ports[3])))

    async def try_spawn(com):
        store = Store(str(tmp_path / "db_rogue"))
        try:
            await pcons.Consensus.spawn(
                pairs[0][0], com, pcons.Parameters(), BlsSigningService(pairs[0][1]), store,
                asyncio.Queue(), verifier=pscheme.make_cpu_verifier("bls"), bind_host="127.0.0.1",
            )
        finally:
            store.close()

    with pytest.raises(InvalidCommittee):
        asyncio.run(try_spawn(pcons.Committee.new(members, scheme="bls")))
    pops = {pk: pscheme.bls_pop(secret) for pk, secret in pairs}
    pops[rogue] = pops[pairs[0][0]]
    with pytest.raises(InvalidCommittee):
        asyncio.run(try_spawn(pcons.Committee.new(members, scheme="bls", pops=pops)))


def test_bls_key_files_cross_between_the_packages(tmp_path):
    from hotstuff_tpu.node.config import Secret as JSecret
    from hotstuff_tpu_torch.node.config import Secret as PSecret

    for writer, reader, name in ((PSecret, JSecret, "port"), (JSecret, PSecret, "jax")):
        path = str(tmp_path / f"{name}.json")
        s = writer.new("bls")
        s.write(path)
        back = reader.read(path)
        assert back.scheme == "bls" and back.pop == s.pop
        assert back.name.to_bytes() == s.name.to_bytes()
        assert back.secret.to_bytes() == s.secret.to_bytes()
    # the same key written by both packages gives the same file bytes
    mine = PSecret.read(str(tmp_path / "jax.json"))
    mine.write(str(tmp_path / "again.json"))
    assert (tmp_path / "again.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_a_mixed_scheme_schedule_boots_with_the_dual_verifier(tmp_path):
    """Epoch 1 Ed25519, epoch 2 BLS: a node of epoch 1 boots on the dual
    verifier, which routes each key to its scheme's backend."""
    from hotstuff_tpu_torch.consensus.config import CommitteeSchedule
    from hotstuff_tpu_torch.crypto.scheme import DualSchemeVerifier
    from hotstuff_tpu_torch.node.config import Secret, write_committee, write_parameters
    from hotstuff_tpu_torch.node.node import Node

    ed = [Secret.new() for _ in range(N)]
    ports = _os_ports(2 * N)
    epoch1 = pcons.Committee.new([(s.name, 1, ("127.0.0.1", p)) for s, p in zip(ed, ports)], epoch=1)
    epoch2, _ = _bls_committee(pcons, pscheme, ports=ports[N:], epoch=2)
    write_committee(CommitteeSchedule([(1, epoch1), (50, epoch2)]), str(tmp_path / "committee.json"))
    write_parameters(pcons.Parameters(), str(tmp_path / "parameters.json"))
    ed[0].write(str(tmp_path / "key.json"))
    bls_key = Secret.new("bls")
    bls_key.write(str(tmp_path / "stranger.json"))

    async def boot():
        node = await Node.new(str(tmp_path / "committee.json"), str(tmp_path / "key.json"),
                              str(tmp_path / "db"), str(tmp_path / "parameters.json"),
                              verifier_backend="cpu", bind_host="127.0.0.1")
        try:
            v = node.consensus.core.verifier
            assert isinstance(v, DualSchemeVerifier)
            assert set(v.backends) == {"ed25519", "bls"}
            assert v._route(bytes(96)) is v.backends["bls"] and v._route(bytes(32)) is v.backends["ed25519"]
        finally:
            await asyncio.wait_for(node.shutdown(), 30)
        # a BLS key of no epoch is refused before boot
        with pytest.raises(Exception, match="not a member"):
            await Node.new(str(tmp_path / "committee.json"), str(tmp_path / "stranger.json"),
                           str(tmp_path / "db2"), verifier_backend="cpu", bind_host="127.0.0.1")

    asyncio.run(boot())
