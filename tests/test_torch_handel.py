"""The port's Handel plane (``consensus/handel.py``) held against the JAX
package, after ``tests/test_agg_qc.py``'s Handel test: the seeded
permutation, tree positions, level blocks and partner blocks at every
committee size the bench and the tests use, over several rounds;
``simulate`` at full and partial participation (final aggregate bytes,
signer bitmap, the leader's and the network's merge counts); the
overlap rejection; the wire form; and the Handel columns of the port's
``bench_agg_qc`` at two tiny sizes on the CPU."""

import pytest
import torch

from hotstuff_tpu.consensus import handel as jh
from hotstuff_tpu.consensus.errors import ConsensusError as JaxConsensusError
from hotstuff_tpu.crypto.bls import BlsSecretKey as JaxSecretKey
from hotstuff_tpu_torch.consensus import handel as ph
from hotstuff_tpu_torch.consensus.errors import ConsensusError
from hotstuff_tpu_torch.crypto.bls import BlsSecretKey
from hotstuff_tpu_torch.crypto.bls.curve import G1Point

torch.set_num_threads(1)

MSG = b"handel parity block digest 32 b."


def _sigs(n):
    return {i: BlsSecretKey(i + 2).sign(MSG).to_bytes() for i in range(n)}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 64, 171, 256])
def test_topology_equals_the_references(n):
    for round_ in (0, 1, 3, 4, 5, 1_000_003):
        j = jh.HandelTopology.for_round(n, round_=round_)
        p = ph.HandelTopology.for_round(n, round_=round_)
        assert p.seed == j.seed
        assert p.validator_at == j.validator_at
        assert p.position == j.position
        assert p.levels == j.levels
        for index in range(n):
            for level in range(1, p.levels + 1):
                assert p.block(index, level) == j.block(index, level)
                assert p.partner_block(index, level) == j.partner_block(index, level)
                assert p.validators_in(p.partner_block(index, level)) == j.validators_in(
                    j.partner_block(index, level))
    seed = b"\x07" * 16
    assert ph.HandelTopology(n, seed).validator_at == jh.HandelTopology(n, seed).validator_at
    custom = ph.HandelTopology.for_round(n, 9, domain=b"other")
    assert custom.validator_at == jh.HandelTopology.for_round(n, 9, domain=b"other").validator_at


def test_an_empty_committee_raises_the_same_error():
    for mod in (jh, ph):
        with pytest.raises(ValueError, match="at least one validator"):
            mod.HandelTopology(0, b"seed")


@pytest.mark.parametrize("n, present", [
    (4, "all"), (7, "all"), (16, "all"), (64, "all"),
    (7, "quorum"), (16, "odd"), (64, "quorum"), (64, "scattered"),
])
def test_simulate_gives_the_same_aggregate_and_merge_counts(n, present):
    sigs = _sigs(n)
    keep = {
        "all": range(n),
        "quorum": range(2 * n // 3 + 1),
        "odd": range(1, n, 2),
        "scattered": [i for i in range(n) if i % 5 != 2],
    }[present]
    subset = {i: sigs[i] for i in keep}
    for round_ in (3, 8):
        jf, jtop, jtotal = jh.simulate(jh.HandelTopology.for_round(n, round_), subset)
        topo = ph.HandelTopology.for_round(n, round_)
        pf, ptop, ptotal = ph.simulate(topo, subset)
        assert pf.point.to_bytes() == jf.point.to_bytes()
        assert pf.bitmap == jf.bitmap
        assert (ptop, ptotal) == (jtop, jtotal)
        assert ptop <= topo.levels and ptotal == len(subset) - 1
        assert pf.weight == len(subset) and pf.signers() == sorted(subset)
        flat = G1Point.sum([G1Point.from_bytes(s, subgroup_check=False) for s in subset.values()])
        assert pf.to_wire() == (flat.to_bytes(), jf.bitmap)
    wide = ph.simulate(ph.HandelTopology.for_round(n, 3), subset, nbytes=40)[0]
    assert wide.bitmap == jh.simulate(jh.HandelTopology.for_round(n, 3), subset, nbytes=40)[0].bitmap


def test_no_contribution_raises_the_same_error():
    for mod, err in ((jh, JaxConsensusError), (ph, ConsensusError)):
        with pytest.raises(err, match="no contributions reached the Handel root"):
            mod.simulate(mod.HandelTopology.for_round(8, 3), {})


def test_overlapping_partials_raise_where_the_reference_raises():
    sigs = _sigs(4)
    outcomes = []
    for mod in (jh, ph):
        a = mod.PartialAggregate.single(sigs[0], 0, 1)
        b = mod.PartialAggregate.single(sigs[1], 1, 1)
        ab = a.merge(b)
        row = [ab.weight, ab.signers(), ab.to_wire()]
        for left, right in ((ab, b), (ab, ab), (b, ab), (a, a)):
            with pytest.raises(mod.PartialOverlap, match="overlapping signer bitmaps"):
                left.merge(right)
        assert issubclass(mod.PartialOverlap, mod.ConsensusError)
        empty = mod.PartialAggregate.empty(1)
        row.append(empty.merge(a).to_wire())
        row.append(a.merge(empty).to_wire())
        row.append(empty.merge(empty).bitmap)
        outcomes.append(row)
    assert outcomes[0] == outcomes[1]


def test_to_wire_and_single_agree():
    sigs = _sigs(9)
    for index in range(9):
        j = jh.PartialAggregate.single(sigs[index], index, 2)
        p = ph.PartialAggregate.single(sigs[index], index, 2)
        assert p.to_wire() == j.to_wire()
        assert p.weight == j.weight == 1
    for mod, err in ((jh, JaxConsensusError), (ph, ConsensusError)):
        with pytest.raises(err, match="empty Handel partial"):
            mod.PartialAggregate.empty(2).to_wire()
        with pytest.raises(err, match="undecodable signature"):
            mod.PartialAggregate.single(b"\x00" * 48, 0, 1)
    # the JAX key signs the same bytes, so either package's signature merges
    assert JaxSecretKey(5).sign(MSG).to_bytes() == BlsSecretKey(5).sign(MSG).to_bytes()


@pytest.mark.parametrize("sizes", [(4, 8), (7,)])
def test_bench_agg_qc_has_the_handel_columns(sizes, monkeypatch):
    """``bench_agg_qc`` on the plain versions at tiny sizes: the levels
    and the leader's merges of the round-3 tree over the quorum, equal
    to the JAX plane's on the same signers."""
    from hotstuff_tpu_torch.bench.verifier import bench_agg_qc

    monkeypatch.setenv("HOTSTUFF_AGG_DEVICE_SUM", "0")
    out = bench_agg_qc(sizes=sizes, reps=1, device="cpu")
    for n in sizes:
        row = out[str(n)]
        topo = jh.HandelTopology.for_round(n, round_=3)
        assert row["handel_levels"] == topo.levels
        assert 0 < row["handel_leader_merges"] <= topo.levels
        # the bench's signers are the quorum's lowest sorted keys
        sks = [JaxSecretKey(i + 2) for i in range(n)]
        pks = sorted(sk.public_key().to_bytes() for sk in sks)
        by_pk = {sk.public_key().to_bytes(): sk for sk in sks}
        quorum = 2 * n // 3 + 1
        sigs = {pks.index(pk): by_pk[pk].sign(MSG).to_bytes() for pk in pks[:quorum]}
        assert row["handel_leader_merges"] == jh.simulate(topo, sigs)[1]
