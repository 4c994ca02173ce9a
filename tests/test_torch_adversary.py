"""The port's Byzantine adversary plane (``faults/adversary.py``) held
against the JAX package, and its seams in the core, the proposer and
state sync driven on 4-node port committees.

The plane: rules and their errors, spec loading, schedule gating and
window edges, ``describe`` and ``stats``, the draw stream, the shadow
branch's digests, the equivocation targets (alone and colluding), and
the bytes of ``forged_qc``, ``forged_compact_qc`` and
``forged_reconfig``, all from the same spec, seed and node index.  The
committees (``run_committee`` with ``adversary=``, the knob the node
CLI's ``--adversary`` sets): an equivocating leader still commits, a
withholding node costs rounds and not safety, a double vote parks on
an honest aggregator, forged QCs die in honest verification, and a
colluding pair's shadow committer reports a history that diverges from
the honest nodes' at rounds the colluders led, which this file's own
comparison of the reported chains pins on both colluders.

Every listener port comes from the OS (``run_committee`` reserves
them); every run has a bounded load window and tears its stacks down
in ``finally``."""

import json
import os
import time

import pytest
import torch

import hotstuff_tpu.faults.adversary as jadv
from hotstuff_tpu.utils.codec import Encoder as JaxEncoder
from hotstuff_tpu_torch.bench.committee import run_committee
from hotstuff_tpu_torch.faults import adversary as padv
from hotstuff_tpu_torch.utils.codec import Encoder

from .test_torch_core import JAX, PORT

torch.set_num_threads(1)

EPOCH = 1_000_000.0  # a spec's t=0, injected through ``now``
BASE = 9900


def _spec(policy="equivocate", nodes=0, at=0.0, until=None, seed=3, n=4):
    return {
        "name": f"byz-{policy}",
        "seed": seed,
        "epoch_unix": EPOCH,
        "nodes": {f"127.0.0.1:{BASE + i}": i for i in range(n)},
        "adversary": [{"policy": policy, "node": nodes, "at": at, "until": until}],
    }


def _planes(spec, self_id=0):
    addr = ("127.0.0.1", BASE + self_id)
    return (jadv.AdversaryPlane(spec, addr, now=EPOCH), padv.AdversaryPlane(spec, addr, now=EPOCH))


def _rule(r):
    return tuple(getattr(r, s) for s in r.__slots__)


def _qc_bytes(qc, encoder):
    enc = encoder()
    qc.encode(enc)
    return enc.finish()


# ---- rules, loading, schedule ------------------------------------------------


RULES = {
    "one": {"adversary": [{"policy": "withhold", "node": 2, "at": 3, "until": 9}]},
    "many": {"adversary": [
        {"policy": "collude", "nodes": [0, 3], "at": 1.5, "label": "pair"},
        {"policy": "flood", "node": 1, "rate": 0.5},
        {"policy": "forge-qc", "nodes": [], "until": 4},
        {"policy": "timeout-surfer", "node": 0, "at": 2, "until": 8},
    ]},
    "none": {},
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_expand_adversary_gives_the_same_rules(name):
    jrules = jadv.expand_adversary(RULES[name])
    prules = padv.expand_adversary(RULES[name])
    assert [_rule(r) for r in prules] == [_rule(r) for r in jrules]
    for t in (0.0, 1.5, 2.9, 3.0, 4.0, 8.99, 9.0, 100.0):
        assert [r.active(t) for r in prules] == [r.active(t) for r in jrules]


@pytest.mark.parametrize("bad", [
    lambda mod: mod.AdversaryRule("bribe", 0),
    lambda mod: mod.expand_adversary({"adversary": [{"policy": "nope", "node": 0}]}),
], ids=["rule", "spec"])
def test_unknown_policies_are_refused_alike(bad):
    with pytest.raises(ValueError) as jerr:
        bad(jadv)
    with pytest.raises(ValueError) as perr:
        bad(padv)
    assert str(perr.value) == str(jerr.value)


def test_load_inline_and_from_a_file(tmp_path):
    spec = _spec("withhold", at=2.0, until=6.0)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    for source in (json.dumps(spec), "  " + json.dumps(spec), str(path)):
        j = jadv.AdversaryPlane.load(source, ("127.0.0.1", BASE), now=EPOCH)
        p = padv.AdversaryPlane.load(source, ("127.0.0.1", BASE), now=EPOCH)
        assert (p.seed, p.name, p.self_id, p.epoch, p.enabled) == (j.seed, j.name, j.self_id, j.epoch, j.enabled)
        assert p.describe() == j.describe()
    with pytest.raises(FileNotFoundError):
        padv.AdversaryPlane.load(str(tmp_path / "missing.json"), ("127.0.0.1", BASE))


def test_a_stale_epoch_falls_back_to_the_boot_alike():
    spec = _spec("withhold", at=2.0)
    spec["epoch_unix"] = EPOCH - 7200.0
    j, p = _planes(spec)
    assert p.epoch == j.epoch == EPOCH
    del spec["epoch_unix"]
    j, p = _planes(spec)
    assert p.epoch == j.epoch == EPOCH


SCHEDULES = {
    "withhold": _spec("withhold", at=2.0, until=6.0),
    "collude": _spec("collude", nodes=[0, 1], at=1.0),
    "mixed": {**_spec("equivocate", at=0.5, until=3.0),
              "adversary": RULES["many"]["adversary"] + [{"policy": "double-vote", "node": 2, "at": 4}]},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("self_id", [0, 1, 2, 3, 9])
def test_schedule_gating_edges_and_stats_agree(name, self_id):
    j, p = _planes(SCHEDULES[name], self_id)
    assert (p.enabled, p.self_id, p.colluders, p.is_shadow_committer) == (
        j.enabled, j.self_id, j.colluders, j.is_shadow_committer)
    for policy in padv.POLICIES + ("sync-withhold", "vote-delay"):
        for t in (0.0, 0.5, 1.0, 1.49, 2.0, 3.0, 4.0, 5.99, 6.0, 8.0, 60.0):
            assert p.active(policy, now=EPOCH + t) == j.active(policy, now=EPOCH + t), (policy, t)
    assert p.window_edges() == j.window_edges()
    assert p.describe() == j.describe()
    for key in ("byz_equivocations", "byz_votes_withheld", "byz_flood_shed", "byz_new_counter"):
        j.count(key, 3)
        p.count(key, 3)
        j.record("x", 4)
        p.record("x", 4)
    assert p.stats() == j.stats()


# ---- the attack math ---------------------------------------------------------


@pytest.mark.parametrize("seed, self_id", [(3, 0), (3, 2), (11, 1)])
def test_draw_streams_and_shadow_digests_agree(seed, self_id):
    j, p = _planes(_spec("collude", nodes=[0, 1], seed=seed), self_id)
    assert [p.rng.random() for _ in range(20)] == [j.rng.random() for _ in range(20)]
    assert [p.rng.getrandbits(8) for _ in range(64)] == [j.rng.getrandbits(8) for _ in range(64)]
    assert p.rng.draws == j.rng.draws
    for r in (1, 2, 17, 1 << 40):
        assert [d.to_bytes() for d in p.shadow_payloads(r)] == [d.to_bytes() for d in j.shadow_payloads(r)]
    jblocks, pblocks = JAX.chain(6), PORT.chain(6)
    for jb, pb in zip(jblocks, pblocks):
        assert pb.digest().to_bytes() == jb.digest().to_bytes()
        js, ps = j.shadow_block(jb), p.shadow_block(pb)
        assert ps.digest().to_bytes() == js.digest().to_bytes() != pb.digest().to_bytes()
        assert (ps.round, ps.author.to_bytes()) == (pb.round, pb.author.to_bytes())


@pytest.mark.parametrize("spec, self_id", [
    (_spec("equivocate"), 0),
    (_spec("equivocate", nodes=2), 2),
    (_spec("collude", nodes=[0, 1]), 0),
    (_spec("collude", nodes=[0, 1, 3]), 3),
], ids=["solo-0", "solo-2", "pair", "trio"])
def test_equivocation_targets_and_bind_agree(spec, self_id):
    ports = range(BASE, BASE + 4)
    jcom, pcom = JAX.committee(ports), PORT.committee(ports)
    jname = next(n for n in jcom.authorities if jcom.address(n)[1] == BASE + self_id)
    pname = next(n for n in pcom.authorities if pcom.address(n)[1] == BASE + self_id)
    j, p = _planes(spec, self_id)
    j.bind(jcom, jname)
    p.bind(pcom, pname)
    assert {i: n.to_bytes() for i, n in p.names_by_index.items()} == {
        i: n.to_bytes() for i, n in j.names_by_index.items()}
    assert sorted(n.to_bytes() for n in p.colluder_names) == sorted(n.to_bytes() for n in j.colluder_names)
    jt = j.equivocation_targets(jcom.broadcast_addresses(jname))
    pt = p.equivocation_targets(pcom.broadcast_addresses(pname))
    assert [(n.to_bytes(), a) for n, a in pt] == [(n.to_bytes(), a) for n, a in jt]
    assert pt


@pytest.mark.parametrize("n", [4, 7, 64])
def test_forged_qcs_and_reconfigs_are_the_same_bytes(n):
    ports = range(BASE, BASE + n)
    jcom, pcom = JAX.committee(ports, n), PORT.committee(ports, n)
    spec = _spec("forge-qc", n=n, seed=5)
    j, p = _planes(spec, 1)
    for r in (1, 2, 9, 33):
        jq, pq = j.forged_qc(jcom, r), p.forged_qc(pcom, r)
        assert len(pq.votes) == pcom.quorum_threshold()
        assert _qc_bytes(pq, Encoder) == _qc_bytes(jq, JaxEncoder)
        pq.check_weight(pcom)  # a quorum by its stake: only verification refuses it
    for r in (3, 4, 5, 6, 7, 8):
        jop, pop = j.forged_reconfig(jcom, r), p.forged_reconfig(pcom, r)
        assert (pop is None) == (jop is None)
        if pop is not None:
            assert pop.serialize() == jop.serialize()
            assert pop.digest() == jop.digest()
    assert p.rng.draws == j.rng.draws


def test_forged_compact_qcs_are_the_same_bytes():
    from hotstuff_tpu.crypto.scheme import keygen_deterministic as jkeygen
    from hotstuff_tpu_torch.crypto.scheme import keygen_deterministic as pkeygen

    n = 7
    seed = bytes(range(32))
    members = lambda keygen: [(keygen("bls", seed, i)[0], 1, ("127.0.0.1", BASE + i))  # noqa: E731
                              for i in range(n)]
    jcom = JAX.consensus.Committee.new(members(jkeygen), scheme="bls")
    pcom = PORT.consensus.Committee.new(members(pkeygen), scheme="bls")
    j, p = _planes(_spec("forge-qc", n=n, seed=8), 2)
    for r in (1, 5, 40):
        jq, pq = j.forged_compact_qc(jcom, r), p.forged_compact_qc(pcom, r)
        assert pq.is_compact and not pq.votes
        assert _qc_bytes(pq, Encoder) == _qc_bytes(jq, JaxEncoder)
    assert p.rng.draws == j.rng.draws == 3 * 48


def test_a_forged_qc_dies_in_honest_verification():
    from hotstuff_tpu_torch.consensus.errors import ConsensusError
    from hotstuff_tpu_torch.crypto.service import CpuVerifier

    pcom = PORT.committee(range(BASE, BASE + 4))
    _, p = _planes(_spec("forge-qc"))
    qc = p.forged_qc(pcom, 5)
    qc.check_weight(pcom)
    with pytest.raises(ConsensusError):
        qc.verify(pcom, CpuVerifier())


# ---- 4-node committees under the knob ----------------------------------------


def _run(policy, nodes=0, duration=4.0, **kw):
    spec = {"seed": 5, "name": f"byz-{policy}",
            "adversary": [{"policy": policy, "node": nodes, "at": 0.0, "until": None}]}
    return run_committee(nodes=4, rate=200, duration=duration, verifier="cpu", timeout_delay=1_000,
                         sync_retry_delay=1_000, adversary=spec, **kw)


def _counts(r, i):
    return r["adversary"]["planes"][i]


def test_an_equivocating_leader_still_commits():
    r = _run("equivocate")
    assert sorted(r["adversary"]["planes"]) == [0]  # honest nodes stay clean
    assert _counts(r, 0)["byz_equivocations"] > 0
    assert min(r["blocks"]) >= 4
    assert r["chains_agree"] and r["roots_agree"]


def test_a_withholding_node_costs_rounds_not_safety():
    r = _run("withhold")
    assert _counts(r, 0)["byz_votes_withheld"] > 0
    assert _counts(r, 0)["byz_votes_withheld"] >= min(r["blocks"]) - 2
    assert min(r["blocks"]) >= 3
    assert r["chains_agree"] and r["roots_agree"]


def test_a_double_vote_parks_on_the_honest_aggregator():
    r = _run("double-vote")
    assert _counts(r, 0)["byz_double_votes"] > 0
    assert sum(r["adversary"]["vote_conflicts"][1:]) > 0
    assert min(r["blocks"]) >= 4 and r["chains_agree"]


def test_forged_qcs_die_on_honest_nodes():
    r = _run("forge-qc")
    assert _counts(r, 0)["byz_forged_qcs"] > 0
    assert min(r["blocks"]) >= 4 and r["chains_agree"] and r["roots_agree"]


def test_a_colluding_pair_gives_a_divergence_attributed_to_both():
    r = _run("collude", nodes=[0, 1], duration=5.0)
    adv = r["adversary"]
    assert _counts(r, 1)["byz_shadow_commits"] > 0 and _counts(r, 0)["byz_shadow_commits"] == 0
    leaders = adv["leader_order"]
    reported = adv["reported_chains"]
    honest = {}
    for i in (2, 3):
        for rnd, digest in reported[i]:
            assert honest.setdefault(rnd, digest) == digest
    conflicts = [(i, rnd) for i, chain in enumerate(reported) for rnd, digest in chain
                 if rnd in honest and honest[rnd] != digest]
    assert conflicts, "the colluders never reported a divergent history"
    reporters = {i for i, _ in conflicts}
    authors = {leaders[rnd % 4] for _, rnd in conflicts}
    assert reporters == {1}  # the shadow committer, the higher colluder
    assert authors <= {0, 1}  # only colluder-led rounds diverge
    assert reporters | authors == {0, 1}
    # the other colluder reports what the honest nodes do, every node
    # holds the one chain, and only the reported roots diverge
    assert all(honest.get(rnd, digest) == digest for rnd, digest in reported[0])
    assert r["chains_agree"] and not r["roots_agree"]


def test_the_knob_leaves_the_environment_as_it_was(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_ADVERSARY", "unchanged")
    spec = {"seed": 1, "adversary": [{"policy": "withhold", "node": 3, "at": 3600.0}]}
    t0 = time.time()
    r = run_committee(nodes=4, rate=100, duration=1.0, verifier="cpu", timeout_delay=1_000,
                      adversary=spec)
    assert sorted(r["adversary"]["planes"]) == [3]
    assert r["adversary"]["planes"][3]["byz_votes_withheld"] == 0  # the window opens in an hour
    assert time.time() - t0 < 60
    assert os.environ["HOTSTUFF_ADVERSARY"] == "unchanged"
