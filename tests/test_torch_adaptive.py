"""The port's adaptive adversary policies (``faults/adaptive.py``) held
against the JAX package.

The knob readers over the same environment values, the policy tables,
the read-only ``StateView``, the four triggers' verdicts on the same
providers over a grid of protocol states, ``CountingRandom``'s draw
streams and counts, the RNG state files (byte for byte, and read back
across the packages), and an armed plane's ``wants`` tokens with its
zero-draw contract, all from the same spec, seed and node index."""

import json
import time

import pytest

import hotstuff_tpu.faults.adaptive as jadapt
import hotstuff_tpu.faults.adversary as jadv
from hotstuff_tpu_torch.faults import adaptive as padapt
from hotstuff_tpu_torch.faults import adversary as padv

EPOCH = 1_000_000.0  # a spec's t=0, injected through ``now``


def _spec(policy, nodes=0, at=0.0, until=None, seed=3, n=4):
    return {
        "name": f"byz-{policy}",
        "seed": seed,
        "epoch_unix": EPOCH,
        "nodes": {f"127.0.0.1:{9940 + i}": i for i in range(n)},
        "adversary": [{"policy": policy, "node": nodes, "at": at, "until": until}],
    }


def _providers(**over):
    """An attacker at node 0 of a 4-committee at round 10: no TC yet,
    nobody syncing, a static committee."""
    providers = {
        "round": lambda: 10,
        "leader": lambda r: f"auth-{r % 4}",
        "self": lambda: "auth-0",
        "last_tc_round": lambda: None,
        "timeout_ms": lambda: 5000.0,
        "credit": lambda: 32,
        "syncing": lambda: frozenset(),
        "boundaries": lambda: (),
        "incidents": lambda: 0,
    }
    providers.update(over)
    return providers


def _views(**over):
    providers = _providers(**over)
    return jadapt.StateView(providers), padapt.StateView(providers)


def test_policy_tables_are_the_references():
    assert padapt.ADAPTIVE_POLICIES == jadapt.ADAPTIVE_POLICIES
    assert padapt.ADAPTIVE_SHORT == jadapt.ADAPTIVE_SHORT
    assert {k: v[0] for k, v in padapt.ADAPTIVE_TRIGGERS.items()} == {
        k: v[0] for k, v in jadapt.ADAPTIVE_TRIGGERS.items()
    }
    assert [v[1].__name__ for v in padapt.ADAPTIVE_TRIGGERS.values()] == [
        v[1].__name__ for v in jadapt.ADAPTIVE_TRIGGERS.values()
    ]
    assert padv.POLICIES == jadv.POLICIES
    assert sorted(padapt.__all__) == sorted(jadapt.__all__)


@pytest.mark.parametrize("knob, values, reader", [
    ("HOTSTUFF_ADAPT_SURF_FRACTION", [None, "0", "0.3", "0.55", "0.95", "1.7", "-2"], "surf_fraction"),
    ("HOTSTUFF_ADAPT_SNIPE_MARGIN", [None, "0", "3", "8", "40"], "snipe_margin"),
    ("HOTSTUFF_ADAPT_FLOOD_BATCH", [None, "1", "64", "1000"], "flood_batch_cap"),
])
def test_knob_readers_read_the_same_values(monkeypatch, knob, values, reader):
    for value in values:
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
        assert getattr(padapt, reader)() == getattr(jadapt, reader)(), value


def test_state_view_is_read_only_and_reads_fresh():
    state = {"round": 10}
    over = {"round": lambda: state["round"], "syncing": lambda: {"peer-a"}}
    for view in _views(**over):
        with pytest.raises(AttributeError):
            view.round = 3
        with pytest.raises(AttributeError):
            del view.round
        with pytest.raises(AttributeError):
            view._providers = {}
    jview, pview = _views(**over)
    for r in (10, 11, 57):
        state["round"] = r
        assert (pview.round, pview.syncing_peers) == (jview.round, jview.syncing_peers)
    empty = (jadapt.StateView({}), padapt.StateView({}))
    read = lambda v: (v.round, v.is_leader(3), v.last_tc_round, v.timeout_ms, v.credit,  # noqa: E731
                      v.syncing_peers, v.epoch_boundaries, v.incidents)
    assert read(empty[1]) == read(empty[0]) == (0, False, None, 0.0, None, frozenset(), (), 0)
    assert read(pview) == read(jview)


STATES = {
    "quiet": {},
    "fresh-tc-leading": {"last_tc_round": lambda: 7},
    "fresh-tc-not-leading": {"last_tc_round": lambda: 8},
    "stale-tc": {"last_tc_round": lambda: 3},
    "syncing": {"syncing": lambda: {"peer-a", "peer-b"}},
    "boundaries": {"boundaries": lambda: (20, 64)},
    "self-2": {"self": lambda: "auth-2"},
    "no-leader": {"leader": None},
}


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("margin", ["8", "2"])
def test_triggers_give_the_same_verdicts(monkeypatch, state, margin):
    monkeypatch.setenv("HOTSTUFF_ADAPT_SNIPE_MARGIN", margin)
    over = {k: v for k, v in STATES[state].items() if v is not None}
    providers = _providers(**over)
    for key, value in STATES[state].items():
        if value is None:
            providers.pop(key)
    jview, pview = jadapt.StateView(providers), padapt.StateView(providers)
    names = ("ambush_trigger", "sync_trigger", "surf_trigger", "snipe_trigger")
    for r in range(0, 70):
        want = [getattr(jadapt, n)(jview, r) for n in names]
        assert [getattr(padapt, n)(pview, r) for n in names] == want, r


def _draws(rng):
    """A mix of the composite methods, each funnelled through the two
    counted primitives."""
    out = [rng.random(), rng.getrandbits(8), rng.getrandbits(77), rng.randrange(1, 1 << 20),
           rng.uniform(0.5, 2.5), rng.choice("abcdefgh"), rng.sample(range(100), 5),
           rng.randint(3, 9), rng.gauss(0.0, 1.0)]
    items = list(range(20))
    rng.shuffle(items)
    out.append(items)
    return out, rng.draws


@pytest.mark.parametrize("seed", [None, 0, 7, "3|adversary|0", "11|adversary|None"])
def test_counting_random_gives_the_same_stream_and_counts(seed):
    if seed is None:
        j, p = jadapt.CountingRandom(), padapt.CountingRandom()
        state = j.getstate()
        p.setstate(state)
        j.draws = p.draws = 0
    else:
        j, p = jadapt.CountingRandom(seed), padapt.CountingRandom(seed)
    for _ in range(5):
        assert _draws(p) == _draws(j)


def test_rng_state_files_round_trip_byte_for_byte(tmp_path):
    assert padapt.rng_state_path(str(tmp_path), 3) == jadapt.rng_state_path(str(tmp_path), 3)
    j, p = jadapt.CountingRandom("5|adversary|2"), padapt.CountingRandom("5|adversary|2")
    _draws(j), _draws(p)
    jpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    jadapt.save_rng_state(str(jpath), j)
    padapt.save_rng_state(str(ppath), p)
    assert ppath.read_bytes() == jpath.read_bytes()
    assert not (tmp_path / "port.json.tmp").exists()
    # each package resumes the stream from the other's file
    j2, p2 = jadapt.CountingRandom(1), padapt.CountingRandom(2)
    assert padapt.load_rng_state(str(jpath), p2) == jadapt.load_rng_state(str(ppath), j2) == j.draws
    assert _draws(p2) == _draws(j2) == _draws(j)
    padapt.save_rng_state(str(ppath), p2)
    jadapt.save_rng_state(str(jpath), j2)
    assert ppath.read_bytes() == jpath.read_bytes()
    assert padapt.load_rng_state(str(tmp_path / "none.json"), p2) is None
    assert jadapt.load_rng_state(str(tmp_path / "none.json"), j2) is None


def _planes(spec, self_id=0):
    addr = ("127.0.0.1", 9940 + self_id)
    return (jadv.AdversaryPlane(spec, addr, now=EPOCH), padv.AdversaryPlane(spec, addr, now=EPOCH))


@pytest.mark.parametrize("policy, action", [
    ("ambush-leader", "equivocate"),
    ("sync-predator", "sync-withhold"),
    ("timeout-surfer", "vote-delay"),
    ("reconfig-sniper", "reconfig"),
    ("reconfig-sniper", "withhold"),
    ("withhold", "withhold"),
    ("equivocate", "equivocate"),
])
def test_wants_tokens_and_marks_agree_with_zero_draws(policy, action):
    spec = _spec(policy, at=1.0, until=9.0)
    jplane, pplane = _planes(spec)
    over = {"last_tc_round": lambda: 7, "boundaries": lambda: (12,)}
    for plane in (jplane, pplane):
        plane.bind_view(_providers(**over))
        plane.note_syncing("peer-a")
    for t in (0.5, 1.0, 4.0, 8.9, 9.0, 30.0):
        for r in (4, 8, 9, 12, 30):
            want = jplane.wants(action, r, now=EPOCH + t)
            assert pplane.wants(action, r, now=EPOCH + t) == want, (t, r)
            jplane.mark_adaptive(want, r)
            pplane.mark_adaptive(want, r)
    assert pplane.rng.draws == jplane.rng.draws == 0
    assert pplane.stats() == jplane.stats()
    assert pplane.surf_delay_s(4.0) == jplane.surf_delay_s(4.0)
    # unbound: wants degrades to the schedule alone
    jplane, pplane = _planes(spec)
    assert [pplane.wants(action, 8, now=EPOCH + t) for t in (0.5, 4.0)] == [
        jplane.wants(action, 8, now=EPOCH + t) for t in (0.5, 4.0)
    ]


def test_planes_restore_the_rng_from_the_env_dir_alike(tmp_path, monkeypatch):
    """With ``HOTSTUFF_ADAPT_RNG_DIR`` set, each decision checkpoints the
    stream, and a plane built again resumes it; the two packages write
    the same file and resume from each other's."""
    spec = _spec("forge-qc")
    spec["epoch_unix"] = time.time()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d, mod in ((jdir, jadv), (pdir, padv)):
        monkeypatch.setenv("HOTSTUFF_ADAPT_RNG_DIR", str(d))
        plane = mod.AdversaryPlane(spec, ("127.0.0.1", 9940))
        for _ in range(7):
            plane.rng.random()
        plane.count("byz_forged_qcs")
    name = padapt.rng_state_path("", 0)
    assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    monkeypatch.setenv("HOTSTUFF_ADAPT_RNG_DIR", str(jdir))
    resumed_p = padv.AdversaryPlane(spec, ("127.0.0.1", 9940))
    monkeypatch.setenv("HOTSTUFF_ADAPT_RNG_DIR", str(pdir))
    resumed_j = jadv.AdversaryPlane(spec, ("127.0.0.1", 9940))
    assert resumed_p.rng.draws == resumed_j.rng.draws == 7
    assert [resumed_p.rng.random() for _ in range(4)] == [resumed_j.rng.random() for _ in range(4)]
    assert json.loads((pdir / name).read_text())["draws"] == 7
