"""The port's node layer against the JAX package's: key, committee and
parameters files byte for byte (each package reading the other's),
``committee_hash``, the committee-hash provenance decision of
``Node.new`` on copies of one store, the boot-time replay of persisted
schedule links, the reconfiguration frame the ``reconfig`` CLI sends,
``Node.new`` on the ``cuda`` verifier's plain versions, and a node
process killed with SIGKILL that rejoins a committee of port ``run``
processes from a peer's snapshot.

Every listener port comes from the OS (``reserve_ports``); every wait
has a deadline; every node, server and process is stopped in
``finally``."""

import asyncio
import importlib
import logging
import os
import re
import shutil
import signal
import stat
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from hotstuff_tpu_torch.bench.committee import reserve_ports

from .test_torch_core import JAX, PORT, SEED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(side, name):
    return importlib.import_module(f"{side.root}.{name}")


def _keys(side, n=5):
    """Deterministic keypairs, ordered by public key."""
    pairs = [side.crypto.generate_keypair(SEED, i) for i in range(n)]
    pairs.sort(key=lambda kp: kp[0])
    return pairs


def _committee(side, ports, members=range(4), epoch=1):
    ks = _keys(side)
    return side.consensus.Committee.new(
        [(ks[i][0], 1, ("127.0.0.1", ports[i])) for i in members], epoch=epoch
    )


def _os_ports(n):
    socks = reserve_ports(n)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:  # the nodes bind these ports themselves
        s.close()
    return ports


def _write_node_files(side, tmp_path, committee, key_index=0, parameters=None):
    """A key file of member ``key_index``, the committee file and a
    parameters file, written by ``side``; returns their paths."""
    config = _mod(side, "node.config")
    pk, sk = _keys(side)[key_index]
    paths = [str(tmp_path / name) for name in ("key.json", "committee.json", "parameters.json")]
    config.Secret(pk, sk).write(paths[0])
    config.write_committee(committee, paths[1])
    config.write_parameters(parameters or side.consensus.Parameters(), paths[2])
    return paths


# ---- config files -------------------------------------------------------------


def _config_object(side, kind):
    ports = [9_100 + i for i in range(5)]
    if kind == "key":
        pk, sk = _keys(side)[2]
        return _mod(side, "node.config").Secret(pk, sk)
    if kind == "committee":
        return _committee(side, ports)
    if kind == "schedule":
        return side.consensus.CommitteeSchedule([
            (1, _committee(side, ports)),
            (12, _committee(side, ports, (0, 1, 2, 4), epoch=2)),
        ])
    return side.consensus.Parameters(timeout_delay=1_234, sync_retry_delay=5_678)


def _write(side, kind, obj, path):
    config = _mod(side, "node.config")
    if kind == "key":
        obj.write(path)
    elif kind == "parameters":
        config.write_parameters(obj, path)
    else:
        config.write_committee(obj, path)


def _read(side, kind, path):
    """What ``side`` reads back from ``path``, in a package-neutral form."""
    config = _mod(side, "node.config")
    if kind == "key":
        s = config.Secret.read(path)
        return s.name.to_bytes(), s.secret.to_bytes(), s.scheme, s.pop
    if kind == "parameters":
        return config.read_parameters(path).to_json()
    return config.read_committee(path).to_json()


@pytest.mark.parametrize("kind", ["key", "committee", "schedule", "parameters"])
def test_config_files_are_byte_equal_and_cross_read(tmp_path, kind):
    paths = {}
    for side in (JAX, PORT):
        paths[side.root] = str(tmp_path / f"{kind}-{side.root}.json")
        _write(side, kind, _config_object(side, kind), paths[side.root])
    jax_bytes = open(paths[JAX.root], "rb").read()
    assert open(paths[PORT.root], "rb").read() == jax_bytes
    # each package reads the other's file to the same thing as its own
    assert _read(PORT, kind, paths[JAX.root]) == _read(JAX, kind, paths[JAX.root])
    assert _read(JAX, kind, paths[PORT.root]) == _read(PORT, kind, paths[PORT.root])


def test_secret_files_are_private_and_bls_keys_match_jax(tmp_path):
    from hotstuff_tpu_torch.crypto import scheme
    from hotstuff_tpu_torch.node.config import Secret

    path = str(tmp_path / "key.json")
    secret = Secret.new()
    secret.write(path)
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    again = Secret.read(path)
    assert again.name == secret.name and again.secret.to_bytes() == secret.secret.to_bytes()
    assert Secret.new().name != secret.name  # OS randomness, not a fixed seed
    pk, sk = scheme.keygen_deterministic("ed25519", SEED, 3)
    assert (pk, sk.to_bytes()) == (PORT.crypto.generate_keypair(SEED, 3)[0],
                                   PORT.crypto.generate_keypair(SEED, 3)[1].to_bytes())
    # BLS: a private file with the key's proof of possession, which the
    # JAX package reads to the same key, secret and proof
    from hotstuff_tpu.crypto.bls import BlsPublicKey, BlsSignature, verify_possession
    from hotstuff_tpu.crypto.scheme import keygen_deterministic as j_keygen
    from hotstuff_tpu.node.config import Secret as JaxSecret

    bls_path = str(tmp_path / "bls.json")
    bls = Secret.new("bls")
    bls.write(bls_path)
    assert stat.S_IMODE(os.stat(bls_path).st_mode) == 0o600
    theirs = JaxSecret.read(bls_path)
    assert theirs.scheme == "bls" and theirs.name.to_bytes() == bls.name.to_bytes()
    assert theirs.secret.to_bytes() == bls.secret.to_bytes() and theirs.pop == bls.pop
    assert verify_possession(BlsPublicKey.from_bytes(bls.name.to_bytes()),
                             BlsSignature.from_bytes(bls.pop))
    mine = Secret.read(bls_path)
    assert (mine.scheme, mine.pop, mine.secret.to_bytes()) == ("bls", bls.pop, bls.secret.to_bytes())
    pk, secret = scheme.keygen_deterministic("bls", SEED, 3)
    jpk, jsecret = j_keygen("bls", SEED, 3)
    assert (pk.to_bytes(), secret.to_bytes()) == (jpk.to_bytes(), jsecret.to_bytes())
    assert scheme.keygen_production("bls")[0] != pk
    with pytest.raises(scheme.UnknownScheme):
        Secret.new("rsa")


@pytest.mark.parametrize("kind", ["committee", "schedule"])
def test_committee_hash_matches_jax(kind):
    ports = [9_300 + i for i in range(5)]

    def obj(side):
        c = _committee(side, ports)
        if kind == "schedule":
            return side.consensus.CommitteeSchedule([(1, c), (20, _committee(side, ports, (0, 1, 2, 4), 2))])
        return c

    port = _mod(PORT, "node.node").committee_hash(obj(PORT))
    assert port == _mod(JAX, "node.node").committee_hash(obj(JAX))
    assert _mod(PORT, "node.node").COMMITTEE_HASH_KEY == _mod(JAX, "node.node").COMMITTEE_HASH_KEY


# ---- Node.new on copies of one store ----------------------------------------


async def _boot(side, paths, store_path, **kwargs):
    """Boot one node of ``side`` on the files, read what the boot left
    in its store and its schedule, and stop it."""
    node = await _mod(side, "node.node").Node.new(
        committee_file=paths[1], key_file=paths[0], store_path=store_path,
        parameters_file=paths[2], bind_host="127.0.0.1", **kwargs,
    )
    try:
        engine = node.store.engine
        key = _mod(side, "node.node").COMMITTEE_HASH_KEY
        return {
            "marker": engine.get(b"marker"),
            "committee_hash": engine.get(key),
            "schedule": node.consensus.core.committee.to_json(),
        }
    finally:
        await node.shutdown()


def _boot_both(tmp_path, paths, seed_store) -> tuple:
    """``Node.new`` of JAX and of the port, one after the other (they
    share the node's port), each on its own copy of ``seed_store``."""
    out = []
    for side in (JAX, PORT):
        copy = str(tmp_path / f"db-{side.root}")
        shutil.copytree(seed_store, copy)
        out.append(asyncio.run(_boot(side, paths, copy, verifier_backend="cpu")))
    return tuple(out)


@pytest.mark.parametrize("case", ["matching", "other", "fresh"])
def test_provenance_decision_matches_jax(tmp_path, monkeypatch, case):
    """A store written under committee A is kept under A, rejected and
    wiped under another committee, and wiped under HOTSTUFF_FRESH_STATE=1
    — the same decision in both packages."""
    ports = _os_ports(4)
    a = _committee(JAX, ports)
    seed = str(tmp_path / "seed-db")
    store = JAX.store.Store(seed)
    store.engine.put(b"marker", b"kept")
    store.engine.put(_mod(JAX, "node.node").COMMITTEE_HASH_KEY, _mod(JAX, "node.node").committee_hash(a))
    store.close()
    committee = a
    if case == "other":  # node 0 keeps its key and address; member 3 moved
        committee = _committee(JAX, ports[:3] + [ports[3] + 1])
    if case == "fresh":
        monkeypatch.setenv("HOTSTUFF_FRESH_STATE", "1")
    else:
        monkeypatch.delenv("HOTSTUFF_FRESH_STATE", raising=False)
    paths = _write_node_files(JAX, tmp_path, committee)
    jax, port = _boot_both(tmp_path, paths, seed)
    assert port == jax
    assert port["marker"] == (b"kept" if case == "matching" else None)
    assert port["committee_hash"] == _mod(PORT, "node.node").committee_hash(committee)


def _links_store(side, tmp_path, ports, case) -> str:
    """A store under the epoch-1 committee carrying the persisted
    schedule links of ``case``: a certified epoch change that admits
    member 4 and retires member 3 (``valid``), undecodable bytes
    (``corrupt``), or a link whose QC certifies another block
    (``uncertified``)."""
    ks = _keys(side)
    reconfig = _mod(side, "consensus.reconfig")
    op = reconfig.ReconfigOp(
        new_committee=_committee(side, ports, (0, 1, 2, 4), epoch=2), margin=4, sponsor=ks[0][0]
    )
    op.signature = side.crypto.Signature.new(side.crypto.Digest(op.digest()), ks[0][1])

    def block(author):
        b = side.consensus.Block(qc=side.consensus.QC.genesis(), author=author[0], round=6, reconfig=op)
        b.signature = side.crypto.Signature.new(b.digest(), author[1])
        return b

    certified = block(ks[1])
    qc_of = block(ks[2]) if case == "uncertified" else certified
    vote_digest = side.consensus.Vote.for_block(qc_of, ks[0][0]).digest()
    qc = side.consensus.QC(hash=qc_of.digest(), round=6,
                           votes=[(pk, side.crypto.Signature.new(vote_digest, sk)) for pk, sk in ks[:3]])
    enc = side.utils_codec.Encoder()
    qc.encode(enc)
    raw = (b"\x07corrupt" if case == "corrupt"
           else side.wire.encode_schedule_links([(certified.serialize(), enc.finish())]))
    path = str(tmp_path / "seed-db")
    store = side.store.Store(path)
    store.engine.put(side.core.SCHEDULE_LINKS_KEY, raw)
    store.engine.put(_mod(side, "node.node").COMMITTEE_HASH_KEY,
                     _mod(side, "node.node").committee_hash(_committee(side, ports)))
    store.close()
    return path


@pytest.mark.parametrize("case", ["valid", "corrupt", "uncertified"])
def test_schedule_link_replay_matches_jax(tmp_path, case):
    """Both packages replay a store's certified links into the same
    schedule, and both ignore a corrupt or uncertified link (the node
    boots on its genesis schedule)."""
    ports = _os_ports(5)
    seed = _links_store(JAX, tmp_path, ports, case)
    paths = _write_node_files(JAX, tmp_path, _committee(JAX, ports))
    jax, port = _boot_both(tmp_path, paths, seed)
    assert port["schedule"] == jax["schedule"]
    entries = port["schedule"]["schedule"]
    assert len(entries) == (2 if case == "valid" else 1)


async def _capture_reconfig(side, args, servers) -> list:
    """Frames each capture server got from ``side``'s reconfig CLI."""
    await _mod(side, "node.main")._submit_reconfig(args)
    frames = []
    for got in servers:
        deadline = time.monotonic() + 5.0
        while not got and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        frames.append(list(got))
        got.clear()
    return frames


def test_reconfig_frame_matches_jax(tmp_path, monkeypatch):
    """``_submit_reconfig`` of both packages sends every current member
    the same signed frame, byte for byte (Ed25519 signatures are
    deterministic)."""
    from hotstuff_tpu_torch.network.framing import read_frame

    monkeypatch.delenv("HOTSTUFF_RECONFIG_MARGIN", raising=False)

    async def run():
        inboxes = [[] for _ in range(4)]
        servers = []

        def handler(inbox):
            async def on_conn(reader, writer):
                try:
                    while True:
                        inbox.append(await read_frame(reader))
                except (asyncio.IncompleteReadError, ConnectionError):
                    pass
                finally:
                    writer.close()
            return on_conn

        try:
            for inbox in inboxes:
                servers.append(await asyncio.start_server(handler(inbox), "127.0.0.1", 0))
            ports = [s.sockets[0].getsockname()[1] for s in servers] + [1]
            key, committee, _ = _write_node_files(JAX, tmp_path, _committee(JAX, ports), key_index=1)
            new = str(tmp_path / "next.json")
            _mod(JAX, "node.config").write_committee(_committee(JAX, ports, (0, 1, 2, 4)), new)
            args = SimpleNamespace(keys=key, committee=committee, new_committee=new,
                                   margin=None, epoch=None, linger=0.2)
            jax = await _capture_reconfig(JAX, args, inboxes)
            port = await _capture_reconfig(PORT, args, inboxes)
        finally:
            for s in servers:
                s.close()
                await s.wait_closed()
        return jax, port

    jax, port = asyncio.run(run())
    assert port == jax
    assert all(len(frames) == 1 for frames in port)
    op = PORT.wire.decode_message(port[0][0])[1]
    assert op.new_committee.epoch == 2 and op.margin == 8


def test_node_new_boots_on_the_cuda_verifiers_plain_versions(tmp_path, monkeypatch, caplog):
    """``verifier_backend="cuda"`` with ``device="cpu"`` warms the
    kernels' plain versions and boots; the default ``"cuda"`` without a
    CUDA device raises before the store is opened."""
    import torch

    from hotstuff_tpu_torch.node.node import LazyDeviceVerifier, Node

    paths = _write_node_files(PORT, tmp_path, _committee(PORT, _os_ports(4)))
    monkeypatch.setenv("HOTSTUFF_COLOCATED_NODES", "2")  # warm a 10-signature wave
    monkeypatch.delenv("HOTSTUFF_SKIP_WARMUP", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def run():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await Node.new(paths[1], paths[0], str(tmp_path / "db-default"), paths[2])
        assert not os.path.exists(tmp_path / "db-default")
        node = await Node.new(paths[1], paths[0], str(tmp_path / "db"), paths[2],
                              bind_host="127.0.0.1", device="cpu")
        try:
            verifier = node.consensus.core.verifier
            assert isinstance(verifier, LazyDeviceVerifier)
            assert verifier.device.type == "cpu" and verifier.device_ready
            assert node.consensus.core.averifier.device
        finally:
            await node.shutdown()

    with caplog.at_level(logging.INFO, logger="hotstuff_tpu_torch.node.node"):
        asyncio.run(run())
    assert "successfully booted" in caplog.text


# ---- a port node process killed and restarted ---------------------------------

RE_COMMIT = re.compile(r"Committed block (\d+) -> (\S+)")
RE_RECOVER = re.compile(r"Recovered consensus state at round (\d+)")
RE_STATE_ROOT = re.compile(r"State root (\d+) -> (\S+) \(round (\d+)\)")
RE_ADOPTED = re.compile(r"Adopted state snapshot version (\d+) at round (\d+)")
RE_CURSOR = re.compile(r"State sync advanced commit cursor (\d+) -> (\d+) \(history replay skipped\)")


def spawn_port_node(tmp_path, i, extra_env=None) -> subprocess.Popen:
    """``python -m hotstuff_tpu_torch.node run --verifier cpu`` for key
    ``i``, appending to ``node_<i>.log``."""
    log = open(tmp_path / f"node_{i}.log", "a")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.node", "-vv", "run", "--verifier", "cpu",
             "--keys", str(tmp_path / f"key_{i}.json"), "--committee", str(tmp_path / "committee.json"),
             "--store", str(tmp_path / f"db_{i}"), "--parameters", str(tmp_path / "parameters.json")],
            stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": REPO, **(extra_env or {})},
        )
    finally:
        log.close()


def spawn_client(tmp_path, rate, duration, module="hotstuff_tpu_torch.node.client"):
    log = open(tmp_path / "client.log", "a")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", module, "--committee", str(tmp_path / "committee.json"),
             "--rate", str(rate), "--duration", str(duration), "--warmup", "1"],
            stdout=log, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": REPO},
        )
    finally:
        log.close()


def log_text(tmp_path, i) -> str:
    path = tmp_path / f"node_{i}.log"
    return path.read_text(errors="replace") if path.exists() else ""


def booted(tmp_path, i) -> bool:
    return "successfully booted" in log_text(tmp_path, i)


def commits(tmp_path, i) -> list:
    return [(int(r), d) for r, d in RE_COMMIT.findall(log_text(tmp_path, i)) if int(r) > 0]


def wait_for(predicate, deadline_s: float) -> bool:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.2)
    return False


def stop_all(procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.terminate()
    for p in procs:
        if p is None:
            continue
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def write_port_committee(tmp_path, n=4, timeout_delay=300, sync_retry_delay=300):
    """n fresh key files, a committee on OS-assigned ports and short
    timers (a 4-node committee on the CPU runs ~100 rounds a second)."""
    from hotstuff_tpu_torch.consensus import Committee, Parameters
    from hotstuff_tpu_torch.node.config import Secret, write_committee, write_parameters

    keys = [Secret.new() for _ in range(n)]
    committee = Committee.new([(s.name, 1, ("127.0.0.1", p)) for s, p in zip(keys, _os_ports(n))])
    write_committee(committee, str(tmp_path / "committee.json"))
    write_parameters(Parameters(timeout_delay=timeout_delay, sync_retry_delay=sync_retry_delay),
                     str(tmp_path / "parameters.json"))
    for i, s in enumerate(keys):
        s.write(str(tmp_path / f"key_{i}.json"))
    return committee


def test_sigkill_port_node_rejoins_from_a_snapshot(tmp_path):
    """The counterpart of tests/test_crash_rejoin_e2e.py on four port
    ``run`` processes and the port client: node 3 is SIGKILLed, the
    survivors commit on, and node 3 restarted on its store recovers its
    round state, adopts a peer's snapshot, commits again, and agrees with
    the others on every committed round and every state root."""
    from benchmark.invariants import check_state_root_agreement

    write_port_committee(tmp_path)
    procs = {}
    client = None
    try:
        for i in range(4):
            procs[i] = spawn_port_node(tmp_path, i)
        # the client gives a node 15 s to come up: start it once all have
        assert wait_for(lambda: all(booted(tmp_path, i) for i in range(4)), 60)
        client = spawn_client(tmp_path, rate=200, duration=120)
        assert wait_for(lambda: len(commits(tmp_path, 3)) >= 5, 30), "no commits before the crash"
        procs[3].send_signal(signal.SIGKILL)
        procs[3].wait(timeout=10)
        base0 = len(commits(tmp_path, 0))
        assert wait_for(lambda: len(commits(tmp_path, 0)) >= base0 + 10, 30), "survivors stalled"
        base3 = len(commits(tmp_path, 3))
        procs[3] = spawn_port_node(tmp_path, 3, {"HOTSTUFF_STATE_SYNC_LAG": "2"})
        assert wait_for(lambda: len(commits(tmp_path, 3)) >= base3 + 5, 40), "node 3 never committed again"
    finally:
        stop_all([client, *procs.values()])
    log3 = log_text(tmp_path, 3)
    recovered = RE_RECOVER.findall(log3)
    assert recovered and int(recovered[-1]) >= 1
    adopted = RE_ADOPTED.findall(log3)
    assert adopted, "the rejoin did not adopt a snapshot"
    cursor = RE_CURSOR.findall(log3)
    assert cursor and int(cursor[-1][1]) > int(cursor[-1][0])
    c0, c3 = dict(commits(tmp_path, 0)), dict(commits(tmp_path, 3))
    common = set(c0) & set(c3)
    assert common and all(c0[r] == c3[r] for r in common)
    roots = {f"node-{i}": [(int(v), root, int(r)) for v, root, r in RE_STATE_ROOT.findall(log_text(tmp_path, i))]
             for i in range(4)}
    ok, violations, details = check_state_root_agreement(roots)
    assert ok is True, violations
    assert details["nodes_reporting"] == 4
    assert [v for v, _, _ in roots["node-3"] if v > int(adopted[-1][0])], "no roots applied after the snapshot"
    assert "Traceback" not in "".join(log_text(tmp_path, i) for i in range(4))
