"""The port's node CLI (``python -m hotstuff_tpu_torch.node``) and its
producer client (``python -m hotstuff_tpu_torch.node.client``), driven
as an operator drives them: ``keys``; ``run`` defaulting to the CUDA verifier with no
quiet CPU fallback; the wave service's stats line against the harness's
regex and the JAX package's line; a ``run-many`` committee fed by the
client, whose logs ``benchmark.logs.LogParser`` reads; ``deploy``; and
a port node joining a committee of JAX nodes through a reconfiguration
submitted with the port's ``reconfig`` command; the client's
digest-only mode (``--size 0``) against a port committee; the
adversary plane (``--adversary`` and ``HOTSTUFF_ADVERSARY``) accepted
by ``run``, ``run-many`` and ``deploy`` on both transports, and armed by
``Consensus.spawn`` exactly where the JAX package's arms it; the chaos plane (``--fault-plane`` and
``HOTSTUFF_FAULTS``) accepted by ``run``, ``run-many`` and ``deploy``
and by ``Consensus.spawn``, and an unreadable spec raising at boot;
and ``HOTSTUFF_WAN_SPEC``
accepted by ``run``, ``run-many`` and ``deploy`` (the WAN model on
asyncio, nothing on native) and by ``Consensus.spawn``.

Every listener port comes from the OS; every wait has a deadline;
every process is stopped in ``finally``."""

import asyncio
import json
import logging
import os
import re
import signal
import socket
import stat
import subprocess
import sys
import time
from unittest import mock

import pytest

from .test_torch_node import (
    REPO,
    RE_STATE_ROOT,
    _os_ports,
    booted,
    commits,
    log_text,
    spawn_client,
    spawn_port_node,
    stop_all,
    wait_for,
    write_port_committee,
)

CLI = [sys.executable, "-m", "hotstuff_tpu_torch.node"]
ENV = {**os.environ, "PYTHONPATH": REPO}


def test_keys_writes_a_private_key_file_both_packages_read(tmp_path):
    from hotstuff_tpu.node.config import Secret as JaxSecret
    from hotstuff_tpu_torch.node.config import Secret

    path = str(tmp_path / "node.json")
    subprocess.run(CLI + ["keys", "--filename", path], env=ENV, check=True, timeout=60)
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    mine, theirs = Secret.read(path), JaxSecret.read(path)
    assert mine.name.to_bytes() == theirs.name.to_bytes()
    assert mine.secret.to_bytes() == theirs.secret.to_bytes() and mine.scheme == "ed25519"


class _Booted(Exception):
    """Raised by the stand-in ``Node.new``: the command got to booting."""


BOOT_ARGV = {
    "run": ["--keys", "key_0.json", "--committee", "committee.json", "--store", "db_0"],
    "run-many": ["--keys", "key_0.json,key_1.json", "--committee", "committee.json",
                 "--store-prefix", "db_"],
    "deploy": ["--nodes", "4", "--base-port", "0"],
}


@pytest.mark.parametrize("command, how", [
    ("run", "flag"), ("run", "env"), ("run-many", "flag"), ("run-many", "env"),
    ("deploy", "flag"), ("deploy", "env"),
])
def test_the_adversary_knob_reaches_the_boot(tmp_path, monkeypatch, command, how):
    """``--adversary SPEC`` (it exited 2 while the plane was not ported)
    and ``HOTSTUFF_ADVERSARY=SPEC`` get every command to its boot with
    the knob set to the spec, where ``Consensus.spawn`` reads it; the
    flag wins over a knob already set.  ``Node.new`` is a stand-in that
    records what the boot saw and stops the command."""
    from hotstuff_tpu_torch.node import main as cli

    seen = []

    class _Node:
        @classmethod
        async def new(cls, **kw):
            seen.append((kw["transport"], os.environ.get("HOTSTUFF_ADVERSARY")))
            raise _Booted

    monkeypatch.setattr(cli, "Node", _Node)
    monkeypatch.setattr(cli, "setup_logging", lambda verbosity: None)
    monkeypatch.chdir(tmp_path)  # deploy writes its files here
    write_port_committee(tmp_path)
    argv = [command, "--verifier", "cpu", "--transport", "native", *BOOT_ARGV[command]]
    before = dict(os.environ)
    with mock.patch.dict(os.environ):
        for knob in ("HOTSTUFF_ADVERSARY", "HOTSTUFF_COLOCATED_NODES", "HOTSTUFF_MAX_PEER_CONNS"):
            os.environ.pop(knob, None)
        if how == "flag":
            os.environ["HOTSTUFF_ADVERSARY"] = "overridden.json"
            argv += ["--adversary", "spec.json"]
        else:
            os.environ["HOTSTUFF_ADVERSARY"] = "spec.json"
        with pytest.raises(_Booted):
            cli.main(argv)
    assert seen == [("native", "spec.json")]
    assert dict(os.environ) == before


@pytest.mark.parametrize("command", ["run", "run-many", "deploy"])
def test_mesh_devices_is_accepted_and_sizes_the_mesh(tmp_path, monkeypatch, command):
    """``--mesh-devices 2`` with ``--verifier mesh`` boots (no exit 2)
    and sets HOTSTUFF_MESH_DEVICES=2 before the first node is built,
    where the sharded verifier reads it.  ``Node.new`` is a stand-in
    that records what the boot saw and stops the command."""
    from hotstuff_tpu_torch.node import main as cli

    seen = []

    class _Node:
        @classmethod
        async def new(cls, **kw):
            seen.append((kw["verifier_backend"], os.environ.get("HOTSTUFF_MESH_DEVICES")))
            raise _Booted

    monkeypatch.setattr(cli, "Node", _Node)
    monkeypatch.setattr(cli, "setup_logging", lambda verbosity: None)
    monkeypatch.chdir(tmp_path)  # deploy writes its files here
    write_port_committee(tmp_path)
    required = {
        "run": ["--keys", "key_0.json", "--committee", "committee.json", "--store", "db_0"],
        "run-many": ["--keys", "key_0.json,key_1.json", "--committee", "committee.json",
                     "--store-prefix", "db_"],
        "deploy": ["--nodes", "4", "--base-port", "0"],
    }[command]
    # the command writes its knobs into os.environ: restore all of it after
    before = dict(os.environ)
    with mock.patch.dict(os.environ):
        for knob in ("HOTSTUFF_MESH_DEVICES", "HOTSTUFF_COLOCATED_NODES", "HOTSTUFF_MAX_PEER_CONNS"):
            os.environ.pop(knob, None)
        with pytest.raises(_Booted):
            cli.main([command, "--verifier", "mesh", "--mesh-devices", "2", *required])
    assert seen == [("mesh", "2")]
    assert dict(os.environ) == before


def test_run_defaults_to_the_cuda_verifier_and_never_falls_back(tmp_path):
    """Without a CUDA device ``run`` (``--verifier cuda`` by default)
    stops with an error before any node boots."""
    write_port_committee(tmp_path)
    out = subprocess.run(
        CLI + ["run", "--keys", str(tmp_path / "key_0.json"), "--committee",
               str(tmp_path / "committee.json"), "--store", str(tmp_path / "db_0")],
        env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "successfully booted" not in out.stderr
    assert not (tmp_path / "db_0").exists()


def test_stats_line_matches_the_harness_and_the_jax_line(caplog):
    """``stats_line()`` holds the JAX fields in the JAX order, so
    ``benchmark.logs.RE_VERIFY_STATS`` reads every one of them (it did
    not before: the port's own fields sat between ``depth=`` and
    ``agg=``, and ``mesh=``, ``zc=`` and ``fb=`` were missing)."""
    from benchmark.logs import RE_VERIFY_STATS
    from hotstuff_tpu.crypto import async_service as jax_service
    from hotstuff_tpu_torch.crypto.async_service import AsyncVerifyService

    counters = {
        "dispatches": 17, "device_dispatches": 11, "cpu_dispatches": 5, "probe_dispatches": 1,
        "device_sigs": 704, "cpu_sigs": 160, "deadline_misses": 2, "pipeline_waits": 3,
        "agg_claims": 0, "agg_sigs": 0, "_device_ewma_s": 0.00437,
    }
    port = AsyncVerifyService(object(), device=True, pipeline_depth=2)
    jax = jax_service.AsyncVerifyService(object(), device=True, pipeline_depth=2)
    for svc in (port, jax):
        for name, value in counters.items():
            setattr(svc, name, value)
    port.peak_inflight, port.packed_waves, port.pad_sigs = 2, 9, 321
    line = port.stats_line()
    m = RE_VERIFY_STATS.search(line)
    assert m is not None
    (tag, disp, dev, cpu, probe, dsig, csig, miss, waits, depth, mesh, agg, agg_sigs,
     ewma, zc, fb) = m.groups()
    assert tag == port._stats_tag
    assert [disp, dev, cpu, probe, dsig, csig, miss, waits, depth] == [
        "17", "11", "5", "1", "704", "160", "2", "3", "2"]
    assert (mesh, agg, agg_sigs, ewma, zc, fb) == ("0", "0", "0", "4.4", "0", "0")
    assert line.endswith(" peak_inflight=2 packed=9 pad_sigs=321")
    with caplog.at_level(logging.INFO, logger=jax_service.__name__):
        jax._log_stats()
    jax_line = next(r.getMessage() for r in caplog.records if "Verify service stats" in r.getMessage())
    untagged = lambda s: re.sub(r"\[\S+\]", "[tag]", s)  # noqa: E731
    assert untagged(line).startswith(untagged(jax_line) + " ")


def test_run_many_with_the_client_reads_through_the_harness_parser(tmp_path):
    """A 4-node ``run-many`` on the ``cuda`` verifier host with
    ``--device cpu`` and the port client, as two processes: the
    harness's ``LogParser`` reads commits, payloads a second, sample
    latency and the wave service's stats line from their logs, and
    SIGTERM stops the nodes cleanly."""
    from benchmark.logs import RE_VERIFY_STATS, LogParser

    write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
    keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
    log = open(tmp_path / "nodes.log", "w")
    # no warm-up: the device host never turns ready, so the wave service
    # serves every wave on the CPU (the plain versions' warm-up would
    # take seconds) and still logs its stats line
    env = {**ENV, "HOTSTUFF_SKIP_WARMUP": "1"}
    nodes = client = None
    try:
        nodes = subprocess.Popen(
            CLI + ["-vv", "run-many", "--device", "cpu", "--keys", keys, "--committee",
                   str(tmp_path / "committee.json"), "--store-prefix", str(tmp_path / "db_"),
                   "--parameters", str(tmp_path / "parameters.json")],
            stdout=log, stderr=subprocess.STDOUT, env=env,
        )
        assert wait_for(lambda: (tmp_path / "nodes.log").read_text().count("successfully booted") == 4, 60)
        client = spawn_client(tmp_path, rate=400, duration=3)
        assert client.wait(timeout=60) == 0
        assert nodes.poll() is None
        nodes.send_signal(signal.SIGTERM)
        assert nodes.wait(timeout=30) == 0
    finally:
        stop_all([client, nodes])
        log.close()
    node_log = (tmp_path / "nodes.log").read_text()
    client_log = (tmp_path / "client.log").read_text()
    assert "Traceback" not in node_log + client_log
    assert node_log.count("successfully booted") == 4
    parser = LogParser([node_log], [client_log])
    assert parser.committed_payloads() > 0
    assert parser.consensus_throughput()[0] > 0 and parser.end_to_end_throughput()[0] > 0
    assert parser.end_to_end_latency() is not None
    assert parser.timeout_delay == 1_000 and parser.input_rate == 400 and parser.tx_size == 512
    stats = RE_VERIFY_STATS.findall(node_log)
    assert stats and stats[-1][0].startswith("cuda@cpu#")
    assert int(stats[-1][1]) == parser.route_waves["cpu"] + parser.route_waves["device"]
    assert "Kernel launches: dual_scalar_mult=0 verify_compressed=0" in node_log


def _free_run(n: int) -> int:
    """A base port with ``n`` consecutive free ports after it."""
    for _ in range(50):
        (base,) = _os_ports(1)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no run of free ports")


def test_deploy_boots_a_local_testbed(tmp_path):
    base = _free_run(4)
    log = open(tmp_path / "deploy.log", "w")
    proc = None
    try:
        proc = subprocess.Popen(
            CLI + ["-vv", "deploy", "--nodes", "4", "--base-port", str(base), "--verifier", "cpu"],
            stdout=log, stderr=subprocess.STDOUT, env=ENV, cwd=tmp_path,
        )
        assert wait_for(lambda: "Deployed 4-node local testbed" in (tmp_path / "deploy.log").read_text(), 60)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        stop_all([proc])
        log.close()
    text = (tmp_path / "deploy.log").read_text()
    assert text.count("successfully booted") == 4 and "Traceback" not in text
    assert (tmp_path / ".committee.json").exists() and (tmp_path / ".node_3.json").exists()


def _write_bls_committee(tmp_path, n=4, timeout_delay=1_000):
    """n BLS key files (``Secret.new("bls")``, each with its proof of
    possession), the committee file carrying the proofs, on OS-assigned
    ports, and a parameters file."""
    from hotstuff_tpu_torch.consensus import Committee, Parameters
    from hotstuff_tpu_torch.node.config import Secret, write_committee, write_parameters

    keys = [Secret.new("bls") for _ in range(n)]
    committee = Committee.new(
        [(s.name, 1, ("127.0.0.1", p)) for s, p in zip(keys, _os_ports(n))],
        scheme="bls", pops={s.name: s.pop for s in keys},
    )
    write_committee(committee, str(tmp_path / "committee.json"))
    write_parameters(Parameters(timeout_delay=timeout_delay, sync_retry_delay=timeout_delay),
                     str(tmp_path / "parameters.json"))
    for i, s in enumerate(keys):
        s.write(str(tmp_path / f"key_{i}.json"))
    return [str(tmp_path / f"key_{i}.json") for i in range(n)]


def _check_bls_files(committee_file, key_files):
    """The JAX package reads the port's BLS files to the same keys, and
    its committee passes the proof-of-possession check."""
    import json

    from hotstuff_tpu.consensus.config import Committee as JaxCommittee
    from hotstuff_tpu.node.config import Secret as JaxSecret, read_committee as jax_read
    from hotstuff_tpu_torch.node.config import Secret, read_committee

    committee = jax_read(committee_file)
    committee = committee if isinstance(committee, JaxCommittee) else committee.committees()[0]
    assert committee.scheme == "bls" and read_committee(committee_file).scheme == "bls"
    committee.verify_pops()
    names = set()
    for path in key_files:
        mine, theirs = Secret.read(path), JaxSecret.read(path)
        assert (mine.scheme, theirs.scheme) == ("bls", "bls") and mine.pop == theirs.pop
        assert mine.name.to_bytes() == theirs.name.to_bytes()
        assert mine.secret.to_bytes() == theirs.secret.to_bytes()
        assert committee.authorities[theirs.name].pop == theirs.pop
        names.add(theirs.name)
        with open(path) as f:
            assert set(json.load(f)) == {"name", "secret", "scheme", "pop"}
    assert names == set(committee.authorities)


@pytest.mark.parametrize("command", ["keys", "deploy", "run-many"])
def test_bls_scheme_runs_from_the_cli(tmp_path, command):
    """``--scheme bls`` from the command line: ``keys`` writes a BLS key
    file as the JAX package's ``Secret.new("bls")`` does (its proof of
    possession included); ``deploy --scheme bls`` writes a committee the
    JAX package reads and accepts, and boots it; ``run-many`` on BLS key
    and committee files (the files decide the scheme, as in the JAX
    package) commits compact QCs under the client, read by the harness's
    parser."""
    from hotstuff_tpu.node.config import Secret as JaxSecret

    if command == "keys":
        path = str(tmp_path / "node.json")
        subprocess.run(CLI + ["keys", "--scheme", "bls", "--filename", path], env=ENV, check=True, timeout=60)
        assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
        theirs = str(tmp_path / "jax.json")
        JaxSecret.new("bls").write(theirs)
        import json

        with open(path) as mine, open(theirs) as ref:
            assert set(json.load(mine)) == set(json.load(ref))
        from hotstuff_tpu.consensus.config import Committee as JaxCommittee
        from hotstuff_tpu.node.config import write_committee as jax_write

        secret = JaxSecret.read(path)
        jax_write(JaxCommittee.new([(secret.name, 1, ("127.0.0.1", 1))], scheme="bls",
                                   pops={secret.name: secret.pop}), str(tmp_path / "committee.json"))
        _check_bls_files(str(tmp_path / "committee.json"), [path])
        return
    log_path = tmp_path / f"{command}.log"
    log = open(log_path, "w")
    procs = []
    try:
        if command == "deploy":
            base = _free_run(4)
            procs.append(subprocess.Popen(
                CLI + ["-vv", "deploy", "--scheme", "bls", "--nodes", "4", "--base-port", str(base),
                       "--verifier", "cpu"],
                stdout=log, stderr=subprocess.STDOUT, env=ENV, cwd=tmp_path,
            ))
            assert wait_for(lambda: "Deployed 4-node local testbed" in log_path.read_text(), 120)
        else:
            keys = _write_bls_committee(tmp_path)
            common = ["--keys", ",".join(keys), "--committee", str(tmp_path / "committee.json"),
                      "--store-prefix", str(tmp_path / "db_"), "--parameters",
                      str(tmp_path / "parameters.json"), "--verifier", "cpu"]
            procs.append(subprocess.Popen(
                CLI + ["-vv", "run-many", "--metrics-port", "0", *common],
                stdout=log, stderr=subprocess.STDOUT, env=ENV,
            ))
            assert wait_for(lambda: log_path.read_text().count("successfully booted") == 4, 120)
            procs.append(spawn_client(tmp_path, rate=200, duration=3))
            assert procs[1].wait(timeout=60) == 0
            # every node's telemetry snapshot (one each 5 s) after the load
            # carries its compact-QC counter
            seen = log_path.read_text().count("Telemetry snapshot")
            assert wait_for(lambda: log_path.read_text().count("Telemetry snapshot") >= seen + 4, 60)
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=30) == 0
    finally:
        stop_all(procs)
        log.close()
    text = log_path.read_text()
    assert text.count("successfully booted") == 4 and "Traceback" not in text
    if command == "deploy":
        _check_bls_files(str(tmp_path / ".committee.json"),
                         [str(tmp_path / f".node_{i}.json") for i in range(4)])
        return
    from benchmark.logs import LogParser

    _check_bls_files(str(tmp_path / "committee.json"), keys)
    parser = LogParser([text], [(tmp_path / "client.log").read_text()])
    assert parser.committed_payloads() > 0
    assert parser.compact_qcs > 0


RE_EPOCH = re.compile(r"Epoch (\d+) activated at round (\d+)")


def _epoch2(tmp_path, i):
    return [int(r) for e, r in RE_EPOCH.findall(log_text(tmp_path, i)) if e == "2"]


def test_port_node_joins_a_jax_committee_through_the_port_reconfig_cli(tmp_path):
    """Four JAX ``run`` processes commit; the port's ``reconfig`` command
    admits a fifth key; a port node booted in join mode against the
    genesis committee file adopts the certified schedule, and every node
    logs ``Epoch 2 activated at round R`` with one R.  The joiner then
    commits past R, on the same chain and state roots as the JAX nodes."""
    from benchmark.invariants import check_state_root_agreement
    from hotstuff_tpu_torch.consensus import Committee
    from hotstuff_tpu_torch.node.config import Secret, write_committee

    genesis = write_port_committee(tmp_path, n=4, timeout_delay=500, sync_retry_delay=500)
    (join_port,) = _os_ports(1)
    joiner = Secret.new()
    joiner.write(str(tmp_path / "key_4.json"))
    members = [(pk, 1, genesis.address(pk)) for pk in genesis.authorities]
    write_committee(Committee.new(members + [(joiner.name, 1, ("127.0.0.1", join_port))]),
                    str(tmp_path / "next.json"))
    procs = {}
    client = None
    try:
        for i in range(4):
            log = open(tmp_path / f"node_{i}.log", "a")
            procs[i] = subprocess.Popen(
                [sys.executable, "-m", "hotstuff_tpu.node", "-vv", "run", "--keys",
                 str(tmp_path / f"key_{i}.json"), "--committee", str(tmp_path / "committee.json"),
                 "--store", str(tmp_path / f"db_{i}"), "--parameters", str(tmp_path / "parameters.json")],
                stdout=log, stderr=subprocess.STDOUT, env=ENV,
            )
            log.close()
        assert wait_for(lambda: all(booted(tmp_path, i) for i in range(4)), 60)
        client = spawn_client(tmp_path, rate=200, duration=120)
        assert wait_for(lambda: len(commits(tmp_path, 0)) >= 5, 40), "the JAX committee never committed"
        submit = subprocess.run(
            CLI + ["-vv", "reconfig", "--keys", str(tmp_path / "key_1.json"), "--committee",
                   str(tmp_path / "committee.json"), "--new-committee", str(tmp_path / "next.json"),
                   "--linger", "0.5"],
            env=ENV, capture_output=True, text=True, timeout=60,
        )
        assert submit.returncode == 0, submit.stderr
        assert wait_for(lambda: all(_epoch2(tmp_path, i) for i in range(4)), 40), "epoch 2 never activated"
        procs[4] = spawn_port_node(tmp_path, 4, {"HOTSTUFF_RECONFIG_LISTEN": f"127.0.0.1:{join_port}"})
        # the joiner crosses the boundary and commits blocks past it
        assert wait_for(
            lambda: _epoch2(tmp_path, 4)
            and sum(r > _epoch2(tmp_path, 4)[0] for r, _ in commits(tmp_path, 4)) >= 5,
            60,
        ), "the joiner never committed in epoch 2"
    finally:
        stop_all([client, *procs.values()])
    log4 = log_text(tmp_path, 4)
    assert "Join mode: key not in the committee yet" in log4
    assert "Verified schedule link: epoch 2 activates at round" in log4
    activations = {i: _epoch2(tmp_path, i) for i in range(5)}
    assert len({r for rs in activations.values() for r in rs}) == 1, activations
    chains = [dict(commits(tmp_path, i)) for i in range(5)]
    for chain in chains[:4]:
        common = set(chain) & set(chains[4])
        assert common and all(chain[r] == chains[4][r] for r in common)
    roots = {f"node-{i}": [(int(v), root, int(r)) for v, root, r in RE_STATE_ROOT.findall(log_text(tmp_path, i))]
             for i in range(5)}
    ok, violations, details = check_state_root_agreement(roots)
    assert ok is True, violations
    assert details["nodes_reporting"] == 5
    assert "Traceback" not in "".join(log_text(tmp_path, i) for i in range(5))


@pytest.mark.parametrize("limits, want", [
    ((1024, "infinity"), [(50_000, "infinity")]),  # never lower an unlimited hard cap
    ((1024, 4096), [(50_000, 50_000)]),  # raise a finite hard cap below the target
    ((60_000, 60_000), []),  # enough already: untouched
], ids=["infinite-hard-cap", "finite-hard-cap", "enough"])
def test_raise_fd_limit(monkeypatch, limits, want):
    """The counterparts of tests/test_telemetry.py's fd-limit tests on
    the port's ``_raise_fd_limit``."""
    import resource

    from hotstuff_tpu_torch.node.main import _raise_fd_limit

    inf = lambda v: resource.RLIM_INFINITY if v == "infinity" else v  # noqa: E731
    calls = []
    monkeypatch.setattr(resource, "getrlimit", lambda res: tuple(map(inf, limits)))
    monkeypatch.setattr(resource, "setrlimit", lambda res, lim: calls.append(lim))
    _raise_fd_limit(50_000)
    assert calls == [tuple(map(inf, c)) for c in want]


def test_gc_gen2_stretch_knob_and_undo(monkeypatch):
    import gc

    from hotstuff_tpu_torch.node.main import _freeze_boot_objects

    before = gc.get_threshold()
    monkeypatch.setenv("HOTSTUFF_GC_GEN2_PERIOD", "0")  # no sweeper task
    try:
        monkeypatch.setenv("HOTSTUFF_GC_GEN2_STRETCH", "0")
        _freeze_boot_objects()()
        assert gc.get_threshold() == before  # opt-out keeps the defaults
        monkeypatch.setenv("HOTSTUFF_GC_GEN2_STRETCH", "1")
        undo = _freeze_boot_objects()
        assert gc.get_threshold() == (before[0], before[1], 500)
        undo()
        assert gc.get_threshold() == before
    finally:
        gc.set_threshold(*before)
        gc.unfreeze()


# ---- the two repairs: Digest.random at --size 0, the env knobs ------------


def test_client_at_size_0_runs_against_a_port_committee(tmp_path):
    """``--size 0`` is the client's digest-only mode: every transaction
    is a ``Digest.random()`` with no body.  The client used to die on its
    first transaction (the port's ``Digest`` had no ``random``); now
    ``LogParser`` reads its sample lines and the nodes' commits of them."""
    from benchmark.logs import LogParser

    write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
    keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
    log = open(tmp_path / "nodes.log", "w")
    client_log = open(tmp_path / "client.log", "w")
    nodes = client = None
    try:
        nodes = subprocess.Popen(
            CLI + ["-vv", "run-many", "--verifier", "cpu", "--keys", keys, "--committee",
                   str(tmp_path / "committee.json"), "--store-prefix", str(tmp_path / "db_"),
                   "--parameters", str(tmp_path / "parameters.json")],
            stdout=log, stderr=subprocess.STDOUT, env=ENV,
        )
        assert wait_for(lambda: (tmp_path / "nodes.log").read_text().count("successfully booted") == 4, 60)
        client = subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.node.client", "--committee",
             str(tmp_path / "committee.json"), "--rate", "300", "--size", "0", "--duration", "3",
             "--warmup", "1"],
            stdout=client_log, stderr=subprocess.STDOUT, env=ENV,
        )
        assert client.wait(timeout=60) == 0
        assert nodes.poll() is None
        nodes.send_signal(signal.SIGTERM)
        assert nodes.wait(timeout=30) == 0
    finally:
        stop_all([client, nodes])
        log.close()
        client_log.close()
    node_text = (tmp_path / "nodes.log").read_text()
    client_text = (tmp_path / "client.log").read_text()
    assert "Traceback" not in node_text + client_text
    parser = LogParser([node_text], [client_text])
    assert parser.tx_size == 0 and parser.input_rate == 300
    samples = re.findall(r"Sending sample payload (\S+)", client_text)
    assert len(samples) >= 20 and len(set(samples)) == len(samples)
    assert parser.committed_payloads() > 0
    assert parser.end_to_end_latency() is not None
    assert "End-to-end BPS: n/a (digest-only payloads)" in parser.result()


ENV_PLANES = ("HOTSTUFF_FAULTS", "HOTSTUFF_ADVERSARY")
WAN = "HOTSTUFF_WAN_SPEC"
RE_COMMITTED = re.compile(r"Committed block (\d+) ->")
RE_REGION = re.compile(r"WAN emulation active: region (\S+)")


def _adversary_spec(tmp_path, addresses, rules, seed=3, extra=None) -> str:
    """An adversary spec over ``addresses`` (scenario index i: the i-th
    address), written as an operator writes one."""
    spec = {"name": "byz-cli", "seed": seed, "adversary": rules,
            "nodes": {f"{h}:{p}": i for i, (h, p) in enumerate(addresses)},
            "epoch_unix": time.time(), **(extra or {})}
    path = tmp_path / "adversary.json"
    path.write_text(json.dumps(spec))
    return str(path)


RE_ADVERSARY = re.compile(r"Adversary plane active: scenario '([^']+)' seed (\d+) \(node index (\d+), "
                          r"policies \[([^\]]*)\]\)")


def _spawn_tasks(side, committee, key, store_path, transport="asyncio") -> dict:
    """What one ``Consensus.spawn`` of ``side`` armed: its plane's index
    and policies (None when inert), whether the core, the proposer and
    the state-sync server share it, and its task names."""
    seen = {}

    async def body():
        store = side.store.Store(store_path)
        stack = None
        name, secret = key
        try:
            stack = await side.consensus.Consensus.spawn(
                name, committee, side.consensus.Parameters(), side.crypto.SignatureService(secret), store,
                asyncio.Queue(), bind_host="127.0.0.1", transport=transport,
            )
            plane = stack.core.adversary
            seen["plane"] = None if plane is None else (plane.self_id, sorted(r.policy for r in plane.my_rules))
            seen["shared"] = stack.proposer.adversary is plane and stack.state_server.adversary is plane
            seen["tasks"] = sorted(t.get_name() for t in stack._tasks if t.get_name().startswith("adversary"))
        finally:
            if stack is not None:
                await stack.shutdown()
            store.close()

    asyncio.run(body())
    return seen


SPAWN_CASES = {
    "no-knob": ({}, "asyncio"),
    "empty-knob": ({"HOTSTUFF_ADVERSARY": ""}, "asyncio"),
    "named": ({"HOTSTUFF_ADVERSARY": [{"policy": "withhold", "node": 0, "at": 3600}]}, "asyncio"),
    "named-native": ({"HOTSTUFF_ADVERSARY": [{"policy": "withhold", "node": 0, "at": 3600}]}, "native"),
    "not-named": ({"HOTSTUFF_ADVERSARY": [{"policy": "equivocate", "node": 2}]}, "asyncio"),
    "collude-flood": ({"HOTSTUFF_ADVERSARY": [{"policy": "collude", "nodes": [0, 1], "at": 3600},
                                              {"policy": "flood", "node": 0, "at": 3600}]}, "asyncio"),
    "adaptive": ({"HOTSTUFF_ADVERSARY": [{"policy": "timeout-surfer", "node": 0, "at": 3600}]}, "native"),
    "with-faults": ({"HOTSTUFF_ADVERSARY": [{"policy": "forge-qc", "node": 0, "at": 3600}],
                     "HOTSTUFF_FAULTS": True}, "asyncio"),
    "with-wan": ({"HOTSTUFF_ADVERSARY": [{"policy": "double-vote", "node": 0, "at": 3600}],
                  WAN: True}, "asyncio"),
}


@pytest.mark.parametrize("case", list(SPAWN_CASES))
def test_consensus_spawn_arms_the_plane_as_the_reference_does(tmp_path, monkeypatch, case):
    """``Consensus.spawn`` arms the adversary plane exactly where the JAX
    package's does (it raised on the knob while the plane was not
    ported): on a non-empty ``HOTSTUFF_ADVERSARY`` naming this node, on
    either transport, beside the chaos plane's or the WAN's spec; the
    core, the proposer and the state-sync server share the plane, and
    the ``adversary-clock`` task (and ``adversary-flood`` for a flood
    rule) runs.  The JAX stack is spawned on asyncio beside the port's
    on the same spec and committee."""
    from hotstuff_tpu_torch.bench.committee import reserve_ports

    from .test_torch_core import JAX, PORT

    env, transport = SPAWN_CASES[case]
    for other in ENV_PLANES + (WAN,):
        monkeypatch.delenv(other, raising=False)
    socks = reserve_ports(4)
    ports = [sk.getsockname()[1] for sk in socks]
    committee = PORT.committee(ports)
    addresses = [committee.address(k) for k in committee.sorted_keys()]
    for knob, value in env.items():
        if knob == "HOTSTUFF_ADVERSARY" and isinstance(value, list):
            value = _adversary_spec(tmp_path, addresses, value)
        elif knob == "HOTSTUFF_FAULTS":
            value = _fault_spec(tmp_path, addresses)
        elif knob == WAN:
            value = _wan_spec(tmp_path, addresses)
        monkeypatch.setenv(knob, value)
    me = next(i for i, k in enumerate(PORT.keys()) if committee.address(k[0]) == addresses[0])
    try:
        socks[0].close()
        port = _spawn_tasks(PORT, committee, PORT.keys()[me], str(tmp_path / "port_db"), transport)
        jax = _spawn_tasks(JAX, JAX.committee(ports), JAX.keys()[me], str(tmp_path / "jax_db"))
    finally:
        for sk in socks:
            sk.close()
    assert port == jax
    armed = case not in ("no-knob", "empty-knob", "not-named")
    assert (port["plane"] is not None) == armed and port["shared"]
    if armed:
        assert port["plane"][0] == 0
        assert port["tasks"] == (["adversary-clock", "adversary-flood"] if case == "collude-flood"
                                 else ["adversary-clock"])


def test_wan_spec_on_the_native_transport_still_boots(tmp_path):
    """The reference applies ``HOTSTUFF_WAN_SPEC`` on the asyncio
    transport only, so a native node with it set boots, as a JAX node
    does."""
    write_port_committee(tmp_path)
    log = open(tmp_path / "node_0.log", "w")
    proc = None
    try:
        proc = subprocess.Popen(
            CLI + ["-vv", "run", "--verifier", "cpu", "--transport", "native", "--keys",
                   str(tmp_path / "key_0.json"), "--committee", str(tmp_path / "committee.json"),
                   "--store", str(tmp_path / "db_0"), "--parameters", str(tmp_path / "parameters.json")],
            stdout=log, stderr=subprocess.STDOUT, env={**ENV, "HOTSTUFF_WAN_SPEC": '{"regions": []}'},
        )
        assert wait_for(lambda: booted(tmp_path, 0), 120)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        stop_all([proc])
        log.close()
    assert "Traceback" not in log_text(tmp_path, 0)


@pytest.mark.parametrize("knob, error, match", [
    ("HOTSTUFF_FAULTS", FileNotFoundError, "spec.json"),
    ("HOTSTUFF_ADVERSARY", FileNotFoundError, "spec.json"),
], ids=lambda v: v if isinstance(v, str) and v.startswith("HOTSTUFF") else "")
def test_consensus_spawn_and_run_committee_raise_on_the_knobs(tmp_path, monkeypatch, knob, error, match):
    """In-process committees cannot start quietly either:
    ``Consensus.spawn`` raises before it serves anything, and so does
    ``run_committee``, on a chaos or an adversary spec that cannot be
    read (as the JAX package raises)."""
    from hotstuff_tpu_torch.bench.committee import run_committee

    from .test_torch_core import PORT as S

    for other in ENV_PLANES + (WAN,):
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(knob, "spec.json")
    monkeypatch.chdir(tmp_path)  # where no spec.json is

    async def body():
        store = S.store.Store(str(tmp_path / "db"))
        name, secret = S.keys()[0]
        try:
            with pytest.raises(error, match=match):
                await S.consensus.Consensus.spawn(
                    name, S.committee(range(7000, 7004)), S.consensus.Parameters(),
                    S.crypto.SignatureService(secret), store, asyncio.Queue(),
                )
        finally:
            store.close()

    asyncio.run(body())
    with pytest.raises(error, match=match):
        run_committee(nodes=4, rate=10, duration=1, verifier="cpu")


def _wan_spec(tmp_path, addresses) -> str:
    """A spec of the port's ``build_spec`` over ``addresses``, written as
    an operator writes one."""
    from hotstuff_tpu_torch.network.wan import build_spec

    path = tmp_path / "wan.json"
    path.write_text(json.dumps(build_spec(addresses)))
    return str(path)


@pytest.mark.parametrize("command", ["run", "run-many", "deploy"])
def test_wan_spec_on_asyncio_runs(tmp_path, command):
    """``HOTSTUFF_WAN_SPEC`` on the asyncio transport (the default) is
    accepted: every node logs its region from a spec written by the
    port's ``build_spec`` over the committee's addresses and boots.  A
    ``run-many`` committee fed by the client commits over the delayed
    links; one ``run`` node boots alone; ``deploy`` boots its testbed
    on its base ports.  The WAN's round trips (60-280 ms between
    regions) are far inside the 1,000 ms timeout delay."""
    log_path = tmp_path / "nodes.log"
    log = open(log_path, "w")
    proc = client = None
    regions = {
        "run": ["us-east-1"],
        "run-many": ["us-east-1", "eu-north-1", "ap-southeast-2", "us-west-1"],
        "deploy": ["us-east-1", "eu-north-1", "ap-southeast-2", "us-west-1"],
    }[command]
    try:
        if command == "deploy":
            base = _free_run(4)
            spec = _wan_spec(tmp_path, [("127.0.0.1", base + i) for i in range(4)])
            argv = ["deploy", "--nodes", "4", "--base-port", str(base), "--verifier", "cpu"]
            done = "Deployed 4-node local testbed"
        else:
            committee = write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
            spec = _wan_spec(tmp_path, [committee.address(n) for n in committee.authorities])
            common = ["--verifier", "cpu", "--committee", str(tmp_path / "committee.json"),
                      "--parameters", str(tmp_path / "parameters.json")]
            if command == "run":
                argv = ["run", "--keys", str(tmp_path / "key_0.json"), "--store", str(tmp_path / "db_0"),
                        *common]
            else:
                keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
                argv = ["run-many", "--keys", keys, "--store-prefix", str(tmp_path / "db_"), *common]
            done = "successfully booted"
        proc = subprocess.Popen(CLI + ["-vv", *argv], stdout=log, stderr=subprocess.STDOUT,
                                env={**ENV, WAN: spec}, cwd=tmp_path)
        assert wait_for(lambda: log_path.read_text().count(done) >= (1 if command == "deploy" else len(regions)),
                        60)
        if command == "run-many":
            client = spawn_client(tmp_path, rate=200, duration=3)
            assert client.wait(timeout=60) == 0
            assert wait_for(lambda: len(RE_COMMITTED.findall(log_path.read_text())) >= 4 * 3, 30)
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        stop_all([client, proc])
        log.close()
    text = log_path.read_text()
    assert "Traceback" not in text and "not ported yet" not in text
    assert sorted(RE_REGION.findall(text)) == sorted(regions)
    if command == "run-many":
        rounds = [int(r) for r in RE_COMMITTED.findall(text)]
        assert len(rounds) >= 4 * 3 and max(rounds) > 0


def test_consensus_spawn_runs_with_a_wan_spec(tmp_path, monkeypatch, caplog):
    """``Consensus.spawn`` with ``HOTSTUFF_WAN_SPEC`` set boots the stack
    and logs the node's region, as the JAX package's does."""
    from hotstuff_tpu_torch.bench.committee import reserve_ports

    from .test_torch_core import PORT as S

    for other in ENV_PLANES:
        monkeypatch.delenv(other, raising=False)
    socks = reserve_ports(4)
    ports = [sk.getsockname()[1] for sk in socks]
    committee = S.committee(ports)
    monkeypatch.setenv(WAN, _wan_spec(tmp_path, [committee.address(n) for n in committee.authorities]))

    async def body():
        store = S.store.Store(str(tmp_path / "db"))
        name, secret = S.keys()[0]
        stack = None
        try:
            socks[0].close()
            stack = await S.consensus.Consensus.spawn(
                name, committee, S.consensus.Parameters(), S.crypto.SignatureService(secret), store,
                asyncio.Queue(), bind_host="127.0.0.1",
            )
        finally:
            if stack is not None:
                await stack.shutdown()
            store.close()
            for sk in socks:
                sk.close()

    with caplog.at_level(logging.INFO, logger="hotstuff_tpu_torch.consensus.consensus"):
        asyncio.run(body())
    host, port = committee.address(S.keys()[0][0])
    with open(os.environ[WAN]) as f:
        region = json.load(f)["regions"][f"{host}:{port}"]
    assert RE_REGION.findall(caplog.text) == [region]


def _fault_spec(tmp_path, addresses) -> str:
    """A split brain of the port's ``faults.scenarios`` over
    ``addresses``, written as an operator writes one; its window opens
    an hour after boot, so the nodes only load the plane."""
    from hotstuff_tpu_torch.faults import scenarios

    spec = scenarios.split_brain(nodes=len(addresses), seed=3, at=3_600.0, until=3_700.0)
    spec["nodes"] = {f"{h}:{p}": i for i, (h, p) in enumerate(addresses)}
    spec["epoch_unix"] = time.time()
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(spec))
    return str(path)


RE_FAULT_PLANE = re.compile(r"Fault plane active: scenario 'split-brain' seed 3 \(node index (\d+), 2 link rules\)")


@pytest.mark.parametrize("command, how", [
    ("run", "flag"), ("run", "flag-health"), ("run", "env"),
    ("run-many", "flag"), ("run-many", "env"),
    ("deploy", "flag"), ("deploy", "env"),
])
def test_the_fault_plane_runs(tmp_path, command, how):
    """``--fault-plane SPEC`` and ``HOTSTUFF_FAULTS=SPEC`` boot ``run``,
    ``run-many`` and ``deploy`` (they exited 2 while the chaos plane was
    not ported): every node logs ``Fault plane active`` with its index
    in a spec written over the committee's addresses, and the command
    stops cleanly on SIGTERM.  With ``--health`` and telemetry on, the
    health monitors run beside the plane."""
    log_path = tmp_path / "nodes.log"
    log = open(log_path, "w")
    proc = None
    try:
        if command == "deploy":
            base = _free_run(4)
            spec = _fault_spec(tmp_path, [("127.0.0.1", base + i) for i in range(4)])
            argv = ["deploy", "--nodes", "4", "--base-port", str(base), "--verifier", "cpu"]
            indices, done = [0, 1, 2, 3], "Deployed 4-node local testbed"
        else:
            committee = write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
            addresses = [committee.address(k) for k in committee.sorted_keys()]
            spec = _fault_spec(tmp_path, addresses)
            common = ["--verifier", "cpu", "--committee", str(tmp_path / "committee.json"),
                      "--parameters", str(tmp_path / "parameters.json")]
            if command == "run":
                argv = ["run", "--keys", str(tmp_path / "key_0.json"), "--store", str(tmp_path / "db_0"),
                        *common]
                from hotstuff_tpu_torch.node.config import Secret

                indices = [addresses.index(committee.address(Secret.read(str(tmp_path / "key_0.json")).name))]
            else:
                keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
                argv = ["run-many", "--keys", keys, "--store-prefix", str(tmp_path / "db_"), *common]
                indices = [0, 1, 2, 3]
            done = "successfully booted"
        env = dict(ENV)
        if how == "env":
            env["HOTSTUFF_FAULTS"] = spec
        else:
            argv += ["--fault-plane", spec]
        if how == "flag-health":
            argv += ["--health", "--metrics-port", "0"]
        proc = subprocess.Popen(CLI + ["-vv", *argv], stdout=log, stderr=subprocess.STDOUT, env=env,
                                cwd=tmp_path)
        assert wait_for(lambda: log_path.read_text().count(done) >= (1 if command == "deploy" else len(indices)),
                        90)
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        stop_all([proc])
        log.close()
    text = log_path.read_text()
    assert "Traceback" not in text and "not ported yet" not in text
    assert sorted(int(i) for i in RE_FAULT_PLANE.findall(text)) == sorted(indices)
    if how == "flag-health":
        assert "Health monitor running for node" in text


def test_consensus_spawn_runs_with_a_fault_spec(tmp_path, monkeypatch, caplog):
    """``Consensus.spawn`` with ``HOTSTUFF_FAULTS`` set boots the stack
    with the plane on its receiver and its senders, spawns the
    ``fault-clock`` task and logs the plane, as the JAX package's does."""
    from hotstuff_tpu_torch.bench.committee import reserve_ports

    from .test_torch_core import PORT as S

    for other in ENV_PLANES + (WAN,):
        monkeypatch.delenv(other, raising=False)
    socks = reserve_ports(4)
    ports = [sk.getsockname()[1] for sk in socks]
    committee = S.committee(ports)
    addresses = [committee.address(k) for k in committee.sorted_keys()]
    monkeypatch.setenv("HOTSTUFF_FAULTS", _fault_spec(tmp_path, addresses))
    seen = {}

    async def body():
        store = S.store.Store(str(tmp_path / "db"))
        name, secret = S.keys()[0]
        stack = None
        try:
            socks[0].close()
            stack = await S.consensus.Consensus.spawn(
                name, committee, S.consensus.Parameters(), S.crypto.SignatureService(secret), store,
                asyncio.Queue(), bind_host="127.0.0.1",
            )
            plane = stack.receiver._faults
            seen["plane"] = plane
            seen["senders"] = [stack.core.network._fault_plane, stack.synchronizer.network._fault_plane,
                               stack.helper.network._fault_plane, stack.proposer.network._fault_plane]
            seen["tasks"] = [t.get_name() for t in stack._tasks]
        finally:
            if stack is not None:
                await stack.shutdown()
            store.close()
            for sk in socks:
                sk.close()

    with caplog.at_level(logging.INFO, logger="hotstuff_tpu_torch.consensus.consensus"):
        asyncio.run(body())
    assert seen["plane"].self_id == addresses.index(committee.address(S.keys()[0][0]))
    assert all(p is seen["plane"] for p in seen["senders"])
    assert "fault-clock" in seen["tasks"]
    assert RE_FAULT_PLANE.findall(caplog.text) == [str(seen["plane"].self_id)]


@pytest.mark.parametrize("command, how, transport", [
    ("run", "flag", "asyncio"), ("run", "env", "native"),
    ("run-many", "flag", "asyncio"), ("run-many", "env", "native"),
    ("deploy", "flag", "native"), ("deploy", "env", "asyncio"),
])
def test_the_adversary_plane_runs(tmp_path, command, how, transport):
    """``--adversary SPEC`` and ``HOTSTUFF_ADVERSARY=SPEC`` boot ``run``,
    ``run-many`` and ``deploy`` on both transports (they exited 2 while
    the plane was not ported): every node the spec names logs
    ``Adversary plane active`` with its index, and the command stops
    cleanly on SIGTERM.  A ``run-many`` committee fed by the client
    commits while node 0 withholds its votes, and node 0 logs each
    withheld vote."""
    log_path = tmp_path / "nodes.log"
    log = open(log_path, "w")
    proc = client = None
    rules = [{"policy": "withhold", "node": 0, "at": 0.0},
             {"policy": "forge-qc", "nodes": [1, 2, 3], "at": 3_600.0}]
    try:
        if command == "deploy":
            base = _free_run(4)
            spec = _adversary_spec(tmp_path, [("127.0.0.1", base + i) for i in range(4)], rules)
            argv = ["deploy", "--nodes", "4", "--base-port", str(base), "--verifier", "cpu"]
            indices, done = [0, 1, 2, 3], "Deployed 4-node local testbed"
        else:
            committee = write_port_committee(tmp_path, timeout_delay=1_000, sync_retry_delay=1_000)
            addresses = [committee.address(k) for k in committee.sorted_keys()]
            spec = _adversary_spec(tmp_path, addresses, rules)
            common = ["--verifier", "cpu", "--committee", str(tmp_path / "committee.json"),
                      "--parameters", str(tmp_path / "parameters.json")]
            if command == "run":
                argv = ["run", "--keys", str(tmp_path / "key_0.json"), "--store", str(tmp_path / "db_0"),
                        *common]
                from hotstuff_tpu_torch.node.config import Secret

                indices = [addresses.index(committee.address(Secret.read(str(tmp_path / "key_0.json")).name))]
            else:
                keys = ",".join(str(tmp_path / f"key_{i}.json") for i in range(4))
                argv = ["run-many", "--keys", keys, "--store-prefix", str(tmp_path / "db_"), *common]
                indices = [0, 1, 2, 3]
            done = "successfully booted"
        argv += ["--transport", transport]
        env = dict(ENV)
        if how == "env":
            env["HOTSTUFF_ADVERSARY"] = spec
        else:
            argv += ["--adversary", spec]
        proc = subprocess.Popen(CLI + ["-vv", *argv], stdout=log, stderr=subprocess.STDOUT, env=env,
                                cwd=tmp_path)
        assert wait_for(lambda: log_path.read_text().count(done) >= (1 if command == "deploy" else len(indices)),
                        90)
        if command == "run-many":
            client = spawn_client(tmp_path, rate=200, duration=3)
            assert client.wait(timeout=60) == 0
            assert wait_for(lambda: len(RE_COMMITTED.findall(log_path.read_text())) >= 3 * 4, 30)
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        stop_all([client, proc])
        log.close()
    text = log_path.read_text()
    assert "Traceback" not in text and "not ported yet" not in text
    armed = RE_ADVERSARY.findall(text)
    assert sorted(int(i) for _, _, i, _ in armed) == sorted(indices)
    assert {(name, seed) for name, seed, _, _ in armed} == {("byz-cli", "3")}
    assert {i: p for _, _, i, p in armed}.get("0", "withhold") == "withhold"
    if command == "run-many":
        assert "byz withhold vote round" in text
        assert max(int(r) for r in RE_COMMITTED.findall(text)) > 0
