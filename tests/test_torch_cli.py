"""The port's node CLI (``python -m hotstuff_tpu_torch.node``) and its
producer client (``python -m hotstuff_tpu_torch.node.client``), driven
as an operator drives them: ``keys``; the refusal of every flag whose
plane is not ported; ``run`` defaulting to the CUDA verifier with no
quiet CPU fallback; the wave service's stats line against the harness's
regex and the JAX package's line; a ``run-many`` committee fed by the
client, whose logs ``benchmark.logs.LogParser`` reads; ``deploy``; and
a port node joining a committee of JAX nodes through a reconfiguration
submitted with the port's ``reconfig`` command; the client's
digest-only mode (``--size 0``) against a port committee; and the env
knobs of planes the port does not have (``HOTSTUFF_FAULTS``,
``HOTSTUFF_ADVERSARY``, ``HOTSTUFF_WAN_SPEC`` on asyncio) refused before
boot by the CLI, ``Consensus.spawn`` and ``run_committee``.

Every listener port comes from the OS; every wait has a deadline;
every process is stopped in ``finally``."""

import asyncio
import logging
import os
import re
import signal
import socket
import stat
import subprocess
import sys

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


@pytest.mark.parametrize("argv", [
    ["run", "--fault-plane", "{}"],
    ["run", "--adversary", "{}"],
    ["run", "--health", "--fault-plane", "{}"],
    ["run", "--mesh-devices", "2"],
    ["run-many", "--profile", "--health", "--mesh-devices", "2"],
], ids=lambda argv: "-".join(a.strip("-") for a in argv[:2]))
def test_unported_flags_are_refused_before_boot(tmp_path, capsys, argv):
    from hotstuff_tpu_torch.node.main import main

    required = {
        "run": ["--keys", "k", "--committee", "c", "--store", str(tmp_path / "db")],
        "run-many": ["--keys", "k", "--committee", "c", "--store-prefix", str(tmp_path / "db")],
        "deploy": ["--nodes", "4"],
        "keys": ["--filename", str(tmp_path / "k.json")],
    }[argv[0]]
    with pytest.raises(SystemExit) as exit_:
        main(argv + required)
    assert exit_.value.code == 2
    assert "is not ported yet" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())  # nothing booted, nothing written


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


ENV_PLANES = ("HOTSTUFF_FAULTS", "HOTSTUFF_ADVERSARY", "HOTSTUFF_WAN_SPEC")


@pytest.mark.parametrize("command", ["run", "run-many", "deploy"])
@pytest.mark.parametrize("knob", ENV_PLANES)
def test_env_knobs_of_unported_planes_are_refused_before_boot(tmp_path, monkeypatch, capsys, knob, command):
    """A node started with a knob that switches on a plane the port does
    not have yet (as ``benchmark/chaos.py`` and ``benchmark/local.py``
    start nodes) stops with exit 2 and names the knob, before any node
    boots; it used to boot and run without the plane."""
    from hotstuff_tpu_torch.node.main import main

    for other in ENV_PLANES:
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(knob, '{"seed": 1}')
    monkeypatch.chdir(tmp_path)
    required = {
        "run": ["--keys", "k", "--committee", "c", "--store", str(tmp_path / "db")],
        "run-many": ["--keys", "k", "--committee", "c", "--store-prefix", str(tmp_path / "db")],
        "deploy": ["--nodes", "4"],
    }[command]
    with pytest.raises(SystemExit) as exit_:
        main([command, *required])
    assert exit_.value.code == 2
    assert f"{knob} is set, but its plane is not ported yet" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())  # nothing booted, nothing written


@pytest.mark.parametrize("env, transport, want", [
    ({}, "asyncio", None),
    ({"HOTSTUFF_FAULTS": ""}, "asyncio", None),
    ({"HOTSTUFF_ADVERSARY": ""}, "native", None),
    ({"HOTSTUFF_FAULTS": "x"}, "native", "HOTSTUFF_FAULTS"),
    ({"HOTSTUFF_ADVERSARY": "x"}, "native", "HOTSTUFF_ADVERSARY"),
    ({"HOTSTUFF_WAN_SPEC": "x"}, "asyncio", "HOTSTUFF_WAN_SPEC"),
    ({"HOTSTUFF_WAN_SPEC": "x"}, "native", None),
    ({"HOTSTUFF_WAN_SPEC": "x", "HOTSTUFF_ADVERSARY": "y"}, "asyncio", "HOTSTUFF_ADVERSARY"),
    ({"HOTSTUFF_MESH_DEVICES": "2"}, "asyncio", None),
])
def test_unported_env_plane_follows_the_references_conditions(monkeypatch, env, transport, want):
    """The knobs are refused exactly where ``hotstuff_tpu.consensus``'s
    ``Consensus.spawn`` would switch their plane on: a non-empty value,
    and the WAN spec only off the native transport.  The mesh size is
    read only where a mesh backend is built, which the port does not
    offer, so it is left alone as the reference leaves it."""
    from hotstuff_tpu_torch.consensus.consensus import unported_env_plane

    for knob in ENV_PLANES + ("HOTSTUFF_MESH_DEVICES",):
        monkeypatch.delenv(knob, raising=False)
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    assert unported_env_plane(transport) == want


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


@pytest.mark.parametrize("knob", ENV_PLANES)
def test_consensus_spawn_and_run_committee_raise_on_the_knobs(tmp_path, monkeypatch, knob):
    """In-process committees cannot start quietly either:
    ``Consensus.spawn`` raises before it builds anything, and so does
    ``run_committee``."""
    from hotstuff_tpu_torch.bench.committee import run_committee

    from .test_torch_core import PORT as S

    for other in ENV_PLANES:
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(knob, "spec.json")

    async def body():
        store = S.store.Store(str(tmp_path / "db"))
        name, secret = S.keys()[0]
        try:
            with pytest.raises(NotImplementedError, match=f"{knob} is set, but its plane is not ported yet"):
                await S.consensus.Consensus.spawn(
                    name, S.committee(range(7000, 7004)), S.consensus.Parameters(),
                    S.crypto.SignatureService(secret), store, asyncio.Queue(),
                )
        finally:
            store.close()

    asyncio.run(body())
    with pytest.raises(NotImplementedError, match=knob):
        run_committee(nodes=4, rate=10, duration=1, verifier="cpu")
