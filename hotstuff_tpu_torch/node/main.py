"""The node CLI: keys / run / run-many / reconfig / deploy.

A copy of ``hotstuff_tpu.node.main`` (reference ``node/src/main.rs:15-148``):

    python -m hotstuff_tpu_torch.node keys --filename node_0.json
    python -m hotstuff_tpu_torch.node -vv run --keys node_0.json \\
        --committee committee.json --store db_0 [--parameters p.json]
    python -m hotstuff_tpu_torch.node -vv run-many --keys k0.json,k1.json,... \\
        --committee committee.json --store-prefix db_ [--parameters p.json]
    python -m hotstuff_tpu_torch.node reconfig --keys k1.json \\
        --committee committee.json --new-committee next.json
    python -m hotstuff_tpu_torch.node -vv deploy --nodes 4

``--verifier`` is ``cuda`` (the default; it raises without a CUDA
device), ``cuda-sharded`` (alias ``mesh``: the verify batch sharded over
a mesh of ``--mesh-devices N`` cards, or ``HOTSTUFF_MESH_DEVICES``,
every visible one by default) or ``cpu``; ``--device cpu`` runs the
device verifiers' kernels as their plain PyTorch versions.  ``--transport`` is ``asyncio``
(the default) or ``native``, the C++ epoll reactor
(``network/native.py``), for ``run``, ``run-many`` and ``deploy``.
``-v`` repeats raise verbosity; the millisecond log format is the
harness's contract (``benchmark/logs.py``).

``--metrics-port N`` (or ``HOTSTUFF_METRICS_PORT``) turns telemetry on
and serves ``/metrics``, ``/snapshot``, ``/trace`` and ``/delta`` on port
N (0 = an ephemeral port, logged as ``Telemetry /metrics endpoint
listening on port P``); ``--journal-dir D`` turns the flight recorder on
and writes every node's JSONL ring segments under D.  With telemetry on,
every node logs a ``Telemetry snapshot: {json}`` line every 5 s;
``HOTSTUFF_WORK_STATS=1`` adds the ``Work stats: {json}`` line.

``--health`` (or ``HOTSTUFF_HEALTH``) runs every node's health monitor
(``telemetry/health.py``): online detectors, ``Health incident: {json}``
lines, ``health.<kind>`` journal edges, the ``health`` snapshot section
and, with ``--journal-dir``, a ``<node>-campaign.json`` ring beside the
journals.  It acts where telemetry is on (``--metrics-port``,
``--journal-dir``, ``--profile`` or ``HOTSTUFF_TELEMETRY``).

``--scheme bls`` on ``keys`` and ``deploy`` makes BLS12-381 keys (each
key file carries its proof of possession); a BLS committee's nodes
aggregate their certificates into the compact form, with the G1 sums on
the card's kernels under ``--verifier cuda``.  ``run-many`` takes the
scheme from its files, as in the JAX package.

``--fault-plane SPEC`` (a spec file or inline JSON; or
``HOTSTUFF_FAULTS``) turns the chaos plane on for ``run``, ``run-many``
and ``deploy`` on both transports (``faults/plane.py``; every node logs
``Fault plane active: ...``; an unreadable spec raises at boot).  Write
a spec over a committee file's addresses with ``faults.scenarios``::

    c = read_committee("committee.json")
    keys = c.sorted_keys()  # scenario index i: the i-th key, the leader order
    spec = scenarios.split_brain(nodes=len(keys), seed=1, at=20.0, until=30.0)
    spec["nodes"] = {"%s:%d" % c.address(k): i for i, k in enumerate(keys)}
    spec["epoch_unix"] = time.time()  # the windows count from here: clear the boot

``--adversary SPEC`` (or ``HOTSTUFF_ADVERSARY``) turns the Byzantine
adversary plane on for the same commands, on both transports
(``faults/adversary.py``: each node the spec's ``adversary`` rules name
logs ``Adversary plane active: ...`` and its ``byz ...`` lines; the
others stay honest and silent).  It reads the same spec format, so one
file may carry both planes; ``faults.scenarios`` builds the ``byz-*``
ones, whose ``adversary`` rules name scenario indexes as above.
``HOTSTUFF_WAN_SPEC=<spec file>``
(``network/wan.py`` ``build_spec``) delays every node-to-node link on
the asyncio transport, as in the reference, and does nothing on the
native one.

``run`` and ``run-many`` stop cleanly on SIGTERM or SIGINT: every node
shuts down, and the process logs the wave service's last stats line and,
when the CUDA kernels were loaded, their launch counts
(``Kernel launches: dual_scalar_mult=M verify_compressed=N`` and, for
the G1 kernels, ``g1_aggregate=A g1_running_add=B g1_scalar_mult=C``),
which it also logs once every node has booted (``Kernel launches at
boot: ...``).
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import logging
import os
import signal
import sys
import time

from ..consensus import Committee, Parameters
from .config import (
    Secret,
    read_committee,
    write_committee,
    write_parameters,
)
from .node import Node

log = logging.getLogger("node")

LEVELS = [logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG]


class _FastFormatter(logging.Formatter):
    """The harness log-line format with the per-record strftime cached
    per second: at ~10 load-bearing INFO lines per committed block the
    default Formatter's asctime path (strftime + two %-formats) was a
    measurable slice of the one-core round.  Output is byte-identical
    to the basicConfig format below."""

    def __init__(self):
        super().__init__()
        self._last_sec: int | None = None
        self._last_prefix = ""

    def format(self, record: logging.LogRecord) -> str:
        sec = int(record.created)
        if sec != self._last_sec:
            self._last_sec = sec
            self._last_prefix = time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(sec)
            )
        msg = record.getMessage()
        if record.exc_info and not record.exc_text:
            record.exc_text = self.formatException(record.exc_info)
        if record.exc_text:
            msg = f"{msg}\n{record.exc_text}"
        if record.stack_info:
            msg = f"{msg}\n{self.formatStack(record.stack_info)}"
        return (
            f"{self._last_prefix}.{int(record.msecs):03d}Z "
            f"[{record.levelname}] {record.name} {msg}"
        )


def setup_logging(verbosity: int) -> None:
    # HOTSTUFF_LOG_LEVEL overrides the -v count (harness runs pin -vv for
    # the log-scrape contract; this lets an operator crank one run to
    # DEBUG without editing the harness)
    env = os.environ.get("HOTSTUFF_LOG_LEVEL", "")
    level = getattr(logging, env.upper(), None) if env else None
    logging.basicConfig(
        level=level if level is not None else LEVELS[min(verbosity, 3)],
        format="%(asctime)s.%(msecs)03dZ [%(levelname)s] %(name)s %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
    )
    for handler in logging.getLogger().handlers:
        handler.setFormatter(_FastFormatter())


def _freeze_boot_objects():
    """Move boot-time immortals (committee state, caches, the torch
    runtime) out of the GC's collected generations: steady-state
    collections otherwise scan megabytes of permanent objects every
    pass, which a one-core rig feels directly in round latency.

    Full (gen2) collections re-scan every live object and measured
    30-55 ms per pause on a one-core host; gen2 runs 50x less often,
    paired with a scheduled full collection every
    ``HOTSTUFF_GC_GEN2_PERIOD`` seconds (300; 0 = none, and then no
    running loop is needed) so cyclic garbage stays bounded.
    ``HOTSTUFF_GC_GEN2_STRETCH=0`` keeps the default thresholds.
    Returns a callable that undoes all of it (an in-process committee
    driver restores the collector when its run ends)."""
    thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()
    sweep = None
    stretch = os.environ.get("HOTSTUFF_GC_GEN2_STRETCH", "1").strip().lower()
    if stretch not in ("", "0", "false", "no", "off"):
        g0, g1, _ = thresholds
        gc.set_threshold(g0, g1, 500)
        period = float(os.environ.get("HOTSTUFF_GC_GEN2_PERIOD", "300") or 300)
        if period > 0:

            async def _gen2_sweep() -> None:
                glog = logging.getLogger(__name__)
                while True:
                    await asyncio.sleep(period)
                    t0 = time.perf_counter()
                    freed = gc.collect(2)
                    glog.debug(
                        "scheduled gen2 sweep: %d collected in %.1f ms",
                        freed,
                        (time.perf_counter() - t0) * 1e3,
                    )

            sweep = asyncio.ensure_future(_gen2_sweep())

    def undo() -> None:
        if sweep is not None:
            sweep.cancel()
        gc.set_threshold(*thresholds)
        gc.unfreeze()

    return undo


def _apply_fault_plane(args) -> None:
    """Activate the chaos plane when ``--fault-plane`` was given: the
    flag value (a spec file path or inline JSON) lands in
    HOTSTUFF_FAULTS, which Consensus.spawn reads at boot — exactly the
    env-first pattern the WAN and journal knobs use."""
    spec = getattr(args, "fault_plane", None)
    if spec:
        os.environ["HOTSTUFF_FAULTS"] = spec


def _apply_adversary(args) -> None:
    """Activate the Byzantine adversary plane when ``--adversary`` was
    given: the flag value (a spec file path or inline JSON naming the
    attacking node indexes and policy windows) lands in
    HOTSTUFF_ADVERSARY, which Consensus.spawn reads at boot.  Inert on
    nodes the spec does not name, so the whole committee can share one
    spec file."""
    spec = getattr(args, "adversary", None)
    if spec:
        os.environ["HOTSTUFF_ADVERSARY"] = spec


def _apply_health(args) -> None:
    """Activate the live health plane when ``--health`` was given: sets
    HOTSTUFF_HEALTH (env-first, inherited by child node processes) so
    every booted node runs the per-node HealthMonitor
    (telemetry/health.py) — online detectors, ``health.*`` incident
    journal edges, and the bounded campaign recorder."""
    if getattr(args, "health", False):
        os.environ["HOTSTUFF_HEALTH"] = "1"


def _metrics_port(args) -> int | None:
    """The /metrics port: ``--metrics-port`` first, then the
    HOTSTUFF_METRICS_PORT env knob; None = endpoint off (default)."""
    port = getattr(args, "metrics_port", None)
    if port is not None:
        return port
    env = os.environ.get("HOTSTUFF_METRICS_PORT", "").strip()
    if not env:
        return None
    try:
        return int(env)
    except ValueError:
        log.warning("ignoring non-integer HOTSTUFF_METRICS_PORT=%r", env)
        return None


def _apply_mesh_devices(args) -> None:
    """Bridge ``--mesh-devices N`` into HOTSTUFF_MESH_DEVICES (the
    env-first pattern) so the sharded verifier sizes its device mesh at
    materialization — in this process and in any child node process."""
    n = getattr(args, "mesh_devices", None)
    if n is not None:
        os.environ["HOTSTUFF_MESH_DEVICES"] = str(max(1, n))


def _apply_journal_dir(args) -> None:
    """Force-enable the flight recorder when ``--journal-dir`` was given
    (the env knobs HOTSTUFF_JOURNAL / HOTSTUFF_JOURNAL_DIR work without
    the flag; off by default)."""
    jdir = getattr(args, "journal_dir", None)
    if jdir:
        from .. import telemetry

        telemetry.set_journal_dir(jdir)


def _apply_env_bridges(args) -> None:
    """Bridge the flags of ported machinery into their env-first homes,
    so the wave service, the proposer and every booted node (in this
    process or a child) pick them up at construction:

    - ``--profile`` -> HOTSTUFF_PROFILE, and the verify-pipeline span
      recorder on (ring-buffered per-stage spans);
    - ``--verify-pipeline N`` -> HOTSTUFF_VERIFY_PIPELINE (device waves
      in flight at once);
    - ``--max-pending N`` -> HOTSTUFF_MAX_PENDING (proposer buffer cap,
      the admission controller's capacity) and ``--ingest-watermark F``
      -> HOTSTUFF_INGEST_WATERMARK (shed threshold as a fraction of it);
    - ``--fresh-state`` -> HOTSTUFF_FRESH_STATE (discard every persisted
      store; normally unnecessary, as the committee-hash provenance check
      already rejects another committee's state);
    - ``--journal-dir D`` -> the flight recorder on, into D."""
    _apply_journal_dir(args)
    if getattr(args, "profile", False):
        from ..telemetry import spans

        os.environ["HOTSTUFF_PROFILE"] = "1"
        spans.enable()
    depth = getattr(args, "verify_pipeline", None)
    if depth is not None:
        os.environ["HOTSTUFF_VERIFY_PIPELINE"] = str(max(1, depth))
    n = getattr(args, "max_pending", None)
    if n is not None:
        os.environ["HOTSTUFF_MAX_PENDING"] = str(max(1, n))
    w = getattr(args, "ingest_watermark", None)
    if w is not None:
        os.environ["HOTSTUFF_INGEST_WATERMARK"] = str(w)
    if getattr(args, "fresh_state", False):
        os.environ["HOTSTUFF_FRESH_STATE"] = "1"


def _wave_service(nodes):
    """The device wave service the nodes' cores share (one a loop and
    device kind), or None with a CPU verifier."""
    for node in nodes:
        core = node.consensus.core if node.consensus is not None else None
        service = getattr(core, "averifier", None)
        if service is not None and service.device:
            return service
    return None


async def _report_verifier(service) -> None:
    """A stopped process's last words about its verifier, once every
    node is down and the in-flight waves have landed: the wave service's
    stats line (cumulative, so the harness's last line per tag is the
    run's total) and, when the CUDA kernels were loaded, their launch
    counts."""
    if service is not None:
        deadline = time.monotonic() + 10.0
        while service._inflight and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        service.log_stats()
        service.close()
    _log_launches("Kernel launches")


def _log_launches(what: str) -> None:
    """Log the CUDA kernels' launch counts so far, those of each kernel
    module that was loaded (the Ed25519 verify kernels, then the G1
    kernels)."""
    counts = []
    for name in ("hotstuff_tpu_torch.gpu.dsm", "hotstuff_tpu_torch.gpu.bls"):
        mod = sys.modules.get(name)
        if mod is not None:
            counts += [f"{k}={v}" for k, v in sorted(mod.launches.items())]
    if counts:
        log.info("%s: %s", what, " ".join(counts))


async def _serve_until_stopped(nodes, boot, metrics_port=None) -> None:
    """Boot nodes with ``boot`` (an async callable appending to
    ``nodes``), then serve them until they retire or the process gets
    SIGTERM/SIGINT; either way every node shuts down.  ``metrics_port``
    (None = off) starts the telemetry endpoint before the first node
    boots — a configured endpoint turns collection on, and nodes pick
    telemetry up only at boot — and stops it after the last one.

    The flight recorder's crash hooks (``telemetry/journal.py``) wrap
    the loop's SIGTERM/SIGINT handlers at the first journal: a signal
    flushes every journal, then wakes the loop as before."""
    from .. import telemetry

    loop = asyncio.get_running_loop()
    task = asyncio.current_task()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, task.cancel)
    probe = None
    service = None
    server = None
    try:
        server = await telemetry.maybe_start_server(metrics_port)
        await boot()
        _freeze_boot_objects()
        service = _wave_service(nodes)
        _log_launches("Kernel launches at boot")
        if len(nodes) >= 64:
            probe = asyncio.ensure_future(_fd_probe())
        # serve() instead of analyze_block(): a node voted out by a
        # committed reconfiguration exits cleanly after its grace window
        await asyncio.gather(*(n.serve() for n in nodes))
    except asyncio.CancelledError:
        log.info("Stopping %d node(s) on a signal", len(nodes))
    finally:
        if probe is not None:
            probe.cancel()
        await asyncio.gather(*(node.shutdown() for node in nodes))
        await _report_verifier(service)
        if server is not None:
            await server.stop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.remove_signal_handler(sig)


async def _fd_probe() -> None:
    """Capacity diagnostics for big co-located committees: one line every
    5 s with the process's live fd count and how many of them are
    sockets.  The native reactor's connections are fds of this process
    too, so both counts include them."""
    plog = logging.getLogger(__name__)
    while True:
        try:
            fds = os.listdir("/proc/self/fd")
        except OSError:
            return
        sockets = 0
        for fd in fds:
            try:
                sockets += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
            except OSError:
                pass  # closed since the listing
        plog.info("fd-probe: %d open fds (%d sockets)", len(fds), sockets)
        await asyncio.sleep(5)


async def _run_node(args) -> None:
    _apply_env_bridges(args)
    _apply_fault_plane(args)
    _apply_adversary(args)
    _apply_health(args)
    _apply_mesh_devices(args)
    nodes: list[Node] = []

    async def boot() -> None:
        nodes.append(
            await Node.new(
                committee_file=args.committee,
                key_file=args.keys,
                store_path=args.store,
                parameters_file=args.parameters,
                verifier_backend=args.verifier,
                transport=args.transport,
                device=args.device,
            )
        )

    await _serve_until_stopped(nodes, boot, _metrics_port(args))


async def _submit_reconfig(args) -> int:
    """Craft, sign, and broadcast a reconfiguration op (docs/RECONFIG.md):
    the NEW epoch's committee (``--new-committee`` file) plus an
    activation margin Δ, sponsored by the member whose key file is
    given.  Every current member receives the op; whichever becomes
    leader first proposes it on-chain."""
    import dataclasses

    from ..consensus.reconfig import ReconfigOp, newest_epoch
    from ..consensus.wire import encode_reconfig
    from ..crypto import Digest
    from ..crypto.scheme import make_signing_service
    from ..network import SimpleSender

    current = read_committee(args.committee)
    new_com = read_committee(args.new_committee)
    if hasattr(new_com, "entries"):  # a schedule file: its newest epoch
        new_com = new_com.committees()[-1]
    secret = Secret.read(args.keys)
    epoch = (
        args.epoch
        if args.epoch is not None
        else max(new_com.epoch, newest_epoch(current) + 1)
    )
    if epoch != new_com.epoch:
        new_com = dataclasses.replace(new_com, epoch=epoch)
    margin = (
        args.margin
        if args.margin is not None
        else int(os.environ.get("HOTSTUFF_RECONFIG_MARGIN", "8"))
    )
    op = ReconfigOp(new_committee=new_com, margin=margin, sponsor=secret.name)
    service = make_signing_service(secret.scheme, secret.secret)
    op.signature = await service.request_signature(Digest(op.digest()))
    frame = encode_reconfig(op)
    sender = SimpleSender()
    targets = [
        current.address(nm)
        for nm in current.authorities
        if current.address(nm) is not None
    ]
    log.info(
        "Submitting %r (margin %d) to %d current members",
        op,
        margin,
        len(targets),
    )
    for address in targets:
        await sender.send(address, frame)
    # fire-and-forget senders queue frames; give the connections a
    # moment to flush before tearing the process down
    await asyncio.sleep(float(args.linger))
    sender.close()
    return 0


def _raise_fd_limit(target: int) -> None:
    """Best-effort RLIMIT_NOFILE raise to ``target`` (soft AND hard
    when the process may); silently keeps the current limit when it is
    already enough or the raise is denied."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft >= target:
            return
        # Never LOWER the hard cap: RLIM_INFINITY is -1 on Linux, so the
        # obvious max(hard, target) would replace an unlimited cap with
        # ``target`` — and for a non-root process that shrink is
        # irreversible.  Touch the hard cap only when it is finite and
        # actually below the target.
        if hard != resource.RLIM_INFINITY and hard < target:
            new_hard = target
        else:
            new_hard = hard
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (target, new_hard))
        except (ValueError, OSError):
            # can't raise the hard cap: take everything the soft cap allows
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ValueError, OSError, ImportError):
        pass


def _fd_budget(n: int, transport: str) -> None:
    """Fit ``n`` co-located nodes into the fd limit.  Each keeps one
    persistent connection per (sender, peer) pair and BOTH socket
    endpoints live in this process, so a committee-wide broadcast opens
    up to ~2*n^2 sockets: raise the limit toward that (best effort,
    never lowering it).  Where the limit still cannot cover it, the
    asyncio senders bound their pools (``HOTSTUFF_MAX_PEER_CONNS``); the
    native reactor's connections are the same count of fds but have no
    pool to bound, so that is logged as a warning instead."""
    _raise_fd_limit(2 * n * n + 20_000)
    cap = _peer_conn_cap(n)
    if cap is None:
        return
    plog = logging.getLogger(__name__)
    if transport == "native":
        import resource

        plog.warning(
            "fd limit %d below 2*%d^2 + 10000 and the native reactor's "
            "connections are not pooled: a committee-wide broadcast may "
            "run out of fds",
            resource.getrlimit(resource.RLIMIT_NOFILE)[0],
            n,
        )
        return
    os.environ.setdefault("HOTSTUFF_MAX_PEER_CONNS", cap)
    plog.info(
        "fd budget below 2*%d^2: bounding per-sender connection pools at %s",
        n,
        os.environ["HOTSTUFF_MAX_PEER_CONNS"],
    )


def _peer_conn_cap(n: int) -> str | None:
    """``HOTSTUFF_MAX_PEER_CONNS`` for ``n`` co-located nodes when the fd
    limit cannot cover the quadratic worst case (2 fds a connection, one
    connection per sender and peer); None when it can.  Idle-LRU
    eviction then keeps the process near (n * senders * cap)
    connections, at the cost of reconnects as leadership rotates."""
    import resource

    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if n <= 1 or soft >= 2 * n * n + 10_000:
        return None
    budget_conns = max(1_000, (soft - 4_000) // 2)
    return str(max(4, budget_conns // (4 * n)))


async def _run_many(args) -> None:
    """Several nodes co-located in ONE process from existing config
    files — the reference's in-process testbed shape (main.rs:102-148)
    driven by the harness's key/committee files.  On a host with fewer
    cores than nodes this removes cross-process scheduling from the
    measured path: every actor shares one asyncio loop."""
    _apply_env_bridges(args)
    _apply_fault_plane(args)
    _apply_adversary(args)
    _apply_health(args)
    _apply_mesh_devices(args)
    key_files = args.keys.split(",")
    n = len(key_files)
    # Co-location hint: the verifier layer coalesces all these nodes'
    # claims into one device dispatch stream, so the device pays off at
    # committee sizes far below the per-node threshold (node.py warmup).
    os.environ["HOTSTUFF_COLOCATED_NODES"] = str(n)
    _fd_budget(n, args.transport)
    nodes: list[Node] = []

    async def boot() -> None:
        for i, key_file in enumerate(key_files):
            nodes.append(
                await Node.new(
                    committee_file=args.committee,
                    key_file=key_file,
                    store_path=f"{args.store_prefix}{i}",
                    parameters_file=args.parameters,
                    verifier_backend=args.verifier,
                    transport=args.transport,
                    bind_host="127.0.0.1",
                    device=args.device,
                )
            )

    await _serve_until_stopped(nodes, boot, _metrics_port(args))


async def _deploy_testbed(
    nodes: int, base_port: int, verifier: str, device=None,
    transport: str = "asyncio", metrics_port: int | None = None,
    scheme: str = "ed25519",
) -> None:
    """In-process local testbed (reference main.rs:102-148): n fresh
    keypairs of ``scheme``, committee.json + node_i.json on disk, every
    node spawned as a task in this process, commit channels drained.  A
    leftover .db_* of an earlier deployment belongs to another committee
    (the keys are fresh), so the provenance check in ``Node.new``
    discards it."""
    keys = [Secret.new(scheme) for _ in range(nodes)]
    committee = Committee.new(
        [
            (secret.name, 1, ("127.0.0.1", base_port + i))
            for i, secret in enumerate(keys)
        ],
        scheme=scheme,
        pops={s.name: s.pop for s in keys if s.pop is not None},
    )
    write_committee(committee, ".committee.json")
    write_parameters(Parameters(), ".parameters.json")
    for i, secret in enumerate(keys):
        secret.write(f".node_{i}.json")
    booted: list[Node] = []

    async def boot() -> None:
        for i in range(nodes):
            booted.append(
                await Node.new(
                    committee_file=".committee.json",
                    key_file=f".node_{i}.json",
                    store_path=f".db_{i}",
                    parameters_file=".parameters.json",
                    verifier_backend=verifier,
                    bind_host="127.0.0.1",
                    transport=transport,
                    device=device,
                )
            )
        log.info(
            "Deployed %d-node local testbed on base port %d", nodes, base_port
        )

    await _serve_until_stopped(booted, boot, metrics_port)


def _add_node_flags(p: argparse.ArgumentParser) -> None:
    """The flags ``run``, ``run-many`` and ``deploy`` share."""
    p.add_argument(
        "--transport",
        choices=["asyncio", "native"],
        default="asyncio",
        help="framed-TCP transport: asyncio (default) or the native C++ "
        "epoll reactor (network/native.py)",
    )
    p.add_argument(
        "--verifier",
        choices=["cuda", "cuda-sharded", "mesh", "cpu"],
        default="cuda",
        help="signature verification backend: the CUDA device (default), "
        "the batch sharded over a mesh of CUDA devices (cuda-sharded, "
        "alias mesh) or the CPU",
    )
    p.add_argument(
        "--device",
        default=None,
        help="torch device of the device verifiers (default: the current "
        "CUDA device; 'cpu' runs the kernels' plain versions)",
    )
    p.add_argument(
        "--profile",
        action="store_true",
        help="enable the verify-pipeline span profiler (ring-buffered "
        "per-stage spans; default: off)",
    )
    p.add_argument(
        "--verify-pipeline",
        type=int,
        default=None,
        metavar="N",
        help="verify dispatch pipeline depth: device waves in flight at "
        "once (default: 2, or the HOTSTUFF_VERIFY_PIPELINE env knob)",
    )
    p.add_argument(
        "--max-pending",
        type=int,
        default=None,
        metavar="N",
        help="proposer payload buffer cap / ingest admission capacity "
        "(default 100000, or the HOTSTUFF_MAX_PENDING env knob)",
    )
    p.add_argument(
        "--ingest-watermark",
        type=float,
        default=None,
        metavar="F",
        help="buffer-occupancy fraction above which the ingest plane "
        "sheds producer payloads with a typed BUSY reply (default 0.75, "
        "or HOTSTUFF_INGEST_WATERMARK)",
    )
    p.add_argument(
        "--fresh-state",
        action="store_true",
        help="discard any persisted store before booting (escape hatch; "
        "by default matching state is recovered and mismatched-committee "
        "state is rejected by the provenance check)",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve Prometheus /metrics on this port and enable telemetry "
        "(0 = ephemeral port, logged at startup; default: off, or the "
        "HOTSTUFF_METRICS_PORT env knob)",
    )
    p.add_argument(
        "--journal-dir",
        default=None,
        help="enable the consensus flight recorder and write its JSONL "
        "ring segments under this directory (default: off, or the "
        "HOTSTUFF_JOURNAL / HOTSTUFF_JOURNAL_DIR env knobs; merge "
        "journals with `python -m benchmark traces`)",
    )
    p.add_argument(
        "--health",
        action="store_true",
        help="enable the live health plane: per-node online anomaly "
        "detectors (leader-stall, view-change storm, commit collapse, "
        "shed storm), health.* incident journal edges, the /delta "
        "streaming-export route, and the bounded campaign recorder "
        "(docs/TELEMETRY.md; default: off, or the HOTSTUFF_HEALTH env "
        "knob)",
    )
    p.add_argument(
        "--mesh-devices",
        type=int,
        default=None,
        metavar="N",
        help="device count for the sharded mesh verifier (default: every "
        "visible device, or the HOTSTUFF_MESH_DEVICES env knob; only "
        "meaningful with --verifier mesh/cuda-sharded)",
    )
    p.add_argument(
        "--fault-plane",
        default=None,
        help="activate the chaos plane from this fault-spec file (or "
        "inline JSON): seeded deterministic drop/delay/duplicate/corrupt "
        "per directed peer pair on a scenario timeline (default: off, or "
        "the HOTSTUFF_FAULTS env knob)",
    )
    p.add_argument(
        "--adversary",
        default=None,
        help="activate the Byzantine adversary plane from this spec file "
        "(or inline JSON): seeded deterministic protocol-level attacks — "
        "equivocate, forge-qc, withhold, double-vote, flood, collude — "
        "on the named node indexes (default: off, or the "
        "HOTSTUFF_ADVERSARY env knob)",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="hotstuff-tpu-torch-node",
        description="2-chain HotStuff with signatures verified on a CUDA device",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    sub = parser.add_subparsers(dest="command", required=True)

    p_keys = sub.add_parser("keys", help="generate a new keypair file")
    p_keys.add_argument("--filename", required=True)
    p_keys.add_argument(
        "--scheme",
        choices=["ed25519", "bls"],
        default="ed25519",
        help="signature scheme (the committee file records the same "
        "scheme; BLS gives constant-cost aggregate QC verification)",
    )

    p_run = sub.add_parser("run", help="run a node")
    p_run.add_argument("--keys", required=True)
    p_run.add_argument("--committee", required=True)
    p_run.add_argument("--store", required=True)
    p_run.add_argument("--parameters", default=None)
    _add_node_flags(p_run)

    p_many = sub.add_parser(
        "run-many",
        help="run several nodes in one process from existing config files",
    )
    p_many.add_argument("--keys", required=True, help="comma-separated key files")
    p_many.add_argument("--committee", required=True)
    p_many.add_argument("--store-prefix", required=True)
    p_many.add_argument("--parameters", default=None)
    _add_node_flags(p_many)

    p_rec = sub.add_parser(
        "reconfig",
        help="submit a signed committee reconfiguration to the live "
        "committee (docs/RECONFIG.md)",
    )
    p_rec.add_argument(
        "--keys",
        required=True,
        help="key file of the sponsoring CURRENT member",
    )
    p_rec.add_argument(
        "--committee",
        required=True,
        help="the current committee (or schedule) file — submission "
        "targets and epoch numbering",
    )
    p_rec.add_argument(
        "--new-committee",
        required=True,
        help="committee file holding the NEXT epoch's full membership",
    )
    p_rec.add_argument(
        "--margin",
        type=int,
        default=None,
        metavar="N",
        help="activation margin Δ in rounds after the commit (default "
        "8, or the HOTSTUFF_RECONFIG_MARGIN env knob)",
    )
    p_rec.add_argument(
        "--epoch",
        type=int,
        default=None,
        metavar="N",
        help="override the new committee's epoch number (default: "
        "newest known epoch + 1)",
    )
    p_rec.add_argument(
        "--linger",
        type=float,
        default=1.0,
        metavar="S",
        help="seconds to keep the submission connections open (flush)",
    )

    p_dep = sub.add_parser("deploy", help="deploy a local testbed")
    p_dep.add_argument("--nodes", type=int, required=True)
    p_dep.add_argument("--base-port", type=int, default=25_200)
    p_dep.add_argument(
        "--scheme",
        choices=["ed25519", "bls"],
        default="ed25519",
        help="signature scheme of the testbed's fresh keys",
    )
    _add_node_flags(p_dep)

    args = parser.parse_args(argv)
    setup_logging(args.verbose)

    if args.command == "keys":
        Secret.new(args.scheme).write(args.filename)
        return 0
    if args.command == "run":
        # sanity-check the committee file before booting
        read_committee(args.committee)
        asyncio.run(_run_node(args))
        return 0
    if args.command == "run-many":
        read_committee(args.committee)
        asyncio.run(_run_many(args))
        return 0
    if args.command == "reconfig":
        return asyncio.run(_submit_reconfig(args))
    if args.command == "deploy":
        _apply_env_bridges(args)
        _apply_fault_plane(args)
        _apply_adversary(args)
        _apply_health(args)
        _apply_mesh_devices(args)
        asyncio.run(
            _deploy_testbed(
                args.nodes, args.base_port, args.verifier, args.device,
                args.transport, _metrics_port(args), args.scheme,
            )
        )
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
