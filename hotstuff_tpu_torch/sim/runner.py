"""Execute one schedule in virtual time and judge it.

A copy of ``hotstuff_tpu.sim.runner``.  ``run_schedule`` is the sim's
unit of work: build a fresh :class:`~hotstuff_tpu_torch.sim.loop.SimLoop`,
install the ambient clock/rng/connector seams and the chaos/adversary
env, run the committee through the schedule, then render each node's
captured log records into ``node-<i>.log`` files in the benchmark log
dialect and hand them to the invariant stack (``sim/invariants.py``
``check_run``, the port's copy of the reference harness's checks) —
safety, state-root agreement, liveness-after-heal, epoch agreement,
handoff gap and the trusted-subset recheck.  The commit critical path
is attributed over the committee's journals by ``telemetry/critpath.py``
on the port's copy of the journal loader (``telemetry/traces.py``).

The capture listens on the port's ``hotstuff_tpu_torch`` logger, so
the journal's ``src`` fields carry the port's logger names;
:func:`normalised_journal_digest` writes them as the reference's to
compare a port journal with a JAX one.

Determinism contract: the verdict and the journal digest are a pure
function of the schedule.  Everything ambient is pinned per run (virtual
clock at ``SIM_EPOCH``, ``Random("sim-run|<seed>")``, in-memory
network); the double-run test in tests/test_simnet.py enforces
byte-identical journals.
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import hashlib
import json
import logging
import os
import random
import tempfile

from ..utils.clock import (
    set_default_clock,
    set_default_connector,
    set_default_rng,
)
from .harness import SIM_BASE_PORT, SimCluster
from .invariants import (
    adversaries_from_spec,
    check_run,
    check_safety,
    commits_from_logs,
    trusted_subset_recheck,
)
from .loop import SIM_EPOCH, SimDeadlock, SimLoop, VirtualClock
from .schedule import schedule_to_spec
from .transport import SimNet, set_current_net

#: the logger the capture listens on: every module of the port logs
#: under it (the actors under ``<module>.<pk8>``)
LOGGER = "hotstuff_tpu_torch"

#: the reference's logger root, written in place of :data:`LOGGER` by
#: :func:`normalised_journal_digest`
REFERENCE_LOGGER = "hotstuff_tpu"

#: env the sim pins for the duration of a run (value None = unset)
_RUN_ENV_BASE = {
    "HOTSTUFF_WAN_SPEC": None,  # WAN emu draws real-region latencies
    "HOTSTUFF_MAX_PEER_CONNS": None,
    "HOTSTUFF_RECONFIG_LISTEN": None,
    "HOTSTUFF_STATE_SYNC_LAG": "2",  # rejoiners snapshot-sync promptly
}


@dataclasses.dataclass
class SimVerdict:
    """One schedule's outcome + everything needed to reproduce it."""

    seed: int
    profile: str
    ok: bool  #: run matched its profile's expectation
    all_ok: bool  #: raw full-history check_run verdict
    safety_ok: bool
    trusted_ok: bool | None  #: trusted-subset recheck (byz specs only)
    commits: int  #: total committed-block observations across nodes
    rounds: int  #: highest committed round observed by any node
    journal_digest: str
    block: str  #: rendered CHAOS/BYZ/RECONFIG report
    failures: list[str] = dataclasses.field(default_factory=list)
    #: invariant-threat classification (guided search fitness input):
    #: "full-history-divergence" when safety failed, "liveness-stall"
    #: when the run missed liveness/commit expectations with safety
    #: intact.  Empty for clean runs.
    threats: list[str] = dataclasses.field(default_factory=list)
    #: view-timeout firings observed across the committee (fitness
    #: pressure signal — more timeouts = closer to a stall)
    timeouts: int = 0
    #: commit critical-path attribution document (telemetry/critpath.py
    #: ``attribution()`` shape) merged from the committee's per-node
    #: flight-recorder journals; None when the run committed nothing.
    #: Deterministic per seed — virtual clocks stamp the journals.
    attribution: dict | None = None
    #: wire-level flow tables per node short-name, one table per boot
    #: (telemetry/flows.py ``table()``): integer byte ledgers driven
    #: entirely by virtual-time scheduling, so a same-seed double-run
    #: must reproduce them byte-for-byte (tests/test_flows.py).  None
    #: when accounting is disabled.
    flows: dict | None = None
    #: ``journal_digest`` with the records' ``src`` written under the
    #: reference's logger root (:func:`normalised_journal_digest`): the
    #: digest the explorer writes into the shared corpus and into emitted
    #: scenarios.  Not part of ``to_json``, whose shape is the reference's.
    normalised_digest: str = dataclasses.field(default="", repr=False)

    def to_json(self) -> dict:
        doc = dataclasses.asdict(self)
        del doc["normalised_digest"]
        return doc


class _LogCapture(logging.Handler):
    """Collects every ``hotstuff_tpu_torch`` log record with its VIRTUAL
    timestamp (``record.created`` is real wall time — useless here)."""

    def __init__(self, clock: VirtualClock):
        super().__init__(level=logging.INFO)
        self._clock = clock
        self.records: list[tuple[float, str, str]] = []

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001 — never let logging kill the run
            return
        self.records.append((self._clock.monotonic(), record.name, msg))


def _stamp(vt: float) -> str:
    """Render virtual seconds as the benchmark log timestamp.  The
    parser (``sim/invariants.py`` ``_ts``) reads it back as LOCAL time, so
    format through ``fromtimestamp`` for an exact round-trip."""
    dt = datetime.datetime.fromtimestamp(SIM_EPOCH + vt)
    return f"{dt:%Y-%m-%dT%H:%M:%S}.{dt.microsecond // 1000:03d}Z"


def _render_logs(
    records: list[tuple[float, str, str]],
    prefix_map: dict[str, int],
    logs_dir: str,
    nodes: int,
) -> None:
    """Write ``node-<i>.log`` files in the benchmark dialect.  Per-node
    attribution rides on the actor logger suffix (``...core.<pk8>``);
    unattributed records (sim harness, planes) stay journal-only."""
    lines: dict[int, list[str]] = {i: [] for i in range(nodes)}
    for vt, name, msg in records:
        suffix = name.rsplit(".", 1)[-1]
        idx = prefix_map.get(suffix)
        if idx is not None:
            lines[idx].append(f"{_stamp(vt)} INFO {msg}")
    os.makedirs(logs_dir, exist_ok=True)
    for i in range(nodes):
        with open(os.path.join(logs_dir, f"node-{i}.log"), "w") as f:
            f.write("\n".join(lines[i]) + ("\n" if lines[i] else ""))


def _journal_lines(
    records: list[tuple[float, str, str]], reference: bool = False
) -> bytes:
    """The merged journal's bytes; with ``reference`` each ``src`` is
    written under the reference's logger root."""
    rename = _reference_name if reference else (lambda src: src)
    return "".join(
        json.dumps({"t": round(vt, 6), "src": rename(name), "msg": msg})
        + "\n"
        for vt, name, msg in records
    ).encode()


def _reference_name(src: str) -> str:
    if src == LOGGER or src.startswith(LOGGER + "."):
        return REFERENCE_LOGGER + src[len(LOGGER):]
    return src


def _write_journal(
    records: list[tuple[float, str, str]], path: str
) -> str:
    """Merged run journal: one JSONL line per captured record, virtual
    timestamps, stable key order.  Returns the sha256 hex digest — the
    byte-identity witness for the determinism contract."""
    payload = _journal_lines(records)
    with open(path, "wb") as f:
        f.write(payload)
    return hashlib.sha256(payload).hexdigest()


def normalised_journal_digest(path: str) -> str:
    """sha256 of the journal at ``path`` with each record's ``src``
    written under the reference's logger root (``hotstuff_tpu_torch.x``
    as ``hotstuff_tpu.x``): the digest the reference's runner gives for
    the same records.  Only the comparison with the reference reads it;
    the run's own journal and ``journal_digest`` keep the port's names."""
    out = []
    with open(path, "rb") as f:
        for line in f:
            rec = json.loads(line)
            rec["src"] = _reference_name(rec["src"])
            out.append(json.dumps(rec) + "\n")
    return hashlib.sha256("".join(out).encode()).hexdigest()


def run_schedule(schedule: dict, workdir: str | None = None) -> SimVerdict:
    """Run one schedule to completion in virtual time (see module
    docstring).  ``workdir`` receives stores, rendered logs and the
    journal; a temp dir (cleaned up) is used when omitted."""
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="hotstuff-sim-") as tmp:
            return run_schedule(schedule, tmp)

    spec = schedule_to_spec(schedule, SIM_BASE_PORT)
    seed = int(schedule["seed"])

    # -- pin the ambient world ----------------------------------------
    saved_env = {
        k: os.environ.get(k)
        for k in list(_RUN_ENV_BASE)
        + ["HOTSTUFF_FAULTS", "HOTSTUFF_ADVERSARY", "HOTSTUFF_ADAPT_RNG_DIR"]
    }
    for k, v in _RUN_ENV_BASE.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    os.environ["HOTSTUFF_FAULTS"] = json.dumps(spec)
    if spec.get("adversary"):
        os.environ["HOTSTUFF_ADVERSARY"] = json.dumps(spec)
        # adversary rng continuity across crash/restart (faults/
        # adaptive.py): checkpoint the per-node draw stream under the
        # run workdir so a restarted adversary resumes it — same seed
        # must keep yielding a byte-identical journal with adaptive
        # policies active
        os.environ["HOTSTUFF_ADAPT_RNG_DIR"] = os.path.join(
            workdir, "adv-rng"
        )
    else:
        os.environ.pop("HOTSTUFF_ADVERSARY", None)
        os.environ.pop("HOTSTUFF_ADAPT_RNG_DIR", None)

    loop = SimLoop()
    clock = VirtualClock(loop)
    net = SimNet()
    prev_clock = set_default_clock(clock)
    prev_rng = set_default_rng(random.Random(f"sim-run|{seed}"))
    prev_conn = set_default_connector(net.open_connection)
    prev_net = set_current_net(net)

    capture = _LogCapture(clock)
    hs_log = logging.getLogger(LOGGER)
    prev_level = hs_log.level
    hs_log.addHandler(capture)
    hs_log.setLevel(logging.INFO)

    failures: list[str] = []
    cluster = SimCluster(schedule, workdir, net)
    try:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(cluster.run())
        except SimDeadlock as exc:
            failures.append(f"virtual-loop deadlock: {exc}")
        # drain stragglers (cancelled receiver handlers, sender
        # reconnect loops) so the loop closes clean; sorted by name so
        # cancellation order never depends on set/heap layout
        pending = sorted(
            (t for t in asyncio.all_tasks(loop) if not t.done()),
            key=lambda t: t.get_name(),
        )
        for t in pending:
            t.cancel()
        if pending:
            try:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            except SimDeadlock:
                failures.append("virtual-loop deadlock during teardown")
        loop.close()
    finally:
        asyncio.set_event_loop(None)
        set_default_clock(prev_clock)
        set_default_rng(prev_rng)
        set_default_connector(prev_conn)
        set_current_net(prev_net)
        hs_log.removeHandler(capture)
        hs_log.setLevel(prev_level)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # -- judge ---------------------------------------------------------
    logs_dir = os.path.join(workdir, "logs")
    _render_logs(capture.records, cluster.prefix_map(), logs_dir, cluster.n)
    journal_digest = _write_journal(
        capture.records, os.path.join(workdir, "journal.jsonl")
    )

    # stage attribution from the committee's flight-recorder journals
    # (best-effort: an attribution failure must never fail the verdict)
    attribution: dict | None = None
    try:
        journals_dir = os.path.join(workdir, "journals")
        if os.path.isdir(journals_dir):
            from ..telemetry import critpath as _critpath
            from ..telemetry.traces import TraceSet

            traces = TraceSet.load(journals_dir)
            if traces.journals:
                report = _critpath.analyze(traces)
                if report.commits:
                    attribution = report.attribution()
    except Exception as exc:  # noqa: BLE001 — observability is advisory
        logging.getLogger(__name__).warning(
            "sim critpath attribution failed: %s", exc
        )

    all_ok, block = check_run(logs_dir, spec, epoch_unix=SIM_EPOCH)
    commits = commits_from_logs(logs_dir)
    safety_ok, safety_viol = check_safety(commits)
    adversaries = adversaries_from_spec(spec)
    trusted_ok: bool | None = None
    trusted_viol: list = []
    if adversaries:
        trusted_ok, trusted_viol = trusted_subset_recheck(
            commits, set(adversaries)
        )

    # invariant-threat classification + timeout tally: the guided
    # explorer's fitness inputs (sim/explorer.py).  Independent of the
    # per-profile ok judgment below — a threat on an "adaptive" run can
    # be a correctly-contained attack and still score fitness.
    threats: list[str] = []
    if not safety_ok:
        threats.append("full-history-divergence")
    elif not all_ok:
        threats.append("liveness-stall")
    timeouts = sum(
        1 for _vt, _name, msg in capture.records
        if msg.startswith("Timeout reached for round")
    )

    profile = schedule.get("profile", "honest")
    if failures:
        ok = False
    elif profile == "byz-collude":
        # expectation: the collusion REALLY diverges the full history
        # (FAIL) while the trusted-subset regime absolves it (PASS)
        ok = (not safety_ok) and bool(trusted_ok)
        if safety_ok:
            failures.append("byz-collude schedule left no divergence")
        if not trusted_ok:
            failures.extend(
                f"trusted-subset: {v}" for v in (trusted_viol or ())
            )
    elif profile == "adaptive":
        # adaptive attacks range from fully absorbed (all invariants
        # green) to full-history divergence; the containment bar is the
        # trusted-subset regime — the f+1 honest view must stay
        # self-consistent no matter what the adversary pulled off
        ok = trusted_ok is not False
        if trusted_ok is False:
            failures.extend(
                f"trusted-subset: {v}" for v in (trusted_viol or ())
            )
    else:
        ok = all_ok
        if not all_ok:
            failures.append("invariant check failed (see block)")

    return SimVerdict(
        seed=seed,
        profile=profile,
        ok=ok,
        all_ok=all_ok,
        safety_ok=safety_ok,
        trusted_ok=trusted_ok,
        commits=sum(len(v) for v in commits.values()),
        rounds=max(
            (r for obs in commits.values() for _t, r, _d in obs),
            default=0,
        ),
        journal_digest=journal_digest,
        block=block,
        failures=failures,
        threats=threats,
        timeouts=timeouts,
        attribution=attribution,
        flows=cluster.flow_tables or None,
        normalised_digest=hashlib.sha256(
            _journal_lines(capture.records, reference=True)
        ).hexdigest(),
    )


__all__ = ["SimVerdict", "normalised_journal_digest", "run_schedule"]
