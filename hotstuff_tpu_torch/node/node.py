"""Node: the composition root wiring store, crypto and consensus, and
the device-verifier host where a node's signature batches are verified.

A copy of ``hotstuff_tpu/node/node.py`` (reference
``node/src/node.rs:16-65``).  ``Node.new`` reads the committee, key and
parameters files, opens the store under the committee-hash provenance
check, replays the certified schedule links a previous lifetime
persisted, warms the device verifier and spawns ``Consensus``;
``serve`` drains commits until a committed reconfiguration retires the
node.

``_DeviceDispatch``, ``LazyDeviceVerifier`` and ``make_verifier`` have
the device kind ``"cuda"``, which materializes the port's
``gpu.ed25519.BatchVerifier(min_device_batch=64)`` for an Ed25519
committee and ``crypto.scheme.make_device_verifier("bls", "cuda")`` (the
G1 sums on the card) for a BLS one, and the mesh kind
``"cuda-sharded"`` (alias ``"mesh"``), which materializes
``parallel.mesh.ShardedBatchVerifier`` over ``HOTSTUFF_MESH_DEVICES``
cards (every visible one by default) or the BLS verifier with its G1
sums sharded over the cards; ``"cpu"`` is the host verifier.  The JAX
package's ``"tpu"`` and ``"tpu-sharded"`` raise, naming the port's
kinds.
A mixed-scheme schedule verifies through the dual router
(``crypto.scheme.make_dual_verifier``).  ``Node.new`` has
the reference's telemetry, flight-recorder journal and work-stats
branches (a ``NodeTelemetry`` handle when telemetry is on, a ``Journal``
when journaling is, a ``CountingVerifier`` and the ``Work stats:`` probe
with ``HOTSTUFF_WORK_STATS``, the ``Telemetry snapshot:`` logger) and
its health branch (with telemetry on and ``HOTSTUFF_HEALTH`` set, a
``HealthMonitor`` task fed by ``critpath.rolling_attribution`` over the
node's trace ring, its campaign ring beside the journal, and the
snapshot's ``health`` section).  Added
to the copy: ``LazyDeviceVerifier.routes``, the inline batches each
route took, and ``_DeviceDispatch.verify_packed``, so a wave adopted
from an ingest arena reaches the kernel from the arena's columns.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil

from ..consensus import Consensus, Parameters
from ..consensus.config import CommitteeSchedule
from ..crypto.digest import sha512_trunc
from ..crypto.scheme import (
    make_cpu_verifier,
    make_device_verifier,
    make_signing_service,
)
from ..crypto.service import CpuVerifier, VerifierBackend
from ..store import Store
from .config import ConfigError, Secret, read_committee, read_parameters

log = logging.getLogger(__name__)

#: the JAX package's device kinds -> the port's
_TPU_KINDS = {"tpu": "cuda", "tpu-sharded": "cuda-sharded"}

#: provenance tag on persisted state: the hash of the committee the
#: store's consensus/state records were produced under.  Disjoint from
#: every other store namespace (32-byte digests, 8-byte round keys,
#: ``consensus_state``, ``latest_round``, ``p<digest>``, ``s/...``).
COMMITTEE_HASH_KEY = b"committee_hash"


def committee_hash(committee) -> bytes:
    """Canonical identity of a committee (or schedule): the digest of
    its sorted-key JSON form — the same serialization the config files
    carry, so identical files hash identically across nodes."""
    return sha512_trunc(
        json.dumps(committee.to_json(), sort_keys=True).encode()
    )


class _DeviceDispatch:
    """Forced-device view of a shared BatchVerifier for the async verify
    service (crypto/async_service.py): the service makes the
    device-vs-CPU routing decision itself, so this view must never
    silently re-route a batch back to the host the way the hybrid
    ``verify_many`` would.  One instance per (kind, device),
    process-wide — its identity is the coalescing key: every in-process
    core's claims land in the same dispatch stream."""

    def __init__(self, device):
        self._device = device
        self.name = getattr(device, "name", "cuda")
        # the async service pads device waves only when the real
        # verifier behind this view opted in
        self.supports_wave_padding = getattr(
            device, "supports_wave_padding", False
        )

    def verify_many(
        self, digests, pks, sigs, aggregate_ok: bool = False
    ) -> list:
        return [bool(v) for v in self._device.verify_device(digests, pks, sigs)]

    def verify_packed(self, dig_buf, pk_buf, sig_buf, rows: int):
        """An adopted ingest arena's columns straight to the device
        verifier (``crypto/async_service.py`` ``eval_claims_arena``).
        The JAX package's view has no such method, so its adopted waves
        flatten their claims after all; here they stage from the
        arena."""
        return self._device.verify_packed(dig_buf, pk_buf, sig_buf, rows)

    def warm_thread(self, batches) -> None:
        """The calling slot thread's staging for ``batches``
        (``AsyncVerifyService.warm_buckets``)."""
        warm = getattr(self._device, "warm_thread", None)
        if warm is not None:
            warm(batches)


class LazyDeviceVerifier:
    """Defers building the device verifier until a batch is big enough
    for the device.  Small batches route to the CPU backend exactly like
    the device verifier's own hybrid routing.

    The materialized device verifier is shared per (kind, device),
    process-wide: an in-process committee holds ONE point cache and ONE
    set of staging buffers, and the async verify service
    (``async_backend``) coalesces every core's claims into one dispatch
    stream.  Keying by device keeps a CPU host and a CUDA host in one
    process apart.

    ``kind`` is ``"cuda"`` (one card) or ``"cuda-sharded"`` (alias
    ``"mesh"``: the batch sharded over a mesh of ``HOTSTUFF_MESH_DEVICES``
    cards, every visible one by default, read when the verifier
    materializes).  ``device`` defaults to ``cuda`` and raises without
    one; the tests pass ``device="cpu"``, which runs the kernels' plain
    versions (the mesh kind: over ``HOTSTUFF_MESH_DEVICES`` virtual CPU
    shards, one by default)."""

    min_device_batch = 64

    # both kinds materialize ed25519 BatchVerifiers, which accept
    # fixed-shape wave padding
    supports_wave_padding = True

    #: "mesh" is the user-facing spelling of the sharded kind (node
    #: --verifier mesh); it normalizes at construction, so both names
    #: share one process-wide device verifier and warm state
    _KIND_ALIASES = {"mesh": "cuda-sharded"}

    _shared_device: dict[tuple, VerifierBackend] = {}
    _shared_dispatch: dict[tuple, _DeviceDispatch] = {}
    # (kind, device) pairs whose device verifier has been warmed in THIS
    # process — the async service routes to the device only then
    _warm: set[tuple] = set()

    def __init__(self, kind: str = "cuda", device=None):
        kind = self._KIND_ALIASES.get(kind, kind)
        if kind not in ("cuda", "cuda-sharded"):
            raise ValueError(f"unknown device verifier kind '{kind}'")
        from ..gpu.ed25519 import resolve_device

        self.device = resolve_device(device)
        self._kind = kind
        self._key = (kind, str(self.device))
        self._cpu = CpuVerifier()
        self._precomputed: list[bytes] = []
        self.name = kind
        # batches this instance verified inline, by route (the wave
        # service's off-loop claims are counted by the service)
        self.routes = {"cpu": 0, "device": 0}
        # Advertises the async off-loop claim path to AsyncVerifyService
        # (one coalescing service per kind and device per loop).
        self.async_kind = f"{kind}@{self.device}"

    @property
    def cpu_backend(self) -> CpuVerifier:
        return self._cpu

    @property
    def device_ready(self) -> bool:
        """True once the device verifier is warm — the async service must
        never trigger a kernel build mid-consensus."""
        return self._key in self._warm

    @property
    def _device(self) -> VerifierBackend | None:
        return self._shared_device.get(self._key)

    @property
    def wave_bucket_shapes(self) -> tuple | None:
        """The device verifier's advertised wave bucket ladder (the mesh
        verifier's mesh-multiple shapes) — None until the device
        materializes, so the wave service's lazy bucket resolution uses
        the canonical ladder before warmup and the mesh grid from then
        on."""
        device = self._device
        if device is None:
            return None
        return getattr(device, "wave_bucket_shapes", None)

    def _materialize(self) -> VerifierBackend:
        device = self._shared_device.get(self._key)
        if device is None:
            if self._kind == "cuda":
                from ..gpu.ed25519 import BatchVerifier

                device = BatchVerifier(
                    min_device_batch=self.min_device_batch, device=self.device
                )
            else:
                from ..parallel.mesh import (
                    Mesh,
                    ShardedBatchVerifier,
                    default_mesh,
                    mesh_devices_from_env,
                )

                # HOTSTUFF_MESH_DEVICES (node --mesh-devices) sizes the
                # mesh; read HERE, when the mesh is built, because the
                # CLI bridge sets it before any verifier exists
                n = mesh_devices_from_env()
                mesh = (
                    Mesh([self.device] * (n or 1))
                    if self.device.type == "cpu"
                    else default_mesh(n)
                )
                device = ShardedBatchVerifier(
                    mesh=mesh, min_device_batch=self.min_device_batch
                )
            self._shared_device[self._key] = device
        if self._precomputed:
            device.precompute(self._precomputed)
            self._precomputed = []
        return device

    @property
    def async_backend(self) -> _DeviceDispatch:
        """The shared forced-device dispatch view (one per kind and
        device) the async verify service coalesces on."""
        dispatch = self._shared_dispatch.get(self._key)
        if dispatch is None:
            dispatch = _DeviceDispatch(self._materialize())
            self._shared_dispatch[self._key] = dispatch
        return dispatch

    def precompute(self, pubkeys: list[bytes]) -> None:
        self._precomputed = list(pubkeys)
        if self._device is not None:
            self._device.precompute(pubkeys)

    def warmup(self, batch: int | None = None) -> None:
        if self._key in self._warm:
            return  # the shared device instance is already warm
        self._materialize().warmup(batch)
        self._warm.add(self._key)

    def verify_one(self, digest, pk, sig) -> bool:
        return self._cpu.verify_one(digest, pk, sig)

    def verify_shared_msg(self, digest, votes) -> bool:
        if len(votes) < self.min_device_batch:
            self.routes["cpu"] += 1
            return self._cpu.verify_shared_msg(digest, votes)
        self.routes["device"] += 1
        return self._materialize().verify_shared_msg(digest, votes)

    def verify_many(
        self, digests, pks, sigs, aggregate_ok: bool = False
    ) -> list[bool]:
        if len(digests) < self.min_device_batch:
            self.routes["cpu"] += 1
            return self._cpu.verify_many(digests, pks, sigs)
        self.routes["device"] += 1
        return self._materialize().verify_many(
            digests, pks, sigs, aggregate_ok=aggregate_ok
        )


def make_verifier(
    kind: str, scheme: str = "ed25519", device=None
) -> VerifierBackend:
    """The verifier backend a node uses: ``"cpu"``, ``"cuda"`` or
    ``"cuda-sharded"`` (alias ``"mesh"``).  ``device`` (the device kinds
    only) defaults to the current CUDA device and raises without one;
    ``device="cpu"`` runs the kernels' plain versions.  A BLS committee's
    device verifier sums vote signatures on the card's G1 kernels (over
    the mesh of every visible card for the sharded kind), with the
    pairing on the host."""
    if kind == "cpu":
        return make_cpu_verifier(scheme)
    if kind in ("cuda", "cuda-sharded", "mesh"):
        if scheme == "bls":
            return make_device_verifier(
                scheme, "cuda" if kind == "cuda" else "cuda-sharded", device=device
            )
        return LazyDeviceVerifier(kind, device=device)
    if kind in _TPU_KINDS:
        raise ValueError(
            f"'{kind}' is the JAX package's verifier: the port's is "
            f"'{_TPU_KINDS[kind]}'"
        )
    raise ValueError(f"unknown verifier backend '{kind}'")


def campaign_file(jdir: str, node: str) -> str:
    """Where a node's campaign ring persists: beside its journal
    segments, under the journal's filename-safe form of the node id.
    The reference joins the raw id, and a base64 id holding ``/`` then
    names a missing subdirectory, so that node's ring never persists
    (about one node in eight); the id itself stays in the file's
    ``node`` field, which is what ``benchmark.traces.load_campaigns``
    reads."""
    from ..telemetry.health import CAMPAIGN_SUFFIX
    from ..telemetry.journal import _sanitize

    return os.path.join(jdir, f"{_sanitize(node)}{CAMPAIGN_SUFFIX}")


class Node:
    CHANNEL_CAPACITY = 1_000

    def __init__(self):
        self.commit: asyncio.Queue | None = None
        self.consensus: Consensus | None = None
        self.store: Store | None = None
        self._journal = None
        self._stats_task: asyncio.Task | None = None
        self._snapshot_task: asyncio.Task | None = None
        self._health_task: asyncio.Task | None = None
        self._health_monitor = None

    @classmethod
    async def new(
        cls,
        committee_file: str,
        key_file: str,
        store_path: str,
        parameters_file: str | None = None,
        verifier_backend: str = "cuda",
        bind_host: str = "0.0.0.0",
        transport: str = "asyncio",
        device=None,
    ) -> "Node":
        """Boot a node.  ``verifier_backend`` is ``"cuda"`` (the
        default: it raises without a CUDA device), ``"cuda-sharded"``
        (alias ``"mesh"``) or ``"cpu"``;
        ``device`` goes to ``make_verifier`` (``device="cpu"`` runs the
        kernels' plain versions); ``transport`` is ``"asyncio"`` or
        ``"native"`` (the C++ reactor, ``network/native.py``)."""
        self = cls()
        committee = read_committee(committee_file)
        # Live reconfiguration (docs/RECONFIG.md) needs a spliceable
        # schedule: a bare committee file is promoted to a
        # single-entry schedule so a committed epoch change can extend
        # it at runtime.  for_round keeps every consumer oblivious.
        if not hasattr(committee, "splice"):
            committee = CommitteeSchedule([(1, committee)])
        secret = Secret.read(key_file)
        schemes = {c.scheme for c in committee.committees()}
        if len(schemes) == 1:
            if secret.scheme != next(iter(schemes)):
                raise ConfigError(
                    f"key file scheme '{secret.scheme}' does not match the "
                    f"committee scheme '{next(iter(schemes))}'"
                )
        else:
            # Mixed-scheme schedule (scheme changeover at an epoch
            # boundary): identities are per-scheme — this node signs
            # under its own key's scheme and must be a member of at
            # least one epoch using it; verification must handle BOTH
            # schemes (old-epoch certificates keep verifying after the
            # changeover), so the verifier is the dual router.
            my_epochs = [
                c for c in committee.committees()
                if secret.name in c.authorities
            ]
            if not my_epochs:
                raise ConfigError(
                    "key is not a member of any epoch in the schedule"
                )
            if any(c.scheme != secret.scheme for c in my_epochs):
                raise ConfigError(
                    f"key file scheme '{secret.scheme}' does not match an "
                    "epoch this key belongs to"
                )
        parameters = (
            read_parameters(parameters_file) if parameters_file else Parameters()
        )
        # before the store opens: a "cuda" verifier without a CUDA
        # device raises here, with nothing on disk touched
        if len(schemes) == 1:
            verifier = make_verifier(
                verifier_backend, next(iter(schemes)), device=device
            )
        else:
            from ..crypto.scheme import make_dual_verifier

            verifier = make_dual_verifier(
                lambda s: make_verifier(verifier_backend, s, device=device)
            )

        self.store = Store(store_path)
        # Committee-hash provenance: persisted consensus/execution state
        # is only valid under the committee that produced it.  A store
        # carrying another committee's history is rejected EXPLICITLY
        # and discarded.  HOTSTUFF_FRESH_STATE=1 (--fresh-state) forces
        # a clean slate regardless of provenance.
        #
        # The hash anchors on the GENESIS-era committee only: under live
        # reconfiguration the on-disk file stays the genesis artifact
        # while the store's schedule legitimately evolves past it — the
        # evolution itself is re-proven at boot from the certified
        # schedule links persisted at each commit (below).
        chash = committee_hash(committee.committees()[0])
        # one-time boot path: the node serves no traffic until new()
        # returns, so a synchronous engine read cannot stall a round
        stored_hash = self.store.engine.get(COMMITTEE_HASH_KEY)
        fresh = os.environ.get("HOTSTUFF_FRESH_STATE", "") not in ("", "0")
        if fresh or (stored_hash is not None and stored_hash != chash):
            if fresh:
                log.info("Discarding persisted state (--fresh-state)")
            else:
                log.warning(
                    "Rejecting persisted state from a different committee "
                    "(stored %s, ours %s): starting fresh",
                    stored_hash.hex()[:16],
                    chash.hex()[:16],
                )
            self.store.close()
            shutil.rmtree(store_path, ignore_errors=True)
            self.store = Store(store_path)
        self.store.engine.put(COMMITTEE_HASH_KEY, chash)
        signature_service = make_signing_service(secret.scheme, secret.secret)
        # Verified-successor acceptance: replay the certified schedule
        # links a previous process lifetime persisted (core commit path,
        # SCHEDULE_LINKS_KEY) so a restart resumes with the same epoch
        # schedule it shut down with — each link is re-verified against
        # the schedule as extended so far, never trusted from disk.
        from ..consensus.core import SCHEDULE_LINKS_KEY
        from ..consensus.errors import InvalidReconfig
        from ..consensus.reconfig import splice_schedule_links
        from ..consensus.wire import decode_schedule_links
        from ..utils.codec import CodecError

        raw_links = self.store.engine.get(SCHEDULE_LINKS_KEY)
        if raw_links:
            try:
                n = splice_schedule_links(
                    decode_schedule_links(raw_links),
                    committee,
                    verifier,
                    log=log,
                )
                if n:
                    log.info(
                        "Replayed %d certified schedule links from the "
                        "store (newest epoch %d)",
                        n,
                        max(c.epoch for c in committee.committees()),
                    )
            except (CodecError, InvalidReconfig) as e:
                log.warning("Ignoring persisted schedule links: %s", e)
        if hasattr(verifier, "precompute"):
            # stage the device verifier's committee point cache
            verifier.precompute(
                [pk.to_bytes() for pk in committee.authorities]
            )
        committee_size = len(committee.authorities)
        # Nodes co-located in this process (run-many sets the hint): their
        # verification claims coalesce into ONE dispatch stream, so the
        # device pays off far below the per-node min_device_batch and the
        # warm shapes must cover whole-committee waves.
        colocated = int(os.environ.get("HOTSTUFF_COLOCATED_NODES", "1") or 1)
        # HOTSTUFF_SKIP_WARMUP (diagnostic): run the device-verifier
        # plumbing with the kernels never built — the service's ready
        # gate keeps everything on the CPU.
        if hasattr(verifier, "warmup") and not os.environ.get(
            "HOTSTUFF_SKIP_WARMUP"
        ) and (
            committee_size >= getattr(verifier, "min_device_batch", 0)
            or colocated > 1
        ):
            # build and stage the device verifier BEFORE binding the
            # consensus port: a cold build on the first QC verify would
            # stall past the round timeout and trigger view changes.
            # Skipped when every possible batch (<= committee size)
            # routes to the CPU anyway.
            quorum = committee_size * 2 // 3 + 1
            wave = (
                committee_size
                if colocated <= 1
                else min(1024, colocated * (quorum + 2))
            )
            verifier.warmup(batch=wave)

        from .. import telemetry

        tel = telemetry.for_node(str(secret.name)[:8])
        # Flight recorder (telemetry/journal.py): must attach BEFORE
        # Consensus.spawn — the consensus actors capture
        # ``telemetry.journal`` at construction time.
        jdir = telemetry.journal_dir(store_path)
        if tel is not None and jdir:
            from ..telemetry.journal import Journal

            self._journal = Journal(tel.node, jdir)
            tel.attach_journal(self._journal)
            if telemetry.spans.enabled():
                # verify-pipeline spans render as one per-process track
                # in the merged trace (first journaled node wins)
                telemetry.spans.attach_journal(self._journal)
            log.info("Flight recorder journaling to %s", jdir)
        stats_task = None
        probe_running = False
        if tel is not None or os.environ.get("HOTSTUFF_WORK_STATS"):
            # per-node work accounting for the committee-scaling
            # decomposition (utils/workstats.py): counted verifier +
            # loop-lag probe, one parseable log line every few seconds.
            # Telemetry reuses the same counted-verifier wrapper; the
            # snapshot document is a superset of the Work stats one.
            from ..utils.workstats import CountingVerifier, WorkStats, run_probe

            stats = WorkStats()
            verifier = CountingVerifier(verifier, stats)
            if os.environ.get("HOTSTUFF_WORK_STATS"):
                probe_running = True
                stats_task = asyncio.ensure_future(
                    run_probe(
                        stats, logging.getLogger(f"workstats.{secret.name}")
                    )
                )
            if tel is not None:
                tel.attach_workstats(stats)

        self.commit = asyncio.Queue(maxsize=self.CHANNEL_CAPACITY)
        self.consensus = await Consensus.spawn(
            secret.name,
            committee,
            parameters,
            signature_service,
            self.store,
            self.commit,
            verifier=verifier,
            bind_host=bind_host,
            transport=transport,
            telemetry=tel,
        )
        self._stats_task = stats_task
        if tel is not None:
            from ..telemetry.exporter import run_snapshot_logger

            # the snapshot logger samples loop lag only when no workstats
            # probe is doing it already (double-counting would halve the
            # reported mean)
            self._snapshot_task = asyncio.ensure_future(
                run_snapshot_logger(
                    tel,
                    logging.getLogger(f"telemetry.{secret.name}"),
                    sample_lag=not probe_running,
                )
            )
        if tel is not None and telemetry.health_enabled():
            from ..telemetry.critpath import rolling_attribution
            from ..telemetry.health import HealthMonitor

            # campaign ring persists beside the journal (when journaling
            # is on) as <node>-campaign.json — a name the journal
            # loader's *.jsonl glob never matches
            campaign_path = campaign_file(jdir, tel.node) if jdir else None
            self._health_monitor = HealthMonitor(
                tel,
                tel.node,
                timeout_s=parameters.timeout_delay / 1000.0,
                campaign_path=campaign_path,
                logger=logging.getLogger(f"health.{secret.name}"),
                # rolling critical-path attribution over the node's own
                # trace ring (health.py is import-free, so the engine
                # hook is injected here)
                attribution_fn=lambda t=tel: rolling_attribution(
                    t.trace.recent(64)
                ),
            )
            self._health_task = asyncio.ensure_future(
                self._health_monitor.run()
            )
            # the live watch scrapes node-local incidents out of the
            # snapshot: the node's own monitor sees a commit stall a
            # fleet-side detector could only infer
            tel.add_section(
                "health",
                lambda m=self._health_monitor: {
                    "open": sorted(i.kind for i in m.open_incidents()),
                    **(
                        {
                            "dominant_stage": m.last_attribution.get(
                                "dominant", ""
                            ),
                            "regime": m.last_attribution.get("regime", ""),
                        }
                        if m.last_attribution
                        else {}
                    ),
                },
            )
            log.info("Health monitor running for node %s", tel.node)
        log.info("Node %s successfully booted", secret.name)
        return self

    async def analyze_block(self) -> None:
        """Drain the commit channel — the application layer stub
        (node/src/node.rs:61-65)."""
        while True:
            _block = await self.commit.get()
            # Here the application would execute the committed payload.

    async def serve(self) -> None:
        """Drain commits until the core retires — a committed epoch
        change excluded this node and its grace window elapsed
        (docs/RECONFIG.md) — then linger briefly so straggling peers can
        still fetch boundary certificates and snapshots, and shut down
        cleanly.  Nodes that are never voted out serve forever."""
        drain = asyncio.ensure_future(self.analyze_block())
        try:
            core = self.consensus.core
            while not getattr(core, "retired", False):
                await asyncio.sleep(0.5)
            linger = float(
                os.environ.get("HOTSTUFF_RECONFIG_LINGER_S", "5") or 5
            )
            log.info(
                "Core retired; lingering %.1f s for boundary sync "
                "before shutdown",
                linger,
            )
            await asyncio.sleep(linger)
        finally:
            drain.cancel()
        await self.shutdown()
        log.info("Node retired cleanly")

    async def shutdown(self) -> None:
        for task in (self._stats_task, self._snapshot_task):
            if task is not None:
                task.cancel()
        self._stats_task = self._snapshot_task = None
        if self._health_task is not None:
            # the monitor's own ``finally`` makes the last campaign
            # persist; it runs before the journal below closes
            self._health_task.cancel()
            await asyncio.gather(self._health_task, return_exceptions=True)
            self._health_task = self._health_monitor = None
        if self.consensus is not None:
            await self.consensus.shutdown()
            self.consensus = None
        if self._journal is not None:
            self._journal.close()
            self._journal = None
        if self.store is not None:
            self.store.close()
            self.store = None
