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
``gpu.ed25519.BatchVerifier(min_device_batch=64)``; ``"cpu"`` is the
host verifier.  The mesh kinds (``"tpu-sharded"``, ``"mesh"``) and BLS
device verifiers are not ported yet and raise, and so does a
mixed-scheme schedule (its dual verifier needs BLS).  The node's
telemetry, flight-recorder journal, work-stats and health branches are
not ported either: their planes come with the port's telemetry.  Added
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
from ..crypto.scheme import make_cpu_verifier, make_signing_service
from ..crypto.service import CpuVerifier, VerifierBackend
from ..store import Store
from .config import ConfigError, Secret, read_committee, read_parameters

log = logging.getLogger(__name__)

#: verifier kinds whose port is still to come (the multi-device mesh)
_NOT_PORTED = ("tpu-sharded", "mesh")

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

    ``device`` defaults to ``cuda`` and raises without one; the tests
    pass ``device="cpu"``, which runs the kernels' plain versions."""

    min_device_batch = 64

    # the kind materializes an ed25519 BatchVerifier, which accepts
    # fixed-shape wave padding
    supports_wave_padding = True

    _shared_device: dict[tuple, VerifierBackend] = {}
    _shared_dispatch: dict[tuple, _DeviceDispatch] = {}
    # (kind, device) pairs whose device verifier has been warmed in THIS
    # process — the async service routes to the device only then
    _warm: set[tuple] = set()

    def __init__(self, kind: str = "cuda", device=None):
        if kind != "cuda":
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

    def _materialize(self) -> VerifierBackend:
        device = self._shared_device.get(self._key)
        if device is None:
            from ..gpu.ed25519 import BatchVerifier

            device = BatchVerifier(
                min_device_batch=self.min_device_batch, device=self.device
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
    """The verifier backend a node uses: ``"cpu"`` or ``"cuda"``.
    ``device`` (``"cuda"`` kind only) defaults to the current CUDA
    device and raises without one; ``device="cpu"`` runs the kernels'
    plain versions."""
    if kind == "cpu":
        return make_cpu_verifier(scheme)
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"the '{kind}' verifier is not ported yet")
    if kind == "cuda":
        if scheme != "ed25519":
            raise NotImplementedError(
                f"a {scheme} device verifier is not ported yet"
            )
        return LazyDeviceVerifier(kind, device=device)
    raise ValueError(f"unknown verifier backend '{kind}'")


class Node:
    CHANNEL_CAPACITY = 1_000

    def __init__(self):
        self.commit: asyncio.Queue | None = None
        self.consensus: Consensus | None = None
        self.store: Store | None = None

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
        default: it raises without a CUDA device) or ``"cpu"``;
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
        if len(schemes) != 1:
            # a scheme changeover at an epoch boundary verifies both
            # schemes through the dual router, which needs BLS
            raise NotImplementedError(
                "mixed-scheme schedules are not ported yet"
            )
        if secret.scheme != next(iter(schemes)):
            raise ConfigError(
                f"key file scheme '{secret.scheme}' does not match the "
                f"committee scheme '{next(iter(schemes))}'"
            )
        parameters = (
            read_parameters(parameters_file) if parameters_file else Parameters()
        )
        # before the store opens: a "cuda" verifier without a CUDA
        # device raises here, with nothing on disk touched
        verifier = make_verifier(
            verifier_backend, next(iter(schemes)), device=device
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
        )
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
        if self.consensus is not None:
            await self.consensus.shutdown()
            self.consensus = None
        if self.store is not None:
            self.store.close()
            self.store = None
