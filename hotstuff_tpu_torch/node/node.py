"""The node's device-verifier host: where a node's signature batches
are verified.

A copy of ``hotstuff_tpu/node/node.py:52-224`` — ``_DeviceDispatch``,
``LazyDeviceVerifier`` and ``make_verifier`` — with the device kind
``"cuda"``, which materializes the port's
``gpu.ed25519.BatchVerifier(min_device_batch=64)``.  ``"cpu"`` is the
host verifier.  The mesh kinds (``"tpu-sharded"``, ``"mesh"``) and BLS
device verifiers are not ported yet and raise.  Added to the copy:
``LazyDeviceVerifier.routes``, the inline batches each route took.  The
``Node`` class, the composition root that wires store, signing service
and consensus, is not ported yet (``bench/committee.py`` wires the
consensus stacks).
"""

from __future__ import annotations

from ..crypto.scheme import make_cpu_verifier
from ..crypto.service import CpuVerifier, VerifierBackend

#: verifier kinds whose port is still to come (the multi-device mesh)
_NOT_PORTED = ("tpu-sharded", "mesh")


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
