"""Device-mesh sharding of the Ed25519 verify kernel: the port of
``hotstuff_tpu/parallel/mesh.py``.

The verify batch is embarrassingly parallel over signatures, so its
batch axis is split over a 1-D mesh of devices (axis ``dp``): each
device runs the verify kernel (K1, ``gpu/dsm.py`` ``verify_compressed``)
on its slice with no communication, and the one word that crosses
devices is the wave's invalid count, summed onto the mesh's first
device.  The production readback fetches that word first and gathers
the lanes only when it is not 0.

The mesh is single-controller, as ``shard_map`` is: one process drives
every device of the mesh, and the JAX package's ``psum`` and gathers
become copies to the first device (nothing uses ``torch.distributed``).
A mesh may repeat a device: ``Mesh([cpu] * 8)`` in the tests stands for
the JAX tests' 8 virtual CPU devices, and ``Mesh([cuda:0] * 4)`` runs the
slicing and the reduction with four shards on one card.  Shards of one
device run on that device's stream, one after another.

A sharded operand is a tuple of tensors, one a mesh position, each on
its position's device and contiguous (K1 takes only contiguous
operands): ``shard_operands`` cuts global operands that way, as the JAX
in_specs do (the batch axis is axis 0, axis 1 of the window planes), and
``ShardedBatchVerifier`` stages each shard's block straight into it.

Deliberate differences: no ``donate`` (torch has no buffer donation;
the staging slots reuse their buffers wave after wave) and no
``interpret`` (a CUDA mesh launches the kernel, a CPU mesh runs its
plain version: JAX's ``pallas = platform == "tpu"`` choice); the
verifier's name is ``cuda-sharded-{m}``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..gpu import dsm
from ..gpu.ed25519 import BatchVerifier, resolve_device
from ..telemetry import spans as _spans

DP_AXIS = "dp"


class Mesh:
    """A 1-D mesh: the devices of the ``dp`` axis, in order.  A device
    may repeat (virtual shards); all are CUDA devices or all the CPU."""

    def __init__(self, devices, axis_names=(DP_AXIS,)):
        devices = tuple(resolve_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError("a mesh's devices are all CUDA devices or all the CPU")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def mesh_devices_from_env() -> int | None:
    """``HOTSTUFF_MESH_DEVICES`` as a positive device count, or None when
    unset/invalid (None means "use every visible device").  This is the
    env half of the node CLI's ``--mesh-devices`` bridge: it is read at
    backend materialization so run/run-many/deploy all size the
    production mesh the same way."""
    raw = os.environ.get("HOTSTUFF_MESH_DEVICES", "").strip()
    if not raw:
        return None
    try:
        n = int(raw)
    except ValueError:
        return None
    return n if n > 0 else None


def default_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D data-parallel mesh over the first ``n_devices`` visible CUDA
    devices (all of them by default).  Raises without a card: a CPU mesh
    is only ever built explicitly (``Mesh([torch.device("cpu")] * m)``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: default_mesh() spans the visible cards; build "
            "Mesh([torch.device('cpu')] * m) to run the plain versions"
        )
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def shard_operands(mesh: Mesh, ax, ay, az, at, s_win, k_win, r_y, r_sign) -> tuple:
    """Global verify operands as sharded ones, laid out as the JAX
    in_specs (``mesh.py:80-89``): the batch axis is axis 0 everywhere but
    in the window planes, where it is axis 1.  Each operand is cut into
    ``mesh.size`` equal blocks, block i a contiguous copy on device i."""

    def cut(t: torch.Tensor, axis: int = 0) -> tuple:
        if t.shape[axis] % mesh.size:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split over {mesh.size} devices")
        blocks = torch.tensor_split(t, mesh.size, dim=axis)
        return tuple(b.contiguous().to(d) for b, d in zip(blocks, mesh.devices))

    return (
        *(cut(c) for c in (ax, ay, az, at)),
        cut(s_win, 1),
        cut(k_win, 1),
        cut(r_y),
        cut(r_sign),
    )


def to_first(mesh: Mesh, parts) -> list:
    """``parts`` (one tensor a mesh position, on its device) on the mesh's
    first device, with that device's current stream ordered after the
    work that made each: every position's current stream records an
    event, which the first device's current stream waits on."""
    first = mesh.devices[0]
    out = []
    for device, t in zip(mesh.devices, parts):
        moved = t.to(first, non_blocking=True)
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            torch.cuda.current_stream(first).wait_event(done)
        out.append(moved)
    return out


def gather_lanes(lanes) -> np.ndarray:
    """The sharded verdict lanes as one host array (the cross-shard
    gather the psum word lets an all-valid wave skip)."""
    return np.concatenate([ok.cpu().numpy() for ok in lanes])


def make_sharded_verify(mesh: Mesh, psum_word: bool = False):
    """The bool verdict lanes of sharded operands (``shard_operands``),
    sharded: K1 (``dsm.verify_compressed``) on each device's slice,
    each on its device's current stream; on a CPU mesh the kernel's plain
    version.  A slice must be a multiple of ``dsm.LANE_TILE`` on CUDA (the
    verifier's pad grid guarantees it).

    ``psum_word=True`` also returns the invalid count as an int32 scalar
    on the mesh's first device, ordered after every shard: the one word
    that crosses devices."""

    def verify(ax, ay, az, at, s_win, k_win, r_y, r_sign):
        lanes = tuple(
            dsm.verify_compressed(
                s_win[i], k_win[i], (ax[i], ay[i], az[i], at[i]), r_y[i], r_sign[i]
            )
            for i in range(mesh.size)
        )
        if not psum_word:
            return lanes
        counts = to_first(
            mesh, [torch.logical_not(ok).sum(dtype=torch.int32) for ok in lanes]
        )
        return lanes, torch.stack(counts).sum(dtype=torch.int32)

    return verify


def make_sharded_qc_check(mesh: Mesh):
    """"Is every signature of this QC valid", from sharded operands: a
    bool scalar on the mesh's first device, from the psum word of the
    per-device invalid counts."""
    verify = make_sharded_verify(mesh, psum_word=True)

    def qc_check(*operands) -> torch.Tensor:
        return verify(*operands)[1] == 0

    return qc_check


class ShardedBatchVerifier(BatchVerifier):
    """BatchVerifier whose kernel runs sharded over a device mesh.

    Host-side batch preparation (point-cache lookups, challenge hashing,
    padding) is inherited; each shard's block is staged contiguously onto
    its device, and the committee key table is replicated on every mesh
    device once per rebuild, each device gathering its own slice of the
    rows (``_device_build``, ``_gather_device_rows``).  Pads so that every
    device gets an equal slice."""

    def __init__(self, mesh: Mesh | None = None, min_device_batch: int = 64):
        mesh = mesh if mesh is not None else default_mesh()
        super().__init__(min_device_batch=min_device_batch, device=mesh.devices[0])
        self.mesh = mesh
        self._shard_devices = mesh.devices
        m = mesh.size
        # the per-item lanes (verify_packed, stage) and the psum-word
        # variant the production verify_device dispatches
        self._kernel = make_sharded_verify(mesh)
        self._kernel_psum = make_sharded_verify(mesh, psum_word=True)
        self.name = f"cuda-sharded-{m}"
        if self.device.type == "cuda":
            # per-shard batches are lane-tile multiples, with the
            # intermediate multiples on the grid (a 256-vote QC pads to
            # m*256, not m*1024)
            self.pad_sizes = tuple(m * k * dsm.LANE_TILE for k in (1, 2, 4, 8))
        else:
            # equal per-device slices: powers of two from one row per
            # device up to 8192, so each canonical bucket is its own
            # kernel shape at every mesh size
            sizes, s = [], m
            while s <= 8192:
                sizes.append(s)
                s *= 2
            self.pad_sizes = tuple(sizes)
        # the canonical bucket ladder (with the 4096 train bucket)
        # snapped up to this mesh's pad grid, advertised to the wave
        # service: every padded wave is a pad shape with equal slices
        grid = self.pad_sizes
        snapped = (
            next((p for p in grid if p >= b), grid[-1])
            for b in (16, 64, 256, 1024, 4096)
        )
        self.wave_bucket_shapes = tuple(sorted(set(snapped)))

    def _kernel_operands(self, shards: list) -> tuple:
        # eight sharded operands, each a tuple of the shards' tensors
        return tuple(zip(*shards))

    def _run_kernel(self, ax, ay, az, at, s_win, k_win, r_y, r_sign) -> torch.Tensor:
        """Sharded dispatch without the word: the lanes gathered onto the
        mesh's first device."""
        lanes = self._kernel(ax, ay, az, at, s_win, k_win, r_y, r_sign)
        return torch.cat(to_first(self.mesh, lanes))

    def verify_device(self, messages, pubkeys, signatures) -> np.ndarray:
        """Mesh dispatch with the psum-word readback: each wave returns
        the sharded lanes AND the invalid count on the first device.  The
        host fetches that word first and gathers the lanes only when
        something was invalid, so an all-valid wave's readback is one
        scalar.  Under the profiler the word fetch is its own
        ``mesh.psum`` span, between device.execute and readback."""
        n = len(messages)
        if n == 0:
            return np.zeros(0, bool)
        if n > self.pad_sizes[-1]:
            # oversized batches chunk through the base class, which
            # comes back here a largest-pad chunk at a time
            return super().verify_device(messages, pubkeys, signatures)
        rec = _spans.recorder()
        with self._on_thread_stream():
            if rec is None:
                valid_host, arrays = self.prepare(messages, pubkeys, signatures)
                lanes, bad = self._kernel_psum(*arrays)
                if int(bad) == 0:
                    # every lane valid => host validity was all-True too
                    # (host-invalid rows are zeroed into failing lanes)
                    return np.ones(n, bool)
                return gather_lanes(lanes)[:n] & valid_host
            with rec.span("prepare"):
                valid_host, arrays = self.prepare(messages, pubkeys, signatures)
            with rec.span("dispatch"):
                lanes, bad = self._kernel_psum(*arrays)
            with rec.span("device.execute"):
                self._sync()
            with rec.span("mesh.psum"):
                bad_count = int(bad)
            if bad_count == 0:
                return np.ones(n, bool)
            with rec.span("readback"):
                return gather_lanes(lanes)[:n] & valid_host
