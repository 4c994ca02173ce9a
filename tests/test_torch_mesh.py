"""The port's mesh verifier (hotstuff_tpu_torch/parallel/mesh.py) on
virtual CPU meshes, ``Mesh([cpu] * m)``, against the JAX package's
``ShardedBatchVerifier(default_mesh(m))`` on the conftest's virtual
8-device CPU mesh and against the oracle (``ed25519_ref.verify``).

Verdicts are booleans and the pad grids integers, so every comparison
is exact (tolerance zero).  A CPU mesh runs the kernel's plain version
on each shard, ~0.6 s a shard call here: the waves are small, and the
JAX verifier compiles one shape a mesh size (~25 s each)."""

import asyncio

import numpy as np
import pytest
import torch

from hotstuff_tpu.parallel.mesh import ShardedBatchVerifier as JaxShardedBatchVerifier
from hotstuff_tpu.parallel.mesh import default_mesh as jax_default_mesh
from hotstuff_tpu_torch.crypto import Digest, Signature, ed25519_ref as ref, generate_keypair
from hotstuff_tpu_torch.crypto.async_service import AsyncVerifyService
from hotstuff_tpu_torch.crypto.service import CpuVerifier
from hotstuff_tpu_torch.gpu import dsm
from hotstuff_tpu_torch.gpu.ed25519 import BatchVerifier
from hotstuff_tpu_torch.node import LazyDeviceVerifier, make_verifier
from hotstuff_tpu_torch.node.node import _DeviceDispatch
from hotstuff_tpu_torch.parallel import mesh as M
from hotstuff_tpu_torch.telemetry import spans

from .common import async_test
from .test_torch_ed25519 import _adversarial, _oracle, _sign_many

# The operands are small: intra-op threads would only contend with the
# other test workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(m: int) -> M.Mesh:
    return M.Mesh([CPU] * m)


def _wave():
    """24 claims: the seven adversarial cases of tests/test_tpu_ed25519.py
    (bad R, flipped s, wrong message, wrong key, s + L, undecodable key,
    R with y >= p), s = L, and valid claims."""
    msgs, pks, sigs = _adversarial()
    more = _sign_many(14, lambda i: b"mesh wave %d" % i, seed0=40)
    return msgs + more[0], pks + more[1], sigs + more[2]


@pytest.fixture(scope="module")
def wave():
    """(claims, the oracle's verdicts, the port's verdicts by mesh size,
    filled on first use)."""
    claims = _wave()
    return claims, _oracle(*claims), {}


def _port_verdicts(wave, m: int) -> list:
    """The port's verdicts on the wave at mesh size m, computed once."""
    claims, _, cache = wave
    if m not in cache:
        v = M.ShardedBatchVerifier(_mesh(m), min_device_batch=0)
        cache[m] = v.verify_device(*claims).tolist()
    return cache[m]


def _qc(n: int, forged=(), seed: int = 0x71):
    """n votes over one digest; ``forged`` votes sign another digest."""
    digest = Digest.of(bytes([seed]) * 8)
    other = Digest.of(b"not the block")
    msgs, pks, sigs = [], [], []
    for i in range(n):
        pk, sk = generate_keypair(bytes([seed]) * 32, i)
        msgs.append(digest.to_bytes())
        pks.append(pk.to_bytes())
        sigs.append(Signature.new(other if i in forged else digest, sk).to_bytes())
    return msgs, pks, sigs


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_pad_grid_and_buckets_equal_jax(m):
    port = M.ShardedBatchVerifier(_mesh(m), min_device_batch=0)
    jax = JaxShardedBatchVerifier(mesh=jax_default_mesh(m), min_device_batch=0)
    assert port.pad_sizes == tuple(jax.pad_sizes)
    assert port.wave_bucket_shapes == tuple(jax.wave_bucket_shapes)
    assert port.name == f"cuda-sharded-{m}" and jax.name == f"tpu-sharded-{m}"
    assert all(p % m == 0 for p in port.pad_sizes)
    assert 4096 in port.wave_bucket_shapes


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_verdicts_equal_the_oracle_at_every_mesh_size(wave, m):
    want = wave[1]
    assert _port_verdicts(wave, m) == want
    assert want.count(False) == 8  # every adversarial case fails


@pytest.mark.parametrize("m", [1, 4])
def test_verdicts_equal_jax_bit_for_bit(wave, m):
    jax = JaxShardedBatchVerifier(mesh=jax_default_mesh(m), min_device_batch=0)
    got = jax.verify_device(*wave[0])
    assert np.asarray(got).tolist() == _port_verdicts(wave, m) == wave[1]


def test_staged_shards_equal_the_single_device_operands_cut_by_shard_operands():
    """The verifier stages each shard's block contiguously; the same
    claims staged on one device and cut by ``shard_operands`` (the JAX
    in_specs: batch axis 0, axis 1 of the window planes) are equal."""
    msgs, pks, sigs = _qc(12, forged={3})
    mesh = _mesh(4)
    v = M.ShardedBatchVerifier(mesh, min_device_batch=0)
    valid, sharded = v.prepare(msgs, pks, sigs)
    one = BatchVerifier(min_device_batch=0, device="cpu")
    one.pad_sizes = (16,)
    valid_one, arrays = one.prepare(msgs, pks, sigs)
    cut = M.shard_operands(mesh, *arrays)
    assert valid.tolist() == valid_one.tolist()
    assert len(sharded) == len(cut) == 8
    for got, want in zip(sharded, cut):
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.is_contiguous() and g.shape == w.shape
            assert torch.equal(g, w)


def test_word_and_qc_check():
    """The psum word is 0 on an all-valid QC and the exact invalid count
    otherwise; ``make_sharded_qc_check`` is its bool."""
    mesh = _mesh(2)
    v = M.ShardedBatchVerifier(mesh, min_device_batch=0)
    word = M.make_sharded_verify(mesh, psum_word=True)
    check = M.make_sharded_qc_check(mesh)
    for forged in ((), (0, 5, 13)):
        msgs, pks, sigs = _qc(14, forged=forged)
        _, arrays = v.prepare(msgs, pks, sigs)
        lanes, bad = word(*arrays)
        assert bad.dtype == torch.int32 and bad.dim() == 0
        assert int(bad) == len(forged)
        assert bool(check(*arrays)) == (not forged)
        assert M.gather_lanes(lanes)[:14].tolist() == [i not in forged for i in range(14)]


@pytest.mark.parametrize("case", ["s_ge_l", "undecodable_key"])
def test_a_wave_whose_only_bad_claim_is_host_invalid(case):
    """The ``bad == 0`` shortcut holds only if host-invalid rows become
    failing lanes: a wave whose one bad claim is rejected on the host
    still counts it in the word and fails it."""
    msgs, pks, sigs = _qc(6)
    if case == "s_ge_l":
        s = int.from_bytes(sigs[2][32:], "little") + ref.L
        sigs[2] = sigs[2][:32] + s.to_bytes(32, "little")
    else:
        pks[2] = (ref.P + 1).to_bytes(32, "little")
    mesh = _mesh(2)
    v = M.ShardedBatchVerifier(mesh, min_device_batch=0)
    valid, arrays = v.prepare(msgs, pks, sigs)
    assert valid.tolist() == [i != 2 for i in range(6)]
    _, bad = M.make_sharded_verify(mesh, psum_word=True)(*arrays)
    assert int(bad) == 1
    assert v.verify_device(msgs, pks, sigs).tolist() == [i != 2 for i in range(6)]


def test_an_oversized_batch_chunks_through_the_base_class():
    v = M.ShardedBatchVerifier(_mesh(2), min_device_batch=0)
    v.pad_sizes = (2, 4)
    msgs, pks, sigs = _qc(6, forged={5})
    assert v.verify_device(msgs, pks, sigs).tolist() == [True] * 5 + [False]
    assert set(v._scratch.pool) == {2, 4}  # a 4-chunk, then a 2-chunk


def test_verify_packed_and_stage_reach_the_sharded_run_kernel():
    """``verify_packed`` stages from columns and runs the sharded kernel
    without the word (``_run_kernel``), as ``stage`` hands it out."""
    msgs, pks, sigs = _qc(5, forged={1})
    v = M.ShardedBatchVerifier(_mesh(2), min_device_batch=0)
    cols = [bytearray(b"".join(c)) for c in (msgs, pks, sigs)]
    assert v.verify_packed(*cols, 5).tolist() == [True, False, True, True, True]
    kernel, arrays, valid = v.stage(msgs, pks, sigs)
    assert kernel == v._run_kernel and valid.all()
    assert all(isinstance(op, tuple) and len(op) == 2 for op in arrays)
    assert kernel(*arrays)[:5].tolist() == [True, False, True, True, True]


def test_profiling_spans_read_the_word_before_the_lanes():
    v = M.ShardedBatchVerifier(_mesh(2), min_device_batch=0)
    rec = spans.enable()
    try:
        assert v.verify_device(*_qc(3)).all()
        clean = [s[0] for s in rec.drain()]
        assert v.verify_device(*_qc(3, forged={0})).tolist() == [False, True, True]
        dirty = [s[0] for s in rec.drain()]
    finally:
        spans.disable()
    assert clean == ["prepare", "dispatch", "device.execute", "mesh.psum"]
    assert dirty == clean + ["readback"]


def test_cpu_meshes_launch_no_kernel():
    dsm.reset_launches()
    assert M.ShardedBatchVerifier(_mesh(2), min_device_batch=0).verify_device(*_qc(2)).all()
    assert dsm.launches == {"verify_compressed": 0, "dual_scalar_mult": 0}


def test_mesh_rules_and_no_quiet_cpu_mesh(monkeypatch):
    assert M.Mesh([CPU] * 3).size == 3 and M.Mesh(["cpu"]).axis_names == ("dp",)
    with pytest.raises(ValueError):
        M.Mesh([])
    monkeypatch.setenv("HOTSTUFF_MESH_DEVICES", "3")
    assert M.mesh_devices_from_env() == 3
    for raw in ("", "0", "-2", "x"):
        monkeypatch.setenv("HOTSTUFF_MESH_DEVICES", raw)
        assert M.mesh_devices_from_env() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.default_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.ShardedBatchVerifier()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.Mesh(["cuda"])


def test_the_mesh_host_sizes_its_mesh_from_the_env_at_materialization(monkeypatch):
    """``make_verifier("mesh", device="cpu")`` reads
    HOTSTUFF_MESH_DEVICES when the device verifier materializes, and the
    wave service picks the mesh's bucket ladder up from then on."""
    for attr in ("_shared_device", "_shared_dispatch"):
        monkeypatch.setattr(LazyDeviceVerifier, attr, {})
    monkeypatch.delenv("HOTSTUFF_WAVE_BUCKETS", raising=False)
    monkeypatch.setenv("HOTSTUFF_MESH_DEVICES", "4")
    host = make_verifier("mesh", device="cpu")
    assert host.name == "cuda-sharded" and host.async_kind == "cuda-sharded@cpu"
    assert host.wave_bucket_shapes is None  # not materialized yet
    service = AsyncVerifyService(host, device=True)
    try:
        default = service.wave_buckets
        device = host.async_backend._device
        assert device.mesh.size == 4 and device.name == "cuda-sharded-4"
        assert host.wave_bucket_shapes == device.wave_bucket_shapes
        assert service.wave_buckets == device.wave_bucket_shapes
        assert default == tuple(sorted(default))
        assert make_verifier("cuda-sharded", device="cpu").async_backend is host.async_backend
    finally:
        service.close()


class _MeshHost:
    """LazyDeviceVerifier stand-in holding a real ShardedBatchVerifier
    (the lazy host shares one device verifier a kind and device, so
    each mesh size builds its own), with the capability surface the wave
    service consults; ``async_kind`` names the mesh, so the service
    labels its waves "mesh"."""

    supports_wave_padding = True
    device_ready = True
    dispatch_deadline_s = 60.0  # the plain versions take seconds a wave

    def __init__(self, m: int):
        self.device = M.ShardedBatchVerifier(_mesh(m), min_device_batch=0)
        self.async_kind = f"mesh-{m}-test"
        self.name = self.async_kind
        self.cpu_backend = CpuVerifier()
        self.dispatched_batches: list[int] = []
        inner = _DeviceDispatch(self.device)
        host = self

        class _Counted:
            supports_wave_padding = True

            def verify_many(self, digests, pks, sigs, aggregate_ok=False):
                host.dispatched_batches.append(len(digests))
                return inner.verify_many(digests, pks, sigs, aggregate_ok)

        self.async_backend = _Counted()
        self.wave_bucket_shapes = self.device.wave_bucket_shapes


def _claims(n: int, seed: int, tamper=frozenset()):
    """n single-signature claims over distinct digests; tampered ones
    sign the wrong digest (well-formed, failing on the device lanes)."""
    wrong = Digest(b"\xee" * 32)
    claims = []
    for i in range(n):
        msg = bytes([seed, i]) + b"\x00" * 30
        pk, sk = generate_keypair(bytes([seed]) * 32, i)
        sig = Signature.new(wrong if i in tamper else Digest(msg), sk)
        claims.append(("one", msg, pk.to_bytes(), sig.to_bytes()))
    return claims


@pytest.mark.parametrize("m", [2, 4])
@async_test
async def test_two_submissions_coalesce_into_one_padded_mesh_wave(m, monkeypatch):
    """JAX ``test_mesh_backend.py:108-140``: two submitters, one tampered
    claim, one wave padded to the smallest mesh bucket, the verdicts
    fanned back per submitter, the wave counted under the ``mesh`` route
    and shown as ``mesh=1`` in the stats line."""
    monkeypatch.delenv("HOTSTUFF_WAVE_BUCKETS", raising=False)
    monkeypatch.setenv("HOTSTUFF_FORCE_DEVICE_ROUTE", "1")
    host = _MeshHost(m)
    service = AsyncVerifyService(host, device=True)
    try:
        out_a, out_b = await asyncio.wait_for(
            asyncio.gather(
                service.verify_claims(_claims(3, seed=0x51)),
                service.verify_claims(_claims(2, seed=0x52, tamper={1})),
            ),
            timeout=60,
        )
        assert out_a == [True, True, True]
        assert out_b == [True, False]
        assert host.dispatched_batches == [16]
        assert service.packed_waves == 1 and service.pad_sigs == 11
        assert service.device_dispatches == service.mesh_dispatches == 1
        assert service.cpu_dispatches == 0
        assert " mesh=1 " in service.stats_line()
    finally:
        service.close()


@pytest.mark.cuda
def test_cuda_mesh_of_four_shards_of_one_card(wave):
    """On a card: K1 on each of four shards of cuda:0, the lane-tile
    pad grid, and verdicts equal to the oracle's and the single-device
    verifier's, the word read first."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    dev = torch.device("cuda", 0)
    v = M.ShardedBatchVerifier(M.Mesh([dev] * 4), min_device_batch=0)
    assert v.pad_sizes == (512, 1024, 2048, 4096)
    assert v.wave_bucket_shapes == (512, 1024, 4096)
    dsm.reset_launches()
    got = v.verify_device(*wave[0]).tolist()
    assert dsm.launches["verify_compressed"] == 4
    one = BatchVerifier(min_device_batch=0, device=dev)
    assert got == wave[1] == one.verify_device(*wave[0]).tolist()
    assert v.verify_device(*_qc(171)).all()
