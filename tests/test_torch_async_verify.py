"""The port's async coalescing verify service
(hotstuff_tpu_torch/crypto/async_service.py) and device-verifier host
(hotstuff_tpu_torch/node/node.py): the cases of tests/test_async_verify.py
against the port, and verdict parity with the JAX package on the same
claims.  Verdicts are booleans, so every comparison is exact."""

import asyncio
import functools
import threading
import time

import pytest
import torch

from hotstuff_tpu.crypto import async_service as jax_asv
from hotstuff_tpu.tpu.ed25519 import BatchVerifier as JaxBatchVerifier
from hotstuff_tpu_torch.crypto import (
    CpuVerifier,
    Digest,
    Signature,
    ed25519_ref as ref,
    generate_keypair,
)
from hotstuff_tpu_torch.crypto import async_service as asv
from hotstuff_tpu_torch.crypto.async_service import (
    AsyncVerifyService,
    eval_claims_sync,
    flatten_claims,
)
from hotstuff_tpu_torch.gpu import dsm
from hotstuff_tpu_torch.node import LazyDeviceVerifier, make_verifier

torch.set_num_threads(1)


def async_test(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return asyncio.run(fn(*args, **kwargs))

    return wrapper


def _signed(seed: int, msg: bytes):
    """(pk, signature over the 32-byte msg treated as a digest)."""
    pk, sk = generate_keypair(bytes([seed]) * 32, 0)
    return pk, Signature.new(Digest(msg), sk)


def _one(seed: int, msg: bytes) -> tuple:
    pk, sig = _signed(seed, msg)
    return ("one", msg, pk.to_bytes(), sig.to_bytes())


def test_flatten_claims_spans():
    d1, d2 = b"\x01" * 32, b"\x02" * 32
    claims = [
        ("one", d1, b"pk1", b"s1"),
        ("shared", d2, ((b"pk2", b"s2"), (b"pk3", b"s3"))),
        ("one", d1, b"pk4", b"s4"),
    ]
    digests, pks, sigs, spans = flatten_claims(claims)
    assert digests == [d1, d2, d2, d1]
    assert pks == [b"pk1", b"pk2", b"pk3", b"pk4"]
    assert spans == [(0, 1), (1, 3), (3, 4)]
    assert (digests, pks, sigs, spans) == jax_asv.flatten_claims(claims)


def test_eval_claims_mixed_validity():
    msg = b"m" * 32
    pk1, sig1 = _signed(1, msg)
    pk2, sig2 = _signed(2, msg)
    pk3, sig3 = _signed(3, msg)
    good_shared = ("shared", msg, ((pk1.to_bytes(), sig1.to_bytes()), (pk2.to_bytes(), sig2.to_bytes())))
    bad_shared = ("shared", msg, ((pk1.to_bytes(), sig1.to_bytes()), (pk2.to_bytes(), sig1.to_bytes())))
    good_one = ("one", msg, pk3.to_bytes(), sig3.to_bytes())
    bad_one = ("one", msg, pk3.to_bytes(), sig1.to_bytes())
    out = eval_claims_sync(CpuVerifier(), [good_shared, bad_shared, good_one, bad_one])
    assert out == [True, False, True, False]


@async_test
async def test_inline_service_is_synchronous():
    claim = _one(6, b"q" * 32)
    service = AsyncVerifyService.for_backend(CpuVerifier())
    assert not service.device
    assert await service.verify_claims([claim]) == [True]


class _FakeDeviceHost:
    """A device host whose 'device' counts dispatches and records batch
    sizes — stands in for node.LazyDeviceVerifier + BatchVerifier."""

    def __init__(self, kind="fake", ready=True, delay=0.0):
        self.async_kind = kind
        self._ready = ready
        self.cpu_backend = CpuVerifier()
        self.dispatched_batches = []
        self._delay = delay
        host = self

        class _Dispatch:
            def verify_many(self, digests, pks, sigs, aggregate_ok=False):
                host.dispatched_batches.append(len(digests))
                if host._delay:
                    time.sleep(host._delay)
                return CpuVerifier().verify_many(digests, pks, sigs)

        self.async_backend = _Dispatch()

    @property
    def device_ready(self):
        return self._ready


@async_test
async def test_device_service_coalesces_concurrent_submissions():
    msg = b"w" * 32
    pairs = [_signed(10 + i, msg) for i in range(8)]
    host = _FakeDeviceHost(kind="coalesce-test")
    service = AsyncVerifyService.for_backend(host)
    assert service.device

    async def submit(pk, sig):
        return await service.verify_claims([("one", msg, pk.to_bytes(), sig.to_bytes())])

    outs = await asyncio.gather(*(submit(pk, sig) for pk, sig in pairs))
    assert all(o == [True] for o in outs)
    assert host.dispatched_batches == [8]  # one batch of 8
    service.close()


@async_test
async def test_device_service_gates_on_readiness():
    host = _FakeDeviceHost(kind="gate-test", ready=False)
    service = AsyncVerifyService.for_backend(host)
    assert await service.verify_claims([_one(30, b"r" * 32)]) == [True]
    assert host.dispatched_batches == []  # CPU path took it
    service.close()


@async_test
async def test_device_service_adapts_to_slow_device():
    """A device slower than the CPU estimate sends small batches to the
    CPU; a batch whose CPU estimate exceeds the EWMA goes back to it."""
    msg = b"s" * 32
    pk, sig = _signed(31, msg)
    host = _FakeDeviceHost(kind="adapt-test", delay=0.05)  # 50 ms device
    service = AsyncVerifyService.for_backend(host)
    claim = ("one", msg, pk.to_bytes(), sig.to_bytes())
    await service.verify_claims([claim])
    assert host.dispatched_batches == [1]
    assert service._device_ewma_s > 0.04
    service._last_probe = asv.time.monotonic()  # suppress the probe window
    await service.verify_claims([claim])
    await service.verify_claims([claim])
    assert host.dispatched_batches == [1]
    # 1500 sigs x CPU_US_PER_SIG 130 us = 195 ms > the 50 ms EWMA
    big = [
        ("one", bytes([i % 256, i // 256]) + b"\x00" * 30, pk.to_bytes(), sig.to_bytes())
        for i in range(1500)
    ]
    out = await service.verify_claims(big)
    assert len(out) == 1500
    assert host.dispatched_batches == [1, 1500]
    service.close()


def test_empty_shared_claim_is_false():
    """Zero signatures prove nothing: vacuous truth over an empty span
    would verify a votes=[] forgery."""
    assert eval_claims_sync(CpuVerifier(), [("shared", b"\x01" * 32, ())]) == [False]


@async_test
async def test_identical_claims_deduplicate_across_submissions():
    claim = _one(50, b"d" * 32)
    host = _FakeDeviceHost(kind="dedup-test")
    service = AsyncVerifyService.for_backend(host)
    outs = await asyncio.gather(*(service.verify_claims([claim]) for _ in range(8)))
    assert all(o == [True] for o in outs)
    assert host.dispatched_batches == [1]  # 8 submissions, ONE evaluation
    service.close()


@async_test
async def test_stalled_device_dispatch_does_not_stall_later_waves():
    claim = _one(40, b"t" * 32)
    host = _FakeDeviceHost(kind="stall-test", delay=0.5)  # 500 ms stall
    service = AsyncVerifyService.for_backend(host)
    t0 = time.perf_counter()
    assert await service.verify_claims([claim]) == [True]
    assert time.perf_counter() - t0 < 0.45  # the deadline cut the wait
    assert service.deadline_misses == 1
    t0 = time.perf_counter()
    assert await service.verify_claims([claim]) == [True]
    assert time.perf_counter() - t0 < 0.2
    assert host.dispatched_batches == [1]  # no second device dispatch
    await asyncio.sleep(0.6)  # let the stalled dispatch land
    assert not service._device_busy
    service.close()


def test_qcmaker_skips_batch_when_all_preverified():
    from hotstuff_tpu_torch.consensus import Aggregator, Committee, Vote

    class Counting(CpuVerifier):
        shared = 0

        def verify_shared_msg(self, d, votes):
            Counting.shared += 1
            return super().verify_shared_msg(d, votes)

    ks = sorted((generate_keypair(bytes(32), i) for i in range(4)), key=lambda kp: kp[0])
    com = Committee.new([(pk, 1, ("127.0.0.1", 9000 + i)) for i, (pk, _) in enumerate(ks)])
    block_hash = Digest(b"\x09" * 32)
    agg = Aggregator(com, Counting(), self_key=ks[0][0])
    qc = None
    for pk, sk in ks[:3]:
        vote = Vote(hash=block_hash, round=1, author=pk)
        vote.signature = Signature.new(vote.digest(), sk)
        qc = agg.add_vote(vote, 1, sig_verified=True) or qc
    assert qc is not None and qc.round == 1
    assert Counting.shared == 0  # no quorum batch needed
    agg2 = Aggregator(com, Counting(), self_key=ks[0][0])
    for i, (pk, sk) in enumerate(ks[:3]):
        vote = Vote(hash=block_hash, round=2, author=pk)
        vote.signature = Signature.new(vote.digest(), sk)
        agg2.add_vote(vote, 2, sig_verified=i != 1)
    assert Counting.shared == 1  # one unverified entry forces the batch


def test_registry_prunes_closed_loops():
    class DeviceBackend(CpuVerifier):
        async_kind = "test-kind"
        device_ready = False

    backend = DeviceBackend()

    async def acquire():
        return AsyncVerifyService.for_backend(backend)

    loop1 = asyncio.new_event_loop()
    svc1 = loop1.run_until_complete(acquire())
    loop1.close()
    assert any(s is svc1 for _, s in AsyncVerifyService._registry.values())
    loop2 = asyncio.new_event_loop()
    svc2 = loop2.run_until_complete(acquire())
    try:
        assert not any(s is svc1 for _, s in AsyncVerifyService._registry.values())
        assert any(s is svc2 for _, s in AsyncVerifyService._registry.values())
    finally:
        svc2.close()
        loop2.close()


class _GatedDeviceHost:
    """Device host whose every dispatch BLOCKS until its per-wave gate is
    released — drives out-of-order completion, per-wave failure
    injection, and in-flight concurrency tracking."""

    def __init__(self, kind):
        self.async_kind = kind
        self.device_ready = True
        self.cpu_backend = CpuVerifier()
        self.dispatch_deadline_s = 5.0  # gates held open must not trip it
        self.gates: list = []
        self.fail_waves: set = set()
        self.concurrent = 0
        self.max_concurrent = 0
        self._lock = threading.Lock()
        host = self

        class _Dispatch:
            def verify_many(self, digests, pks, sigs, aggregate_ok=False):
                with host._lock:
                    idx = len(host.gates)
                    gate = threading.Event()
                    host.gates.append(gate)
                    host.concurrent += 1
                    host.max_concurrent = max(host.max_concurrent, host.concurrent)
                try:
                    if not gate.wait(5.0):
                        raise RuntimeError("test gate never released")
                    if idx in host.fail_waves:
                        raise RuntimeError(f"wave {idx} failed")
                    return CpuVerifier().verify_many(digests, pks, sigs)
                finally:
                    with host._lock:
                        host.concurrent -= 1

        self.async_backend = _Dispatch()


async def _until(cond, timeout=2.0):
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, "condition not reached"
        await asyncio.sleep(0.005)


@async_test
async def test_out_of_order_completion_resolves_right_futures():
    msg_a, msg_b = b"a" * 32, b"b" * 32
    pk, sig_a = _signed(60, msg_a)
    claim_a = ("one", msg_a, pk.to_bytes(), sig_a.to_bytes())
    claim_b = ("one", msg_b, pk.to_bytes(), sig_a.to_bytes())  # invalid
    host = _GatedDeviceHost("ooo-test")
    service = AsyncVerifyService(host, device=True, pipeline_depth=2)
    task_a = asyncio.ensure_future(service.verify_claims([claim_a]))
    await _until(lambda: len(host.gates) == 1)
    task_b = asyncio.ensure_future(service.verify_claims([claim_b]))
    await _until(lambda: len(host.gates) == 2)
    assert service.peak_inflight == 2
    host.gates[1].set()  # wave B lands FIRST
    assert (await task_b) == [False]
    assert not task_a.done()
    host.gates[0].set()
    assert (await task_a) == [True]
    service.close()


@async_test
async def test_failed_wave_poisons_only_its_own_futures():
    host = _GatedDeviceHost("poison-test")
    host.fail_waves = {0}
    service = AsyncVerifyService(host, device=True, pipeline_depth=2)
    task_a = asyncio.ensure_future(service.verify_claims([_one(61, b"c" * 32)]))
    await _until(lambda: len(host.gates) == 1)
    task_b = asyncio.ensure_future(service.verify_claims([_one(62, b"e" * 32)]))
    await _until(lambda: len(host.gates) == 2)
    host.gates[0].set()
    with pytest.raises(RuntimeError):
        await task_a
    host.gates[1].set()
    assert (await task_b) == [True]
    service.close()


@async_test
async def test_depth_cap_backpressure_queues_next_wave(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_FORCE_DEVICE_ROUTE", "1")
    claims = [_one(70 + i, bytes([100 + i]) * 32) for i in range(3)]
    host = _GatedDeviceHost("cap-test")
    service = AsyncVerifyService(host, device=True, pipeline_depth=2)
    tasks = []
    for i in range(2):
        tasks.append(asyncio.ensure_future(service.verify_claims([claims[i]])))
        await _until(lambda i=i: len(host.gates) == i + 1)
    tasks.append(asyncio.ensure_future(service.verify_claims([claims[2]])))
    await asyncio.sleep(0.05)
    assert len(host.gates) == 2  # the third wave queued
    assert service.pipeline_waits == 1
    host.gates[0].set()
    await _until(lambda: len(host.gates) == 3)
    host.gates[1].set()
    host.gates[2].set()
    assert await asyncio.gather(*tasks) == [[True]] * 3
    assert host.max_concurrent <= 2
    assert service.peak_inflight == 2
    service.close()


@async_test
async def test_depth_one_preserves_single_inflight(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_FORCE_DEVICE_ROUTE", "1")
    host = _GatedDeviceHost("depth1-test")
    service = AsyncVerifyService(host, device=True, pipeline_depth=1)
    task_a = asyncio.ensure_future(service.verify_claims([_one(80, b"f" * 32)]))
    await _until(lambda: len(host.gates) == 1)
    task_b = asyncio.ensure_future(service.verify_claims([_one(81, b"g" * 32)]))
    await asyncio.sleep(0.05)
    assert len(host.gates) == 1
    host.gates[0].set()
    await _until(lambda: len(host.gates) == 2)
    host.gates[1].set()
    assert await asyncio.gather(task_a, task_b) == [[True], [True]]
    assert host.max_concurrent == 1
    assert service.peak_inflight == 1
    service.close()


def test_route_under_full_occupancy(monkeypatch):
    class DeviceBackend(CpuVerifier):
        async_kind = "occupancy-route-test"
        device_ready = True

    monkeypatch.delenv("HOTSTUFF_FORCE_DEVICE_ROUTE", raising=False)
    service = AsyncVerifyService(DeviceBackend(), device=True, pipeline_depth=2)
    now = time.monotonic()
    service._inflight = {1: now + 10.0, 2: now + 10.0}
    service._last_probe = 0.0  # a probe is long overdue
    service._device_ewma_s = 0.001
    assert service._route_device(256) == "wait"
    service._device_ewma_s = 10.0
    assert service._route_device(1) == "cpu"  # and no probe at the cap
    monkeypatch.setenv("HOTSTUFF_FORCE_DEVICE_ROUTE", "1")
    assert service._route_device(1) == "wait"
    monkeypatch.delenv("HOTSTUFF_FORCE_DEVICE_ROUTE")
    service._inflight[1] = now - 1.0  # overdue
    service._device_ewma_s = 0.001
    assert service._route_device(256) == "cpu"
    service._inflight.clear()
    service._device_ewma_s = 10.0
    assert service._route_device(1) == "probe"
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    assert service._route_device(256) == "cpu"
    service.close()


@pytest.mark.parametrize(
    "raw, depth, buckets, window_s",
    [
        (None, asv.DEFAULT_PIPELINE_DEPTH, asv.DEFAULT_WAVE_BUCKETS, 0.0),
        ("4", 4, (4,), 0.004),
        ("0", 1, (), 0.0),
        ("64,16,256", asv.DEFAULT_PIPELINE_DEPTH, (16, 64, 256), 0.0),
        ("off", asv.DEFAULT_PIPELINE_DEPTH, (), 0.0),
        ("bogus", asv.DEFAULT_PIPELINE_DEPTH, asv.DEFAULT_WAVE_BUCKETS, 0.0),
    ],
)
def test_env_parsers_match_the_jax_package(monkeypatch, raw, depth, buckets, window_s):
    names = ("HOTSTUFF_VERIFY_PIPELINE", "HOTSTUFF_WAVE_BUCKETS", "HOTSTUFF_COALESCE_WINDOW_MS")
    for name in names:
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
    got = (asv.pipeline_depth_from_env(), asv.wave_buckets_from_env(), asv.coalesce_window_s_from_env())
    assert got == (depth, buckets, window_s)
    assert got == (
        jax_asv.pipeline_depth_from_env(),
        jax_asv.wave_buckets_from_env(),
        jax_asv.coalesce_window_s_from_env(),
    )
    assert asv.resolve_wave_buckets(object()) == jax_asv.resolve_wave_buckets(object())


def test_pad_claim_is_a_valid_signature_and_the_jax_bytes():
    pad = asv.make_pad_claim()
    assert pad[0] == "one"
    assert eval_claims_sync(CpuVerifier(), [pad]) == [True]
    assert pad == jax_asv.make_pad_claim()


@async_test
async def test_fixed_shape_padding_hits_bucket_and_preserves_verdicts(monkeypatch):
    monkeypatch.delenv("HOTSTUFF_WAVE_BUCKETS", raising=False)
    monkeypatch.setenv("HOTSTUFF_FORCE_DEVICE_ROUTE", "1")
    host = _FakeDeviceHost(kind="pack-test")
    host.supports_wave_padding = True
    service = AsyncVerifyService(host, device=True)
    claims = [_one(100 + i, bytes([120 + i]) * 32) for i in range(4)]
    bad = ("one", b"k" * 32, claims[0][2], claims[0][3])  # invalid
    assert await service.verify_claims(claims + [bad]) == [True] * 4 + [False]
    assert host.dispatched_batches == [16]  # 5 real sigs padded to 16
    assert (service.packed_waves, service.pad_sigs) == (1, 11)
    fit = [_one(130, bytes([10, i]) + b"\x00" * 30) for i in range(16)]
    assert len(await service.verify_claims(fit)) == 16
    assert host.dispatched_batches[-1] == 16
    assert service.packed_waves == 1  # no pads for the exact fit
    service.close()


@async_test
async def test_padding_needs_backend_opt_in(monkeypatch):
    monkeypatch.delenv("HOTSTUFF_WAVE_BUCKETS", raising=False)
    monkeypatch.setenv("HOTSTUFF_FORCE_DEVICE_ROUTE", "1")
    host = _FakeDeviceHost(kind="no-pack-test")
    service = AsyncVerifyService(host, device=True)
    assert await service.verify_claims([_one(105, b"l" * 32)]) == [True]
    assert host.dispatched_batches == [1]
    assert service.packed_waves == 0 and service.pad_sigs == 0
    service.close()


def test_warm_buckets_drives_every_bucket_shape(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "4,8")
    host = _FakeDeviceHost(kind="warm-test")
    host.supports_wave_padding = True
    service = AsyncVerifyService(host, device=True)
    service.warm_buckets()
    assert host.dispatched_batches == [4, 8]
    plain = AsyncVerifyService(CpuVerifier())
    plain.warm_buckets()  # inline services: a no-op
    cold = _FakeDeviceHost(kind="warm-cold-test", ready=False)
    cold.supports_wave_padding = True
    AsyncVerifyService(cold, device=True).warm_buckets()
    assert cold.dispatched_batches == []  # not warm: never dispatched
    service.close()
    plain.close()


@async_test
async def test_round_window_coalesces_qc_and_tc_into_one_wave(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_COALESCE_WINDOW_MS", "80")
    monkeypatch.setenv("HOTSTUFF_FORCE_DEVICE_ROUTE", "1")
    msg = b"i" * 32
    qc_pairs = [_signed(91 + i, msg) for i in range(4)]
    qc_claim = ("shared", msg, tuple((pk.to_bytes(), s.to_bytes()) for pk, s in qc_pairs))
    tc_claims = [_one(95 + i, bytes([110 + i]) * 32) for i in range(3)]
    bad = ("one", b"j" * 32, tc_claims[0][2], tc_claims[0][3])
    host = _FakeDeviceHost(kind="window-test")
    service = AsyncVerifyService(host, device=True)
    assert abs(service.coalesce_window_s - 0.08) < 1e-9
    qc_fut = asyncio.ensure_future(service.verify_claims([qc_claim]))
    await asyncio.sleep(0.02)  # well inside the window
    tc_fut = asyncio.ensure_future(service.verify_claims(tc_claims + [bad]))
    assert (await qc_fut) == [True]
    assert (await tc_fut) == [True, True, True, False]
    assert host.dispatched_batches == [8]  # 4 QC + 4 TC sigs, ONE dispatch
    assert service.device_dispatches == 1
    service.close()


@async_test
async def test_dispatch_loop_shuts_down_on_close():
    host = _FakeDeviceHost(kind="lifecycle-test")
    service = AsyncVerifyService.for_backend(host)
    assert await service.verify_claims([_one(90, b"h" * 32)]) == [True]
    dl = service._dispatch
    assert dl is not None and dl in asv._live_dispatch_loops
    threads = list(dl._threads)
    assert threads and all(t.is_alive() for t in threads)
    assert all(t.name.startswith("verify-slot-") for t in threads)
    assert len(threads) == service.pipeline_depth
    assert "device=1" in service.stats_line()
    service.close()
    assert service._dispatch is None
    assert dl not in asv._live_dispatch_loops
    for t in threads:
        t.join(timeout=2.0)
    assert not any(t.is_alive() for t in threads)
    with pytest.raises(RuntimeError):
        dl.submit(lambda: None, lambda r, e: None)


def test_no_claim_dedup_gives_private_services(monkeypatch):
    class DeviceBackend(CpuVerifier):
        async_kind = "nodedup-test"
        device_ready = False

    backend = DeviceBackend()
    monkeypatch.setenv("HOTSTUFF_NO_CLAIM_DEDUP", "1")

    async def acquire_two():
        return AsyncVerifyService.for_backend(backend), AsyncVerifyService.for_backend(backend)

    loop = asyncio.new_event_loop()
    try:
        s1, s2 = loop.run_until_complete(acquire_two())
        assert s1 is not s2 and s1.device and s2.device
        assert not any(s in (s1, s2) for _, s in AsyncVerifyService._registry.values())
    finally:
        s1.close()
        s2.close()
        loop.close()


def test_make_verifier_kinds_and_per_device_singletons():
    assert isinstance(make_verifier("cpu"), CpuVerifier)
    for kind in ("tpu-sharded", "mesh"):
        with pytest.raises(NotImplementedError, match="not ported"):
            make_verifier(kind)
    # BLS: the G1 sums on the card's kernels (raising without a card), or
    # their plain versions, as the JAX package's make_verifier("tpu", "bls")
    from hotstuff_tpu.crypto.bls.service import BlsVerifier as JaxBlsVerifier

    bls = make_verifier("cuda", scheme="bls", device="cpu")
    jax_bls = JaxBlsVerifier(aggregator="tpu")
    assert bls.name == "bls-cuda" and jax_bls.name == "bls-tpu"
    for attr in ("prefers_aggregate", "always_offload", "dispatch_deadline_s", "device_ready"):
        assert getattr(bls, attr) == getattr(jax_bls, attr), attr
    assert bls.async_kind == "bls-cuda-offload"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_verifier("cuda", scheme="bls")
    with pytest.raises(ValueError):
        make_verifier("gpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_verifier("cuda")
    a = make_verifier("cuda", device="cpu")
    b = make_verifier("cuda", device="cpu")
    assert a._key == b._key == ("cuda", "cpu") and a.async_kind == "cuda@cpu"
    assert a.async_backend is b.async_backend  # shared per (kind, device)
    assert a.async_backend._device.device.type == "cpu"
    assert a.supports_wave_padding and a.async_backend.supports_wave_padding


def _parity_claims():
    """Valid and adversarial claims of every kind, with duplicates."""
    msg = Digest.of(b"parity block").to_bytes()
    pairs = [_signed(140 + i, msg) for i in range(5)]
    shared = ("shared", msg, tuple((pk.to_bytes(), s.to_bytes()) for pk, s in pairs))
    bad_vote = (pairs[1][0].to_bytes(), pairs[2][1].to_bytes())
    shared_bad = ("shared", msg, shared[2][:3] + (bad_vote,))
    ones = [_one(150 + i, Digest.of(b"parity %d" % i).to_bytes()) for i in range(8)]
    sig = ones[1][3]
    s_plus_l = (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
    adversarial = [
        ones[0][:3] + (bytes([sig[0] ^ 1]) + sig[1:],),  # bad R
        ones[1][:3] + (sig[:32] + s_plus_l,),  # s + L
        ones[2][:2] + ((ref.P + 1).to_bytes(32, "little"), ones[2][3]),  # undecodable key
        ones[3][:3] + ((ref.P + 3).to_bytes(32, "little") + ones[3][3][32:],),  # R with y >= p
        ("one", b"tampered digest".ljust(32, b"\0"), ones[4][2], ones[4][3]),  # wrong message
        ones[5][:2] + (ones[6][2], ones[5][3]),  # wrong key
    ]
    agg = ("agg", msg, b"\x01" * 48, tuple(pk.to_bytes() for pk, _ in pairs))
    return [
        [shared, ones[6], ones[7]],
        [shared_bad] + adversarial,
        [("shared", msg, ()), shared, agg, ones[7], shared],
    ]


@async_test
async def test_service_verdicts_match_the_jax_service(monkeypatch):
    """The same claim lists through the JAX service on the JAX verifier
    (XLA path) and through the port's service on the port's device host
    with device="cpu" (the kernels' plain versions): identical verdict
    lists, and the port's wave really went to the device route."""
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "64")
    batches = _parity_claims()
    jax_service = jax_asv.AsyncVerifyService.for_backend(
        JaxBatchVerifier(min_device_batch=0, use_pallas=False)
    )
    want = [await jax_service.verify_claims(cs) for cs in batches]

    host = LazyDeviceVerifier("cuda", device="cpu")
    host.dispatch_deadline_s = 600.0  # the plain version is slow on a CPU
    host.warmup(16)
    service = AsyncVerifyService.for_backend(host)
    dsm.reset_launches()
    got = await asyncio.gather(*(service.verify_claims(cs) for cs in batches))
    service.close()
    assert list(got) == want
    assert want[0] == [True] * 3 and not any(want[1])
    assert want[2] == [False, True, False, True, True]
    assert (service.device_dispatches, service.cpu_dispatches) == (1, 0)
    assert service.deadline_misses == 0 and service.packed_waves == 1
    assert dsm.launches["verify_compressed"] == 0  # CPU tensors launch nothing
