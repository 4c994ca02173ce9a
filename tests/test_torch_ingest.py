"""The port's zero-copy ingest plane against the JAX package's.

The wave-pack bindings (``crypto/native_ed25519.py``) on one seeded
corpus against the port's Python decoder and the JAX bindings; the
packed claim digest against ``Vote.claim()``; ``ZeroCopyIngest`` driven
by the same scripted sequences as the JAX plane, decisions and counters
equal; the adopted arena columns against ``flatten_claims`` at every
bucket and against the JAX arena's; ``eval_claims_arena`` verdicts
through the port's device host (the kernels' plain versions), the JAX
``BatchVerifier`` and the oracle; and vote frames reaching the port's
asyncio ``Receiver`` adopted by the wave service, with ``zc=``/``fb=``
in its stats line.  Booleans and bytes: the tolerance is zero.
"""

import asyncio
import struct

import numpy as np
import pytest
import torch

from benchmark.logs import RE_VERIFY_STATS

from hotstuff_tpu.crypto import async_service as jsvc
from hotstuff_tpu.crypto import native_ed25519 as jne
from hotstuff_tpu_torch.bench.committee import reserve_ports
from hotstuff_tpu_torch.consensus import Vote
from hotstuff_tpu_torch.consensus import wire as pwire
from hotstuff_tpu_torch.consensus.errors import SerializationError
from hotstuff_tpu_torch.crypto import Digest, Signature, generate_keypair
from hotstuff_tpu_torch.crypto import async_service as psvc
from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.crypto import native_ed25519 as pne
from hotstuff_tpu_torch.network import Receiver, receiver
from hotstuff_tpu_torch.network.framing import write_frame
from hotstuff_tpu_torch.node import make_verifier

torch.set_num_threads(1)

TIMEOUT_S = 20.0
L = 2**252 + 27742317777372353535851937790883648493


@pytest.fixture(scope="module", autouse=True)
def _jax_wave_pack():
    # the JAX bindings build the JAX package's own library (make -C native)
    assert jne.wave_pack_available()


@pytest.fixture
def fresh_plane(monkeypatch):
    """A new process-wide ingest plane for this test: other tests in the
    process may have left packed votes in the shared one."""
    monkeypatch.delenv("HOTSTUFF_ZERO_COPY", raising=False)
    monkeypatch.setattr(psvc, "_zero_copy", None)
    return psvc


def _raw_votes(seed: int, n: int):
    """``n`` wire-shaped ed25519 vote frames with random contents, from a
    numpy seed, and the claim ``Vote.claim()`` gives for each (decoded
    by the port)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, pk, sig = rng.bytes(32), rng.bytes(32), rng.bytes(64)
        rnd = int(rng.integers(0, 1 << 62))
        frame = (
            b"\x01" + h + struct.pack("<Q", rnd) + struct.pack("<I", 32) + pk
            + struct.pack("<I", 64) + sig
        )
        _, vote = pwire.decode_message(frame, scheme="ed25519")
        out.append((frame, vote.claim()))
    return out


def _signed_votes(n: int, forged=()):
    """Real signed votes from seeded keys: row i in ``forged`` gets a
    flipped signature byte (odd i) or S raised by L, so S >= L (even i).
    Returns (frames, claims)."""
    frames, claims = [], []
    for i in range(n):
        pk, sk = generate_keypair(b"\x3c" * 32, i)
        vote = Vote(hash=Digest.of(b"ingest block %d" % i), round=7 + i, author=pk)
        sig = Signature.new(vote.digest(), sk).to_bytes()
        if i in forged and i % 2:
            sig = sig[:10] + bytes([sig[10] ^ 0x40]) + sig[11:]
        elif i in forged:
            s = int.from_bytes(sig[32:], "little") + L
            sig = sig[:32] + s.to_bytes(32, "little")
        vote.signature = Signature(sig)
        frames.append(pwire.encode_vote(vote))
        claims.append(vote.claim())
    return frames, claims


# ---- the bindings ----------------------------------------------------------


def test_ingest_tag_constants_match_the_wire():
    assert psvc.INGEST_TAG_VOTE == pwire.TAG_VOTE == receiver._TAG_VOTE
    assert receiver._TAG_PRODUCER_V2 == pwire.TAG_PRODUCER_V2
    assert pne.MAX_PRODUCER_BATCH == pwire.MAX_PRODUCER_BATCH == jne.MAX_PRODUCER_BATCH


def _py_vote(frame: bytes) -> bool:
    try:
        tag, _ = pwire.decode_message(frame, scheme="ed25519")
    except SerializationError:
        return False
    return tag == pwire.TAG_VOTE


def _py_producer(frame: bytes):
    try:
        tag, payload = pwire.decode_message(frame, scheme="ed25519")
    except SerializationError:
        return None
    return payload if tag == pwire.TAG_PRODUCER_V2 else None


def _mutations(rng, frames, count):
    for frame in frames:
        for _ in range(count):
            buf = bytearray(frame)
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(len(buf)))] ^= 1 << int(rng.integers(8))
            yield bytes(buf)


def _vote_corpus():
    rng = np.random.default_rng(0xF040)
    frames, _ = _signed_votes(2)
    frames += [f for f, _ in _raw_votes(1, 6)]
    corpus = list(frames)
    for frame in frames[:3]:
        corpus += [frame[:cut] for cut in range(len(frame) + 1)]
        corpus += [frame + b"\x00", frame + frame]
    for off in (41, 77):  # the pk and sig length prefixes
        for val in (0, 1, 31, 33, 48, 63, 65, 96, 1 << 16, 0xFFFFFFFF):
            buf = bytearray(frames[2])
            buf[off : off + 4] = struct.pack("<I", val)
            corpus.append(bytes(buf))
    corpus += list(_mutations(rng, frames, 100))
    corpus += [b"\x01" + rng.bytes(int(rng.integers(0, 200))) for _ in range(300)]
    return corpus


def _producer_corpus():
    rng = np.random.default_rng(0xF041)

    def v2(n, size):
        return pwire.encode_producer_batch(
            [(Digest.of(bytes([i]) * size), bytes([i]) * size) for i in range(n)]
        )

    frames = [v2(1, 0), v2(5, 48), v2(16, 1), v2(3, 300)]
    corpus = list(frames)
    for frame in frames:
        corpus += [frame[:cut] for cut in range(len(frame) + 1)] + [frame + b"\x00"]
    for version in (0, 1, 3, 255):
        corpus.append(bytes([frames[1][0], version]) + frames[1][2:])
    head = bytes([pwire.TAG_PRODUCER_V2, pwire.PRODUCER_FRAME_VERSION])
    for count in (0, 1, pwire.MAX_PRODUCER_BATCH, pwire.MAX_PRODUCER_BATCH + 1, 0xFFFFFFFF):
        corpus += [head + struct.pack("<I", count), head + struct.pack("<I", count) + frames[1][6:]]
    for ln in (0, 1, 65536, 65537, 0xFFFFFFFF):
        corpus.append(head + struct.pack("<I", 1) + b"\xaa" * 32 + struct.pack("<I", ln)
                      + b"\xbb" * min(ln, 70_000))
    corpus += list(_mutations(rng, frames, 150))
    corpus += [bytes([pwire.TAG_PRODUCER_V2]) + rng.bytes(int(rng.integers(0, 300)))
               for _ in range(300)]
    return corpus


def test_vote_probe_agrees_with_the_port_decoder_and_the_jax_bindings():
    corpus = _vote_corpus()
    accepted = 0
    for frame in corpus:
        verdict = pne.probe_vote(frame)
        assert verdict == _py_vote(frame) == jne.probe_vote(frame), frame.hex()
        accepted += verdict
    assert 8 <= accepted < len(corpus) // 2


def test_producer_parse_agrees_with_the_port_decoder_and_the_jax_bindings():
    corpus = _producer_corpus()
    accepted = 0
    for frame in corpus:
        mine, theirs, items = pne.parse_producer(frame), jne.parse_producer(frame), _py_producer(frame)
        assert mine == theirs, frame[:32].hex()
        if items is None:
            assert mine is None, frame[:32].hex()
            continue
        accepted += 1
        digests, spans = mine
        assert len(spans) == len(items)
        for i, (digest, body) in enumerate(items):
            assert digests[i * 32 : (i + 1) * 32] == digest.to_bytes()
            off, ln = spans[i]
            assert frame[off : off + ln] == body
    assert accepted >= 4


def test_packed_digest_is_the_vote_claim_digest():
    pad = psvc.make_pad_claim()
    packer = pne.WavePacker(16, 2)
    try:
        assert packer.set_pad(pad[1], pad[2], pad[3])
        frames, claims = _signed_votes(3)
        for i, (frame, claim) in enumerate(zip(frames, claims)):
            slot, digest = packer.pack_vote(frame)
            assert slot == i and digest == claim[1]
            # the claim key's pk and sig at the vote frame's fixed offsets
            assert (frame[45:77], frame[81:145]) == (claim[2], claim[3])
    finally:
        packer.close()


# ---- the arena, scripted through both planes -------------------------------


def _summary(result):
    if isinstance(result, (psvc.AdoptedWave, jsvc.AdoptedWave)):
        return ("wave", result.n, result.rows)
    return result


def _prefix_and_surplus(svc, votes, log):
    ing = svc.ZeroCopyIngest(capacity=16, ring_depth=3)
    for frame, _ in votes[:10]:
        log.append(ing.note_vote_frame(frame))
    claims = [c for _, c in votes[:10]]
    w1 = ing.try_adopt(claims[:4], svc.DEFAULT_WAVE_BUCKETS)
    log.append(_summary(w1))
    w1.release()
    w2 = ing.try_adopt(claims[4:], svc.DEFAULT_WAVE_BUCKETS)
    log.append(_summary(w2))
    w2.release()
    log.append(ing.active)
    return ing


def _disjoint_then_overlapping(svc, votes, log):
    ing = svc.ZeroCopyIngest(capacity=16, ring_depth=2)
    for frame, _ in votes[:3]:
        ing.note_vote_frame(frame)
    claims = [c for _, c in votes[:3]]
    other = [c for _, c in votes[3:5]]  # never packed: a disjoint wave
    log.append(_summary(ing.try_adopt(other, svc.DEFAULT_WAVE_BUCKETS)))
    log.append((ing.active, ing.fallback_waves))
    log.append(_summary(ing.try_adopt([claims[1], claims[0]], svc.DEFAULT_WAVE_BUCKETS)))
    log.append((ing.active, ing.fallback_waves))
    for frame, _ in votes[:3]:
        ing.note_vote_frame(frame)
    wave = ing.try_adopt(claims, svc.DEFAULT_WAVE_BUCKETS)
    log.append(_summary(wave))
    wave.release()
    return ing


def _full_arena_resyncs(svc, votes, log):
    ing = svc.ZeroCopyIngest(capacity=2, ring_depth=2)
    for frame, _ in votes[:4]:
        log.append((ing.note_vote_frame(frame), ing.active))
    return ing


def _ring_exhausted_resyncs(svc, votes, log):
    ing = svc.ZeroCopyIngest(capacity=4, ring_depth=2)
    claims = [c for _, c in votes]
    for frame, _ in votes[:2]:
        ing.note_vote_frame(frame)
    held = ing.try_adopt(claims[:2], (4,))  # not released yet
    log.append(_summary(held))
    for frame, _ in votes[2:4]:
        ing.note_vote_frame(frame)
    log.append(_summary(ing.try_adopt(claims[2:4], (4,))))  # no free arena
    log.append(ing.active)
    held.release()
    for frame, _ in votes[2:4]:
        ing.note_vote_frame(frame)
    wave = ing.try_adopt(claims[2:4], (4,))
    log.append(_summary(wave))
    wave.release()
    return ing


def _idempotent_release(svc, votes, log):
    ing = svc.ZeroCopyIngest(capacity=4, ring_depth=2)
    frame, claim = votes[0]
    ing.note_vote_frame(frame)
    wave = ing.try_adopt([claim], (4,))
    log.append(_summary(wave))
    wave.release()
    wave.release()
    log.append(wave._released)
    return ing


@pytest.mark.parametrize("script", [
    _prefix_and_surplus, _disjoint_then_overlapping, _full_arena_resyncs,
    _ring_exhausted_resyncs, _idempotent_release,
], ids=lambda f: f.__name__.strip("_"))
def test_arena_decisions_and_counters_equal_the_jax_plane(script):
    votes = _raw_votes(7, 10)
    logs = {}
    for svc in (psvc, jsvc):
        log: list = []
        ing = script(svc, votes, log)
        try:
            logs[svc] = (log, ing.counters())
        finally:
            ing.packer.close()
    assert logs[psvc] == logs[jsvc]
    assert logs[psvc][1]["packed"] > 0


def test_adopted_columns_equal_flatten_claims_and_the_jax_arena_at_every_bucket():
    pad = psvc.make_pad_claim()
    assert pad == jsvc.make_pad_claim()
    assert psvc.DEFAULT_WAVE_BUCKETS == jsvc.DEFAULT_WAVE_BUCKETS
    mine = psvc.ZeroCopyIngest(capacity=psvc.DEFAULT_WAVE_BUCKETS[-1], ring_depth=3)
    theirs = jsvc.ZeroCopyIngest(capacity=jsvc.DEFAULT_WAVE_BUCKETS[-1], ring_depth=3)
    seed = 0
    try:
        for bucket in psvc.DEFAULT_WAVE_BUCKETS:
            for n in (bucket, max(1, bucket - 3)):
                seed += 1
                votes = _raw_votes(seed, n)
                claims = [c for _, c in votes]
                waves = []
                for ing, svc in ((mine, psvc), (theirs, jsvc)):
                    for frame, _ in votes:
                        assert ing.note_vote_frame(frame)
                    wave = ing.try_adopt(claims, svc.DEFAULT_WAVE_BUCKETS)
                    assert wave is not None and (wave.n, wave.rows) == (n, bucket)
                    waves.append(wave)
                digests, pks, sigs, spans = psvc.flatten_claims(claims)
                assert spans == [(i, i + 1) for i in range(n)]
                want = {
                    "dig": b"".join(digests) + pad[1] * (bucket - n),
                    "pk": b"".join(pks) + pad[2] * (bucket - n),
                    "sig": b"".join(sigs) + pad[3] * (bucket - n),
                }
                for col, data in want.items():
                    assert bytes(getattr(waves[0], col)) == data, (bucket, n, col)
                    assert bytes(getattr(waves[1], col)) == data, (bucket, n, col)
                for wave in waves:
                    wave.release()
        assert mine.counters() == theirs.counters()
        assert mine.counters()["zero_copy_waves"] == 2 * len(psvc.DEFAULT_WAVE_BUCKETS)
    finally:
        mine.packer.close()
        theirs.packer.close()


# ---- verdicts --------------------------------------------------------------


def test_eval_claims_arena_verdicts_equal_the_jax_verifier_and_the_oracle():
    """A 16-row wave with four forged rows (two flipped signature bytes,
    two with S >= L) through the port's device host on the CPU (the
    kernels' plain versions, staged from the arena by verify_packed),
    through the JAX eval_claims_arena on its BatchVerifier, and through
    the oracle."""
    from hotstuff_tpu.tpu.ed25519 import BatchVerifier as JaxBatchVerifier

    forged = {2, 5, 10, 13}
    frames, claims = _signed_votes(16, forged)
    oracle = [ref.verify(c[3], c[2], c[1]) for c in claims]
    assert [not ok for ok in oracle] == [i in forged for i in range(16)]

    host = make_verifier("cuda", device="cpu")
    host.precompute([c[2] for c in claims])
    jax_backend = JaxBatchVerifier(min_device_batch=0, use_pallas=False)
    jax_backend.precompute([c[2] for c in claims])
    verdicts = {}
    for svc, backend in ((psvc, host.async_backend), (jsvc, jax_backend)):
        ing = svc.ZeroCopyIngest(capacity=64, ring_depth=2)
        try:
            for frame in frames:
                assert ing.note_vote_frame(frame)
            wave = ing.try_adopt(claims, svc.DEFAULT_WAVE_BUCKETS)
            assert (wave.n, wave.rows) == (16, 16)
            verdicts[svc] = svc.eval_claims_arena(backend, wave, claims)
            assert wave._released and ing.counters()["recycle"] == 1
        finally:
            ing.packer.close()
    assert verdicts[psvc] == verdicts[jsvc] == oracle


# ---- the plane on the receive path ---------------------------------------


class _WaveHandler:
    """Decodes vote frames and submits each ``size`` claims as one wave
    to ``service``, after the claims in ``prefixes[w]`` for wave ``w``;
    keeps the verdict futures."""

    def __init__(self, service, size, prefixes):
        self.service, self.size, self.prefixes = service, size, prefixes
        self.claims: list = []
        self.waves: list = []

    async def dispatch(self, writer, message: bytes) -> None:
        tag, vote = pwire.decode_message(message, scheme="ed25519")
        assert tag == pwire.TAG_VOTE
        self.claims.append(vote.claim())
        if len(self.claims) == self.size:
            wave = self.prefixes[len(self.waves)] + self.claims
            self.claims = []
            self.waves.append(asyncio.ensure_future(self.service.verify_claims(wave)))


def test_asyncio_receiver_notes_votes_and_the_service_adopts_them(fresh_plane, monkeypatch):
    """Vote frames on the port's asyncio Receiver reach the ingest plane
    through ``dispatch_ingest``: a wave of votes in receive order is
    adopted (``zc=1``); a mixed wave, a certificate claim ahead of the
    packed votes, resyncs the plane and flattens (``fb=1``); every
    verdict is the oracle's."""
    frames, claims = _signed_votes(8, forged={3})
    oracle = [ref.verify(c[3], c[2], c[1]) for c in claims]
    qc = ("shared", claims[0][1], ((claims[0][2], claims[0][3]),))
    # the device host on the CPU with routing held to the CPU (another
    # test in the process may have warmed it): the service serves every
    # wave inline, the adopted one through eval_claims_arena
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    host = make_verifier("cuda", device="cpu")

    async def body():
        service = psvc.AsyncVerifyService(host, device=True)
        handler = _WaveHandler(service, 4, [[], [qc]])
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        sock.close()
        recv = Receiver("127.0.0.1", port, handler)
        writer = None
        try:
            await recv.spawn()
            plane = psvc.zero_copy_ingest_if_active()
            assert plane is not None
            _, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), TIMEOUT_S)
            for w in range(2):
                for frame in frames[4 * w : 4 * w + 4]:
                    write_frame(writer, frame)
                await writer.drain()
                deadline = asyncio.get_running_loop().time() + TIMEOUT_S
                while len(handler.waves) <= w:
                    assert asyncio.get_running_loop().time() < deadline
                    await asyncio.sleep(0.01)
                await asyncio.wait_for(handler.waves[w], TIMEOUT_S)
            got = [await w for w in handler.waves]
            assert got == [oracle[:4], [True] + oracle[4:]]
            assert (service.zero_copy_waves, service.fallback_waves) == (1, 1)
            assert service.cpu_dispatches == 2 and not service._inflight
            assert service.zero_copy_sigs == 4 and plane.packed_votes == 8
            m = RE_VERIFY_STATS.search(service.stats_line())
            assert m is not None and (m.group(15), m.group(16)) == ("1", "1")
        finally:
            if writer is not None:
                writer.close()
            await recv.shutdown()
            service.close()

    asyncio.run(body())


def test_a_plane_that_cannot_start_raises_and_names_the_switch(fresh_plane, monkeypatch):
    """With the plane enabled (the default) a library that fails to
    build raises at the receiver's spawn; ``HOTSTUFF_ZERO_COPY=0`` turns
    the plane off and frames go straight to the handler."""
    from hotstuff_tpu_torch import _native_build

    build = _native_build.build

    def broken(name):
        if name != "transport":
            return build(name)
        raise RuntimeError("g++ failed (1): no compiler here")

    monkeypatch.setattr(_native_build, "_LIBS", {})
    monkeypatch.setattr(_native_build, "build", broken)

    class Sink:
        frames: list = []

        async def dispatch(self, writer, message):
            self.frames.append(message)

    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        sock.close()
        with pytest.raises(RuntimeError, match="HOTSTUFF_ZERO_COPY=0"):
            await Receiver("127.0.0.1", port, Sink()).spawn()
        monkeypatch.setenv("HOTSTUFF_ZERO_COPY", "0")
        recv = Receiver("127.0.0.1", port, Sink())
        await recv.spawn()
        try:
            assert psvc.zero_copy_ingest() is None
            frame = _signed_votes(1)[0][0]
            await receiver.dispatch_ingest(Sink(), None, frame)
            assert Sink.frames == [frame]
        finally:
            await recv.shutdown()

    asyncio.run(body())
