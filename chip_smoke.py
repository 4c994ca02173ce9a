#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``hotstuff_tpu_torch`` at the repo's deployment size — a
256-validator committee, QCs of 2f+1 = 171 votes, coalesced waves padded
to 1024 — through the verifier backend a node calls, and checks every
verdict against the arbitrary-precision oracle (``ed25519_ref.verify``):

1. prints the card's name and power limit, builds the CUDA kernels and
   prints each kernel's registers, stack frame and shared memory, and
   each device function's size and commonest opcodes in SASS;
2. ``BatchVerifier(min_device_batch=0)`` on ``cuda``: ``precompute`` of
   the 256 keys, ``warmup(256)``;
3. the main path, with the launch counts set to 0 just before it and
   read just after: ``verify_shared_msg`` on a valid QC and on one with
   a corrupted signature, ``verify_many`` on a 171-entry TC,
   ``verify_device`` on a 1024-claim wave mixing the adversarial cases,
   ``verify_packed`` over ``bytearray`` columns of the same wave;
4. the scan path (the coordinate-output kernel) on the staged wave,
   counted the same way, its points checked to compress to R exactly
   where the oracle accepts;
5. each kernel against its plain PyTorch version on the card at
   B = 128, 256, 1024 — integers, so the tolerance is zero — and 20
   back-to-back launches of each kernel at B = 1024, every result equal
   to the plain one (a missing barrier shows only some of the time);
6. CUDA-event times of the kernels and the plain versions, host-clock
   latency of ``verify_shared_msg`` on the 171-vote QC (mean of 20 after
   warm-up, with the challenge memo cleared before each call, as for a
   QC first seen, and kept, as for a re-verify), host-clock time of the
   whole 1024-claim ``verify_device`` and its split into the span stages
   (prepare / dispatch / device.execute / readback), with the challenge
   memo kept, cleared, and cleared on a second thread;
7. (a) the view-change storm at N = 256, quorum 171
   (``hotstuff_tpu_torch/bench/storm.py``) on ``make_verifier("cuda")``
   after ``precompute`` + ``warmup(171)`` (+ ``warm_buckets()`` for the
   off-loop row): every row of its report, every signature of the storm
   checked against the oracle, a forged vote, timeout, embedded QC and
   TC entry rejected, and the CPU route's measured cost a signature
   beside the routing model's ``CPU_US_PER_SIG``; launch counts set to 0
   just before and read just after;
8. (b) coalesced waves at the same committee shape: 8 asyncio tasks
   stand in for 8 in-process cores and submit each round's claims (the
   171-vote QC from every task, 256 votes with 3 forged, 171
   distinct-digest timeouts) to the shared ``AsyncVerifyService``;
   4 rounds back to back at pipeline depth 2.  Every fanned-out verdict
   must equal the oracle's, every wave must take the device route,
   padded to the 1024 bucket, and the verify kernel's launch count must
   rise; wave wall times, launches per wave and the service's stats
   line are printed;
9. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is the sum
   over the three main-path runs (3, 7 and 8).

Any mismatch raises, so the exit code is not 0 and no result line is
printed.  Without a CUDA device it exits with 2 and prints no result.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

COMMITTEE = 256  # bench.py's committee shape
QUORUM = 2 * ((COMMITTEE - 1) // 3) + 1  # 2f+1 = 171
WAVE = 1024
PAD_SIZES = (128, 256, 1024)
TIMED_LAUNCHES = 10
REPEATED_LAUNCHES = 20
QC_CALLS = 20

# Peak rates of one H100 SXM used for the bound (at its 700 W limit):
# HBM 3.35 TB/s (data sheet); int32 multiply-adds at 64 lanes per SM per
# clock x 132 SMs x 1.98 GHz boost (Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 64 * 132 * 1.98e9


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def bounds(batch: int):
    """(ms, "operations" | "bytes") for the verify and the scan kernel at
    ``batch`` lanes: the larger of the int32 multiply-adds (squarings
    counted at 210, other products at 400) over the card's int32 rate and the bytes (each input read once, each output
    written once) over its memory rate."""
    from hotstuff_tpu_torch.gpu import dsm, field as F

    def bound(mads, nbytes):
        t_ops = batch * mads / INT32_MADS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    limbs = batch * F.NLIMBS * 4
    in_bytes = 2 * 64 * batch * 4 + 4 * limbs + dsm.BTAB_T2D.nbytes + 2 * F.NLIMBS * 4
    verify = bound(dsm.MADS_VERIFY, in_bytes + limbs + batch * 4 + batch * 4)
    scan = bound(dsm.MADS_SCAN, in_bytes + 4 * limbs)
    return verify, scan


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_mix(lib_path) -> None:
    """Print, for each kernel of the library, its body and every device
    function it calls (named by address: a CALL target), with the number
    of SASS instructions and the commonest opcodes.  Needs ``cuobjdump``;
    without it, says so and returns."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: cuobjdump not found")
        return
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    for section in out.split("Function : ")[1:]:
        name = section.split("\n", 1)[0].strip()
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", section)]
        targets = sorted({int(t, 16) for t in re.findall(r"CALL\.REL\.NOINC\s+(?:0x)?([0-9a-f]+)", section)})
        bounds = [0] + targets + [ins[-1][0] + 16] if ins else []
        print(f"sass: {name}")
        for lo, hi in zip(bounds, bounds[1:]):
            ops = collections.Counter(op for a, op in ins if lo <= a < hi)
            what = "kernel body" if lo == 0 else f"function at {lo:#x}"
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common(6))
            print(f"sass:   {what}: {sum(ops.values())} instructions ({top})")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_claims():
    """The committee, a QC, a TC and a 1024-claim adversarial wave, with
    the oracle's verdict for every claim."""
    from hotstuff_tpu_torch.crypto import Digest, Signature, generate_keypair
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref

    keys = [generate_keypair(b"\x33" * 32, i) for i in range(COMMITTEE)]
    pks = [pk for pk, _ in keys]

    qc_digest = Digest.of(b"chip smoke block")
    qc_votes = [(pk, Signature.new(qc_digest, sk)) for pk, sk in keys[:QUORUM]]
    bad = qc_votes[QUORUM // 3][1].to_bytes()
    qc_bad = list(qc_votes)
    qc_bad[QUORUM // 3] = (qc_votes[QUORUM // 3][0], Signature(bad[:10] + bytes([bad[10] ^ 1]) + bad[11:]))

    tc_msgs = [Digest.of(b"chip smoke timeout %d" % i).to_bytes() for i in range(QUORUM)]
    tc_pks = [pks[i].to_bytes() for i in range(QUORUM)]
    tc_sigs = [
        Signature.new(Digest(m), keys[i][1]).to_bytes() for i, m in enumerate(tc_msgs)
    ]

    msgs, wpks, sigs = [], [], []
    for i in range(WAVE):
        pk, sk = keys[i % COMMITTEE]
        d = Digest.of(b"chip smoke wave %d" % i)
        msgs.append(d.to_bytes())
        wpks.append(pk.to_bytes())
        sigs.append(Signature.new(d, sk).to_bytes())
    # the adversarial cases of tests/test_tpu_ed25519.py, spread over the wave
    stranger = ref.public_from_seed(b"\xaa" * 32)
    for i in range(WAVE):
        case = i % 16
        sig = sigs[i]
        if case == 1:  # bad R
            sigs[i] = bytes([sig[0] ^ 1]) + sig[1:]
        elif case == 2:  # flipped s
            sigs[i] = sig[:40] + bytes([sig[40] ^ 0x80]) + sig[41:]
        elif case == 3:  # wrong message
            msgs[i] = Digest.of(b"tampered %d" % i).to_bytes()
        elif case == 4:  # wrong key
            wpks[i] = stranger
        elif case == 5:  # s + L (non-canonical s)
            s_int = int.from_bytes(sig[32:], "little") + ref.L
            sigs[i] = sig[:32] + s_int.to_bytes(32, "little")
        elif case == 6:  # undecodable key (y >= p)
            wpks[i] = (ref.P + 1).to_bytes(32, "little")
        elif case == 7:  # non-canonical R: y >= p
            sigs[i] = (ref.P + 3).to_bytes(32, "little") + sig[32:]
    t0 = time.perf_counter()
    expect_tc = [ref.verify(s, p, m) for m, p, s in zip(tc_msgs, tc_pks, tc_sigs)]
    expect_wave = [ref.verify(s, p, m) for m, p, s in zip(msgs, wpks, sigs)]
    expect_qc = all(ref.verify(s.to_bytes(), p.to_bytes(), qc_digest.to_bytes()) for p, s in qc_votes)
    expect_qc_bad = all(ref.verify(s.to_bytes(), p.to_bytes(), qc_digest.to_bytes()) for p, s in qc_bad)
    print(f"oracle verdicts: {len(expect_tc) + len(expect_wave) + 2 * QUORUM} in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return {
        "pks": [pk.to_bytes() for pk in pks],
        "qc": (qc_digest, qc_votes, expect_qc),
        "qc_bad": (qc_digest, qc_bad, expect_qc_bad),
        "tc": (tc_msgs, tc_pks, tc_sigs, expect_tc),
        "wave": (msgs, wpks, sigs, expect_wave),
    }


def oracle(claim) -> bool:
    """The arbitrary-precision oracle's verdict on one wave claim."""
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref

    if claim[0] == "one":
        return ref.verify(claim[3], claim[2], claim[1])
    return bool(claim[2]) and all(ref.verify(s, p, claim[1]) for p, s in claim[2])


def storm_phase(card: str, nodes: int = COMMITTEE, torch_device=None) -> int:
    """(a) The view-change storm on the node's device host; returns the
    verify kernel's launches in it."""
    from hotstuff_tpu_torch.bench import storm
    from hotstuff_tpu_torch.consensus import InvalidSignature, QC, TC, Timeout, Vote
    from hotstuff_tpu_torch.crypto import CpuVerifier, Signature
    from hotstuff_tpu_torch.crypto.async_service import CPU_US_PER_SIG, flatten_claims
    from hotstuff_tpu_torch.crypto.signature import HAVE_CRYPTOGRAPHY
    from hotstuff_tpu_torch.gpu import dsm
    from hotstuff_tpu_torch.node import make_verifier

    quorum = 2 * nodes // 3 + 1
    t0 = time.perf_counter()
    committee, timeouts, (tc, tc_worst), high_qc = storm._ed25519_fixture(nodes, quorum)
    want = [oracle(("one", t.digest().to_bytes(), t.author.to_bytes(), t.signature.to_bytes()))
            for t in timeouts]
    want += [oracle(c) for c in high_qc.claims() + tc.claims() + tc_worst.claims()]
    check(all(want), "storm fixture: every signature valid for the oracle")
    print(f"storm fixture + oracle: {len(want)} claims in {time.perf_counter() - t0:.1f} s (host)")

    dsm.reset_launches()
    t0 = time.perf_counter()
    results = storm.run_storm(nodes, device=True, torch_device=torch_device)
    wall = time.perf_counter() - t0
    v = make_verifier("cuda", device=torch_device)  # the warm shared host
    check(v.device_ready, "storm: the device host is warm")

    def rejected(msg) -> bool:
        try:
            msg.verify(committee, v)
        except InvalidSignature:
            return True
        return False

    def bad(sig):
        b = sig.to_bytes()
        return Signature(b[:7] + bytes([b[7] ^ 1]) + b[8:])

    vote = Vote(hash=high_qc.hash, round=high_qc.round, author=high_qc.votes[5][0],
                signature=high_qc.votes[5][1])
    check(not rejected(vote), "storm: a valid vote is accepted")
    forged_vote = Vote(hash=vote.hash, round=vote.round, author=vote.author, signature=bad(vote.signature))
    t = timeouts[3]
    forged_timeout = Timeout(high_qc=t.high_qc, round=t.round, author=t.author, signature=bad(t.signature))
    qc_votes = list(high_qc.votes)
    k = 2 * quorum // 3
    qc_votes[k] = (qc_votes[k][0], bad(qc_votes[k][1]))
    forged_qc = Timeout(high_qc=QC(hash=high_qc.hash, round=high_qc.round, votes=qc_votes),
                        round=t.round, author=t.author, signature=t.signature)
    entries = list(tc_worst.votes)
    entries[quorum // 2] = (entries[quorum // 2][0], bad(entries[quorum // 2][1]), entries[quorum // 2][2])
    forged_tc = TC(round=tc_worst.round, votes=entries)
    for what, msg in (("vote", forged_vote), ("timeout", forged_timeout),
                      ("timeout's embedded QC", forged_qc), ("TC entry", forged_tc)):
        check(oracle_rejects(msg), f"storm: the oracle rejects the forged {what}")
        check(rejected(msg), f"storm: a forged {what} is rejected")
    launches = dsm.launches["verify_compressed"]
    print(storm.format_report(nodes, results))
    print(f"storm phase: {wall:.1f} s host clock, verify kernel launches {launches}; "
          f"every verdict equals the oracle's; forged vote, timeout, QC vote and TC entry rejected [{card}]")

    cpu = CpuVerifier()
    digests, pks, sigs, _ = flatten_claims(tc_worst.claims())
    t0 = time.perf_counter()
    ok = cpu.verify_many(digests, pks, sigs)
    us = (time.perf_counter() - t0) / len(digests) * 1e6
    check(all(ok), "storm: the CPU route accepts the worst-case TC")
    route = "OpenSSL via cryptography" if HAVE_CRYPTOGRAPHY else "pure-Python oracle"
    print(f"CPU route ({route}; CpuVerifier.verify_many, {len(digests)} distinct digests): {us:.1f} us a signature "
          f"measured, routing model CPU_US_PER_SIG = {CPU_US_PER_SIG:.0f} us [{card}]")
    return launches


def oracle_rejects(msg) -> bool:
    """Does the oracle find a bad signature in ``msg`` (a vote, a timeout
    with its embedded QC, or a TC)?"""
    if isinstance(getattr(msg, "votes", None), list):  # TC
        return not all(oracle(c) for c in msg.claims())
    if hasattr(msg, "high_qc"):
        own = ("one", msg.digest().to_bytes(), msg.author.to_bytes(), msg.signature.to_bytes())
        return not (oracle(own) and all(oracle(c) for c in msg.high_qc.claims()))
    return not oracle(msg.claim())


def gc_pause_recorder(pauses: list):
    """A ``gc.callbacks`` entry that appends each collection's pause (s)."""
    start = []

    def on_gc(phase, _info):
        if phase == "start":
            start[:] = [time.perf_counter()]
        elif start:
            pauses.append(time.perf_counter() - start[0])

    return on_gc


def coalesced_phase(card: str, nodes: int = COMMITTEE, rounds: int = 4, cores: int = 8,
                    torch_device=None) -> int:
    """(b) Coalesced waves from ``cores`` in-process cores through the
    shared async service; returns the verify kernel's launches in it."""
    import asyncio

    from hotstuff_tpu_torch.consensus import QC, TC, Vote, timeout_digest
    from hotstuff_tpu_torch.crypto import Digest, Signature, generate_keypair
    from hotstuff_tpu_torch.crypto.async_service import AsyncVerifyService
    from hotstuff_tpu_torch.gpu import dsm
    from hotstuff_tpu_torch.node import make_verifier
    from hotstuff_tpu_torch.telemetry import spans

    quorum = 2 * nodes // 3 + 1
    members = [generate_keypair(b"\x51" * 32, i) for i in range(nodes)]  # the storm's committee
    forged = {17 % nodes, 101 % nodes, 200 % nodes}
    t0 = time.perf_counter()
    waves = []
    for r in range(rounds):
        block = Digest.of(b"coalesced block %d" % r)
        vd = Vote(hash=block, round=20 + r, author=members[0][0]).digest()
        qc = QC(hash=block, round=20 + r, votes=[(pk, Signature.new(vd, sk)) for pk, sk in members[:quorum]])
        votes = []
        for i, (pk, sk) in enumerate(members):
            v = Vote(hash=Digest.of(b"coalesced next %d" % r), round=21 + r, author=pk)
            v.signature = Signature.new(v.digest(), members[(i + 1) % nodes][1] if i in forged else sk)
            votes.append(v.claim())
        tc = TC(round=20 + r, votes=[(pk, Signature.new(timeout_digest(20 + r, i), sk), i)
                                     for i, (pk, sk) in enumerate(members[:quorum])])
        timeouts = tc.claims()
        check(len(timeouts) == quorum and all(c[0] == "one" for c in timeouts), "distinct-digest timeouts")
        per_core = [[qc.claims()[0]] + votes[c::cores] + timeouts[c::cores] for c in range(cores)]
        want = [[oracle(c) for c in cs] for cs in per_core]
        check(sum(not ok for cs in want for ok in cs) == len(forged), "the oracle rejects the forged votes")
        waves.append((per_core, want))
    sigs_per_wave = quorum + nodes + quorum
    print(f"coalesced fixture + oracle: {rounds} rounds of {sigs_per_wave} unique signatures "
          f"in {time.perf_counter() - t0:.1f} s (host)")

    host = make_verifier("cuda", device=torch_device)
    host.precompute([pk.to_bytes() for pk, _ in members])
    host.warmup(quorum)

    async def run():
        service = AsyncVerifyService.for_backend(host)
        try:
            check(service.device and service.pipeline_depth == 2, "shared device service at depth 2")
            service.warm_buckets()
            bucket = next(b for b in service.wave_buckets if b >= sigs_per_wave)
            dsm.reset_launches()

            async def one_round(svc, per_core):
                t_r = time.perf_counter()
                got = await asyncio.gather(*(svc.verify_claims(cs) for cs in per_core))
                return list(got), time.perf_counter() - t_r

            async def play(svc=service):
                """All rounds back to back: round r+1 is submitted as soon
                as wave r departs.  Returns each wave's wall time and the
                whole run's."""
                t_all = time.perf_counter()
                start = svc.dispatches
                pending = []
                for r, (per_core, _) in enumerate(waves):
                    pending.append(asyncio.ensure_future(one_round(svc, per_core)))
                    # wait until wave r departs; poll with a real sleep, in
                    # which the loop releases the GIL (a sleep(0) spin would
                    # keep it from the slot threads)
                    while svc.dispatches <= start + r:
                        await asyncio.sleep(0.0002)
                done = await asyncio.gather(*pending)
                total = time.perf_counter() - t_all
                for r, ((got, _), (_, want)) in enumerate(zip(done, waves)):
                    check(got == want, f"coalesced round {r}: fanned-out verdicts equal the oracle's")
                return [wall for _, wall in done], total

            # the fixtures left a large heap: collect it now, and record
            # the collector's pauses during the run
            gc.collect()
            pauses: list = []
            gc.callbacks.append(on_gc := gc_pause_recorder(pauses))
            try:
                walls, total = await play()
            finally:
                gc.callbacks.remove(on_gc)
            launches = dsm.launches["verify_compressed"]
            for r, wall in enumerate(walls):
                print(f"coalesced wave {r}: {wall * 1e3:.1f} ms host clock from submit to the last "
                      f"verdict, {sum(map(len, waves[r][0]))} verdicts to {cores} cores [{card}]")
            print(f"coalesced run: {total * 1e3:.1f} ms host clock for {rounds} waves, "
                  f"{rounds * sigs_per_wave / total:.0f} unique sigs/s; garbage-collector pauses "
                  f"{len(pauses)}, longest {max(pauses, default=0.0) * 1e3:.1f} ms [{card}]")
            print(service.stats_line())
            # the router decides each wave from the measured dispatch time,
            # so a host stall may send a wave to the CPU; the device waves
            # are checked for what they must show
            on_device = service.device_dispatches + service.probe_dispatches
            check(service.device_dispatches >= 1, "the coalesced waves took the device route")
            kernels_run = host.device.type == "cuda"  # a CPU rehearsal runs the plain versions
            check(launches == (on_device if kernels_run else 0),
                  "one verify-kernel launch for each wave on the device")
            check(service.device_sigs + service.cpu_sigs == rounds * sigs_per_wave,
                  "cross-core dedup: one QC claim a wave, however many cores sent it")
            check(service.packed_waves == on_device
                  and service.pad_sigs == on_device * (bucket - sigs_per_wave),
                  f"device waves padded to the {bucket} bucket")
            print(f"coalesced phase: {rounds} waves of {sigs_per_wave} signatures, "
                  f"{service.device_dispatches} on the device padded to {bucket}, "
                  f"{service.cpu_dispatches} on the CPU, peak in flight {service.peak_inflight} "
                  f"(depth {service.pipeline_depth}), verify kernel launches {launches} "
                  f"({launches / max(on_device, 1):.2f} a device wave) [{card}]")

            # where a wave's time goes: the same waves again, pinned to the
            # device, with the span recorder on and the challenge memo
            # cleared (as for claims seen for the first time), through the
            # shared service and then through a private one at depth 1
            os.environ["HOTSTUFF_FORCE_DEVICE_ROUTE"] = "1"
            single = AsyncVerifyService(host, device=True, pipeline_depth=1)
            try:
                for label, svc in (("depth 2, shared service", service),
                                   ("depth 1, new service", single)):
                    host.async_backend._device._challenge_memo.clear()
                    gc.collect()
                    rec = spans.enable()
                    try:
                        walls, total = await play(svc)
                        rows = rec.drain()
                    finally:
                        spans.disable()
                    check(svc.device_dispatches >= rounds, f"{label}: every replayed wave on the device")
                    stages: dict = {}
                    for name, _t0, dur, _depth, _thread in rows:
                        stages.setdefault(name, []).append(dur / 1e6)
                    occupancy = stages.pop("pipeline.occupancy", [0.0])
                    print(f"coalesced replay ({label}): {total * 1e3:.1f} ms host clock, waves "
                          + ", ".join(f"{w * 1e3:.1f}" for w in walls)
                          + f" ms; mean occupancy at spawn {sum(occupancy) / len(occupancy) * 1e6:.2f} [{card}]")
                    print(f"coalesced replay ({label}) span stages (mean ms x count): " + ", ".join(
                        f"{k} {sum(v) / len(v):.3f} x{len(v)}" for k, v in stages.items()))
                    print(f"coalesced replay ({label}) per wave, prepare / dispatch.wall ms: " + ", ".join(
                        f"{p:.1f}/{w:.1f}" for p, w in zip(stages.get("prepare", []),
                                                          stages.get("dispatch.wall", []))))
            finally:
                del os.environ["HOTSTUFF_FORCE_DEVICE_ROUTE"]
                await drained(single)
                single.close()
            return launches
        finally:
            await drained(service)
            service.close()

    async def drained(svc, limit_s: float = 10.0) -> None:
        """Let every in-flight wave (a probe included) land before the
        service closes, so no slot thread is left mid-launch."""
        t_end = time.perf_counter() + limit_s
        while svc._inflight and time.perf_counter() < t_end:
            await asyncio.sleep(0.001)

    return asyncio.run(run())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hotstuff_tpu_torch.gpu import _build, dsm, field as F
    from hotstuff_tpu_torch.gpu.ed25519 import BatchVerifier
    from hotstuff_tpu_torch.telemetry import spans

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: {_build.library_path().name}")
    report = _build.library_path().with_suffix(".ptxas.txt")
    if report.exists():
        keys = ("Compiling entry", "Function properties", "stack frame", "registers")
        for line in report.read_text().splitlines():
            if any(key in line for key in keys):
                print("ptxas:", line.strip())
    print(f"dynamic shared memory per block (both kernels): {_build.load().dsm_smem_bytes()} bytes")
    sass_mix(_build.library_path())

    claims = make_claims()

    # 2. the verifier a node would build
    t0 = time.perf_counter()
    v = BatchVerifier(min_device_batch=0)
    v.precompute(claims["pks"])
    v.warmup(COMMITTEE)
    print(f"precompute + warmup: {time.perf_counter() - t0:.1f} s")

    # 3. the main path
    msgs, wpks, sigs, expect_wave = claims["wave"]
    dsm.reset_launches()
    digest, votes, want = claims["qc"]
    check(v.verify_shared_msg(digest, votes) == want and want, "valid QC")
    digest, votes, want = claims["qc_bad"]
    check(v.verify_shared_msg(digest, votes) == want and not want, "corrupted QC")
    tc_msgs, tc_pks, tc_sigs, expect_tc = claims["tc"]
    check(v.verify_many(tc_msgs, tc_pks, tc_sigs) == expect_tc, "TC verdicts")
    got = v.verify_device(msgs, wpks, sigs)
    check(got.tolist() == expect_wave, "1024-claim wave verdicts (verify_device)")
    got = v.verify_packed(
        bytearray(b"".join(msgs)), bytearray(b"".join(wpks)), bytearray(b"".join(sigs)), WAVE
    )
    check(got.tolist() == expect_wave, "1024-claim wave verdicts (verify_packed)")
    main_launches = dict(dsm.launches)
    print(f"main path launches: {main_launches}; wave valid "
          f"{sum(expect_wave)}/{WAVE}, all verdicts agree with the oracle")
    check(main_launches["verify_compressed"] > 0, "main path never launched the verify kernel")

    # 4. the scan path: P = [s]B + [k](-A) for the staged wave must
    #    compress to R exactly where the oracle accepts
    valid_host, arrays = v.prepare(msgs, wpks, sigs)
    ax, ay, az, at, s_win, k_win, r_y, r_sign = (a.clone() for a in arrays)
    dsm.reset_launches()
    X, Y, Z, _ = dsm.dual_scalar_mult(s_win, k_win, (ax, ay, az, at))
    torch.cuda.synchronize()
    scan_launches = dict(dsm.launches)
    check(scan_launches["dual_scalar_mult"] > 0, "scan path never launched the scan kernel")
    zinv = F.pow_inv(Z)
    y_ok = (F.canonical(F.mul(Y, zinv)) == r_y).all(dim=-1)
    sign_ok = F.is_odd(F.mul(X, zinv)) == r_sign
    compresses = (y_ok & sign_ok).cpu().numpy()
    check(
        (compresses[:WAVE] & valid_host).tolist() == expect_wave,
        "scan kernel points compress to R exactly where the oracle accepts",
    )
    print(f"scan path launches: {scan_launches}; points agree with the oracle")

    # 5. + 6. kernels against their plain versions, and times
    times = {}
    errs = {"verify": 0, "scan": 0}
    for size in PAD_SIZES:
        valid_host, arrays = v.prepare(msgs[:size], wpks[:size], sigs[:size])
        ax, ay, az, at, s_win, k_win, r_y, r_sign = (a.clone() for a in arrays)
        a_pt = (ax, ay, az, at)
        ok_k = dsm.verify_compressed(s_win, k_win, a_pt, r_y, r_sign)
        box = {}
        plain_ms = cuda_ms(
            lambda: box.__setitem__("ok", dsm.plain_verify_compressed(s_win, k_win, a_pt, r_y, r_sign)), 1
        )
        err = int((ok_k.int() - box["ok"].int()).abs().max())
        errs["verify"] = max(errs["verify"], err)
        check(err == 0, f"verify kernel vs plain at B={size}")
        check(
            (ok_k.cpu().numpy()[:size] & valid_host).tolist() == expect_wave[:size],
            f"verify kernel vs oracle at B={size}",
        )
        pk_out = dsm.dual_scalar_mult(s_win, k_win, a_pt)
        scan_plain_ms = cuda_ms(
            lambda: box.__setitem__("pt", dsm.plain_dual_scalar_mult(s_win, k_win, a_pt)), 1
        )
        for c in range(3):
            diff = (F.canonical(pk_out[c]) - F.canonical(box["pt"][c])).abs().max()
            errs["scan"] = max(errs["scan"], int(diff))
        check(errs["scan"] == 0, f"scan kernel vs plain at B={size} (canonical X, Y, Z)")
        dsm.verify_compressed(s_win, k_win, a_pt, r_y, r_sign)  # warm
        ms = cuda_ms(lambda: dsm.verify_compressed(s_win, k_win, a_pt, r_y, r_sign), TIMED_LAUNCHES)
        scan_ms = cuda_ms(lambda: dsm.dual_scalar_mult(s_win, k_win, a_pt), TIMED_LAUNCHES)
        times[size] = (ms, plain_ms, scan_ms, scan_plain_ms)
        if size == WAVE:
            oks = [dsm.verify_compressed(s_win, k_win, a_pt, r_y, r_sign)
                   for _ in range(REPEATED_LAUNCHES)]
            pts = [dsm.dual_scalar_mult(s_win, k_win, a_pt) for _ in range(REPEATED_LAUNCHES)]
            torch.cuda.synchronize()
            want = [F.canonical(box["pt"][c]) for c in range(3)]
            for i, (ok_i, pt_i) in enumerate(zip(oks, pts)):
                check(bool((ok_i == box["ok"]).all()), f"verify launch {i} of {REPEATED_LAUNCHES} vs plain")
                for c in range(3):
                    check(bool((F.canonical(pt_i[c]) == want[c]).all()),
                          f"scan launch {i} of {REPEATED_LAUNCHES} vs plain")
                    check(bool((pt_i[c] == pts[0][c]).all()), f"scan launch {i}: raw limbs vary")
            print(f"B={size}: {REPEATED_LAUNCHES} back-to-back launches of each kernel equal the plain versions")
        vb, sb = bounds(size)
        print(f"B={size}: verify kernel {ms:.3f} ms (bound {vb[0]:.4f} ms, {vb[1]}), plain "
              f"{plain_ms:.1f} ms; scan kernel {scan_ms:.3f} ms (bound {sb[0]:.4f} ms, {sb[1]}), "
              f"plain {scan_plain_ms:.1f} ms; exact match [{card}]")

    digest, votes, want = claims["qc"]
    for memo in ("cleared", "kept"):
        check(v.verify_shared_msg(digest, votes) == want, "QC warm-up")
        total = 0.0
        for _ in range(QC_CALLS):
            if memo == "cleared":
                v._challenge_memo.clear()
            t0 = time.perf_counter()
            ok_qc = v.verify_shared_msg(digest, votes)
            total += time.perf_counter() - t0
            check(ok_qc == want, "QC verdict while timing")
        print(f"verify_shared_msg, {QUORUM}-vote QC (pad 256), challenge memo {memo}: "
              f"{total / QC_CALLS * 1e3:.3f} ms host clock, mean of {QC_CALLS} [{card}]")

    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        v.verify_device(msgs, wpks, sigs)
    wall = (time.perf_counter() - t0) / reps
    print(f"verify_device, 1024-claim wave: {wall * 1e3:.1f} ms host clock, "
          f"{WAVE / wall:.0f} sigs/s [{card}]")
    def waves(clear: bool) -> None:
        for _ in range(reps):
            if clear:
                v._challenge_memo.clear()
            v.verify_device(msgs, wpks, sigs)

    def on_thread(clear: bool) -> None:  # a second thread, as the wave service's slots are
        worker = threading.Thread(target=waves, args=(clear,))
        worker.start()
        worker.join()

    # cleared: as for claims seen for the first time
    for label, run, clear in (("challenge memo kept", waves, False),
                              ("challenge memo cleared", waves, True),
                              ("challenge memo cleared, on a second thread", on_thread, True)):
        rec = spans.enable()
        try:
            run(clear)
            stages = {}
            for name, _t0, dur, _depth, _thread in rec.drain():
                stages[name] = stages.get(name, 0) + dur / reps / 1e6
        finally:
            spans.disable()
        print("verify_device stages, %s (ms, mean of %d): %s" % (
            label, reps, ", ".join(f"{k} {ms:.3f}" for k, ms in stages.items())))

    # 7. (a) the view-change storm, 8. (b) coalesced waves: each its own
    #    main-path run, counted from 0
    t0 = time.perf_counter()
    storm_launches = storm_phase(card)
    print(f"phase (a) took {time.perf_counter() - t0:.1f} s")
    check(storm_launches > 0, "the storm never launched the verify kernel")
    t0 = time.perf_counter()
    wave_launches = coalesced_phase(card)
    print(f"phase (b) took {time.perf_counter() - t0:.1f} s")
    check(wave_launches > 0, "the coalesced waves never launched the verify kernel")

    B = WAVE
    v_bound, s_bound = bounds(B)
    kernels = [
        {
            "name": "dsm_verify_kernel",
            "route": "cuda",
            "source": "hotstuff_tpu_torch/gpu/csrc/dsm_kernels.cu",
            "replaces": "hotstuff_tpu/tpu/pallas_dsm.py:587",
            "launches": main_launches["verify_compressed"] + storm_launches + wave_launches,
            "max_abs_err": errs["verify"],
            "ms": times[B][0],
            "plain_ms": times[B][1],
            "bound_ms": v_bound[0],
            "bound_by": v_bound[1],
            "library_ms": None,
        },
        {
            "name": "dsm_scan_kernel",
            "route": "cuda",
            "source": "hotstuff_tpu_torch/gpu/csrc/dsm_kernels.cu",
            "replaces": "hotstuff_tpu/tpu/pallas_dsm.py:526",
            "launches": scan_launches["dual_scalar_mult"],
            "max_abs_err": errs["scan"],
            "ms": times[B][2],
            "plain_ms": times[B][3],
            "bound_ms": s_bound[0],
            "bound_by": s_bound[1],
            "library_ms": None,
        },
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
