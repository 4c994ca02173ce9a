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
   beside the routing model's ``CPU_US_PER_SIG``, and the native batch
   equation's beside ``cpu_batch_estimate_s``; launch counts set to 0
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
9. (c) a 64-node co-located committee (``bench/committee.py``
   ``run_committee(nodes=64, rate=1000, duration=20, size=512,
   verifier="cuda")``, quorum 43, 5,000 ms timeout delay, no faults):
   64 consensus stacks in one event loop sharing ``make_verifier("cuda")``
   and its wave service, fed 1,000 producer frames a second of 512-byte
   bodies over TCP.  Every node must commit at least 5 non-genesis
   blocks, all 64 chains must agree on their common prefix, the verify
   kernel must launch after boot and the service must route waves to the
   device; everything ``run_committee`` returns is printed (the chains
   as lengths and the common prefix), with the wall times of boot and
   shutdown;
10. (d) the same committee for 60 s with one crash and recovery
   (``run_committee(..., duration=60, restart={"node": 1, "down_at_s":
   5.0, "behind_rounds": 16, "deadline_s": 30.0})``): node 1's stack is
   stopped 5 s into the load, spawned again on its store once the live
   nodes are 16 rounds past its commit cursor, and catches up from a
   peer's certified delta snapshot before it enters the protocol.  The
   restarted node must adopt a snapshot at least 8 rounds past its
   cursor with entries in it, log the advance of its commit cursor and
   commit at least 5 blocks after the restart; every node must commit
   at least 5 blocks; the chains must agree round by round and the state
   roots version by version over all 64 nodes; every ledger read of a
   payload committed during the outage must find it at the restarted
   node where a live node does; and the verify kernel must launch in
   the phase.  The result is printed with the sync's outcome, its times
   and the routes of the manifest certificate checks;
11. (e) the node CLI on the card: 64 key files (one written by
   ``python -m hotstuff_tpu_torch.node keys``, 63 by ``Secret``), a
   committee on OS-assigned ports and default parameters, then
   ``python -m hotstuff_tpu_torch.node -vv run-many --verifier cuda``
   and, as a second process, ``python -m hotstuff_tpu_torch.node.client
   --rate 1000 --size 512 --duration 20 --warmup 2`` (the deployment of
   ``results/bench-0-64-1000-tpu-1proc.txt``).  3 s after the client
   exits the node process gets SIGTERM and must stop within 60 s.  Both
   logs are parsed with this script's own copies of the harness's
   regexes (``benchmark/logs.py``): 64 boots, at least 5 non-genesis
   commits a node, one digest a committed round, one state root a
   version, device waves and device signatures in the last stats line,
   K1 launched (the process logs its launch counts as it stops), no
   traceback.  Boot seconds, committed rounds, consensus and end-to-end
   payloads a second, sample latency, timeouts, routes and the phase's
   wall time are printed;
12. (f) 16 waves of 1024 signed votes over the native transport into one
   ``NativeReceiver``, adopted from the ingest arenas and verified by the
   verify kernel, and (g) the node CLI of (e) on ``--transport native``;
13. (h) the port's verifier bench (``hotstuff_tpu_torch/bench/verifier.py``)
   at the 256-validator shape: a 1024-signature shared-digest stream, QC
   sizes 16/64/256 and the 171-entry TC, every verdict checked; the
   native CPU batch rate (shared and distinct digests), the OpenSSL
   loop's, the verify kernel's CUDA-event ms and device sigs/s, the
   host-clock sigs/s of ``verify_device`` and ``vs_baseline``; then the
   seven adversarial cases of step 3's wave and a signature whose R
   carries a point of small order, through both routes: the verify
   kernel must give the cofactorless oracle's verdict
   (``ed25519_ref.verify``), the native batch equation the cofactored
   one ([8][s]B = [8]R + [8][k]A, checked here in ``ed25519_ref``
   arithmetic);
14. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is the sum
   over the main-path runs (3 and (a)-(h)), each counted from 0.

Phases (c), (e) and (g) print the wave service's routes (device, cpu and
probe waves, ``ewma_ms``, the mean wave and the verify kernel's launches
after boot).  The router weighs a wave against the native batch
equation's cost (``cpu_batch_estimate_s``), as the JAX package's does,
so it may send every non-probe wave to the CPU: where it sent none to
the device, the check is that the verify kernel launched after boot at
least once for every device and probe wave.

Any mismatch raises, so the exit code is not 0 and no result line is
printed.  Without a CUDA device it exits with 2 and prints no result.
"""

from __future__ import annotations

import collections
import faulthandler
import gc
import hashlib
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
WATCHDOG_S = 900

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
    from hotstuff_tpu_torch.crypto.async_service import CPU_US_PER_SIG, cpu_batch_estimate_s, flatten_claims
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
    route = "OpenSSL via cryptography" if HAVE_CRYPTOGRAPHY else "the native library's single verify"
    print(f"CPU route ({route}; CpuVerifier.verify_many, {len(digests)} distinct digests): {us:.1f} us a signature "
          f"measured, routing model CPU_US_PER_SIG = {CPU_US_PER_SIG:.0f} us [{card}]")
    t0 = time.perf_counter()
    ok = cpu.verify_many(digests, pks, sigs, aggregate_ok=True)
    us = (time.perf_counter() - t0) / len(digests) * 1e6
    check(all(ok), "storm: the native batch route accepts the worst-case TC")
    print(f"CPU route (native batch equation; CpuVerifier.verify_many(aggregate_ok=True), {len(digests)} distinct "
          f"digests): {us:.1f} us a signature measured, routing model cpu_batch_estimate_s "
          f"{cpu_batch_estimate_s(len(digests)) / len(digests) * 1e6:.1f} us [{card}]")
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


def committee_phase(card: str, nodes: int = 64, rate: int = 1000, duration: float = 20,
                    torch_device=None) -> int:
    """(c) A co-located committee on the device host; returns the verify
    kernel's launches in it (boot included)."""
    from hotstuff_tpu_torch.bench.committee import run_committee
    from hotstuff_tpu_torch.gpu import dsm
    from hotstuff_tpu_torch.gpu.ed25519 import resolve_device

    dsm.reset_launches()
    t0 = time.perf_counter()
    # the phase gets its own deadline: boot, the load and shutdown take
    # about duration + 15 s
    faulthandler.dump_traceback_later(duration + 120, exit=True)
    try:
        r = run_committee(nodes=nodes, rate=rate, duration=duration, size=512,
                          verifier="cuda", device=torch_device)
    finally:
        faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    wall = time.perf_counter() - t0
    launches = dsm.launches["verify_compressed"]
    chains = r.pop("chains")
    roots = r.pop("state_roots")
    print("committee result: " + json.dumps(r))
    print(f"committee state roots: {sum(map(len, roots))} reports over {nodes} nodes, agree "
          f"{r['roots_agree']}; " + summarize_roots(roots))
    lengths = [len(c) for c in chains]
    prefix = [d.to_bytes().hex()[:8] for d in chains[0][:r["common_prefix"]]]
    if len(prefix) > 16:
        prefix[8:-8] = ["..."]
    print(f"committee chains: {nodes} chains of {min(lengths)}-{max(lengths)} blocks, common prefix "
          f"{r['common_prefix']}, agree {r['chains_agree']}; prefix digests: " + " ".join(prefix))
    print(f"committee phase: {nodes} nodes, {rate} tx/s of 512 B for {duration} s: boot {r['boot_s']:.2f} s, "
          f"shutdown {r['shutdown_s']:.2f} s, {wall:.1f} s in all (host clock); blocks per node "
          f"{min(r['blocks'])}-{max(r['blocks'])}; {r['payloads_per_s']:.0f} payloads/s; latency mean "
          f"{(r['latency_mean_s'] or 0) * 1e3:.0f} ms, p50 {(r['latency_p50_s'] or 0) * 1e3:.0f} ms; "
          f"view-change timeouts {r['timeouts']}; verify kernel launches {launches} "
          f"({r['k1_launches']} after boot); worst loop lag {r['max_loop_lag_s'] * 1e3:.1f} ms; "
          f"{zc_fb(r)} [{card}]")
    check(min(r["blocks"]) >= 5, "committee: every node commits at least 5 non-genesis blocks")
    check(r["chains_agree"], "committee: all chains agree on their common prefix")
    svc = r["service"]
    check(svc is not None, "committee: the device host's wave service ran")
    ewma = float(RE_EWMA.search(svc["stats_line"])[1])
    print(f"committee routes: {routes(svc, ewma, r['k1_launches'])} [{card}]")
    if resolve_device(torch_device).type == "cuda":  # a CPU rehearsal runs the plain versions
        check(r["k1_launches"] > 0, "committee: the verify kernel launched after boot")
        if svc["device"] == 0:
            # the router weighed every non-probe wave against the native
            # batch equation and sent it to the CPU: K1 must still have
            # run every probe
            check(r["k1_launches"] >= svc["device"] + svc["probe"],
                  "committee: a verify-kernel launch after boot for every device and probe wave")
    return launches


RE_EWMA = re.compile(r"ewma_ms=([\d.]+)")


def routes(stats: dict, ewma_ms: float, k1_after_boot) -> str:
    """The wave service's routes, its device EWMA, the mean wave and the
    verify kernel's launches after boot, as one phrase."""
    mean = (stats["device_sigs"] + stats["cpu_sigs"]) / max(stats["dispatches"], 1)
    return (f"device {stats['device']} cpu {stats['cpu']} probe {stats['probe']} of "
            f"{stats['dispatches']} waves, ewma_ms {ewma_ms}, mean wave {mean:.1f} sigs, "
            f"verify kernel launches after boot {k1_after_boot}")


def zc_fb(r) -> str:
    """The wave service's zero-copy and fallback waves from a
    ``run_committee`` result."""
    svc = r["service"] or {}
    return f"zc={svc.get('zero_copy_waves')} fb={svc.get('fallback_waves')}"


def summarize_roots(roots) -> str:
    """``version:root-prefix xnodes`` for each applied version, the
    versions two nodes disagree on marked with ``!``."""
    by_version: dict = collections.defaultdict(collections.Counter)
    for node in roots:
        for version, (root, _) in node.items():
            by_version[version][root] += 1
    parts = []
    for version in sorted(by_version):
        seen = by_version[version]
        mark = "!" if len(seen) > 1 else ""
        parts.append(f"{version}:" + "/".join(f"{r[:8]}x{n}" for r, n in seen.items()) + mark)
    if len(parts) > 16:
        parts[8:-8] = ["..."]
    return " ".join(parts)


def restart_phase(card: str, nodes: int = 64, rate: int = 1000, duration: float = 60,
                  torch_device=None, timeout_delay: int = 5_000, sync_retry_delay: int = 10_000,
                  restart=None) -> int:
    """(d) The committee with one node crashed and recovered through
    state sync; returns the verify kernel's launches in it.  The
    defaults are the deployment's; a CPU rehearsal at 4 nodes shortens
    the timers (README, port section)."""
    from hotstuff_tpu_torch.bench.committee import run_committee
    from hotstuff_tpu_torch.gpu import dsm
    from hotstuff_tpu_torch.gpu.ed25519 import resolve_device

    if restart is None:
        restart = {"node": 1, "down_at_s": 5.0, "behind_rounds": 16, "deadline_s": 30.0}
    dsm.reset_launches()
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(duration + 150, exit=True)
    try:
        r = run_committee(nodes=nodes, rate=rate, duration=duration, size=512, verifier="cuda",
                          device=torch_device, timeout_delay=timeout_delay,
                          sync_retry_delay=sync_retry_delay, restart=restart)
    finally:
        faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    wall = time.perf_counter() - t0
    launches = dsm.launches["verify_compressed"]
    chains = r.pop("chains")
    roots = r.pop("state_roots")
    sync = r["state_sync"]
    k = sync["node"]
    print("restart result: " + json.dumps(r))
    lengths = [len(c) for c in chains]
    print(f"restart chains: {nodes} chains of {min(lengths)}-{max(lengths)} blocks, node {k}'s "
          f"{lengths[k]} with a gap, common prefix {r['common_prefix']}, agree {r['chains_agree']}")
    print(f"restart state roots: {sum(map(len, roots))} reports over {nodes} nodes, agree "
          f"{r['roots_agree']}; node {k} reported {len(roots[k])} versions; " + summarize_roots(roots))
    print(f"restart sync: node {k} down at {sync['down_at_s']:.2f} s, cursor {sync['cursor_at_stop']}, "
          f"restarted at {sync['restart_at_s']:.2f} s {sync['rounds_behind']} rounds behind; "
          f"adopted {sync['adopted']} ({sync['kind']}) version {sync['version']} at round {sync['round']} "
          f"from {sync['offers']} offers: {sync['chunks']} chunks, {sync['entries']} entries, "
          f"{sync['reasks']} re-asks, in {(sync['sync_s'] or 0) * 1e3:.0f} ms; cursor line "
          f"{sync['cursor_advanced']}; first commit {(sync['first_commit_s'] or 0):.2f} s after the "
          f"restart, {sync['blocks_after']} blocks after it; manifest QC checks by route "
          f"{sync['qc_check_routes']}; worst loop lag in the sync "
          f"{sync['max_loop_lag_in_sync_s'] * 1e3:.1f} ms [{card}]")
    print(f"restart phase: {nodes} nodes, {rate} tx/s of 512 B for {duration} s: boot {r['boot_s']:.2f} s, "
          f"shutdown {r['shutdown_s']:.2f} s, {wall:.1f} s in all (host clock); blocks per node "
          f"{min(r['blocks'])}-{max(r['blocks'])}; {r['payloads_per_s']:.0f} payloads/s; latency mean "
          f"{(r['latency_mean_s'] or 0) * 1e3:.0f} ms, p50 {(r['latency_p50_s'] or 0) * 1e3:.0f} ms; "
          f"view-change timeouts {r['timeouts']}; verify kernel launches {launches} "
          f"({r['k1_launches']} after boot); worst loop lag {r['max_loop_lag_s'] * 1e3:.1f} ms at "
          f"{r['max_loop_lag_at_s']:.2f} s; ledger reads {r['ledger_reads']}; {zc_fb(r)} [{card}]")
    check(sync["adopted"] and sync["entries"] > 0, "restart: the node adopted a snapshot with entries")
    check(sync["round"] >= sync["cursor_at_stop"] + 8,
          "restart: the snapshot is at least 8 rounds past the node's commit cursor")
    check(sync["cursor_advanced"] is not None and sync["cursor_advanced"][1] == sync["round"],
          "restart: the node logged its commit cursor's advance to the snapshot round")
    check(sync["blocks_after"] >= 5, "restart: the node committed at least 5 blocks after the restart")
    check(min(r["blocks"]) >= 5, "restart: every node commits at least 5 non-genesis blocks")
    check(r["chains_agree"], "restart: all chains agree round by round")
    check(r["roots_agree"], "restart: all state roots agree version by version")
    reads = r["ledger_reads"]
    check(reads["reads"] > 0 and reads["matched"] == reads["reads"],
          "restart: every ledger read at the restarted node matches a live node's")
    if resolve_device(torch_device).type == "cuda":  # a CPU rehearsal runs the plain versions
        check(launches > 0, "restart: the verify kernel launched in the phase")
    return launches


def _oracle_rows(rows) -> list:
    """The oracle's verdicts on ``(sig, pk, digest)`` rows (a worker of
    the ingest phase's process pool)."""
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref

    return [ref.verify(sig, pk, digest) for sig, pk, digest in rows]


def ingest_phase(card: str, nodes: int = COMMITTEE, waves: int = 16, wave: int = WAVE,
                 torch_device=None) -> int:
    """(f) Vote frames from the wire verified from the staging arenas the
    native reactor packed: one ``NativeReceiver`` feeding a handler that
    submits ``wave``-claim waves to the shared ``AsyncVerifyService``;
    returns the verify kernel's launches in the wire run."""
    import asyncio
    import multiprocessing

    from hotstuff_tpu_torch.bench.committee import reserve_ports
    from hotstuff_tpu_torch.consensus import Vote
    from hotstuff_tpu_torch.consensus.wire import (
        TAG_VOTE, decode_message, encode_producer_batch, encode_vote,
    )
    from hotstuff_tpu_torch.crypto import Digest, Signature, generate_keypair
    from hotstuff_tpu_torch.crypto import async_service as svc_mod
    from hotstuff_tpu_torch.gpu import dsm
    from hotstuff_tpu_torch.gpu.ed25519 import resolve_device
    from hotstuff_tpu_torch.network import native
    from hotstuff_tpu_torch.node import make_verifier
    from hotstuff_tpu_torch.telemetry import spans

    L = 2**252 + 27742317777372353535851937790883648493
    t0 = time.perf_counter()
    members = [generate_keypair(b"\x51" * 32, i) for i in range(nodes)]  # the storm's committee
    # two forged votes a wave at known positions: a flipped signature
    # byte, and S raised by L (S >= L)
    flipped, big_s = 333 % wave, 777 % wave
    frames, claims = [], []
    for w in range(waves):
        fw, cw = [], []
        for i in range(wave):
            pk, sk = members[(w * wave + i) % nodes]
            vote = Vote(hash=Digest.of(b"ingest block %d %d" % (w, i)), round=1_000 + w, author=pk)
            sig = Signature.new(vote.digest(), sk).to_bytes()
            if i == flipped:
                sig = sig[:7] + bytes([sig[7] ^ 0x10]) + sig[8:]
            elif i == big_s:
                sig = sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
            vote.signature = Signature(sig)
            fw.append(encode_vote(vote))
            cw.append(vote.claim())
        frames.append(fw)
        claims.append(cw)
    t_sign = time.perf_counter() - t0
    rows = [(c[3], c[2], c[1]) for cw in claims for c in cw]
    procs = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        chunks = pool.map(_oracle_rows, [rows[k : k + 256] for k in range(0, len(rows), 256)])
    oracle = [ok for chunk in chunks for ok in chunk]
    want = [oracle[w * wave : (w + 1) * wave] for w in range(waves)]
    check(all(not want[w][flipped] and not want[w][big_s] for w in range(waves))
          and sum(oracle) == waves * (wave - 2), "ingest: the oracle rejects exactly the forged votes")
    print(f"ingest fixture: {waves} waves of {wave} signed votes from {nodes} validators signed in "
          f"{t_sign:.1f} s, oracle over {len(rows)} signatures in {time.perf_counter() - t0 - t_sign:.1f} s "
          f"on {procs} processes (host)")

    host = make_verifier("cuda", device=torch_device)
    host.precompute([pk.to_bytes() for pk, _ in members])
    host.warmup(wave)
    # every adopted wave must reach the device view's verify_packed at
    # its bucket: record the rows of each call
    dispatch = host.async_backend
    packed_rows: list = []
    to_device = dispatch.verify_packed

    def recording(dig, pk, sig, rows):
        packed_rows.append(rows)
        return to_device(dig, pk, sig, rows)

    dispatch.verify_packed = recording

    class Handler:
        """Decodes vote frames; every ``wave`` claims go to the service
        as one wave.  The producer-v2 ping only proves the connection."""

        def __init__(self, service):
            self.service = service
            self.claims: list = []
            self.waves: list = []
            self.warmed = asyncio.Event()

        async def dispatch(self, writer, message: bytes) -> None:
            tag, payload = decode_message(message, scheme="ed25519")
            if tag != TAG_VOTE:
                self.warmed.set()
                return
            self.claims.append(payload.claim())
            if len(self.claims) == wave:
                batch, self.claims = self.claims, []
                self.waves.append(asyncio.ensure_future(self.service.verify_claims(batch)))

    async def until(cond, what: str, limit_s: float = 30.0) -> None:
        # a real sleep: a sleep(0) spin would keep the GIL from the slot threads
        t_end = time.perf_counter() + limit_s
        while not cond():
            check(time.perf_counter() < t_end, f"ingest: timed out waiting for {what}")
            await asyncio.sleep(0.0005)

    async def run():
        os.environ.pop("HOTSTUFF_ZERO_COPY", None)
        svc_mod._zero_copy = None  # a fresh plane: earlier phases' receivers noted votes
        service = svc_mod.AsyncVerifyService.for_backend(host)
        service.warm_buckets()
        handler = Handler(service)
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        sock.close()
        recv = native.NativeReceiver("127.0.0.1", port, handler)
        sender = native.NativeSimpleSender()
        addr = ("127.0.0.1", port)
        try:
            await recv.spawn()
            plane = svc_mod.zero_copy_ingest_if_active()
            check(plane is not None, "ingest: the receiver created the ingest plane")
            # the native sender drops frames while it connects, and a lost
            # vote would desync the packed and claim streams: ping with a
            # frame the packer ignores until one arrives
            ping = encode_producer_batch([(Digest.of(b"ingest ping"), b"")])
            for _ in range(100):
                await sender.send(addr, ping)
                try:
                    await asyncio.wait_for(handler.warmed.wait(), 0.1)
                    break
                except asyncio.TimeoutError:
                    continue
            check(handler.warmed.is_set(), "ingest: the native sender connected")
            tx0 = native.Reactor.shared().counters()["tx_frames"]
            start = service.dispatches
            dsm.reset_launches()
            rec = spans.enable()
            try:
                t_wire = time.perf_counter()
                for w in range(waves):
                    for k in range(0, wave, 128):  # under the reactor's 1000-frame outbox
                        for frame in frames[w][k : k + 128]:
                            await sender.send(addr, frame)
                        await asyncio.sleep(0)
                    sent = native.Reactor.shared().counters()["tx_frames"] - tx0
                    # at most two waves outstanding: the dispatcher took
                    # this one, and the one before it landed
                    await until(lambda: service.dispatches > start + w,
                                f"wave {w} to reach the dispatcher ({sent} of "
                                f"{(w + 1) * wave} frames handed to the reactor)")
                    if w:
                        await asyncio.wait_for(asyncio.shield(handler.waves[w - 1]), 30.0)
                got = await asyncio.wait_for(asyncio.gather(*handler.waves), 30.0)
                wire_s = time.perf_counter() - t_wire
                launches = dsm.launches["verify_compressed"]
                stages: dict = {}
                for name, _t, dur, _depth, _thread in rec.drain():
                    stages.setdefault(name, []).append(dur / 1e6)
            finally:
                spans.disable()
            for w in range(waves):
                check(got[w] == want[w], f"ingest wave {w}: every verdict equals the oracle's")
            hit = service.zero_copy_sigs / (waves * wave)
            print(service.stats_line())
            print(f"ingest plane counters: {plane.counters()}; packed votes {plane.packed_votes}")
            print(f"ingest phase: {waves} waves x {wave} votes over the native transport, wire to verdict "
                  f"{wire_s * 1e3:.1f} ms, {waves * wave / wire_s:.0f} sigs/s; adopted {service.zero_copy_waves} "
                  f"waves ({service.zero_copy_sigs} sigs, hit rate {hit:.3f}), fell back {service.fallback_waves}; "
                  f"routes device {service.device_dispatches} cpu {service.cpu_dispatches} probe "
                  f"{service.probe_dispatches}, deadline misses {service.deadline_misses}; verify_packed rows "
                  f"{sorted(set(packed_rows))} x{len(packed_rows)}; verify kernel launches {launches} [{card}]")
            print("ingest phase span stages (mean ms x count): " + ", ".join(
                f"{k} {sum(v) / len(v):.3f} x{len(v)}" for k, v in stages.items()
                if k != "pipeline.occupancy"))
            check(hit >= 0.90, "ingest: at least 90% of the signatures verified from the arenas")
            check(service.dispatches - start == waves and service.device_dispatches == waves
                  and service.cpu_dispatches == 0 and service.probe_dispatches == 0,
                  "ingest: every wave took the device route")
            check(len(packed_rows) == service.zero_copy_waves and set(packed_rows) == {wave},
                  f"ingest: every adopted wave staged from its arena at the {wave} bucket")
            if resolve_device(torch_device).type == "cuda":  # a CPU rehearsal runs the plain versions
                check(launches >= service.device_dispatches,
                      "ingest: a verify-kernel launch for every device wave")
            return launches, service
        finally:
            sender.close()
            await recv.shutdown()
            t_end = time.perf_counter() + 10.0
            while service._inflight and time.perf_counter() < t_end:
                await asyncio.sleep(0.001)
            service.close()

    try:
        launches, _ = asyncio.run(run())
    finally:
        dispatch.verify_packed = to_device

    # the same waves through the arena and through the flatten path, off
    # the wire and off the service, as bench.py's bench_ingest does
    target = host.async_backend
    ing = svc_mod.ZeroCopyIngest(capacity=wave, ring_depth=3)
    try:
        t_zc = time.perf_counter()
        got_zc = []
        for w in range(waves):
            for frame in frames[w]:
                ing.note_vote_frame(frame)
            adopted = ing.try_adopt(claims[w], (wave,))
            check(adopted is not None, "ingest: the arena adopted the wave off the wire")
            got_zc.append(svc_mod.eval_claims_arena(target, adopted, claims[w]))
        zc_s = time.perf_counter() - t_zc
    finally:
        ing.packer.close()
    t_flat = time.perf_counter()
    got_flat = [svc_mod.eval_claims_sync(target, claims[w]) for w in range(waves)]
    flat_s = time.perf_counter() - t_flat
    check(got_zc == want and got_flat == want, "ingest: arena and flatten verdicts equal the oracle's")
    sigs = waves * wave
    print(f"ingest off the wire: {waves} waves of {wave}, pack + adopt + verify_packed {zc_s * 1e3:.1f} ms "
          f"({sigs / zc_s:.0f} sigs/s) against flatten + verify_device {flat_s * 1e3:.1f} ms "
          f"({sigs / flat_s:.0f} sigs/s), ratio {flat_s / zc_s:.2f} [{card}]")
    return launches


# the harness's log contract (benchmark/logs.py), held here as copies:
# the script imports nothing of the JAX package or its harness
_TS = r"(\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{3})Z"
RE_BOOTED = re.compile(_TS + r".*Node (\S+) successfully booted")
RE_CREATED = re.compile(_TS + r".*Created block (\d+) \(payloads (\S*)\) -> (\S+)")
RE_COMMITTED = re.compile(_TS + r".*Committed block (\d+) -> (\S+)")
RE_STATE_ROOT = re.compile(r"\] (\S+) State root (\d+) -> (\S+) \(round (\d+)\)")
RE_TIMEOUT = re.compile(r"Timeout reached for round (\d+)")
RE_VERIFY_STATS = re.compile(
    r"Verify service stats \[(\S+)\]: dispatches=(\d+) device=(\d+) "
    r"(?:cpu=(\d+) probe=(\d+) )?"
    r"device_sigs=(\d+) cpu_sigs=(\d+) deadline_misses=(\d+) "
    r"(?:waits=(\d+) depth=(\d+) )?"
    r"(?:mesh=(\d+) )?"
    r"(?:agg=(\d+) agg_sigs=(\d+) )?"
    r"ewma_ms=([\d.]+)"
    r"(?: zc=(\d+) fb=(\d+))?"
)
RE_LAUNCHES = re.compile(r"Kernel launches: (.*)")
RE_BOOT_LAUNCHES = re.compile(r"Kernel launches at boot: (.*)")
RE_CLIENT_RATE = re.compile(_TS + r".*Transactions rate: (\d+) tx/s")
RE_SAMPLE = re.compile(_TS + r".*Sending sample payload (\S+)")


def _ts(stamp: str) -> float:
    import datetime

    return datetime.datetime.strptime(stamp, "%Y-%m-%dT%H:%M:%S.%f").timestamp()


def parse_node_logs(node_log: str, client_log: str) -> dict:
    """What ``benchmark/logs.py`` ``LogParser`` reads from a run's logs,
    by the same definitions: commits and proposals merged over all nodes
    at their earliest observation, consensus payloads a second (unique
    committed payloads over first proposal to last commit), end-to-end
    payloads a second (over client start to last commit), and the
    latency of each committed sample payload (client send to the commit
    of its block)."""
    proposals, block_payloads, payload_block = {}, {}, {}
    for ts, _rnd, payloads, block in RE_CREATED.findall(node_log):
        t = _ts(ts)
        proposals[block] = min(t, proposals.get(block, t))
        block_payloads[block] = tuple(p for p in payloads.split(",") if p)
        for p in block_payloads[block]:
            payload_block[p] = block
    commits, by_round, n_commits = {}, collections.defaultdict(set), 0
    for ts, rnd, block in RE_COMMITTED.findall(node_log):
        if int(rnd) == 0:
            continue
        n_commits += 1
        t = _ts(ts)
        commits[block] = min(t, commits.get(block, t))
        by_round[int(rnd)].add(block)
    roots = collections.defaultdict(set)
    for _node, version, root, _rnd in RE_STATE_ROOT.findall(node_log):
        roots[int(version)].add(root)
    commits = {b: t for b, t in commits.items() if b in proposals}
    unique = {p for b in commits for p in block_payloads.get(b, ())}
    out = {
        "booted": len(RE_BOOTED.findall(node_log)),
        "boot_at": max((_ts(ts) for ts, _ in RE_BOOTED.findall(node_log)), default=None),
        "commit_lines": n_commits,
        "committed_rounds": len(by_round),
        "rounds_agree": all(len(ds) == 1 for ds in by_round.values()),
        "versions": len(roots),
        "roots_agree": all(len(rs) == 1 for rs in roots.values()),
        "timeouts": len(RE_TIMEOUT.findall(node_log)),
        "committed_payloads": len(unique),
        "consensus_payloads_per_s": 0.0,
        "e2e_payloads_per_s": 0.0,
        "latency_mean_s": None,
        "latency_p50_s": None,
        "stats": None,
        "launches": None,
        "boot_launches": None,
    }
    if commits:
        end = max(commits.values())
        out["consensus_payloads_per_s"] = len(unique) / max(end - min(proposals.values()), 1e-9)
        m = RE_CLIENT_RATE.search(client_log)
        if m:
            out["e2e_payloads_per_s"] = len(unique) / max(end - _ts(m[1]), 1e-9)
    lat = sorted(
        commits[payload_block[p]] - _ts(ts)
        for ts, p in RE_SAMPLE.findall(client_log)
        if payload_block.get(p) in commits
    )
    if lat:
        out["latency_mean_s"] = sum(lat) / len(lat)
        out["latency_p50_s"] = lat[(len(lat) - 1) // 2]
    stats = RE_VERIFY_STATS.findall(node_log)
    if stats:
        last = stats[-1]
        out["stats"] = {
            "dispatches": int(last[1]), "device": int(last[2]), "cpu": int(last[3] or 0),
            "probe": int(last[4] or 0), "device_sigs": int(last[5]), "cpu_sigs": int(last[6]),
            "deadline_misses": int(last[7]), "ewma_ms": float(last[13]),
            "zc": int(last[14] or 0), "fb": int(last[15] or 0),
        }
    for key, regex in (("launches", RE_LAUNCHES), ("boot_launches", RE_BOOT_LAUNCHES)):
        m = regex.findall(node_log)
        if m:
            out[key] = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m[-1])}
    return out


def cofactored_verify(sig: bytes, pub: bytes, msg: bytes) -> bool:
    """The native batch equation's acceptance of one signature, in
    ``ed25519_ref`` arithmetic: [8][s]B = [8]R + [8][k]A, with the
    library's decoding rules (canonical y, no -0, canonical s)."""
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref

    if len(sig) != 64 or len(pub) != 32:
        return False
    A, R = ref.point_decompress(pub), ref.point_decompress(sig[:32])
    s = int.from_bytes(sig[32:], "little")
    if A is None or R is None or s >= ref.L:
        return False
    k = ref.verify_challenge(sig, pub, msg)
    lhs = ref.point_mul(8, ref.base_mul(s))
    rhs = ref.point_mul(8, ref.point_add(R, ref.point_mul(k, A)))
    return ref.point_equal(lhs, rhs)


def small_order_case(seed: bytes, msg: bytes):
    """(msg, pk, sig) of a signature whose R carries a point of small
    order T: R' = [r]B + T and s = r + k'a with k' = H(R'||A||M).  The
    cofactored check accepts it ([8]T is the identity); the cofactorless
    one rejects it ([s]B - [k']A = R' - T)."""
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref

    y = 2
    while (q := ref.point_decompress(y.to_bytes(32, "little"))) is None or ref.point_equal(
            small := ref.point_mul(ref.L, q), ref.IDENTITY):
        y += 1
    a, prefix = ref.secret_expand(seed)
    pk = ref.public_from_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % ref.L
    r_enc = ref.point_compress(ref.point_add(ref.base_mul(r), small))
    k = ref.verify_challenge(r_enc + bytes(32), pk, msg)
    return msg, pk, r_enc + ((r + k * a) % ref.L).to_bytes(32, "little")


def verifier_phase(card: str, claims, torch_device=None, batch: int = WAVE, rounds: int = 16,
                   reps: int = 20, qc_sizes=(16, 64, 256), tc: int = QUORUM) -> int:
    """(h) The port's verifier bench, then the adversarial cases through
    the verify kernel and the native batch equation; returns the verify
    kernel's launches in the phase."""
    from hotstuff_tpu_torch.bench import verifier as bench
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref
    from hotstuff_tpu_torch.crypto import native_ed25519
    from hotstuff_tpu_torch.gpu import dsm
    from hotstuff_tpu_torch.gpu.ed25519 import BatchVerifier

    dsm.reset_launches()
    t0 = time.perf_counter()
    r = bench.run(device=torch_device or "cuda", batch=batch, rounds=rounds, reps=reps,
                  qc_sizes=qc_sizes, tc=tc)
    wall = time.perf_counter() - t0
    print("verifier bench result: " + json.dumps(r))
    base, dev, host = r["baseline"], r["device_throughput"], r["verify_device"]
    print(f"verifier bench: {batch}-signature shared-digest batch; native CPU batch {base.get('batch_sigs_per_s')} "
          f"sigs/s (distinct digests {base.get('batch_distinct_sigs_per_s')}), {base['loop_backend']} loop "
          f"{base['loop_sigs_per_s']} sigs/s; verify kernel {dev['device_ms']} ms CUDA events, "
          f"{dev['device_sigs_per_s']} device sigs/s ({dev['vs_baseline']}x the baseline); launch stream "
          f"{r['value']} sigs/s, vs_baseline {r['vs_baseline']}; verify_device {host['ms']} ms host clock, "
          f"{host['sigs_per_s']} sigs/s ({host['vs_baseline']}x); TC of {r['tc_verify_ms']['quorum']}: p50 "
          f"{r['tc_verify_ms']['rig_p50_ms']} ms, kernel {r['tc_verify_ms']['device_ms']} ms; "
          f"{wall:.1f} s in all; card {r['device']['name']}, {r['device']['power_limit']} [{card}]")
    check(r["baseline"]["backend"].startswith("native-batch"), "bench: the baseline is the native batch")
    check(r["device"]["platform"] == ("gpu" if torch_device in (None, "cuda") else "cpu"),
          "bench: the result names where it ran")

    # the seven adversarial cases of step 3's wave (cases 1-7 of every
    # 16) and a small-order R, each through both routes
    msgs, wpks, sigs, expect_wave = claims["wave"]
    cases = [(msgs[i], wpks[i], sigs[i]) for i in range(1, 8)]
    cases.append(small_order_case(b"\x77" * 32, hashlib.sha512(b"chip smoke small-order R").digest()[:32]))
    names = ["bad R", "flipped s", "wrong message", "wrong key", "s + L", "undecodable key",
             "non-canonical R", "small-order R"]
    valid = (msgs[0], wpks[0], sigs[0])
    check(expect_wave[0], "the filler signature is valid")
    cofactorless = [ref.verify(s, p, m) for m, p, s in cases]
    cofactored = [cofactored_verify(s, p, m) for m, p, s in cases]
    check(cofactorless == expect_wave[1:8] + [False], "the oracle's verdicts on the cases")
    v = BatchVerifier(min_device_batch=0, device=torch_device)
    k1 = v.verify_device(*(list(col) for col in zip(*cases))).tolist()
    native = [native_ed25519.batch_verify(m + valid[0], 32, p + valid[1], s + valid[2], 2, shared=False)
              for m, p, s in cases]
    for name, got_k1, want_k1, got_cpu, want_cpu in zip(names, k1, cofactorless, native, cofactored):
        print(f"adversarial case {name}: verify kernel {got_k1} (cofactorless oracle {want_k1}), "
              f"native batch equation {got_cpu} (cofactored oracle {want_cpu})")
    check(k1 == cofactorless, "the verify kernel gives the cofactorless verdict on every case")
    check(native == cofactored, "the native batch equation gives the cofactored verdict on every case")
    check(cofactored[-1] and not cofactorless[-1], "the small-order R splits the two semantics")
    launches = dsm.launches["verify_compressed"]
    print(f"verifier phase: verify kernel launches {launches} [{card}]")
    return launches


def node_phase(card: str, nodes: int = 64, rate: int = 1000, duration: float = 20,
               verifier: str = "cuda", transport: str = "asyncio"):
    """(e), and (g) with ``transport="native"``: the node CLI, a
    ``run-many`` committee process and the producer client process, both
    started from the command line; returns the verify kernel's launches
    in the node process (boot included) and what the logs say.
    ``verifier="cpu"`` rehearses the phase without a card: no wave
    service, so the stats and launch checks are skipped."""
    import signal
    import tempfile

    from hotstuff_tpu_torch.bench.committee import reserve_ports
    from hotstuff_tpu_torch.consensus import Committee, Parameters
    from hotstuff_tpu_torch.node.config import Secret, write_committee, write_parameters

    t0 = time.perf_counter()
    phase = "node phase" if transport == "asyncio" else f"node phase ({transport})"
    logs = os.path.join(ROOT, "chiprun_out", "node_phase" if transport == "asyncio" else f"node_phase_{transport}")
    os.makedirs(logs, exist_ok=True)
    node_log_path = os.path.join(logs, "nodes.log")
    client_log_path = os.path.join(logs, "client.log")
    env = {**os.environ, "PYTHONPATH": ROOT}
    cli = [sys.executable, "-m", "hotstuff_tpu_torch.node"]
    procs = []
    with tempfile.TemporaryDirectory(prefix="node-phase-") as tmp:
        key_files = [os.path.join(tmp, f"key_{i}.json") for i in range(nodes)]
        subprocess.run(cli + ["keys", "--filename", key_files[0]], env=env, check=True, timeout=120)
        for path in key_files[1:]:
            Secret.new().write(path)
        names = [Secret.read(path).name for path in key_files]
        socks = reserve_ports(nodes)
        committee = Committee.new([(pk, 1, ("127.0.0.1", s.getsockname()[1]))
                                   for pk, s in zip(names, socks)])
        committee_file = os.path.join(tmp, "committee.json")
        parameters_file = os.path.join(tmp, "parameters.json")
        write_committee(committee, committee_file)
        write_parameters(Parameters(), parameters_file)
        check(Parameters().timeout_delay == 5_000, f"{phase}: default 5,000 ms timeout delay")
        for s in socks:  # free the reserved ports for the nodes' receivers
            s.close()
        stopped_in_time = False
        try:
            with open(node_log_path, "w") as node_log, open(client_log_path, "w") as client_log:
                t_launch = time.time()
                procs.append(subprocess.Popen(
                    cli + ["-vv", "run-many", "--transport", transport, "--verifier", verifier,
                           "--keys", ",".join(key_files),
                           "--committee", committee_file, "--store-prefix", os.path.join(tmp, "db_"),
                           "--parameters", parameters_file],
                    stdout=node_log, stderr=subprocess.STDOUT, env=env))
                node = procs[0]
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "hotstuff_tpu_torch.node.client", "--committee", committee_file,
                     "--rate", str(rate), "--size", "512", "--duration", str(duration), "--warmup", "2"],
                    stdout=client_log, stderr=subprocess.STDOUT, env=env))
                client = procs[1]
                # the client waits up to 3 s a node for the ports, then sends
                client.wait(timeout=3.0 * nodes + duration + 120)
                check(client.returncode == 0, f"{phase}: the client exited with {client.returncode}")
                check(node.poll() is None, f"{phase}: the node process is still running after the load")
                time.sleep(3.0)
                t_stop = time.perf_counter()
                node.send_signal(signal.SIGTERM)
                try:
                    node.wait(timeout=60)
                    stopped_in_time = True
                except subprocess.TimeoutExpired:
                    pass
                stop_s = time.perf_counter() - t_stop
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    wall = time.perf_counter() - t0
    with open(node_log_path) as f:
        node_text = f.read()
    with open(client_log_path) as f:
        client_text = f.read()
    r = parse_node_logs(node_text, client_text)
    boot_s = r["boot_at"] - t_launch if r["boot_at"] is not None else None
    stats = r["stats"] or {}
    launches = (r["launches"] or {}).get("verify_compressed", 0)
    after_boot = launches - (r["boot_launches"] or {}).get("verify_compressed", 0)
    print(f"{phase}: {nodes} nodes (run-many, --verifier {verifier}), {rate} tx/s of 512 B for {duration} s "
          f"from the client process: boot {boot_s if boot_s is None else round(boot_s, 2)} s, "
          f"{r['committed_rounds']} committed rounds ({r['commit_lines']} commit lines), "
          f"{r['consensus_payloads_per_s']:.1f} consensus payloads/s, {r['e2e_payloads_per_s']:.1f} "
          f"end-to-end payloads/s, sample latency mean {(r['latency_mean_s'] or 0) * 1e3:.0f} ms p50 "
          f"{(r['latency_p50_s'] or 0) * 1e3:.0f} ms, timeouts {r['timeouts']}, routes "
          f"device {stats.get('device')} cpu {stats.get('cpu')} probe {stats.get('probe')} "
          f"(device_sigs {stats.get('device_sigs')}, cpu_sigs {stats.get('cpu_sigs')}), ewma_ms "
          f"{stats.get('ewma_ms')}, zc {stats.get('zc')} fb {stats.get('fb')}, verify kernel launches {launches}, {r['versions']} state versions; "
          f"stopped in {stop_s:.1f} s; {wall:.1f} s in all (host clock) [{card}]")
    print(f"{phase} result: " + json.dumps({**r, "boot_s": boot_s, "stop_s": stop_s, "wall_s": wall}))
    check(stopped_in_time, f"{phase}: the node process stopped within 60 s of SIGTERM")
    check("Traceback" not in node_text and "Traceback" not in client_text,
          f"{phase}: no traceback in the node or client log")
    check(r["booted"] == nodes, f"{phase}: {nodes} 'successfully booted' lines")
    check(r["commit_lines"] >= nodes * 5, f"{phase}: at least 5 committed blocks a node")
    check(r["rounds_agree"], f"{phase}: every committed round names one digest")
    check(r["versions"] > 0 and r["roots_agree"], f"{phase}: every version has one state root")
    if verifier == "cuda":
        check(r["stats"] is not None and r["boot_launches"] is not None,
              f"{phase}: the node process logged its stats line and its launches at boot")
        print(f"{phase} routes: {routes(stats, stats['ewma_ms'], after_boot)} [{card}]")
        if stats["device"] == 0:
            # the router weighed every non-probe wave against the native
            # batch equation and sent it to the CPU: K1 must still have
            # run after boot, once for every probe
            check(after_boot > 0, f"{phase}: the verify kernel launched after boot")
        else:
            check(stats["device_sigs"] > 0,
                  f"{phase}: the last stats line shows device waves and device signatures")
        # one device wave of up to 1024 signatures is one verify_device
        # call, which launches K1 once; the boot's warmup launches too
        check(launches >= stats["device"] + stats["probe"],
              f"{phase}: a verify-kernel launch for every device and probe wave")
    r.update(boot_s=boot_s, stop_s=stop_s, wall_s=wall, launches=launches, launches_after_boot=after_boot)
    return launches, r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # a hang anywhere dumps every thread's stack and exits non-zero well
    # inside the run's 1200 s limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
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

    # 7. (a) the view-change storm, 8. (b) coalesced waves, 9. (c) the
    #    committee: each its own main-path run, counted from 0
    t0 = time.perf_counter()
    storm_launches = storm_phase(card)
    print(f"phase (a) took {time.perf_counter() - t0:.1f} s")
    check(storm_launches > 0, "the storm never launched the verify kernel")
    t0 = time.perf_counter()
    wave_launches = coalesced_phase(card)
    print(f"phase (b) took {time.perf_counter() - t0:.1f} s")
    check(wave_launches > 0, "the coalesced waves never launched the verify kernel")
    t0 = time.perf_counter()
    committee_launches = committee_phase(card)
    print(f"phase (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    restart_launches = restart_phase(card)
    print(f"phase (d) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    node_launches, node_r = node_phase(card)
    print(f"phase (e) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ingest_launches = ingest_phase(card)
    print(f"phase (f) took {time.perf_counter() - t0:.1f} s")
    check(ingest_launches > 0, "the ingest phase never launched the verify kernel")
    t0 = time.perf_counter()
    native_launches, native_r = node_phase(card, transport="native")
    print(f"phase (g) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bench_launches = verifier_phase(card, claims)
    print(f"phase (h) took {time.perf_counter() - t0:.1f} s")
    check(bench_launches > 0, "the verifier bench never launched the verify kernel")
    keys = ("boot_s", "committed_rounds", "consensus_payloads_per_s", "latency_mean_s", "latency_p50_s",
            "timeouts", "launches", "stop_s")
    for label, r in (("(e) asyncio", node_r), ("(g) native", native_r)):
        print(f"node CLI {label}: " + ", ".join(f"{k} {r[k]}" for k in keys) + f", stats {r['stats']} [{card}]")

    B = WAVE
    v_bound, s_bound = bounds(B)
    kernels = [
        {
            "name": "dsm_verify_kernel",
            "route": "cuda",
            "source": "hotstuff_tpu_torch/gpu/csrc/dsm_kernels.cu",
            "replaces": "hotstuff_tpu/tpu/pallas_dsm.py:587",
            "launches": (main_launches["verify_compressed"] + storm_launches + wave_launches
                         + committee_launches + restart_launches + node_launches
                         + ingest_launches + native_launches + bench_launches),
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
