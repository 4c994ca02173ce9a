#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``hotstuff_tpu_torch`` at the repo's deployment size — a
256-validator committee, QCs of 2f+1 = 171 votes, coalesced waves padded
to 1024 — through the verifier backend a node calls, and checks every
verdict against the arbitrary-precision oracle (``ed25519_ref.verify``):

1. prints the card's name and power limit, builds the CUDA kernels (and,
   beside them, the port's g++ libraries, so that no node builds one on
   its event loop at first use) and prints each kernel's registers,
   stack frame and shared memory, and each device function's size and
   commonest opcodes in SASS;
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
   and, once every node logged its boot, as a second process,
   ``python -m hotstuff_tpu_torch.node.client
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
   arithmetic); and the bench's ``bench_verify_split``: 8 QC-256 claims
   through the wave service's host route and its device route, the split
   read from the telemetry registry, every device-route signature on the
   card;
14. (i) the node CLI of (e) with the telemetry plane on (``--metrics-port
   0 --journal-dir <dir> --profile`` and ``HOTSTUFF_WORK_STATS=1``):
   ``/metrics``, ``/snapshot``, ``/trace`` and ``/delta`` scraped at 8 s
   and 16 s of the load and once after it — OpenMetrics with every family
   typed, 64 node labels, no counter falling between scrapes, the route
   counts at most the final stats line's, device wall seconds wherever
   device or probe waves ran, 64 snapshot documents each a superset of
   the ``Work stats:`` one, a ``/delta`` frame decoding against the one
   before; in the final scrape every node's ``flows`` section on with
   tx and rx bytes, its classes covering every byte, its ``propose``
   amplification at most 63 and exactly 63 on some leader, the three
   ``net_*_bytes`` gauges of 64 nodes, and no node-to-node class
   received more than was sent (``flow_checks``); after the SIGTERM stop
   every node's journal, its commit records the rounds of its
   ``Committed`` lines, and every node's ``Telemetry snapshot:`` and
   ``Work stats:`` lines.  It prints the wire bytes a committed block by
   class, the proposals' trips (leader to node, from the journals), the
   committee's trace edges, the split of the loop's time (the wave
   service's host and device wall, the nodes' inline verify wall, the
   loop lag), the scrapes' sizes and times, and (i)'s rounds beside
   (e)'s (logs in ``chiprun_out/telemetry_phase/``);
15. (j) the health plane on the node CLI (``health_phase``): (j1) the
   committee of (e) started with ``--health --metrics-port 0
   --journal-dir <dir>`` and the client, ``/snapshot`` and ``/delta``
   scraped at 8 s and 16 s of the load: 64 ``Health monitor running``
   lines, a ``health`` section in every snapshot document, a dominant
   stage and a critical-path regime on every node past its fourth
   commit, no ``leader_stall``, the port's ``straggler`` and
   ``root_divergence`` detectors quiet over the decoded ``/delta``
   states, every ``Health incident:`` line JSON with its opens and
   closes in order and equal to the node's ``health.*`` journal
   records, 64 campaign rings persisted at the SIGTERM stop with >= 10
   samples, and the verify kernel launched after boot; (j2) the same
   committee file with 42 of the 64 key files (quorum 43) and no client
   for 25 s after the last boot: every node opens ``leader_stall`` with
   a value >= 15 s, journals it and ends its campaign ring with the
   incident open.  It prints every incident opened in (j1), the count
   of nodes in each regime, the time from each (j2) monitor's start to
   its first incident, and (j1)'s rounds beside (i)'s (logs in
   ``chiprun_out/health_phase/``);
16. (m) the WAN committee (``wan_phase``): (e)'s committee with
   ``HOTSTUFF_WAN_SPEC`` naming a spec written by the port's
   ``network/wan.build_spec`` over its 64 addresses (the reference's five
   regions, 12 or 13 members each) and ``--metrics-port 0``, scraped
   once after the load: every node logs its region, commits at least 5
   blocks, the chains agree, K1 launches after boot, the mean commit
   latency is at or above the spec's floor (two one-way hops to the
   43rd-nearest member from the best leader region, less 3 sd of
   jitter), no proposal reaches a node of another region sooner than
   0.6 of the spec's one-way delay (the journals' ``propose`` and
   ``recv.propose`` records), and the flows show node-to-node bytes in
   each class of a round that (i) shows; prints rounds, latency,
   timeouts (by leader region), payloads/s and bytes a block beside
   (e)'s, and each region pair's proposal trips (logs in
   ``chiprun_out/wan_phase/``);
17. (n) the chaos plane (``faults/plane.py``) on the node CLI, each a
   spec of the port's ``faults.scenarios`` over the committee file's 64
   addresses, its window opening 15 s after the boot (e) (or (g))
   measured: (n1) ``split_brain_phase``: (e) with ``--fault-plane <spec>
   --metrics-port 0 --journal-dir <dir>``, the members cut 32 against 32
   (quorum 43) for 10 s: every node logs ``Fault plane active`` with its
   index, some round commits before the window, no new round from its
   open + 5 s to the heal, a new round within the scenario's 20 s of the
   heal, one digest a committed round, every node's ``fault_plane``
   section with drops and no inbound drop, ``fault.open`` /
   ``fault.close`` journaled by every node at the spec's times within the
   loop's worst lag, K1 after boot; prints the window against the first
   commit, the rounds and the loop's lag before and inside it and the
   time to resume (logs in ``chiprun_out/split-brain_phase/``); (n2)
   ``flapping_phase``: (g) with the flapping link between two members
   whose turns to lead fall in the window (down 1.5 s of every 3 for
   12 s): rounds commit through it, one digest a round, the pair
   consults the plane on its link both ways and nobody else drops a
   frame (logs in ``chiprun_out/flapping_phase/``);
18. (o) the adversary plane (``faults/adversary.py``): first a direct
   check of the honest side's kernels (``adversary_kernel_check``): the
   forged QCs that ``AdversaryPlane.forged_qc`` builds for a 64-member
   committee (43 real authors, garbage signatures), three in one
   ``verify_many`` on ``make_verifier("cuda")`` (the device route) and
   each through ``QC.verify``, all rejected, K1's lanes on the same
   claims equal to the plain version's and the oracle's, all false; the
   forged compact QC on a 64-member BLS committee rejected, and its
   signers' real votes on another block replayed for the forged digest,
   rejected after B4 summed them on the card (the sum the host's).
   Then ``adversary_phase``: (e) with ``--adversary <spec>``, the
   reference scenarios' rules over four attackers (equivocate on the
   leader of round 3, forge-qc, double-vote and withhold on the next
   three leaders), equivocate, forge-qc and double-vote open from the
   scenarios' t = 2 s, withhold's window opening 8 s after the boot (e)
   measured and closing 6 s later: the four planes armed, every
   attacker logs its policy firing, the 60 honest nodes hold one digest
   a round and one root a version and committed no shadow digest,
   rounds commit before the withhold window, inside it and after it, a
   new one within the withhold scenario's 25 s of its close, K1 after
   boot (logs in ``chiprun_out/adversary_phase/``);
19. (k) BLS at BASELINE config 5's size (``bls_phase``): (k1) the three
   G1 kernels (``gpu/csrc/g1_kernels.cu``) against their plain versions
   on the card and against the oracle (``crypto/bls/curve.py``), X, Y and
   Z as integers mod q, tolerance zero: the tree sum at B = 256 (171
   points), 512 (171, the aggregator's pad) and 1024, the running sum over
   a 512-vote chain (the first 64 votes beside the plain version), then
   ``G1RunningSum.snapshot()`` after back-to-back bursts of 43 and 171
   votes (host clock, each sum against the oracle), the
   ladder at B = 171 with 128-bit scalars and at the storm offload's
   shape (1024 lanes, 256 bits, every lane), and on the storm offload's
   own scalars (w h_eff, w, the group order; every lane against the
   oracle), the tree sum on that ladder's Montgomery rows at B = 256 as
   the storm sums them; 20 back-to-back launches of each equal;
   CUDA-event times (each kernel's beside the earlier one-thread
   kernel's; the running sum's with the host out of the window, beside
   an empty launch's timed the same way), plain times, the host route's
   times, the bounds (the additions the data needs) and the ptxas lines
   of the three kernels;
   (k2) the storm's BLS rows at N = 256, quorum 171 (``bls-cpu`` and
   ``bls-cuda-storm-offload``, refused unless the offload engages), every
   signature checked against the native pairing, a forged vote, timeout
   and TC entry rejected, then ``bench_agg_qc`` at n = 64, 256 and 512,
   its Handel columns held to the round-3 tree (6, 8 and 9 levels, the
   leader merging at most once a level);
   (k3) 64 BLS key files (``keys --scheme bls`` and ``Secret.new("bls")``)
   through ``run-many --verifier cuda --metrics-port 0`` and
   the client for 30 s: every node commits at least 3 blocks, the chains
   agree, compact QCs were emitted, and the running-sum kernel launched
   at least once for every vote those QCs summed (logs in
   ``chiprun_out/bls_phase/``);
20. (l) the mesh verifier (``mesh_phase``) on the mesh of every visible
   card (``default_mesh()``, one card here) and on four shards of card 0
   (``Mesh([cuda:0] * 4)``, the port's counterpart of XLA's forced host
   device count): (l1) ``ShardedBatchVerifier`` after ``precompute`` and
   ``warmup``: step 3's wave, the 171-vote QC and the forged QC, every
   verdict equal to the single-device verifier's and the oracle's; 20
   back-to-back waves with one forged claim moving across the shards; the
   word-only readback of all-valid QCs (spans ``mesh.psum`` and no
   ``readback``); ``make_sharded_qc_check`` and the word; K1 launched
   once a shard a dispatch.  (l2) ``bench_sharded``: the QC-256 sharded
   dispatch's CUDA-event ms beside K1's on one device at the same padded
   batch.  (l3) ``G1Aggregator(mesh=...)`` at 171 points: X, Y, Z equal
   to the plain sharded sum's mod q, the point to ``aggregate_plain``'s
   and the oracle's, CUDA-event ms beside B4 on one device; and
   ``BlsVerifier(aggregator="cuda-sharded").verify_shared_msg`` on a
   171-vote QC and a forged one.  (l4) (e) with ``--verifier mesh
   --mesh-devices 1`` (logs in ``chiprun_out/mesh_phase/``): the checks
   of (e) and ``mesh=`` > 0 and equal to ``device=`` in the last stats
   line.  Prints a ``mesh {json}`` line;
21. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is the sum
   over the main-path runs (3, (a)-(j), (m), (n), (o) and (l) for the Ed25519
   verify kernel, (k2), (k3), (l3) and (o)'s direct check for the G1
   kernels), each counted from 0.
   A row's ``ms`` is the mean of back-to-back launches between two CUDA
   events, the host's enqueue inside the window (``cuda_ms``), except
   B6's (``g1_running_add_kernel``): its launch is shorter than its
   enqueue, so its ``ms`` is taken with the host out of the window
   (``covered_cuda_ms``), and its row also gives the back-to-back mean
   (``b2b_ms``) and an empty launch's time taken the same way as its
   ``ms`` (``floor_ms``).

The phases run in the order (a)-(j), (m), (n1), (n2), (o), (k), (l);
before each, the script prints its running total (host clock), and
after each the phase's own time (``phase (x) took``).

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
import concurrent.futures
import contextlib
import faulthandler
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
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
SPLIT_TRIALS = 3  # more fresh wave services through the verify split in (h)
WATCHDOG_S = 1080

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


def covered_cuda_ms(fn, reps: int) -> tuple:
    """(ms, covered): the mean device time of ``fn`` over ``reps`` calls
    with the host out of the window.  A spin kernel (``torch.cuda._sleep``)
    holds the stream while the host enqueues the start event, the calls
    and the end event, so the card runs the calls back to back however
    slowly the host enqueues them: where a call's enqueue takes longer
    than its kernel, ``cuda_ms`` measures the enqueue.  The spin lasts
    twice the host's time for the calls (measured first); ``covered``
    says the start event had not fired when the last call was enqueued
    (else the spin is doubled and the window taken again, up to 4
    times)."""
    import torch

    for _ in range(2):  # warm: the kernel loaded, the clocks up
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    spin = 1 << 20
    calib = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calib[0].record()
    torch.cuda._sleep(spin)
    calib[1].record()
    torch.cuda.synchronize()
    cycles = int(spin / calib[0].elapsed_time(calib[1]) * (2 * host_ms + 1))
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            break
        cycles *= 2
    return start.elapsed_time(end) / reps, covered


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
    results = storm.run_storm(nodes, device=True, torch_device=torch_device, bls=False)
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
            reactor = native.Reactor.shared()
            tx0, txb0 = (reactor.counters()[k] for k in ("tx_frames", "tx_bytes"))
            framed = 0  # the bytes of the frames handed to the reactor, prefixes included
            start = service.dispatches
            dsm.reset_launches()
            rec = spans.enable()
            try:
                t_wire = time.perf_counter()
                for w in range(waves):
                    for k in range(0, wave, 128):  # under the reactor's 1000-frame outbox
                        for frame in frames[w][k : k + 128]:
                            await sender.send(addr, frame)
                            framed += 4 + len(frame)
                        # the simple sender drops a frame that a full outbox
                        # refuses: the next batch waits until the reactor
                        # has written this one to the socket
                        await until(lambda: reactor.counters()["tx_bytes"] - txb0 >= framed,
                                    f"the reactor to write wave {w}'s first {k + 128} frames")
                    sent = reactor.counters()["tx_frames"] - tx0
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
            "deadline_misses": int(last[7]), "mesh": int(last[10] or 0), "ewma_ms": float(last[13]),
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
    split = r["verify_split"]
    print(f"verify split: {split['waves']} QC-{split['qc_size']} claims a route through the wave service, "
          f"host route {split['host_wall_ms']} ms, device route {split['device_wall_ms']} ms (telemetry "
          f"registry), device sigs {split['device_sigs']}, CPU fallback sigs {split['cpu_fallback_sigs']}, "
          f"deadline misses {split['deadline_misses']}, verify kernel launches {split['launches']} [{card}]")
    check(split["host_wall_ms"] > 0 and split["device_wall_ms"] > 0,
          "verify split: both routes' wall seconds in the registry")
    if r["device"]["platform"] == "gpu":
        check(split["device_sigs"] >= split["waves"] * split["qc_size"],
              "verify split: every device-route claim verified on the card")
        check(split["launches"] >= split["waves"], "verify split: the verify kernel launched for every wave")
        # a fresh service's first device wave seeds the router's EWMA:
        # its slot threads stage into buffers warm_buckets allocated, so
        # every wave of every fresh service stays on the card
        qm, qp, qs = bench.make_qc_batch(split["qc_size"])
        trials = [bench.bench_verify_split(qm, qp, qs, device=torch_device or "cuda", qc=split["qc_size"])
                  for _ in range(SPLIT_TRIALS)]
        print(f"verify split, {SPLIT_TRIALS} more fresh services: first device wave "
              f"{[t['first_device_wave_ms'] for t in trials]} ms (CPU estimate {split['cpu_estimate_ms']} ms; "
              f"the first service's {split['first_device_wave_ms']} ms), device sigs "
              f"{[t['device_sigs'] for t in trials]}, probes {[t['probe_dispatches'] for t in trials]} [{card}]")
        for i, t in enumerate(trials):
            check(t["device_sigs"] >= t["waves"] * t["qc_size"],
                  f"verify split, fresh service {i}: every device-route claim verified on the card")

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


def committee_files(tmp: str, nodes: int, phase: str, timeout_delay: int | None = None,
                    scheme: str = "ed25519", held: list | None = None) -> tuple:
    """(key files, committee file, parameters file) of an ``nodes``-member
    committee of ``scheme`` under ``tmp``, as an operator makes them: the
    first key file by ``python -m hotstuff_tpu_torch.node keys --scheme``,
    the rest by ``Secret.new(scheme)``, the members on OS-assigned ports
    with the BLS keys' proofs of possession, and the default parameters,
    or a ``timeout_delay`` (ms).  The ports are free again when this
    returns, or, with a ``held`` list, stay reserved by the sockets
    appended to it until the caller closes them: the node process's
    listeners bind beside them (``reserve_ports``), and no connection
    made during the boot can take a member's port."""
    from hotstuff_tpu_torch.bench.committee import reserve_ports
    from hotstuff_tpu_torch.consensus import Committee, Parameters
    from hotstuff_tpu_torch.node.config import Secret, write_committee, write_parameters

    env = {**os.environ, "PYTHONPATH": ROOT}
    key_files = [os.path.join(tmp, f"key_{i}.json") for i in range(nodes)]
    subprocess.run([sys.executable, "-m", "hotstuff_tpu_torch.node", "keys", "--scheme", scheme,
                    "--filename", key_files[0]], env=env, check=True, timeout=120)
    for path in key_files[1:]:
        Secret.new(scheme).write(path)
    secrets = [Secret.read(path) for path in key_files]
    check(all(s.scheme == scheme for s in secrets), f"{phase}: every key file is {scheme}")
    socks = reserve_ports(nodes)
    committee = Committee.new([(sec.name, 1, ("127.0.0.1", s.getsockname()[1]))
                               for sec, s in zip(secrets, socks)],
                              scheme=scheme,
                              pops={sec.name: sec.pop for sec in secrets if sec.pop is not None})
    committee_file = os.path.join(tmp, "committee.json")
    parameters_file = os.path.join(tmp, "parameters.json")
    write_committee(committee, committee_file)
    if timeout_delay is None:
        write_parameters(Parameters(), parameters_file)
        check(Parameters().timeout_delay == 5_000, f"{phase}: default 5,000 ms timeout delay")
    else:
        write_parameters(Parameters(timeout_delay=timeout_delay, sync_retry_delay=timeout_delay),
                         parameters_file)
    if held is None:
        for s in socks:
            s.close()
    else:
        held.extend(socks)
    return key_files, committee_file, parameters_file


def node_phase(card: str, nodes: int = 64, rate: int = 1000, duration: float = 20,
               verifier: str = "cuda", transport: str = "asyncio", label: str | None = None,
               extra_args=(), extra_env=None, during=None, files=None, scheme: str = "ed25519"):
    """(e), (g) with ``transport="native"``, and (k3) with
    ``scheme="bls"``: the node CLI, a
    ``run-many`` committee process and the producer client process, both
    started from the command line; returns the verify kernel's launches
    in the node process (boot included) and what the logs say.
    ``verifier="cpu"`` rehearses the phase without a card: no wave
    service, so the stats and launch checks are skipped.  ``label``
    names the phase and its log directory under ``chiprun_out/``;
    ``extra_args`` and ``extra_env`` go to the ``run-many`` process;
    ``during(node_log_path, client_log_path, client)`` runs once the
    client process started, before the phase waits for it to exit;
    ``files`` are the caller's ``committee_files`` (new ones by default).
    ``scheme="bls"``: BLS key files (they decide the scheme), ``run-many
    --metrics-port 0`` (the telemetry snapshots carry the compact-QC
    counters), at least 3 commits a node, compact QCs, and the running-sum
    kernel launched for every vote those QCs summed; the K1 checks are
    the Ed25519 committee's."""
    import signal
    import tempfile

    t0 = time.perf_counter()
    phase = label or ("node phase" if transport == "asyncio" else f"node phase ({transport})")
    logs = os.path.join(ROOT, "chiprun_out", phase.replace(" (", "_").replace(" ", "_").strip(")"))
    os.makedirs(logs, exist_ok=True)
    node_log_path = os.path.join(logs, "nodes.log")
    client_log_path = os.path.join(logs, "client.log")
    env = {**os.environ, "PYTHONPATH": ROOT}
    node_env = {**env, **(extra_env or {})}
    cli = [sys.executable, "-m", "hotstuff_tpu_torch.node"]
    procs = []
    held: list = []  # the member ports, reserved until the node process ends
    with tempfile.TemporaryDirectory(prefix="node-phase-") as tmp:
        key_files, committee_file, parameters_file = files or committee_files(
            tmp, nodes, phase, scheme=scheme, held=held)
        if scheme == "bls":
            extra_args = ("--metrics-port", "0", *extra_args)
        stopped_in_time = False
        try:
            with open(node_log_path, "w") as node_log, open(client_log_path, "w") as client_log:
                t_launch = time.time()
                procs.append(subprocess.Popen(
                    cli + ["-vv", "run-many", "--transport", transport, "--verifier", verifier,
                           "--keys", ",".join(key_files),
                           "--committee", committee_file, "--store-prefix", os.path.join(tmp, "db_"),
                           "--parameters", parameters_file, *extra_args],
                    stdout=node_log, stderr=subprocess.STDOUT, env=node_env))
                node = procs[0]
                # the client starts once every node listens, so its first
                # connections find every listener
                boot_deadline = time.monotonic() + 3.0 * nodes + 120
                while node.poll() is None and time.monotonic() < boot_deadline:
                    with open(node_log_path) as f:
                        if len(RE_BOOTED.findall(f.read())) >= nodes:
                            break
                    time.sleep(0.5)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "hotstuff_tpu_torch.node.client", "--committee", committee_file,
                     "--rate", str(rate), "--size", "512", "--duration", str(duration), "--warmup", "2"],
                    stdout=client_log, stderr=subprocess.STDOUT, env=env))
                client = procs[1]
                if during is not None:
                    during(node_log_path, client_log_path, client)
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
            for s in held:
                s.close()
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
    check(r["rounds_agree"], f"{phase}: every committed round names one digest")
    check(r["versions"] > 0 and r["roots_agree"], f"{phase}: every version has one state root")
    if scheme == "bls":
        bls_checks(phase, card, node_text, r, nodes, verifier)
        r.update(boot_s=boot_s, stop_s=stop_s, wall_s=wall)
        return r["launches"], r
    check(r["commit_lines"] >= nodes * 5, f"{phase}: at least 5 committed blocks a node")
    if verifier == "mesh":
        check(r["stats"] is not None and 0 < stats["mesh"] == stats["device"],
              f"{phase}: the last stats line counts every device wave under mesh= "
              f"(mesh={stats.get('mesh')}, device={stats.get('device')})")
    if verifier in ("cuda", "mesh"):
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


def bls_checks(phase: str, card: str, node_text: str, r: dict, nodes: int, verifier: str) -> None:
    """(k3)'s checks of a BLS committee's node log: at least 3 commits a
    node, compact QCs in the last telemetry snapshot of every node, and,
    on the card, a running-sum launch for every vote those QCs summed
    (each compact QC of a node was at least a quorum of adds on its
    accumulator)."""
    per_node = collections.Counter(node for node, rnd in RE_CORE_COMMIT.findall(node_text) if int(rnd) > 0)
    check(len(per_node) == nodes and min(per_node.values()) >= 3,
          f"{phase}: every node commits at least 3 blocks ({sorted(per_node.values())[:3]})")
    last = {}
    for node, doc in RE_NODE_TELEMETRY.findall(node_text):
        last[node] = json.loads(doc)
    check(len(last) == nodes, f"{phase}: a telemetry snapshot from every node ({len(last)})")
    compact_qcs = sum(d.get("aggregator", {}).get("compact_qcs_total", 0) for d in last.values())
    compact_tcs = sum(d.get("aggregator", {}).get("compact_tcs_total", 0) for d in last.values())
    quorum = 2 * nodes // 3 + 1
    lag_mean = sum(d.get("loop_lag_mean_ms", 0.0) for d in last.values()) / len(last)
    lag_max = max(d.get("loop_lag_max_ms", 0.0) for d in last.values())
    r.update(compact_qcs=compact_qcs, compact_tcs=compact_tcs, loop_lag_mean_ms=lag_mean,
             loop_lag_max_ms=lag_max, commits_per_node=(min(per_node.values()), max(per_node.values())))
    check(compact_qcs > 0, f"{phase}: compact QCs were emitted")
    launches = r["launches"] or {}
    print(f"{phase}: {compact_qcs} compact QCs and {compact_tcs} compact TCs emitted (last snapshots), "
          f"commits a node {min(per_node.values())}-{max(per_node.values())}, loop lag mean {lag_mean:.1f} ms "
          f"max {lag_max:.1f} ms, G1 kernel launches {launches} [{card}]")
    if verifier == "cuda":
        check("g1_running_add" in launches, f"{phase}: the clean stop logs the G1 kernels' launch counts")
        check(launches["g1_running_add"] >= compact_qcs * quorum,
              f"{phase}: a running-sum launch for every accumulated vote "
              f"({launches['g1_running_add']} < {compact_qcs} x {quorum})")


# the telemetry plane's log and endpoint contract: RE_TELEMETRY is the
# harness's (benchmark/logs.py), the rest name the port's own lines
RE_TELEMETRY = re.compile(r"Telemetry snapshot: (\{.*\})")
RE_NODE_TELEMETRY = re.compile(r"\] telemetry\.(\S+) Telemetry snapshot: (\{.*\})")
RE_WORK_STATS = re.compile(r"\] workstats\.(\S+) Work stats: (\{.*\})")
RE_ENDPOINT = re.compile(r"Telemetry /metrics endpoint listening on port (\d+)")
RE_CORE_COMMIT = re.compile(r"\] hotstuff_tpu_torch\.consensus\.core\.(\S+) Committed block (\d+) ->")
RE_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
TRACE_EDGES = ("propose_to_vote", "vote_to_qc", "qc_to_commit", "propose_to_commit")


def scrape(port: int, path: str) -> dict:
    """One GET of the node process's endpoint: body, content type, bytes
    and host-clock ms."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        body = resp.read()
        ctype = resp.headers.get("Content-Type")
    return {"body": body.decode(), "type": ctype, "bytes": len(body),
            "ms": (time.perf_counter() - t0) * 1e3}


def parse_metrics(text: str):
    """OpenMetrics text -> ({family: type}, {(sample, labels): value})."""
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, family, kind = line.split(" ", 3)
            types[family] = kind
        elif line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            name, _, labels = head.partition("{")
            samples[(name, tuple(RE_LABEL.findall(labels)))] = float(value)
    return types, samples


def family_of(sample: str, types: dict) -> str | None:
    """The ``# TYPE`` family a sample belongs to, or None."""
    for suffix in ("", "_total", "_bucket", "_sum", "_count"):
        if suffix and not sample.endswith(suffix):
            continue
        family = sample[: len(sample) - len(suffix)] if suffix else sample
        if family in types:
            return family
    return None


def by_label(samples: dict, name: str, key: str) -> dict:
    """Sum of the ``name`` samples by the value of label ``key``."""
    out: dict = collections.defaultdict(float)
    for (sample, labels), value in samples.items():
        if sample == name:
            out[dict(labels).get(key)] += value
    return out


def merged_percentiles(samples: dict, edge: str) -> tuple:
    """p50 and p99 (ms, bucket upper bounds) of one trace edge over every
    node's ``commit_edge_seconds`` histogram."""
    buckets: dict = collections.defaultdict(float)
    for (sample, labels), value in samples.items():
        labels = dict(labels)
        if sample == "hotstuff_commit_edge_seconds_bucket" and labels.get("edge") == edge:
            buckets[labels["le"]] += value
    finite = sorted((float(le), n) for le, n in buckets.items() if le != "+Inf")
    total = buckets.get("+Inf", 0.0)
    out = []
    for q in (0.5, 0.99):
        bound = next((le for le, n in finite if n >= q * total), float("inf"))
        out.append(round(bound * 1e3, 3) if total else None)
    return tuple(out)


def read_journals(jdir: str) -> dict:
    """node id -> its records, every ring segment merged by sequence
    number (the node id is the segment's meta line's)."""
    import glob

    out: dict = collections.defaultdict(list)
    for path in sorted(glob.glob(os.path.join(jdir, "*.jsonl"))):
        node, records = None, []
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn line
                if rec.get("e") == "meta":
                    node = rec["n"]
                else:
                    records.append(rec)
        out[node].extend(records)
    return {n: sorted(rs, key=lambda r: r["s"]) for n, rs in out.items()}


def keys_mismatch(state: dict, snapshot_flat: dict) -> list:
    """The keys by which a ``/delta`` state decoded after a
    ``/snapshot`` scrape is not the snapshot document (none when it
    is).  The state may hold more than the snapshot: the ``metrics``
    blocks, the percentiles of histograms that were empty at the
    snapshot and the ``flows`` keys of a class first charged between
    the two scrapes (keys only appear).  Two blocks are ranked by flow
    bytes, each node's top 8 peers (``flows.peers`` and ``net.peer``),
    and their members change from one scrape to the next, so their
    keys are left out; each block may only grow (a peer first charged
    in between), which is held instead."""
    def ranked(k: str) -> str | None:
        for block in (".flows.peers.", ".net.peer."):
            if block in k:
                return k[:k.index(block) + len(block)]
        return None

    def members(flat: dict) -> collections.Counter:
        return collections.Counter(ranked(k) for k in {k.rsplit(".", 1)[0] for k in flat if ranked(k)})

    mine = {k for k in state if ".metrics." not in k and not ranked(k)}
    theirs = {k for k in snapshot_flat if not ranked(k)}
    out = sorted(theirs - mine)
    out += sorted(k for k in mine - theirs
                  if snapshot_flat.get(k.rsplit(".", 1)[0] + ".count") != 0 and ".flows." not in k)
    sizes, their_sizes = members(state), members(snapshot_flat)
    out += sorted(f"{block} holds {sizes[block]} peers, fewer than {n}"
                  for block, n in their_sizes.items() if sizes[block] < n)
    return out


#: the classes of frames one node sends another in a round or a view
#: change (the client's producer frames and the ACKs are not among them)
NODE_CLASSES = ("propose", "vote", "timeout", "tc")
NET_GAUGES = ("hotstuff_net_tx_bytes", "hotstuff_net_rx_bytes", "hotstuff_net_retx_bytes")


def flow_checks(phase: str, card: str, docs: dict, samples: dict, nodes: int, rounds: int) -> dict:
    """The flows sections of one ``/snapshot`` scrape (``docs``, node ->
    document) and the byte gauges of the ``/metrics`` scrape beside it
    (``samples``): every node's section is on with tx and rx bytes, its
    classes cover every accounted byte, its ``propose`` amplification
    (wire over logical bytes) is at most n - 1 (more only by its
    retransmits' share), and exactly n - 1 on at least one leader that
    answered no sync request (a sync reply is a single-peer ``propose``
    frame) and retransmitted nothing; summed over the nodes, no
    node-to-node class received more bytes than were sent.  Returns the
    bytes a committed block by class (``rounds`` committed rounds)."""
    check(len(docs) == nodes, f"{phase}: {nodes} snapshot documents for the flows ({len(docs)})")
    for gauge in NET_GAUGES:
        check(len(by_label(samples, gauge, "node")) == nodes, f"{phase}: /metrics has {gauge} for {nodes} nodes")
    totals: dict = collections.defaultdict(lambda: [0, 0])
    amps, exact = [], 0
    for n, doc in docs.items():
        f = doc.get("flows") or {}
        check(f.get("enabled") is True and f["tx_bytes"] > 0 and f["rx_bytes"] > 0,
              f"{phase}: node {n}'s flows section is on, with tx and rx bytes ({f})")
        classes = f["classes"]
        for d in ("tx", "rx"):
            check(sum(c[f"{d}_bytes"] for c in classes.values()) == f[f"{d}_bytes"],
                  f"{phase}: node {n}'s classes cover its {d} bytes")
        for cls, c in classes.items():
            totals[cls][0] += c["tx_bytes"]
            totals[cls][1] += c["rx_bytes"]
        amp = f["amp"].get("propose")
        if amp is None:
            continue  # sent no propose frame
        p = classes.get("propose", {"tx_bytes": 0, "retx_bytes": 0, "retx_frames": 0})
        ceiling = (nodes - 1) * p["tx_bytes"] / max(1, p["tx_bytes"] - p["retx_bytes"])
        check(0 < amp <= ceiling + 1e-3, f"{phase}: node {n}'s propose amplification {amp} in (0, {ceiling:.3f}]")
        amps.append(amp)
        if classes.get("sync-req", {}).get("rx_frames", 0) == 0 and p["retx_frames"] == 0 and amp == nodes - 1:
            exact += 1
    check(exact > 0, f"{phase}: some leader's propose amplification is exactly {nodes - 1} ({sorted(amps)[-5:]})")
    for cls in NODE_CLASSES:
        tx, rx = totals.get(cls, (0, 0))
        check(rx <= tx, f"{phase}: {cls} bytes received ({rx}) at most those sent ({tx}), over all nodes")
    per_block = {cls: round(tx / max(rounds, 1)) for cls, (tx, _) in sorted(totals.items())}
    print(f"{phase} flows: tx/rx bytes by class over {nodes} nodes "
          f"{ {cls: tuple(v) for cls, v in sorted(totals.items())} }; propose amplification "
          f"{min(amps, default=None)}-{max(amps, default=None)} on {len(amps)} nodes, exactly {nodes - 1} on {exact}; "
          f"wire bytes a committed block ({rounds} rounds) by class {per_block} [{card}]")
    return {"classes": {cls: tuple(v) for cls, v in totals.items()}, "per_block": per_block,
            "amp_exact": exact, "amp_range": (min(amps, default=None), max(amps, default=None))}


def endpoint_and_load_start(phase: str, nodes: int, node_log_path, client_log_path, client) -> tuple:
    """The node process's endpoint port and the host-clock moment the
    client began sending, read from the two logs as they grow."""
    deadline = time.monotonic() + 3.0 * nodes + 120
    port = start = None
    while time.monotonic() < deadline and (port is None or start is None):
        with open(node_log_path) as f:
            m = RE_ENDPOINT.search(f.read())
        port = int(m[1]) if m else None
        with open(client_log_path) as f:
            start = time.monotonic() if "Transactions rate:" in f.read() else None
        check(client.poll() is None or start is not None, f"{phase}: the client exited before sending")
        time.sleep(0.1)
    check(port is not None and start is not None, f"{phase}: the endpoint's port and the load's start")
    return port, start


def telemetry_phase(card: str, nodes: int = 64, rate: int = 1000, duration: float = 20,
                    verifier: str = "cuda", scrape_at=(0.4, 0.8)):
    """(i) The node CLI of (e) with the telemetry plane on:
    ``--metrics-port 0 --journal-dir <dir> --profile`` and
    ``HOTSTUFF_WORK_STATS=1``.  The endpoint is scraped at ``scrape_at``
    of the load (8 s and 16 s of 20) and once after it; the journals
    are read after the SIGTERM stop.  Returns the verify kernel's
    launches in the node process and what the logs say."""
    from hotstuff_tpu_torch.telemetry.health import DeltaDecoder, flatten
    from hotstuff_tpu_torch.utils.workstats import WORKSTATS_KEYS

    phase = "telemetry phase"
    jdir = os.path.join(ROOT, "chiprun_out", "telemetry_phase", "journals")
    shutil.rmtree(jdir, ignore_errors=True)
    scrapes = []

    def during(node_log_path, client_log_path, client):
        port, start = endpoint_and_load_start(phase, nodes, node_log_path, client_log_path, client)
        for frac in scrape_at:
            time.sleep(max(0.0, start + frac * duration - time.monotonic()))
            got = {"at_s": time.monotonic() - start}
            got["snapshot"] = scrape(port, "/snapshot")
            got["metrics"] = scrape(port, "/metrics")
            got["trace"] = scrape(port, "/trace")
            got["delta_full"] = scrape(port, "/delta?since=0")
            seq = json.loads(got["delta_full"]["body"])["seq"]
            got["delta_next"] = scrape(port, f"/delta?since={seq}")
            scrapes.append(got)
        client.wait(timeout=3.0 * nodes + duration + 120)
        scrapes.append({"at_s": time.monotonic() - start, "snapshot": scrape(port, "/snapshot"),
                        "metrics": scrape(port, "/metrics"), "trace": scrape(port, "/trace")})

    launches, r = node_phase(card, nodes, rate, duration, verifier, label=phase,
                             extra_args=("--metrics-port", "0", "--journal-dir", jdir, "--profile"),
                             extra_env={"HOTSTUFF_WORK_STATS": "1"}, during=during)
    logs = os.path.join(ROOT, "chiprun_out", "telemetry_phase")
    with open(os.path.join(logs, "nodes.log")) as f:
        node_text = f.read()
    with open(os.path.join(logs, "scrapes.json"), "w") as f:
        json.dump([{k: (v if k == "at_s" else {x: v[x] for x in ("bytes", "ms", "type")})
                    for k, v in s.items()} for s in scrapes], f)
    with open(os.path.join(logs, "last_metrics.txt"), "w") as f:
        f.write(scrapes[-1]["metrics"]["body"])

    # /metrics: OpenMetrics, every family typed, 64 nodes, counters only rise
    parsed = []
    for s in scrapes:
        m = s["metrics"]
        check(m["type"].startswith("application/openmetrics-text"), f"{phase}: /metrics content type")
        check(m["body"].endswith("# EOF\n"), f"{phase}: /metrics ends in # EOF")
        types, samples = parse_metrics(m["body"])
        untyped = {name for name, _ in samples if family_of(name, types) is None}
        check(not untyped, f"{phase}: every /metrics family has a # TYPE (untyped: {sorted(untyped)[:5]})")
        node_labels = {dict(labels).get("node") for _, labels in samples} - {None}
        check(len(node_labels) == nodes, f"{phase}: /metrics carries {nodes} node labels ({len(node_labels)})")
        parsed.append((types, samples))
    for (types, first), (_, second) in zip(parsed, parsed[1:]):
        fell = [k for k, v in first.items()
                if types.get(family_of(k[0], types)) == "counter" and k in second and second[k] < v]
        check(not fell, f"{phase}: no counter falls between two scrapes ({fell[:3]})")
    types, last = parsed[-1]
    stats = r["stats"] or {}
    routes_scraped = by_label(last, "hotstuff_verify_route_total", "route")
    device_wall = by_label(last, "hotstuff_verify_device_wall_seconds_total", "svc")
    host_wall = by_label(last, "hotstuff_verify_host_wall_seconds_total", "svc")
    if verifier == "cuda":
        for route in ("device", "cpu", "probe"):
            check(routes_scraped.get(route, 0) <= stats[route],
                  f"{phase}: the last scrape's {route} waves ({routes_scraped.get(route, 0)}) are at most "
                  f"the final stats line's ({stats[route]})")
        by_svc = collections.defaultdict(float)
        for (sample, labels), value in last.items():
            labels = dict(labels)
            if sample == "hotstuff_verify_route_total" and labels["route"] in ("device", "probe"):
                by_svc[labels["svc"]] += value
        for svc, waves in by_svc.items():
            check(waves == 0 or device_wall.get(svc, 0) > 0,
                  f"{phase}: device wall seconds wherever device or probe waves ran ({svc})")
        check(sum(by_svc.values()) > 0, f"{phase}: the scrape shows device or probe waves")

    # /snapshot: 64 node documents, each a superset of the Work stats one
    snapshots = [json.loads(s["snapshot"]["body"]) for s in scrapes]
    for snap in snapshots:
        check(len(snap) == nodes, f"{phase}: /snapshot holds {nodes} node documents ({len(snap)})")
        check(all(set(WORKSTATS_KEYS) <= set(doc) for doc in snap.values()),
              f"{phase}: every snapshot document is a superset of the Work stats one")
    # /delta: the second frame decodes against the first
    for s, snap in zip(scrapes, snapshots):
        if "delta_full" not in s:
            continue
        decoder = DeltaDecoder()
        f0, f1 = json.loads(s["delta_full"]["body"]), json.loads(s["delta_next"]["body"])
        check("full" in f0 and decoder.apply(f0) is not None, f"{phase}: /delta?since=0 is a full frame")
        state = decoder.apply(f1)
        check(state is not None and f1.get("base") == f0["seq"] and decoder.seq == f1["seq"],
              f"{phase}: the second /delta frame decodes against the first")
        off = keys_mismatch(state, flatten(snap))
        check(not off, f"{phase}: the decoded /delta state is the /snapshot document ({len(off)} keys "
                       f"differ: {off[:8]})")

    # flows: the final scrape's sections and byte gauges
    r["flows"] = flow_checks(phase, card, snapshots[-1], last, nodes, r["committed_rounds"])

    # journals: every node's, its commit records the rounds of its Committed lines
    journals = read_journals(jdir)
    check(len(journals) == nodes, f"{phase}: {nodes} nodes' journals after the stop ({len(journals)})")
    logged = collections.defaultdict(list)
    for node, rnd in RE_CORE_COMMIT.findall(node_text):
        logged[node].append(int(rnd))
    mismatched = [n for n, recs in journals.items()
                  if [x["r"] for x in recs if x["e"] == "commit"] != logged.get(n)]
    check(not mismatched, f"{phase}: each node's commit records are its Committed lines' rounds "
                          f"({len(mismatched)} differ)")
    trips = sorted(secs for _, _, secs in proposal_delays(jdir))
    if trips:
        r["proposal_trip_ms"] = [round(trips[0] * 1e3, 3), round(statistics.median(trips) * 1e3, 3), len(trips)]
        print(f"{phase}: proposal trips, leader to node, no WAN: min {r['proposal_trip_ms'][0]} ms, median "
              f"{r['proposal_trip_ms'][1]} ms over {len(trips)} [{card}]")
    snap_nodes = set()
    for line in node_text.splitlines():
        who, doc = RE_NODE_TELEMETRY.search(line), RE_TELEMETRY.search(line)
        if who and doc and "node" in json.loads(doc[1]):
            snap_nodes.add(who[1])
    check(len(snap_nodes) == nodes, f"{phase}: every node logs a Telemetry snapshot line the harness's "
                                    f"pattern reads ({len(snap_nodes)})")
    work_lines = {n for n, _ in RE_WORK_STATS.findall(node_text)}
    check(len(work_lines) == nodes, f"{phase}: every node logs a Work stats line ({len(work_lines)})")
    check("Kernel launches:" in node_text or verifier != "cuda",
          f"{phase}: the clean stop logs the kernels' launch counts")

    # the split of the loop's time and the committee's edges
    final = snapshots[-1]
    trace_ring = json.loads(scrapes[-1]["trace"]["body"])
    edges = {}
    for edge in TRACE_EDGES:
        ring = sorted(rec[f"{edge}_ms"] for recs in trace_ring.values() for rec in recs
                      if f"{edge}_ms" in rec)
        exact = (ring[(len(ring) - 1) // 2], ring[min(len(ring) - 1, int(0.99 * len(ring)))]) if ring else None
        edges[edge] = {"buckets_p50_p99_ms": merged_percentiles(last, edge),
                       "ring_p50_p99_ms": exact, "ring_samples": len(ring)}
    verify_wall_ms = sum(doc["verify_wall_ms"] for doc in final.values())
    lag_mean = sum(doc["loop_lag_mean_ms"] for doc in final.values()) / max(len(final), 1)
    lag_max = max((doc["loop_lag_max_ms"] for doc in final.values()), default=0.0)
    split = {
        "window_s": duration,
        "host_wall_s": sum(host_wall.values()),
        "device_wall_s": sum(device_wall.values()),
        "workstats_verify_wall_s": verify_wall_ms / 1e3,
        "loop_lag_mean_ms": lag_mean,
        "loop_lag_max_ms": lag_max,
        "scrape_at_s": [s["at_s"] for s in scrapes],
        # each route's bytes and host-clock ms, every scrape; the
        # endpoint renders on the nodes' one event loop
        "scrapes": [{k: [v["bytes"], v["ms"]] for k, v in s.items() if k != "at_s"} for s in scrapes],
        "scrape_ms_in_load": sum(v["ms"] for s in scrapes[:-1] for k, v in s.items() if k != "at_s"),
        "journal_records": sum(map(len, journals.values())),
        "edges": edges,
    }
    for edge, e in edges.items():
        print(f"{phase} edge {edge}: p50/p99 {e['ring_p50_p99_ms']} ms over the last {e['ring_samples']} "
              f"trace records, {e['buckets_p50_p99_ms']} ms by the merged histograms' bucket bounds [{card}]")
    print(f"{phase} loop split over the {duration} s window: wave service host (CPU) wall "
          f"{split['host_wall_s']:.3f} s, device wall {split['device_wall_s']:.3f} s (slot threads); "
          f"nodes' inline verify (WorkStats) {split['workstats_verify_wall_s']:.3f} s; loop lag mean "
          f"{lag_mean:.2f} ms, max {lag_max:.1f} ms [{card}]")
    for at, s in zip(split["scrape_at_s"], split["scrapes"]):
        print(f"{phase} scrape at {at:.1f} s of the load: " + ", ".join(
            f"/{route} {b} bytes in {ms:.1f} ms" for route, (b, ms) in s.items()) + f" [{card}]")
    print(f"{phase}: the scrapes inside the load held the endpoint (and so the nodes' loop) "
          f"{split['scrape_ms_in_load']:.0f} ms of the {duration} s window; "
          f"{split['journal_records']} journal records [{card}]")
    print(f"{phase} result: " + json.dumps({"split": split, "routes": routes_scraped}))
    r["split"] = split
    return launches, r


# the health plane's log contract: RE_HEALTH and RE_HEALTH_ON are the
# harness's (benchmark/logs.py), the stop line the node CLI's own
RE_HEALTH = re.compile(_TS + r".*Health incident: (\{.*\})")
RE_HEALTH_ON = re.compile(r"Health monitor running")
RE_HEALTH_ON_AT = re.compile(_TS + r".*Health monitor running for node (\S+)")
RE_STOPPING = re.compile(_TS + r".*Stopping \d+ node\(s\) on a signal")


def health_events(node_text: str, phase: str) -> list:
    """Every ``Health incident:`` line as (time, document); each must
    parse, and per node and kind the phases must run open, close, open..."""
    events = []
    for ts, blob in RE_HEALTH.findall(node_text):
        try:
            events.append((_ts(ts), json.loads(blob)))
        except ValueError:
            check(False, f"{phase}: a Health incident line that is not JSON: {blob[:120]}")
    state: dict = {}
    for _, doc in events:
        key = (doc.get("node"), doc.get("kind"))
        want = "close" if state.get(key) == "open" else "open"
        check(doc.get("phase") == want, f"{phase}: {key} logs {doc.get('phase')} where {want} was due")
        state[key] = doc["phase"]
    return events


def check_journaled_incidents(phase: str, jdir: str, events: list, nodes: int) -> None:
    """Each node's ``health.<kind>`` journal records are its logged
    incidents, in order."""
    journals = read_journals(jdir)
    check(len(journals) == nodes, f"{phase}: {nodes} nodes' journals after the stop ({len(journals)})")
    logged = collections.defaultdict(list)
    for _, doc in events:
        logged[doc["node"]].append((f"health.{doc['kind']}", doc["phase"]))
    for node, records in journals.items():
        journaled = [(r["e"], r.get("p")) for r in records if r["e"].startswith("health.")]
        check(journaled == logged.get(node, []),
              f"{phase}: node {node}'s health.* journal records are its Health incident lines")


def campaign_rings(phase: str, jdir: str, node_text: str, nodes: int, min_samples: int) -> dict:
    """node id -> its campaign ring, checked: one ``-campaign.json`` a
    node beside the journals, persisted at or after the SIGTERM stop,
    with at least ``min_samples`` rows."""
    import glob

    stops = RE_STOPPING.findall(node_text)
    check(len(stops) == 1, f"{phase}: the node process logged its stop on the signal")
    stop_at = _ts(stops[0])
    rings = {}
    for path in glob.glob(os.path.join(jdir, "*-campaign.json")):
        with open(path) as f:
            doc = json.load(f)
        check(os.path.getmtime(path) >= stop_at - 0.01,
              f"{phase}: {os.path.basename(path)} was persisted at the stop")
        rings[doc["node"]] = doc
    check(len(rings) == nodes, f"{phase}: {nodes} campaign rings beside the journals ({len(rings)})")
    short = min(len(doc["samples"]) for doc in rings.values())
    check(short >= min_samples, f"{phase}: every campaign ring holds >= {min_samples} samples ({short})")
    return rings


def health_phase(card: str, nodes: int = 64, rate: int = 1000, duration: float = 20,
                 verifier: str = "cuda", scrape_at=(0.4, 0.8), stall_s: float = 25.0,
                 timeout_delay: int | None = None):
    """(j) The health plane on the node CLI, as an operator runs it:
    ``run-many --verifier cuda --health --metrics-port 0 --journal-dir``.

    (j1) the committee of (e) with the client: ``/snapshot`` and
    ``/delta`` scraped at ``scrape_at`` of the load; every node's monitor
    running and its ``health`` section served, a critical-path regime on
    every node past its fourth commit, no ``leader_stall``, the port's
    fleet detectors (``straggler`` on rounds, ``root_divergence`` on
    state roots) quiet over the decoded ``/delta`` states, and after
    SIGTERM a campaign ring and a journal a node whose ``health.*``
    records are the logged incidents.

    (j2) the same committee file with one key file fewer than the quorum
    (42 of 64) and no client, for ``stall_s`` after the last boot: no QC
    and no TC can form, so every live node must open ``leader_stall``
    (value >= 3 timeouts), journal it and persist it in its campaign
    ring at the stop.

    Returns the verify kernel's launches in both node processes and
    (j1)'s log reading."""
    import signal
    import tempfile

    from hotstuff_tpu_torch.node.config import Secret
    from hotstuff_tpu_torch.telemetry.critpath import LOCAL_EDGE_REGIME
    from hotstuff_tpu_torch.telemetry.health import DeltaDecoder, root_divergence, straggler

    phase = "health phase"
    logs = os.path.join(ROOT, "chiprun_out", "health_phase")
    os.makedirs(logs, exist_ok=True)
    quorum = nodes - (nodes - 1) // 3
    live = quorum - 1
    stall_floor_s = 3 * (timeout_delay or 5_000) / 1e3
    scrapes = []

    def during(node_log_path, client_log_path, client):
        port, start = endpoint_and_load_start(phase, nodes, node_log_path, client_log_path, client)
        decoder = DeltaDecoder()
        for frac in scrape_at:
            time.sleep(max(0.0, start + frac * duration - time.monotonic()))
            got = {"at_s": time.monotonic() - start}
            got["snapshot"] = json.loads(scrape(port, "/snapshot")["body"])
            pulled = scrape(port, f"/delta?since={decoder.since}")
            state = decoder.apply(json.loads(pulled["body"]))
            if state is None:  # a gap: one full re-pull, as the fleet watch does
                pulled = scrape(port, f"/delta?since={decoder.since}")
                state = decoder.apply(json.loads(pulled["body"]))
            check(state is not None, f"{phase}: the /delta frame at {got['at_s']:.1f} s decodes")
            got["delta"] = {"state": dict(state), "bytes": pulled["bytes"], "ms": pulled["ms"],
                            "t": time.monotonic()}
            scrapes.append(got)

    with tempfile.TemporaryDirectory(prefix="health-phase-") as tmp, contextlib.ExitStack() as ports:
        held: list = []
        files = committee_files(tmp, nodes, phase, timeout_delay, held=held)
        for s in held:  # the member ports stay reserved through (j1) and (j2)
            ports.enter_context(s)
        key_files, committee_file, parameters_file = files
        names = [str(Secret.read(path).name)[:8] for path in key_files]

        # (j1) the healthy committee
        jdir = os.path.join(tmp, "journals_j1")
        t0 = time.perf_counter()
        launches, r = node_phase(card, nodes, rate, duration, verifier, label=phase,
                                 extra_args=("--health", "--metrics-port", "0", "--journal-dir", jdir),
                                 during=during, files=files)
        with open(os.path.join(logs, "nodes.log")) as f:
            node_text = f.read()
        check(len(RE_HEALTH_ON.findall(node_text)) == nodes,
              f"{phase}: {nodes} 'Health monitor running' lines")
        check(len(scrapes) == len(scrape_at), f"{phase}: the scrapes at {scrape_at} of the load")
        for got in scrapes:
            snap = got["snapshot"]
            check(len(snap) == nodes and all(isinstance(doc.get("health"), dict) for doc in snap.values()),
                  f"{phase}: a health section in all {nodes} snapshot documents at {got['at_s']:.1f} s")
        first, last = scrapes[0]["snapshot"], scrapes[-1]["snapshot"]
        past_fourth = [n for n, doc in first.items() if doc.get("trace", {}).get("commits", 0) >= 4]
        check(past_fourth, f"{phase}: some node past its fourth commit at {scrapes[0]['at_s']:.1f} s")
        regimes = set(LOCAL_EDGE_REGIME.values())
        for n in past_fourth:
            h = last[n]["health"]
            check(h.get("dominant_stage") in LOCAL_EDGE_REGIME and h.get("regime") in regimes,
                  f"{phase}: node {n}, past its fourth commit, publishes a dominant stage and a regime ({h})")
        by_regime = collections.Counter(doc["health"].get("regime") or "none" for doc in last.values())
        events = health_events(node_text, phase)
        opened = [doc for _, doc in events if doc["phase"] == "open"]
        check(not [d for d in opened if d["kind"] == "leader_stall"], f"{phase}: no leader_stall incident")
        check_journaled_incidents(phase, jdir, events, nodes)
        rings = campaign_rings(phase, jdir, node_text, nodes, min_samples=10)
        ring_dir = os.path.join(logs, "campaigns_j1")
        shutil.rmtree(ring_dir, ignore_errors=True)
        shutil.copytree(jdir, ring_dir, ignore=shutil.ignore_patterns("*.jsonl"))
        fleet = []
        for got in scrapes:
            state, now = got["delta"]["state"], got["delta"]["t"]
            rounds, roots = {}, {}
            for n in got["snapshot"]:
                rnd = state.get(f"{n}.metrics.hotstuff_core_round") or state.get(f"{n}.state.last_round", 0)
                rounds[n] = (now, float(rnd or 0))
                if state.get(f"{n}.state.root"):
                    roots[n] = (int(state.get(f"{n}.state.version") or 0), str(state[f"{n}.state.root"]))
            check(len(rounds) == nodes and len(roots) == nodes,
                  f"{phase}: rounds and state roots of {nodes} nodes in the decoded /delta state")
            lagging, diverged = straggler(rounds, {}, now), root_divergence(roots)
            check(not lagging, f"{phase}: the straggler detector is quiet ({[i.to_json() for i in lagging][:3]})")
            check(not diverged, f"{phase}: the root_divergence detector is quiet "
                                f"({[i.to_json() for i in diverged][:3]})")
            head = max(v for _, v in rounds.values())
            fleet.append({"at_s": round(got["at_s"], 1), "head_round": head,
                          "max_lag": head - min(v for _, v in rounds.values()),
                          "versions": len({v for v, _ in roots.values()}),
                          "delta_bytes": got["delta"]["bytes"], "delta_ms": round(got["delta"]["ms"], 1)})
        j1_s = time.perf_counter() - t0
        for d in opened:
            print(f"{phase} (j1) incident opened: {d['kind']} on {d['node']}, {d['severity']}, "
                  f"value {d['value']} [{card}]")
        print(f"{phase} (j1): {nodes} monitors, {len(opened)} incidents opened, "
              f"{len(events) - len(opened)} closed; regimes at {scrapes[-1]['at_s']:.1f} s: "
              f"{dict(sorted(by_regime.items()))} ({len(past_fourth)} nodes past their fourth commit at "
              f"{scrapes[0]['at_s']:.1f} s); campaign rings {min(len(x['samples']) for x in rings.values())}-"
              f"{max(len(x['samples']) for x in rings.values())} samples; fleet detectors quiet: {fleet}; "
              f"{j1_s:.1f} s [{card}]")

        # (j2) below quorum: one key file fewer than the quorum, no client
        jdir2 = os.path.join(tmp, "journals_j2")
        log2 = os.path.join(logs, "j2_nodes.log")
        t0 = time.perf_counter()
        node = None
        stopped = False
        try:
            with open(log2, "w") as out:
                node = subprocess.Popen(
                    [sys.executable, "-m", "hotstuff_tpu_torch.node", "-vv", "run-many", "--verifier",
                     verifier, "--health", "--metrics-port", "0", "--journal-dir", jdir2,
                     "--keys", ",".join(key_files[:live]), "--committee", committee_file,
                     "--store-prefix", os.path.join(tmp, "j2_db_"), "--parameters", parameters_file],
                    stdout=out, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": ROOT})
            booted_at = None
            deadline = time.monotonic() + 3.0 * live + 120
            while node.poll() is None and time.monotonic() < deadline:
                with open(log2) as f:
                    if len(RE_BOOTED.findall(f.read())) >= live:
                        booted_at = time.monotonic()
                        break
                time.sleep(0.5)
            check(booted_at is not None, f"{phase} (j2): {live} nodes booted")

            def stalled() -> set:
                with open(log2) as f:
                    return {doc["node"] for _, doc in health_events(f.read(), phase)
                            if doc["kind"] == "leader_stall" and doc["phase"] == "open"}

            time.sleep(max(0.0, booted_at + stall_s - time.monotonic()))
            extra = time.monotonic() + 10.0
            while len(stalled()) < live and time.monotonic() < extra and node.poll() is None:
                time.sleep(0.5)
            check(node.poll() is None, f"{phase} (j2): the node process is still running")
            node.send_signal(signal.SIGTERM)
            try:
                node.wait(timeout=60)
                stopped = True
            except subprocess.TimeoutExpired:
                pass
        finally:
            if node is not None and node.poll() is None:
                node.kill()
                node.wait()
        check(stopped, f"{phase} (j2): the node process stopped within 60 s of SIGTERM")
        with open(log2) as f:
            text2 = f.read()
        check("Traceback" not in text2, f"{phase} (j2): no traceback")
        check(len(RE_HEALTH_ON.findall(text2)) == live, f"{phase} (j2): {live} 'Health monitor running' lines")
        events2 = health_events(text2, phase)
        stalls = {}
        for t, doc in events2:
            if doc["kind"] == "leader_stall" and doc["phase"] == "open":
                stalls.setdefault(doc["node"], (t, doc))
        missing = sorted(set(names[:live]) - set(stalls))
        check(not missing, f"{phase} (j2): every live node opens leader_stall ({len(missing)} did not)")
        low = [doc["value"] for _, doc in stalls.values() if doc["value"] < stall_floor_s]
        check(not low, f"{phase} (j2): every leader_stall value >= {stall_floor_s} s ({low[:3]})")
        check_journaled_incidents(f"{phase} (j2)", jdir2, events2, live)
        rings2 = campaign_rings(f"{phase} (j2)", jdir2, text2, live, min_samples=min(10, int(stall_s) - 2))
        quiet = [n for n, doc in rings2.items() if doc["samples"][-1].get("incidents", 0) < 1]
        check(not quiet, f"{phase} (j2): every campaign ring ends with an open incident ({quiet[:3]})")
        monitor_at = {n: _ts(ts) for ts, n in RE_HEALTH_ON_AT.findall(text2)}
        order = sorted(monitor_at, key=monitor_at.get)
        lag = {n: stalls[n][0] - monitor_at[n] for n in order}
        launches2 = RE_LAUNCHES.findall(text2)
        check(launches2 or verifier != "cuda", f"{phase} (j2): the clean stop logs the kernels' launch counts")
        k1_j2 = int(re.search(r"verify_compressed=(\d+)", launches2[-1])[1]) if launches2 else 0
        j2_s = time.perf_counter() - t0
        print(f"{phase} (j2): {live} of {nodes} nodes (quorum {quorum}), no client, {stall_s} s after the last "
              f"boot: leader_stall opened on {len(stalls)} nodes, values "
              f"{min(d['value'] for _, d in stalls.values()):.3f}-{max(d['value'] for _, d in stalls.values()):.3f} s; "
              f"monitor start to first incident: first node {lag[order[0]]:.3f} s, last node "
              f"{lag[order[-1]]:.3f} s (range {min(lag.values()):.3f}-{max(lag.values()):.3f} s); "
              f"{len(events2)} incident lines; verify kernel launches {k1_j2}; "
              f"{j2_s:.1f} s [{card}]")
    r["health"] = {"regimes": dict(by_regime), "opened": opened, "fleet": fleet, "j2_launches": k1_j2}
    print(f"{phase} result: " + json.dumps(r["health"]))
    return launches + k1_j2, r

# ---- (m) the WAN committee ---------------------------------------------------

RE_REGION = re.compile(r"WAN emulation active: region (\S+)")


def wan_floor_s(spec: dict, quorum: int) -> tuple:
    """The least mean commit latency the spec allows: for a leader in each
    region, two one-way hops to the ``quorum``-th nearest member (itself
    at 0 ms), the spec's base delays less three standard deviations of
    its jitter; the smallest over the regions, and that region."""
    matrix = {}
    for key, ms in spec["matrix_one_way_ms"].items():
        a, b = key.split("|")
        matrix[(a, b)] = matrix[(b, a)] = float(ms)
    members = list(spec["regions"].values())
    shrink = 1.0 - 3.0 * float(spec["jitter_pct"]) / 100.0
    best = None
    for region in sorted(set(members)):
        hops = sorted(float(spec["intra_region_ms"]) if m == region else matrix[(region, m)]
                      for m in members)
        hops[0] = 0.0  # the leader itself
        floor = 2.0 * hops[quorum - 1] * shrink / 1e3
        if best is None or floor < best[0]:
            best = (floor, region)
    return best


def proposal_delays(jdir: str) -> list:
    """(leader, receiver, seconds) for every proposal a node's journal
    received (``recv.propose``), from its leader's ``propose`` record:
    the nodes share one process and one monotonic clock, so the
    difference is the proposal's trip, link delay and loop lag."""
    journals = read_journals(jdir)
    proposed = {r["d"]: (node, r["m"]) for node, recs in journals.items() for r in recs
                if r["e"] == "propose"}
    return [(proposed[r["d"]][0], node, (r["m"] - proposed[r["d"]][1]) / 1e9)
            for node, recs in journals.items() for r in recs
            if r["e"] == "recv.propose" and r["d"] in proposed and proposed[r["d"]][0] != node]


#: the least share of a link's base delay a proposal's trip may take:
#: the jitter is normal with a 10% standard deviation, so 4 of them
WAN_MIN_SHARE = 0.6


def wan_phase(card: str, base: dict, i_classes: dict, nodes: int = 64, rate: int = 1000,
              duration: float = 20, verifier: str = "cuda"):
    """(m) The committee of (e) on the reference's five-region WAN: a
    spec written by the port's ``network/wan.build_spec`` over the
    committee's 64 addresses (12 or 13 members a region, the default
    one-way matrix of 30-140 ms between regions, 0.5 ms within one, 10%
    jitter), handed to ``run-many --verifier cuda --metrics-port 0``
    through ``HOTSTUFF_WAN_SPEC``, and the client's 1,000 tx/s of 512 B
    for ``duration`` s; ``/snapshot`` and ``/metrics`` scraped once after
    the load; every node's journal (``--journal-dir``) read after the
    stop.  Every node logs its region and commits at least 5 blocks, the
    chains agree, K1 launches after boot, the mean commit latency is at
    or above the spec's floor (``wan_floor_s``), every proposal reached
    a node of another region no sooner than ``WAN_MIN_SHARE`` of the
    spec's one-way delay between the two regions (``proposal_delays``,
    the journals' ``propose`` and ``recv.propose`` records on the one
    clock of the process), and the flows show node-to-node bytes in each
    class of a round without a view change that (i) shows
    (``i_classes``).  The mean commit latency is printed beside (e)'s
    (``base``, the same call); it is not held above it: at 64 nodes the
    one loop takes ~1 s a round, far more than the WAN's round trips,
    and a payload's latency is the backlog of an offered load the
    committee does not keep up with.  Returns the verify kernel's
    launches in the node process and what the logs say."""
    import tempfile

    from hotstuff_tpu_torch.consensus.leader import LeaderElector
    from hotstuff_tpu_torch.network.wan import DEFAULT_REGIONS, build_spec
    from hotstuff_tpu_torch.node.config import read_committee

    phase = "wan phase"
    scraped: dict = {}

    def during(node_log_path, client_log_path, client):
        port, _ = endpoint_and_load_start(phase, nodes, node_log_path, client_log_path, client)
        client.wait(timeout=3.0 * nodes + duration + 120)
        scraped["snapshot"] = json.loads(scrape(port, "/snapshot")["body"])
        scraped["metrics"] = parse_metrics(scrape(port, "/metrics")["body"])[1]

    with tempfile.TemporaryDirectory(prefix="wan-phase-") as tmp, contextlib.ExitStack() as ports:
        held: list = []
        files = committee_files(tmp, nodes, phase, held=held)
        for sock in held:  # the member ports stay reserved through the run
            ports.enter_context(sock)
        committee = read_committee(files[1])
        keys = committee.sorted_keys()
        spec = build_spec([committee.address(k) for k in keys])
        spec_path = os.path.join(tmp, "wan.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        quorum = committee.quorum_threshold()
        floor_s, floor_region = wan_floor_s(spec, quorum)
        jdir = os.path.join(tmp, "journals")
        launches, r = node_phase(card, nodes, rate, duration, verifier, label=phase,
                                 extra_args=("--metrics-port", "0", "--journal-dir", jdir),
                                 extra_env={"HOTSTUFF_WAN_SPEC": spec_path}, during=during, files=files)
        delays = proposal_delays(jdir)
    region_of = {str(k)[:8]: spec["regions"]["%s:%d" % committee.address(k)] for k in keys}
    one_way = {}
    for key, ms in spec["matrix_one_way_ms"].items():
        a, b = key.split("|")
        one_way[(a, b)] = one_way[(b, a)] = ms / 1e3
    trips = collections.defaultdict(list)
    for leader, node, secs in delays:
        trips[(region_of[leader], region_of[node])].append(secs)
    crossing = {pair: ts for pair, ts in trips.items() if pair[0] != pair[1]}
    check(len(crossing) >= 4, f"{phase}: proposals crossed at least 4 region pairs ({sorted(crossing)})")
    early = {pair: min(ts) for pair, ts in crossing.items() if min(ts) < WAN_MIN_SHARE * one_way[pair]}
    check(not early, f"{phase}: no proposal reached another region sooner than {WAN_MIN_SHARE} of the link's "
                     f"one-way delay ({early})")
    trip_ms = {f"{a}>{b}": [round(min(ts) * 1e3, 1), round(statistics.median(ts) * 1e3, 1),
                            one_way.get((a, b), 0.0) * 1e3, len(ts)]
               for (a, b), ts in sorted(trips.items())}
    with open(os.path.join(ROOT, "chiprun_out", "wan_phase", "nodes.log")) as f:
        node_text = f.read()
    regions = collections.Counter(RE_REGION.findall(node_text))
    check(regions == collections.Counter(spec["regions"].values())
          and set(regions) == set(DEFAULT_REGIONS[:nodes])
          and max(regions.values()) - min(regions.values()) <= 1,
          f"{phase}: every node logs its spec's region, {nodes // 5} or {-(-nodes // 5)} a region "
          f"({dict(regions)})")
    per_node = collections.Counter(node for node, rnd in RE_CORE_COMMIT.findall(node_text) if int(rnd) > 0)
    check(len(per_node) == nodes and min(per_node.values()) >= 5,
          f"{phase}: every node commits at least 5 blocks ({sorted(per_node.values())[:3]})")
    lat = r["latency_mean_s"]
    check(lat is not None and lat >= floor_s,
          f"{phase}: mean commit latency {lat} s at or above the spec's floor {floor_s:.4f} s "
          f"(a leader in {floor_region})")
    check("snapshot" in scraped, f"{phase}: the scrape after the load")
    flows = flow_checks(phase, card, scraped["snapshot"], scraped["metrics"], nodes, r["committed_rounds"])
    # timeout and tc frames flow only where a view change happened
    want = {cls for cls in ("propose", "vote") if i_classes.get(cls, (0, 0))[0] > 0}
    missing = [cls for cls in want if flows["classes"].get(cls, (0, 0))[0] == 0]
    check(not missing, f"{phase}: node-to-node bytes in every class (i) shows ({missing} missing)")
    elector = LeaderElector(committee)
    by_region = collections.Counter(
        spec["regions"]["%s:%d" % committee.address(elector.get_leader(int(rnd)))]
        for rnd in RE_TIMEOUT.findall(node_text))
    r.update(regions=dict(regions), floor_s=floor_s, floor_region=floor_region, flows=flows,
             timeouts_by_leader_region=dict(by_region), proposal_trip_ms=trip_ms)
    keys_ = ("committed_rounds", "latency_p50_s", "latency_mean_s", "timeouts", "consensus_payloads_per_s")
    print(f"{phase}: regions {dict(sorted(regions.items()))}; latency floor {floor_s * 1e3:.1f} ms "
          f"(a leader in {floor_region}, quorum {quorum}); timeouts by leader region {dict(by_region)}; "
          f"(m) " + ", ".join(f"{k} {r[k]}" for k in keys_) + "; (e) "
          + ", ".join(f"{k} {base[k]}" for k in keys_)
          + f"; wire bytes a committed block by class {flows['per_block']} [{card}]")
    print(f"{phase}: proposal trips, leader region > node region: [min ms, median ms, the spec's one-way ms, "
          f"trips] {trip_ms} [{card}]")
    print(f"{phase} result: " + json.dumps({k: r[k] for k in (*keys_, "regions", "floor_s", "floor_region",
                                                               "timeouts_by_leader_region", "flows",
                                                               "proposal_trip_ms")}))
    return launches, r


# ---- (n) the chaos plane ----------------------------------------------------

RE_FAULT_ACTIVE = re.compile(r"Fault plane active: scenario '([^']+)' seed (\d+) \(node index (\d+), (\d+) link rules\)")
RE_SNAPSHOT_AT = re.compile(_TS + r" \[INFO\] telemetry\.(\S+) Telemetry snapshot: (\{.*\})")
FAULT_SEED = 17
FAULT_DRAIN_S = 5.0  # commits of rounds certified before a window opens may still land in it
FAULT_LEAD_S = 15.0  # from the committee's boot to a window's open: the client starts, commits begin


def fault_spec(tmp: str, committee, build, first: int = 0, **kw) -> tuple:
    """A spec of the port's ``faults.scenarios`` builder ``build`` over
    the committee file's addresses, scenario index i the member of
    sorted-key (leader) position ``first + i`` (mod n), its t=0
    (``epoch_unix``) now, written where ``--fault-plane`` reads it;
    returns (spec, path)."""
    keys = committee.sorted_keys()
    spec = build(nodes=len(keys), seed=FAULT_SEED, **kw)
    spec["nodes"] = {"%s:%d" % committee.address(keys[(first + i) % len(keys)]): i for i in range(len(keys))}
    spec["epoch_unix"] = time.time()
    path = os.path.join(tmp, "faults.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return spec, path


def commits_at(node_text: str) -> list:
    """(unix time, round) of every non-genesis ``Committed`` line."""
    return sorted((_ts(ts), int(rnd)) for ts, rnd, _ in RE_COMMITTED.findall(node_text) if int(rnd) > 0)


def loop_lag_ms(node_text: str, t0: float | None, t1: float) -> float | None:
    """The loop's mean lag between unix times ``t0`` (None: each node's
    first snapshot line) and ``t1``, from the
    nodes' ``Telemetry snapshot`` lines (every 5 s a node): each carries
    its 50 ms probe's cumulative mean and the seconds since it started,
    so a probe's samples are about elapsed / (0.05 s + mean) and the
    lag summed over them mean x samples; the window's mean is the
    difference of two such sums over the difference of their samples,
    averaged over the nodes (one loop, 64 probes)."""
    lines = collections.defaultdict(list)
    for ts, node, doc in RE_SNAPSHOT_AT.findall(node_text):
        d = json.loads(doc)
        if "loop_lag_mean_ms" in d:
            lines[node].append((_ts(ts), d["elapsed_s"], d["loop_lag_mean_ms"] / 1e3))
    means = []
    for rows in lines.values():
        before = rows[:1] if t0 is None else [r for r in rows if r[0] <= t0]
        upto = [r for r in rows if r[0] <= t1]
        if not before or not upto or upto[-1][0] <= before[-1][0]:
            continue
        (_, e0, m0), (_, e1, m1) = before[-1], upto[-1]
        n0, n1 = e0 / (0.05 + m0), e1 / (0.05 + m1)
        if n1 > n0:
            means.append((m1 * n1 - m0 * n0) / (n1 - n0) * 1e3)
    return sum(means) / len(means) if means else None


def split_brain_phase(card: str, base: dict, nodes: int = 64, rate: int = 1000, window_s: float = 10.0,
                      verifier: str = "cuda"):
    """(n1) (e)'s committee under the port's ``faults.scenarios.split_brain``:
    the committee file's 64 members cut 32 against 32 (quorum 43, so
    neither half has one) for ``window_s`` seconds, the window opening
    ``FAULT_LEAD_S`` after the boot (e) measured (``base``), handed to
    ``run-many --fault-plane <spec> --metrics-port 0 --journal-dir D``
    with the client's 1,000 tx/s of 512 B.  Every node logs ``Fault plane
    active`` with its index; some round commits before the window; no
    new round commits from its open plus ``FAULT_DRAIN_S`` to the heal; a
    new round commits within the scenario's ``liveness.resume_within_s``
    (20 s) of the heal; every committed round names one digest; every
    node's ``fault_plane`` section (``/snapshot`` after the resumption)
    has ``dropped > 0`` and ``inbound_dropped == 0``; every node journals
    ``fault.open`` and ``fault.close`` at the spec's times, within the
    loop's worst lag; K1 launches after boot.  Prints where the window
    fell against the first commit, the rounds and the loop's lag inside
    the window and before it, and the time to resume.  Returns the
    verify kernel's launches in the node process and what the logs
    say."""
    import tempfile

    from hotstuff_tpu_torch.faults import scenarios
    from hotstuff_tpu_torch.node.config import read_committee

    phase = "split-brain phase"
    at = base["boot_s"] + FAULT_LEAD_S
    until = at + window_s
    scraped: dict = {}
    with tempfile.TemporaryDirectory(prefix="split-brain-") as tmp, contextlib.ExitStack() as ports:
        held: list = []
        files = committee_files(tmp, nodes, phase, held=held)
        for sock in held:  # the member ports stay reserved through the run
            ports.enter_context(sock)
        committee = read_committee(files[1])
        spec, spec_path = fault_spec(tmp, committee, scenarios.split_brain, at=at, until=until)
        epoch, resume_within = spec["epoch_unix"], spec["liveness"]["resume_within_s"]
        open_at, heal_at = epoch + at, epoch + until
        node_log = os.path.join(ROOT, "chiprun_out", "split-brain_phase", "nodes.log")

        def during(node_log_path, client_log_path, client):
            port, _ = endpoint_and_load_start(phase, nodes, node_log_path, client_log_path, client)
            # wait for a round past every round committed before the
            # heal, committed after it, or the scenario's deadline
            deadline = heal_at + resume_within + 2.0
            while time.time() < deadline:
                with open(node_log_path) as f:
                    seen = commits_at(f.read())
                before = max((rnd for t, rnd in seen if t <= heal_at), default=0)
                if any(t > heal_at and rnd > before for t, rnd in seen):
                    break
                time.sleep(0.5)
            scraped["snapshot"] = json.loads(scrape(port, "/snapshot")["body"])

        jdir = os.path.join(tmp, "journals")
        # the load runs through the window and past the heal
        duration = max(20.0, until - base["boot_s"] + 5.0)
        launches, r = node_phase(card, nodes, rate, duration, verifier, label=phase, files=files,
                                 extra_args=("--fault-plane", spec_path, "--metrics-port", "0",
                                             "--journal-dir", jdir), during=during)
        journals = read_journals(jdir)
    with open(node_log) as f:
        node_text = f.read()
    active = RE_FAULT_ACTIVE.findall(node_text)
    check(sorted(int(i) for *_, i, _ in active) == list(range(nodes))
          and all(name == "split-brain" and int(seed) == FAULT_SEED for name, seed, _, _ in active),
          f"{phase}: every node logs 'Fault plane active' with its index ({len(active)} lines)")
    seen = commits_at(node_text)
    first = seen[0][0] if seen else None
    stall_from = open_at + FAULT_DRAIN_S
    pre = [rnd for t, rnd in seen if t <= open_at]
    pre_stall = [rnd for t, rnd in seen if t <= stall_from]
    inside = [rnd for t, rnd in seen if stall_from < t <= heal_at]
    before_heal = max((rnd for t, rnd in seen if t <= heal_at), default=0)
    resumed = [(t, rnd) for t, rnd in seen if t > heal_at and rnd > before_heal]
    resume_s = resumed[0][0] - heal_at if resumed else None
    check(bool(pre), f"{phase}: some round commits before the window opens (first commit at "
                     f"{None if first is None else round(first - epoch, 2)} s, window at {at:.2f} s)")
    check(not inside or max(inside) <= max(pre_stall),
          f"{phase}: no new round commits from the window's open + {FAULT_DRAIN_S} s to the heal "
          f"(last before {max(pre_stall, default=None)}, inside {sorted(set(inside))[:5]})")
    check(resume_s is not None and resume_s <= resume_within,
          f"{phase}: a new round commits within {resume_within} s of the heal ({resume_s})")
    check(r["rounds_agree"], f"{phase}: every committed round names one digest on every node")
    sections = [doc.get("fault_plane") for doc in scraped.get("snapshot", {}).values()]
    check(len(sections) == nodes and all(s is not None for s in sections),
          f"{phase}: a fault_plane section in every node's snapshot ({len(sections)})")
    check(all(s["dropped"] > 0 and s["inbound_dropped"] == 0 for s in sections),
          f"{phase}: every node dropped frames across the cut and swallowed none inbound "
          f"(dropped {min(s['dropped'] for s in sections)}-{max(s['dropped'] for s in sections)})")
    lag_max_s = max((json.loads(doc).get("loop_lag_max_ms", 0.0) for _, _, doc in RE_SNAPSHOT_AT.findall(node_text)),
                    default=0.0) / 1e3
    edges = collections.defaultdict(list)
    for recs in journals.values():
        for rec in recs:
            if rec["e"] in ("fault.open", "fault.close"):
                edges[rec["e"]].append((rec["p"], rec["w"] / 1e9 - epoch))
    for kind, want in (("fault.open", at), ("fault.close", until)):
        got = edges[kind]
        late = max((t - want for _, t in got), default=None)
        check(len(got) == nodes and all(p == "split-brain" and -0.05 <= t - want <= lag_max_s + 0.5
                                        for p, t in got),
              f"{phase}: every node journals {kind} at {want:.2f} s within the loop's worst lag "
              f"{lag_max_s:.3f} s ({len(got)} records, latest {late})")
    check(verifier == "cpu" or r["launches_after_boot"] > 0, f"{phase}: the verify kernel launched after boot")
    boot_at = r["boot_at"] - epoch if r["boot_at"] is not None else None
    rounds_in = len({rnd for t, rnd in seen if open_at < t <= heal_at})
    rounds_pre = len({rnd for t, rnd in seen if t <= open_at})
    lag_in = loop_lag_ms(node_text, open_at, heal_at)
    lag_pre = loop_lag_ms(node_text, None, open_at)
    out = {"at_s": at, "until_s": until, "boot_at_s": boot_at,
           "first_commit_s": None if first is None else first - epoch, "rounds_before": rounds_pre,
           "rounds_in_window": rounds_in, "last_round_before": max(pre_stall, default=None),
           "resume_s": resume_s, "resumed_round": resumed[0][1] if resumed else None,
           "loop_lag_before_ms": lag_pre, "loop_lag_in_window_ms": lag_in, "loop_lag_max_ms": lag_max_s * 1e3,
           "dropped": [min(s["dropped"] for s in sections), max(s["dropped"] for s in sections)],
           "edges_late_s": {k: max(t - (at if k == "fault.open" else until) for _, t in v)
                            for k, v in edges.items()}}
    r.update(split_brain=out)
    print(f"{phase}: window {at:.2f}-{until:.2f} s after the spec's t=0; boot at {boot_at} s, first commit at "
          f"{out['first_commit_s']} s; {rounds_pre} rounds committed before the window, {rounds_in} inside it "
          f"(last before the drain margin {out['last_round_before']}), round {out['resumed_round']} committed "
          f"{resume_s} s after the heal; loop lag mean {lag_pre} ms before the window, {lag_in} ms inside it "
          f"(worst {lag_max_s * 1e3:.1f} ms); fault edges late by {out['edges_late_s']} s [{card}]")
    print(f"{phase} result: " + json.dumps(out))
    return launches, r


def flapping_phase(card: str, base: dict, nodes: int = 64, rate: int = 1000, window_s: float = 12.0,
                   verifier: str = "cuda"):
    """(n2) (e)'s committee on the native transport under the port's
    ``faults.scenarios.flapping_link``: the link between the committee
    file's members 0 and 1 hard-drops for 1.5 s of every 3 s for
    ``window_s`` seconds (``run-many --transport native --fault-plane
    <spec> --metrics-port 0``).  At 64 nodes two members talk on their
    own link only around their turns to lead: a leader's proposal goes
    over the reliable sender, which holds it through a hard cut and
    draws no decision (the reference's contract), and a vote goes to the
    next round's leader over the best-effort sender, which drops it in a
    cut.  So scenario members 0 and 1 are the committee's leaders of two
    consecutive rounds that (e)'s round rate puts just inside the window:
    1 votes to 0 a round before 0 leads, 0 to 1 as 0 leads.  Quorum is
    never lost: rounds commit inside the window, every committed round
    names one digest, members 0 and 1 consult the plane on their link to
    each other, the only drops in the committee are theirs on that link
    (``/snapshot`` after the window), and K1 launches after boot.
    Returns the verify kernel's launches in the node process and what
    the logs say."""
    import tempfile

    from hotstuff_tpu_torch.faults import scenarios
    from hotstuff_tpu_torch.node.config import read_committee

    phase = "flapping phase"
    at = base["boot_s"] + FAULT_LEAD_S
    until = at + window_s
    scraped: dict = {}
    with tempfile.TemporaryDirectory(prefix="flapping-") as tmp, contextlib.ExitStack() as ports:
        held: list = []
        files = committee_files(tmp, nodes, phase, held=held)
        for sock in held:
            ports.enter_context(sock)
        committee = read_committee(files[1])
        # (e)'s rounds a second from its first commits, ~2 s after boot
        first = min(max(2, int(base["committed_rounds"] / 20.0 * (FAULT_LEAD_S - 2.0)) + 2), nodes - 2)
        spec, spec_path = fault_spec(tmp, committee, scenarios.flapping_link, first=first, at=at, until=until)
        epoch = spec["epoch_unix"]
        addr = {i: a for a, i in spec["nodes"].items()}

        def during(node_log_path, client_log_path, client):
            port, _ = endpoint_and_load_start(phase, nodes, node_log_path, client_log_path, client)
            time.sleep(max(0.0, epoch + until + 1.0 - time.time()))
            # and the pair's turns to lead are past (a slow run gets there late)
            deadline = epoch + until + 30.0
            while time.time() < deadline:
                with open(node_log_path) as f:
                    if any(rnd >= first + 2 for _, rnd in commits_at(f.read())):
                        break
                time.sleep(0.5)
            scraped["snapshot"] = json.loads(scrape(port, "/snapshot")["body"])

        duration = max(20.0, until - base["boot_s"] + 3.0)
        launches, r = node_phase(card, nodes, rate, duration, verifier, transport="native", label=phase,
                                 files=files, extra_args=("--fault-plane", spec_path, "--metrics-port", "0"),
                                 during=during)
    with open(os.path.join(ROOT, "chiprun_out", "flapping_phase", "nodes.log")) as f:
        node_text = f.read()
    active = RE_FAULT_ACTIVE.findall(node_text)
    check(sorted(int(i) for *_, i, _ in active) == list(range(nodes)),
          f"{phase}: every node logs 'Fault plane active' with its index ({len(active)} lines)")
    seen = commits_at(node_text)
    open_at, close_at = epoch + at, epoch + until
    inside = sorted({rnd for t, rnd in seen if open_at < t <= close_at})
    before = max((rnd for t, rnd in seen if t <= open_at), default=0)
    check(len(inside) >= 2 and inside[-1] > before,
          f"{phase}: rounds commit through the window ({len(inside)} rounds inside, last before it {before})")
    check(r["rounds_agree"], f"{phase}: every committed round names one digest on every node")
    sections = {s["node"]: s for s in (doc.get("fault_plane") for doc in scraped.get("snapshot", {}).values())
                if s is not None}
    check(sorted(sections) == list(range(nodes)), f"{phase}: a fault_plane section from every node")
    link01 = sections[0]["links"].get(addr[1], {"seq": 0, "dropped": 0})
    link10 = sections[1]["links"].get(addr[0], {"seq": 0, "dropped": 0})
    others = {i: (s["dropped"], s["links"]) for i, s in sections.items()
              if i not in (0, 1) and (s["dropped"] or s["links"])}
    check(link01["seq"] > 0 and link10["seq"] > 0,
          f"{phase}: members 0 and 1 consult the plane on their link to each other "
          f"(decisions 0->1 {link01['seq']}, 1->0 {link10['seq']})")
    check(sections[0]["dropped"] == link01["dropped"] and sections[1]["dropped"] == link10["dropped"]
          and set(sections[0]["links"]) <= {addr[1]} and set(sections[1]["links"]) <= {addr[0]},
          f"{phase}: members 0 and 1 drop only on their link to each other")
    check(not others, f"{phase}: no other member has a fault view or drops a frame ({others})")
    check(verifier == "cpu" or r["launches_after_boot"] > 0, f"{phase}: the verify kernel launched after boot")
    out = {"at_s": at, "until_s": until, "members_0_1_at_leader_positions": [first, first + 1],
           "rounds_before": len({rnd for t, rnd in seen if t <= open_at}), "rounds_in_window": len(inside),
           "first_round_in_window": inside[0] if inside else None, "last_round_in_window": inside[-1] if inside
           else None, "link_0_to_1": link01, "link_1_to_0": link10,
           "loop_lag_in_window_ms": loop_lag_ms(node_text, open_at, close_at),
           "loop_lag_before_ms": loop_lag_ms(node_text, None, open_at)}
    r.update(flapping=out)
    print(f"{phase}: window {at:.2f}-{until:.2f} s, link 0<->1 (the leaders of rounds {first} and {first + 1} "
          f"mod {nodes}) down 1.5 s of every 3; {out['rounds_before']} rounds before it, {len(inside)} inside it "
          f"({out['first_round_in_window']}-{out['last_round_in_window']}); 0->1 {link01}, 1->0 {link10} "
          f"(decisions, drops), elsewhere none; "
          f"loop lag mean {out['loop_lag_before_ms']} ms before, {out['loop_lag_in_window_ms']} ms inside; "
          f"(e) committed {base['committed_rounds']} rounds in 20 s [{card}]")
    print(f"{phase} result: " + json.dumps(out))
    return launches, r


# ---- (o) the adversary plane -------------------------------------------------

RE_ADVERSARY_ACTIVE = re.compile(r"Adversary plane active: scenario '([^']+)' seed (\d+) \(node index (\d+), "
                                 r"policies \[([^\]]*)\]\)")
RE_BYZ = re.compile(_TS + r" \[INFO\] hotstuff_tpu_torch\.consensus\.(?:core|proposer)\.(\S+) "
                    r"byz (equivocate|forge-qc|double-vote|withhold)(?: vote)? round (\d+)(.*)")
RE_NODE_COMMIT = re.compile(_TS + r" \[INFO\] hotstuff_tpu_torch\.consensus\.core\.(\S+) Committed block (\d+) -> (\S+)")
ADV_SEED = 19
ADV_LEAD_S = 8.0  # from (e)'s boot to the withhold window's open: the client starts, the first rounds commit
ADV_WITHHOLD_S = 6.0  # the withhold window
# the attackers' scenario indexes: the committee file's members at leader
# positions ADV_FIRST, ADV_FIRST + 1, ...: the equivocator leads round
# ADV_FIRST, one of the first rounds that carry the client's payloads
ADV_FIRST = 3
ADV_POLICIES = ("equivocate", "forge-qc", "double-vote", "withhold")


def adversary_spec(tmp: str, committee, at: float, until: float, first: int = ADV_FIRST) -> tuple:
    """The reference scenarios' rules over four distinct attackers:
    ``byz_equivocate`` and ``byz_forge_qc`` as built (open from t = 2 s,
    before any round), double-vote in the same rule form, and
    ``byz_withhold`` over [``at``, ``until``]; scenario index i the
    member at sorted-key (leader) position ``first + i`` (mod n), written
    where ``--adversary`` reads it; returns (spec, path)."""
    from hotstuff_tpu_torch.faults import scenarios

    keys = committee.sorted_keys()
    n = len(keys)
    equivocate = scenarios.byz_equivocate(nodes=n, seed=ADV_SEED)
    forge = scenarios.byz_forge_qc(nodes=n, seed=ADV_SEED)
    double = {**equivocate["adversary"][0], "policy": "double-vote"}
    withhold = scenarios.byz_withhold(nodes=n, seed=ADV_SEED, at=at, until=until)
    rules = []
    for index, rule in enumerate((equivocate["adversary"][0], forge["adversary"][0], double,
                                  withhold["adversary"][0])):
        rules.append({**rule, "node": index})
    spec = {"name": "byz-mixed", "seed": ADV_SEED, "rules": [], "adversary": rules,
            "liveness": withhold["liveness"],
            "nodes": {"%s:%d" % committee.address(keys[(first + i) % n]): i for i in range(n)},
            "epoch_unix": time.time()}
    path = os.path.join(tmp, "adversary.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return spec, path


def adversary_kernel_check(card: str, nodes: int = 64, torch_device=None) -> dict:
    """(o)'s direct check of the kernels on the honest side: the forged
    QCs that the port's ``AdversaryPlane.forged_qc`` builds for a
    ``nodes``-member committee (quorum 43: real authors, garbage
    signatures) through ``make_verifier("cuda")``, three of them in one
    ``verify_many`` (129 claims, the device route) and each through
    ``QC.verify``; then the same claims staged by a ``BatchVerifier``
    and K1's lanes against the plain version's and the oracle's, all
    false.  On a BLS committee of the same size, ``forged_compact_qc``
    through ``QC.verify`` on ``make_verifier("cuda", "bls")`` (the key
    sum and one pairing: no G1 kernel on that path), and the forged
    certificate's 43 signers replayed, each with its real signature on
    another block, as a vote list for the forged digest through
    ``verify_shared_msg``, whose vote sum is B4's on the card: both
    rejected, the sum equal to the host's.  Returns the launches through
    the wrappers a node calls (the comparisons' launches apart)."""
    from hotstuff_tpu_torch.consensus import Committee
    from hotstuff_tpu_torch.consensus.errors import ConsensusError
    from hotstuff_tpu_torch.crypto import Digest
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref
    from hotstuff_tpu_torch.crypto.bls.curve import G1Point
    from hotstuff_tpu_torch.crypto.scheme import keygen_deterministic, make_signing_service
    from hotstuff_tpu_torch.faults import AdversaryPlane
    from hotstuff_tpu_torch.gpu import bls as G
    from hotstuff_tpu_torch.gpu import dsm
    from hotstuff_tpu_torch.gpu.ed25519 import BatchVerifier, resolve_device
    from hotstuff_tpu_torch.node.node import make_verifier

    phase = "adversary kernel check"
    on_card = resolve_device(torch_device).type == "cuda"  # a CPU rehearsal runs the plain versions
    t0 = time.perf_counter()
    seed = b"\x19" * 32
    addr = lambda i: ("127.0.0.1", 7000 + i)  # noqa: E731
    spec = {"seed": ADV_SEED, "nodes": {"%s:%d" % addr(i): i for i in range(nodes)},
            "adversary": [{"policy": "forge-qc", "node": 1}]}
    ed_keys = [keygen_deterministic("ed25519", seed, i) for i in range(nodes)]
    committee = Committee.new([(pk, 1, addr(i)) for i, (pk, _) in enumerate(ed_keys)])
    plane = AdversaryPlane(spec, addr(1))
    forged = [plane.forged_qc(committee, r) for r in (7, 8, 9)]
    quorum = committee.quorum_threshold()
    check(all(len(qc.votes) == quorum for qc in forged), f"{phase}: a forged QC names {quorum} authors")
    for qc in forged:
        qc.check_weight(committee)  # a quorum by stake: only the signatures give it away
    msgs, raw_pks, raw_sigs = [], [], []
    for qc in forged:
        for pk, sig in qc.votes:
            msgs.append(qc.digest().to_bytes())
            raw_pks.append(pk.to_bytes())
            raw_sigs.append(sig.to_bytes())
    verifier = make_verifier("cuda", device=torch_device)
    verifier.precompute([pk.to_bytes() for pk, _ in ed_keys])
    verifier.warmup(256)
    dsm.reset_launches()
    G.reset_launches()
    verdicts = verifier.verify_many(msgs, raw_pks, raw_sigs)
    k1_route = dsm.launches["verify_compressed"]
    rejected = 0
    for qc in forged:
        try:
            qc.verify(committee, verifier)
        except ConsensusError:
            rejected += 1
    check(verifier.routes["device"] >= 1 and (k1_route > 0 or not on_card),
          f"{phase}: {len(msgs)} forged claims took the device route (K1 launches {k1_route})")
    check(not any(verdicts), f"{phase}: every forged claim is rejected through make_verifier('cuda')")
    check(rejected == len(forged), f"{phase}: QC.verify rejects every forged QC ({rejected})")
    # K1's lanes on the same claims against the plain version and the oracle
    v = BatchVerifier(min_device_batch=0, device=torch_device)
    v.precompute([pk.to_bytes() for pk, _ in ed_keys])
    valid_host, arrays = v.prepare(msgs, raw_pks, raw_sigs)
    ax, ay, az, at, s_win, k_win, r_y, r_sign = (a.clone() for a in arrays)
    lanes = dsm.verify_compressed(s_win, k_win, (ax, ay, az, at), r_y, r_sign)
    plain = dsm.plain_verify_compressed(s_win, k_win, (ax, ay, az, at), r_y, r_sign)
    lanes_k = lanes.cpu().numpy()
    oracle_v = [ref.verify(s, p, m) for m, p, s in zip(msgs, raw_pks, raw_sigs)]
    err = int((lanes.int() - plain.int()).abs().max())
    check(err == 0, f"{phase}: K1's lanes equal the plain version's ({len(lanes_k)} lanes)")
    got = (lanes_k[:len(msgs)] & valid_host).tolist()
    check(got == oracle_v and not any(got), f"{phase}: K1's lanes are the oracle's, all false")
    # BLS: the forged compact QC, and its signers' real signatures replayed
    bls_keys = [keygen_deterministic("bls", seed, i) for i in range(nodes)]
    bls_committee = Committee.new([(pk, 1, addr(i)) for i, (pk, _) in enumerate(bls_keys)], scheme="bls")
    compact = plane.forged_compact_qc(bls_committee, 7)
    bls_verifier = make_verifier("cuda", "bls", device=torch_device)
    bls_verifier.precompute([pk.to_bytes() for pk, _ in bls_keys])
    b4_before = G.launches["g1_aggregate"]
    try:
        compact.verify(bls_committee, bls_verifier)
        compact_rejected = False
    except ConsensusError:
        compact_rejected = True
    b4_compact = G.launches["g1_aggregate"] - b4_before
    check(compact_rejected, f"{phase}: QC.verify rejects the forged compact QC")
    secrets = dict(bls_keys)
    signers = compact.signer_keys(bls_committee)
    other = Digest.of(b"a block the signers did vote for")
    replay = [(pk, make_signing_service("bls", secrets[pk]).sign_sync(other)) for pk in signers]
    accepted = bls_verifier.verify_shared_msg(compact.digest(), replay)
    b4_replay = G.launches["g1_aggregate"] - b4_before - b4_compact
    check(not accepted and (b4_replay > 0 or not on_card),
          f"{phase}: the replayed signatures are rejected for the forged digest, summed by B4 "
          f"({b4_replay} launches)")
    check(bls_verifier.verify_shared_msg(other, replay), f"{phase}: ... and accepted for their own digest")
    launches = {"k1": k1_route, "b4": G.launches["g1_aggregate"]}  # the comparison below apart
    points = [G1Point.from_bytes(sig.to_bytes(), subgroup_check=False) for _, sig in replay]
    device_sum = bls_verifier._dev_agg.aggregate(points)
    check(device_sum == G1Point.sum(points), f"{phase}: B4's sum of the replayed votes is the host's")
    wall = time.perf_counter() - t0
    out = {"claims": len(msgs), "k1_route_launches": k1_route, "forged_rejected": rejected,
           "host_invalid": int((~valid_host).sum()), "k1_vs_plain_err": err, "compact_rejected": compact_rejected,
           "b4_on_compact_path": b4_compact, "b4_replay_launches": b4_replay, "wall_s": wall}
    print(f"{phase}: {len(forged)} forged QCs of {quorum} authors ({len(msgs)} claims, "
          f"{out['host_invalid']} refused by host decoding) rejected through make_verifier('cuda') on the "
          f"device route ({k1_route} K1 launches) and by QC.verify; K1's lanes equal the plain version's and "
          f"the oracle's, all false; the forged compact QC rejected ({b4_compact} B4 launches on its path: key "
          f"sum and one pairing), its {len(signers)} signers' replayed votes rejected after B4 summed them "
          f"({b4_replay} launches); {wall:.1f} s [{card}]")
    print(f"{phase} result: " + json.dumps(out))
    return launches


def adversary_phase(card: str, base: dict, nodes: int = 64, rate: int = 1000, duration: float = 20,
                    verifier: str = "cuda"):
    """(o) (e)'s committee under the adversary plane: ``run-many
    --adversary <spec>`` with the client's 1,000 tx/s of 512 B for
    ``duration`` s, the spec ``adversary_spec``'s four attackers (the
    equivocator the leader of round ``ADV_FIRST``; forge-qc, double-vote
    and withhold the next three leaders), the withhold window opening
    ``ADV_LEAD_S`` after the boot (e) measured and closing
    ``ADV_WITHHOLD_S`` later.  Checks: the four planes armed with their
    policies; every attacker logs its policy firing; the 60 honest nodes
    hold one digest a committed round and one root a version, and none
    committed a shadow digest (the equivocator's second block or the
    double vote's); rounds commit before the withhold window, inside it
    and after it, a new one within the withhold scenario's
    ``liveness.resume_within_s`` of its close; K1 after boot and the
    device waves in the last stats line; no traceback and a stop within
    60 s of SIGTERM (``node_phase``).  Returns the verify kernel's
    launches in the node process and what the logs say."""
    import tempfile

    from hotstuff_tpu_torch.node.config import read_committee

    phase = "adversary phase"
    at = base["boot_s"] + ADV_LEAD_S
    until = at + ADV_WITHHOLD_S
    first = ADV_FIRST
    with tempfile.TemporaryDirectory(prefix="adversary-") as tmp, contextlib.ExitStack() as ports:
        held: list = []
        files = committee_files(tmp, nodes, phase, held=held)
        for sock in held:
            ports.enter_context(sock)
        committee = read_committee(files[1])
        spec, spec_path = adversary_spec(tmp, committee, at, until)
        epoch, resume_within = spec["epoch_unix"], spec["liveness"]["resume_within_s"]
        open_at, close_at = epoch + at, epoch + until
        keys = committee.sorted_keys()
        tags = {str(keys[(first + i) % nodes])[:8]: i for i in range(len(ADV_POLICIES))}

        def during(node_log_path, client_log_path, client):
            # the equivocator's turn, and a round after the withhold
            # window, or the scenario's deadline
            deadline = close_at + resume_within + 2.0
            while time.time() < deadline:
                with open(node_log_path) as f:
                    seen = commits_at(f.read())
                before = max((rnd for t, rnd in seen if t <= close_at), default=0)
                if (any(rnd >= first + 2 for _, rnd in seen)
                        and any(t > close_at and rnd > before for t, rnd in seen)):
                    break
                time.sleep(0.5)

        launches, r = node_phase(card, nodes, rate, duration, verifier, label=phase, files=files,
                                 extra_args=("--adversary", spec_path), during=during)
    with open(os.path.join(ROOT, "chiprun_out", "adversary_phase", "nodes.log")) as f:
        node_text = f.read()
    armed = {int(i): p for name, seed, i, p in RE_ADVERSARY_ACTIVE.findall(node_text)
             if name == "byz-mixed" and int(seed) == ADV_SEED}
    check(armed == dict(enumerate(ADV_POLICIES)),
          f"{phase}: the four attackers, and only they, log 'Adversary plane active' with their policy ({armed})")
    fired = collections.defaultdict(list)
    shadows = set()
    for ts, tag, policy, rnd, rest in RE_BYZ.findall(node_text):
        fired[(tags.get(tag), policy)].append(int(rnd))
        if policy == "equivocate":
            shadows.add(rest.split("|")[1].split()[0])
        elif policy == "double-vote":
            shadows.add(rest.split("-> ")[1].strip())
    counts = {p: len(fired[(i, p)]) for i, p in enumerate(ADV_POLICIES)}
    check(all(counts.values()), f"{phase}: every attacker logs its policy firing ({counts})")
    check(sum(len(v) for v in fired.values()) == sum(counts.values()),
          f"{phase}: no other node logs a firing")
    by_round = collections.defaultdict(set)
    honest_lines = 0
    for ts, tag, rnd, digest in RE_NODE_COMMIT.findall(node_text):
        if tag not in tags and int(rnd) > 0:
            by_round[int(rnd)].add(digest)
            honest_lines += 1
    roots = collections.defaultdict(set)
    for logger, version, root, _rnd in RE_STATE_ROOT.findall(node_text):
        if logger.rsplit(".", 1)[-1] not in tags:
            roots[int(version)].add(root)
    check(honest_lines >= (nodes - len(tags)) * 5 and all(len(d) == 1 for d in by_round.values()),
          f"{phase}: the {nodes - len(tags)} honest nodes hold one digest a committed round "
          f"({len(by_round)} rounds, {honest_lines} lines)")
    check(roots and all(len(rs) == 1 for rs in roots.values()),
          f"{phase}: the honest nodes report one state root a version ({len(roots)} versions)")
    committed = set().union(*by_round.values()) if by_round else set()
    check(shadows and not shadows & committed,
          f"{phase}: no honest node committed a shadow digest ({len(shadows)} shadow digests)")
    seen = commits_at(node_text)
    before = {rnd for t, rnd in seen if t <= open_at}
    inside = {rnd for t, rnd in seen if open_at < t <= close_at}
    last_before_close = max((rnd for t, rnd in seen if t <= close_at), default=0)
    resumed = [(t, rnd) for t, rnd in seen if t > close_at and rnd > last_before_close]
    resume_s = resumed[0][0] - close_at if resumed else None
    check(bool(before) and bool(inside) and bool(resumed),
          f"{phase}: rounds commit before the withhold window ({len(before)}), inside it ({len(inside)}) "
          f"and after it ({len(resumed)} commit lines)")
    check(resume_s is not None and resume_s <= resume_within,
          f"{phase}: a new round commits within {resume_within} s of the withhold window's close ({resume_s})")
    check(verifier == "cpu" or (r["launches_after_boot"] > 0 and r["stats"] is not None),
          f"{phase}: the verify kernel launched after boot, and the last stats line shows the device waves")
    withheld = sorted(set(fired[(3, "withhold")]))
    out = {"at_s": at, "until_s": until, "equivocator_leads": first, "firings": counts,
           "equivocated_rounds": sorted(set(fired[(0, "equivocate")])),
           "withheld_rounds": [withheld[0], withheld[-1]], "rounds_before": len(before),
           "rounds_in_withhold": len(inside), "rounds_after": len({rnd for t, rnd in seen if t > close_at}),
           "resume_s": resume_s, "shadow_digests": len(shadows), "honest_rounds": len(by_round),
           "timeouts": r["timeouts"]}
    r.update(adversary=out)
    print(f"{phase}: withhold's window {at:.2f}-{until:.2f} s after the spec's t=0 (the others open at "
          f"{spec['adversary'][0]['at']} s); the equivocator leads round {first} mod {nodes}; firings {counts}; "
          f"{len(before)} rounds before the withhold window, {len(inside)} inside it, {out['rounds_after']} "
          f"after it, the first new one "
          f"{resume_s} s after the close; {len(shadows)} shadow digests, none committed; {r['timeouts']} "
          f"timeouts; (e) committed {base['committed_rounds']} rounds in 20 s [{card}]")
    print(f"{phase} result: " + json.dumps(out))
    return launches, r


# ---- (k) BLS at BASELINE config 5's size ------------------------------------

G1_B4_SHAPES = ((171, 256), (171, 512), (1024, 1024))  # (points, B); 171 -> 512 is the aggregator's pad
G1_CHAIN = 512  # B6: a committee of 512 chains 512 adds
G1_CHAIN_PLAIN = 64  # ... the first 64 also through the plain version (7,000 launches an add)
G1_LADDER = 171  # B7 at 128 bits, the weights' width
G1_STORM_LANES = 3 * QUORUM  # the storm offload's ladder: 513 points padded to 1024 ...
G1_STORM_BITS = 256  # ... of 256-bit scalars (w * h_eff, and the group order)
# The one-thread-an-addition kernels' times (PERF.md section 6, their
# chip_smoke.py run on an H100 80GB HBM3 at 700 W), printed beside the
# team kernels' as the earlier ones
G1_EARLIER_MS = {"b4": {256: 0.428, 512: 0.493, 1024: 0.651, "mont": 0.432},
                 "b7_171": 11.642, "b7_storm": 24.488, "b6": 0.0748}
G1_BURSTS = (2 * ((64 - 1) // 3) + 1, QUORUM)  # B6: a quorum's votes at n = 64 (43) and n = 256 (171) ...
G1_BURST_REPS = 5  # ... each burst this many times, on a fresh running sum


def g1_bound(point_adds: int, nbytes: int):
    """(ms, "operations" | "bytes"): the int32 multiply-adds of
    ``point_adds`` point additions (``gpu.bls.MADS_PER_ADD``) over the
    card's int32 rate, or the bytes over its memory rate, the larger."""
    from hotstuff_tpu_torch.gpu import bls as G

    t_ops = point_adds * G.MADS_PER_ADD / INT32_MADS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ladder_adds(scalars) -> int:
    """The point additions a double-and-add ladder needs for these
    scalars: below each scalar's top set bit, a doubling a bit and an add
    a set bit (a zero scalar, a pad lane, needs none)."""
    return sum(k.bit_length() - 1 + bin(k).count("1") - 1 for k in scalars if k)


def ptxas_lines(library: str, kernel: str) -> list:
    """The ``-Xptxas -v`` lines of one kernel's entry (stack frame,
    spills, registers) from the library's build report."""
    from hotstuff_tpu_torch.gpu import _build

    report = _build.library_path(library).with_suffix(".ptxas.txt")
    if not report.exists():
        return ["no ptxas report"]
    out, inside = [], False
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("stack frame" in line or "registers" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def g1_points(n: int, seed: int):
    """n subgroup points made from a seed: k0*G, then steps of d*G."""
    import random

    from hotstuff_tpu_torch.crypto.bls.curve import G1Point

    rng = random.Random(seed)
    p = G1Point.generator().mul(rng.randrange(1, 2**64))
    d = G1Point.generator().mul(rng.randrange(1, 2**64))
    out = []
    for _ in range(n):
        out.append(p)
        p = p + d
    return out


def b6_times(card: str, dev, acc, chain) -> dict:
    """B6's device time a launch (``covered_cuda_ms``: the host out of the
    window) and back to back (``cuda_ms``: the enqueue in it), over
    ``G1_CHAIN`` launches that add ``chain[0]`` to ``acc``; an empty
    launch's time taken the same way (``torch.cuda._sleep(0)``), the
    floor of a launch a vote; and the host clock of
    ``G1RunningSum.snapshot()`` after back-to-back bursts of ``G1_BURSTS``
    votes of ``chain`` (a leader draining a quorum's votes, then forming
    the QC), each sum against the oracle.  Prints the bursts; returns
    the numbers."""
    import torch

    from hotstuff_tpu_torch.crypto.bls.curve import G1Point
    from hotstuff_tpu_torch.gpu import bls as G

    p = chain[0]
    b6_b2b_ms = cuda_ms(lambda: G.running_add_(acc, p.x, p.y), G1_CHAIN)
    b6_ms, b6_covered = covered_cuda_ms(lambda: G.running_add_(acc, p.x, p.y), G1_CHAIN)
    floor_ms, floor_covered = covered_cuda_ms(lambda: torch.cuda._sleep(0), G1_CHAIN)
    check(b6_covered and floor_covered, "B6's and the empty launch's windows hold no host enqueue")
    # a leader draining a quorum's votes in one burst, then forming the QC
    bursts = {}
    for n_votes in G1_BURSTS:
        want = G1Point.sum(chain[:n_votes])
        adds, snaps = [], []
        for _ in range(G1_BURST_REPS):
            b = G.G1RunningSum(device=dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for q in chain[:n_votes]:
                b.add(q)
            t1 = time.perf_counter()
            got = b.snapshot()
            t2 = time.perf_counter()
            check(got == want, f"G1RunningSum.snapshot() after a burst of {n_votes} votes vs the oracle")
            adds.append((t1 - t0) * 1e3)
            snaps.append((t2 - t1) * 1e3)
        bursts[n_votes] = {"adds_ms": sum(adds) / len(adds), "snapshot_ms": sum(snaps) / len(snaps),
                           "snapshot_min_ms": min(snaps), "snapshot_max_ms": max(snaps)}
    for n_votes, r in bursts.items():
        print(f"B6 burst of {n_votes} votes: G1RunningSum.add x {n_votes} {r['adds_ms']:.3f} ms, then snapshot() "
              f"{r['snapshot_ms']:.3f} ms host clock (mean of {G1_BURST_REPS}, range {r['snapshot_min_ms']:.3f}-"
              f"{r['snapshot_max_ms']:.3f}); every sum the oracle's [{card}]")
    return {"ms": b6_ms, "b2b_ms": b6_b2b_ms, "floor_ms": floor_ms, "bursts": bursts}


def g1_phase(card: str, torch_device=None) -> dict:
    """(k1) The three G1 kernels against their plain versions on the card
    and against the oracle (``crypto/bls/curve.py``): B4 at B = 256 (171
    points), 512 (171, the aggregator's pad) and 1024; B6 over a 512-vote
    chain (the first 64 votes beside the plain version), then the host
    time of ``G1RunningSum.snapshot()`` after back-to-back bursts of
    ``G1_BURSTS`` votes, each sum against the oracle; B7 at B = 171
    with 128-bit scalars, and at the storm offload's shape (513 points
    padded to 1024 lanes, 256 bits: every lane against the plain version,
    every real lane against the oracle), and on the storm offload's own
    scalars (every real lane against the oracle); B4 in the storm's mode,
    on the ladder's Montgomery rows padded to 256.  X, Y, Z are compared
    as integers mod q (the kernels return canonical rows, the plain
    versions loose ones): the tolerance is zero.  20 back-to-back
    launches of each kernel give equal results; CUDA-event times of
    each kernel (beside the earlier ones, ``G1_EARLIER_MS``; B6 with the
    host out of the window, ``covered_cuda_ms``, beside its back-to-back
    time, which holds the host's enqueue, and beside an empty launch's
    time taken the same way, the floor of a launch a vote) and plain
    version, the host route's time for the same sums, the bounds (the
    additions the data needs: n - 1 for n points, ``ladder_adds`` for the
    scalars), and the ptxas lines of the three kernels.  Returns the
    numbers of the kernels line."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.crypto.bls.curve import G1Point
    from hotstuff_tpu_torch.crypto.bls.fields import P as Q
    from hotstuff_tpu_torch.gpu import bls as G

    dev = torch.device(torch_device or "cuda")
    t_phase = time.perf_counter()

    def mod_q(rows):
        return [G.limbs_to_int(r) % Q for r in rows]

    def err(a, b) -> int:
        return max(abs(x - y) for x, y in zip(mod_q(a), mod_q(b)))

    def affine(rows):
        return G.projective_to_affine(*(r.cpu().numpy() for r in rows))

    def plain_rows(points, batch):
        rows = np.zeros((3, batch, G.NLIMBS), np.int32)
        m = len(points)
        rows[0, :m] = G.ints_to_limbs_batch([p.x for p in points])
        rows[1, :m] = G.ints_to_limbs_batch([p.y for p in points])
        rows[2, :m, 0] = 1
        rows[1, m:, 0] = 1
        return torch.from_numpy(rows).to(dev)

    out = {}
    pts = g1_points(1024, seed=5)
    G.reset_launches()
    # B4: the tree sum
    b4 = {"err": 0}
    for n, batch in G1_B4_SHAPES:
        rows = plain_rows(pts[:n], batch).unbind(0)
        want = G1Point.sum(pts[:n])
        got = G.aggregate(*rows, plain=True)
        box = {}
        plain_ms = cuda_ms(lambda: box.__setitem__("p", G.aggregate_plain(*rows)), 1)
        e = err(got, box["p"])
        b4["err"] = max(b4["err"], e)
        check(e == 0, f"g1_aggregate_kernel vs plain at B={batch} ({n} points)")
        check(affine(got) == want, f"g1_aggregate_kernel vs the oracle at B={batch}")
        check(affine(box["p"]) == want, f"the plain tree vs the oracle at B={batch}")
        reps = [G.aggregate(*rows, plain=True) for _ in range(REPEATED_LAUNCHES)]
        check(all(all(torch.equal(a, b) for a, b in zip(r, got)) for r in reps),
              f"g1_aggregate_kernel: {REPEATED_LAUNCHES} back-to-back launches at B={batch} equal")
        ms = cuda_ms(lambda: G.aggregate(*rows, plain=True), TIMED_LAUNCHES)
        t0 = time.perf_counter()
        G1Point.sum(pts[:n])
        host_ms = (time.perf_counter() - t0) * 1e3
        # the additions the data needs: n - 1 (the pads are identities)
        bound = g1_bound(n - 1, 3 * batch * G.NLIMBS * 4 + 3 * G.NLIMBS * 4)
        b4[batch] = {"ms": ms, "plain_ms": plain_ms, "bound": bound, "host_ms": host_ms}
        print(f"B4 g1_aggregate_kernel B={batch} ({n} points): {ms:.4f} ms CUDA events (mean of "
              f"{TIMED_LAUNCHES}; earlier {G1_EARLIER_MS['b4'][batch]} ms), plain {plain_ms:.1f} ms, bound {bound[0]:.6f} ms ({bound[1]}), host route "
              f"(G1Point.sum, Jacobian) {host_ms:.2f} ms; X, Y, Z equal the plain version's mod q, the point "
              f"the oracle's; {REPEATED_LAUNCHES} launches equal [{card}]")
    agg = G.G1Aggregator(device=dev)
    agg.aggregate(pts[:QUORUM])
    t0 = time.perf_counter()
    for _ in range(QC_CALLS):
        check(agg.aggregate(pts[:QUORUM]) == G1Point.sum(pts[:QUORUM]), "G1Aggregator at a 171-vote QC")
    e2e_ms = (time.perf_counter() - t0) / QC_CALLS * 1e3
    print(f"G1Aggregator.aggregate, 171 votes (pad 512): {e2e_ms:.3f} ms host clock (staging, launch, readback "
          f"and the Fq inversion to affine), mean of {QC_CALLS} [{card}]")
    out["g1_aggregate_kernel"] = {"b4": b4, "e2e_ms": e2e_ms}

    # B6: the running sum, one launch a vote
    chain = g1_points(G1_CHAIN, seed=6)
    s = G.G1RunningSum(device=dev)
    plain = G.G1RunningSum(device=dev)._acc
    pz = torch.zeros((1, G.NLIMBS), dtype=torch.int32, device=dev)
    pz[0, 0] = 1
    plain_total = 0.0
    for p in chain[:G1_CHAIN_PLAIN]:
        s.add(p)
        px = torch.from_numpy(G.ints_to_limbs_batch([p.x])).to(dev)
        py = torch.from_numpy(G.ints_to_limbs_batch([p.y])).to(dev)
        box = {}
        plain_total += cuda_ms(lambda: box.__setitem__(
            "p", G.running_add_plain(plain[0:1], plain[1:2], plain[2:3], px, py, pz)), 1)
        plain = torch.cat(box["p"], dim=0)
    b6_err = err(s._acc, plain)
    check(b6_err == 0, f"g1_running_add_kernel vs plain over {G1_CHAIN_PLAIN} chained votes")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for p in chain[G1_CHAIN_PLAIN:]:
        s.add(p)
    host_us = (time.perf_counter() - t0) / (G1_CHAIN - G1_CHAIN_PLAIN) * 1e6
    check(s.snapshot() == G1Point.sum(chain), f"g1_running_add_kernel over a {G1_CHAIN}-vote chain vs the oracle")
    base = s._acc.clone()
    p = chain[0]
    reps = []
    for _ in range(REPEATED_LAUNCHES):
        acc = base.clone()
        G.running_add_(acc, p.x, p.y)
        reps.append(acc)
    check(all(torch.equal(a, reps[0]) for a in reps), f"g1_running_add_kernel: {REPEATED_LAUNCHES} launches equal")
    check(affine(reps[0].unbind(0)) == G1Point.sum(chain) + p, "g1_running_add_kernel: one more vote vs the oracle")
    scratch = base.clone()
    times = b6_times(card, dev, scratch, chain)
    t0 = time.perf_counter()
    host = G1Point.identity()
    for q in chain:
        host = host + q
    host_add_us = (time.perf_counter() - t0) / G1_CHAIN * 1e6
    b6_plain_ms = plain_total / G1_CHAIN_PLAIN
    b6_bound = g1_bound(1, 2 * 3 * G.NLIMBS * 4 + 96)
    print(f"B6 g1_running_add_kernel: {times['ms'] * 1e3:.2f} us a launch CUDA events with the host out of the "
          f"window (mean of {G1_CHAIN}; earlier {G1_EARLIER_MS['b6'] * 1e3:.1f} us), {times['b2b_ms'] * 1e3:.2f} us "
          f"back to back (enqueue included), empty launch {times['floor_ms'] * 1e3:.2f} us (the floor of a launch a "
          f"vote), {host_us:.1f} us host clock a vote (G1RunningSum.add, no synchronisation), plain {b6_plain_ms:.1f} ms "
          f"an add, bound {b6_bound[0] * 1e3:.4f} us ({b6_bound[1]}), host route (affine add) {host_add_us:.1f} us; "
          f"{G1_CHAIN}-vote chain equals the oracle, the first {G1_CHAIN_PLAIN} the plain chain mod q [{card}]")
    out["g1_running_add_kernel"] = dict(times, plain_ms=b6_plain_ms, bound=b6_bound, err=b6_err,
                                        host_us=host_us, host_add_us=host_add_us)

    # B7: the ladder
    import random

    rng = random.Random(7)
    ks = [rng.randrange(1 << 128) for _ in range(G1_LADDER)]
    bits, xs, ys, zs = G.G1ScalarMul(nbits=128, device=dev).stage(ks, pts[:G1_LADDER])
    lanes = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (bits[:, :G1_LADDER], xs[:G1_LADDER], ys[:G1_LADDER], zs[:G1_LADDER])]
    got = G.scalar_mult(*lanes)
    box = {}
    b7_171_plain_ms = cuda_ms(lambda: box.__setitem__("p", G.scalar_mult_plain(*lanes)), 1)
    b7_171_err = max(err([c[i] for c in got], [c[i] for c in box["p"]]) for i in range(G1_LADDER))
    check(b7_171_err == 0, "g1_scalar_mult_kernel vs plain at B=171, 128 bits")
    x, y, z = (c.cpu().numpy() for c in got)
    check(all(G.projective_to_affine(x[i], y[i], z[i]) == pts[i]._mul_raw(k) for i, k in enumerate(ks[:G1_LADDER])),
          "g1_scalar_mult_kernel vs the oracle at B=171")
    reps = [G.scalar_mult(*lanes) for _ in range(REPEATED_LAUNCHES)]
    check(all(all(torch.equal(a, b) for a, b in zip(r, got)) for r in reps),
          f"g1_scalar_mult_kernel: {REPEATED_LAUNCHES} back-to-back launches equal")
    b7_171_ms = cuda_ms(lambda: G.scalar_mult(*lanes), TIMED_LAUNCHES)
    # the storm offload's shape (the main path's): 3 x 171 points padded
    # to 1024, 256 bits; every lane against the plain version, every
    # real lane against the oracle
    storm_ks = [rng.randrange(1 << G1_STORM_BITS) for _ in range(G1_STORM_LANES)]
    storm_pts = (pts * 2)[:G1_STORM_LANES]
    m = G.G1ScalarMul(nbits=G1_STORM_BITS, device=dev)
    staged = [torch.from_numpy(a).to(dev) for a in m.stage(storm_ks, storm_pts)]
    storm_batch = staged[1].shape[0]
    storm_got = G.scalar_mult(*staged)
    box = {}
    b7_plain_ms = cuda_ms(lambda: box.__setitem__("p", G.scalar_mult_plain(*staged)), 1)
    b7_err = max(err([c[i] for c in storm_got], [c[i] for c in box["p"]]) for i in range(storm_batch))
    check(b7_err == 0, f"g1_scalar_mult_kernel vs plain at the storm shape, all {storm_batch} lanes")
    sx, sy, sz = (c.cpu().numpy() for c in storm_got)
    t0 = time.perf_counter()
    storm_want = [p._mul_raw(k) for p, k in zip(storm_pts, storm_ks)]
    host_lane_ms = (time.perf_counter() - t0) / G1_STORM_LANES * 1e3
    check(all(G.projective_to_affine(sx[i], sy[i], sz[i]) == storm_want[i] for i in range(G1_STORM_LANES)),
          f"g1_scalar_mult_kernel at the storm shape vs the oracle, all {G1_STORM_LANES} real lanes")
    reps = [G.scalar_mult(*staged) for _ in range(REPEATED_LAUNCHES)]
    check(all(all(torch.equal(a, b) for a, b in zip(r, storm_got)) for r in reps),
          f"g1_scalar_mult_kernel: {REPEATED_LAUNCHES} back-to-back launches at the storm shape equal")
    b7_ms = cuda_ms(lambda: G.scalar_mult(*staged), TIMED_LAUNCHES)
    # the storm offload's own scalars (StormOffload.batch_points): w * h_eff
    # (~192 bits), w (128 bits), the group order (255 bits), by kind;
    # every real lane vs the oracle
    from hotstuff_tpu_torch.crypto.bls.curve import H1
    from hotstuff_tpu_torch.crypto.bls.fields import R as ORDER

    ws = [rng.randrange(1 << 128) for _ in range(QUORUM)]
    mix_ks = [w * H1 for w in ws] + ws + [ORDER] * QUORUM
    mix = [torch.from_numpy(a).to(dev) for a in m.stage(mix_ks, storm_pts)]
    mix_got = G.scalar_mult(*mix)
    mx, my, mz = (c.cpu().numpy() for c in mix_got)
    check(all(G.projective_to_affine(mx[i], my[i], mz[i]) == p._mul_raw(k)
              for i, (p, k) in enumerate(zip(storm_pts, mix_ks))),
          f"g1_scalar_mult_kernel on the storm's scalars vs the oracle, all {G1_STORM_LANES} real lanes")
    b7_mix_ms = cuda_ms(lambda: G.scalar_mult(*mix), TIMED_LAUNCHES)
    storm_bytes = storm_batch * (G1_STORM_BITS + 3 * G.NLIMBS * 2) * 4
    b7_bound = g1_bound(ladder_adds(storm_ks), storm_bytes)
    b7_171_bound = g1_bound(ladder_adds(ks), G1_LADDER * (128 + 3 * G.NLIMBS * 2) * 4)
    mix_adds = ladder_adds(mix_ks)
    b7_mix_bound = g1_bound(mix_adds, storm_bytes)
    print(f"B7 g1_scalar_mult_kernel: B=171 x 128 bits {b7_171_ms:.3f} ms (earlier "
          f"{G1_EARLIER_MS['b7_171']} ms; bound {b7_171_bound[0]:.5f} ms, "
          f"{b7_171_bound[1]}), plain {b7_171_plain_ms:.1f} ms; storm shape B={storm_batch} x {G1_STORM_BITS} "
          f"bits, random scalars {b7_ms:.3f} ms (earlier "
          f"{G1_EARLIER_MS['b7_storm']} ms; bound {b7_bound[0]:.5f} ms, {b7_bound[1]}), plain {b7_plain_ms:.1f} ms; "
          f"the storm's scalars (w h_eff, w, the group order) {b7_mix_ms:.3f} ms "
          f"(bound {b7_mix_bound[0]:.5f} ms for its {mix_adds} additions); host route "
          f"(G1Point._mul_raw, {G1_STORM_BITS}-bit) {host_lane_ms:.2f} ms a lane; X, Y, Z equal the plain "
          f"version's mod q on every lane, the points the oracle's [{card}]")
    out["g1_scalar_mult_kernel"] = {"ms": b7_ms, "plain_ms": b7_plain_ms, "bound": b7_bound,
                                    "err": max(b7_err, b7_171_err), "ms_171": b7_171_ms,
                                    "plain_ms_171": b7_171_plain_ms, "bound_171": b7_171_bound,
                                    "host_lane_ms": host_lane_ms, "mix_ms": b7_mix_ms,
                                    "mix_bound": b7_mix_bound}

    # B4 in the storm's mode: Montgomery rows out of the ladder (the
    # weighted signatures, lanes n..2n), identity-padded to 256, as
    # StormOffload._aggregate_mont stages them
    n = QUORUM
    agg_pad = 1 << (n - 1).bit_length()
    rows = np.zeros((3, agg_pad, G.NLIMBS), np.int32)
    rows[1] = G._ONE_MONT
    rows[0, :n], rows[1, :n], rows[2, :n] = sx[n:2 * n], sy[n:2 * n], sz[n:2 * n]
    mont = torch.from_numpy(rows).to(dev).unbind(0)
    mont_got = G.aggregate(*mont, plain=False)
    box = {}
    mont_plain_ms = cuda_ms(lambda: box.__setitem__("p", G.aggregate_plain(*mont, plain=False)), 1)
    mont_err = err(mont_got, box["p"])
    check(mont_err == 0, f"g1_aggregate_kernel vs plain on Montgomery rows at B={agg_pad} (the storm's sum)")
    mont_want = G1Point.sum(storm_want[n:2 * n])
    check(affine(mont_got) == mont_want, f"g1_aggregate_kernel on Montgomery rows at B={agg_pad} vs the oracle")
    reps = [G.aggregate(*mont, plain=False) for _ in range(REPEATED_LAUNCHES)]
    check(all(all(torch.equal(a, b) for a, b in zip(r, mont_got)) for r in reps),
          f"g1_aggregate_kernel: {REPEATED_LAUNCHES} back-to-back launches on Montgomery rows equal")
    mont_ms = cuda_ms(lambda: G.aggregate(*mont, plain=False), TIMED_LAUNCHES)
    b4["err"] = max(b4["err"], mont_err)
    b4["mont"] = {"ms": mont_ms, "plain_ms": mont_plain_ms}
    print(f"B4 g1_aggregate_kernel B={agg_pad} Montgomery rows ({n} ladder outputs, the storm's sum): {mont_ms:.4f} "
          f"ms CUDA events (mean of {TIMED_LAUNCHES}; earlier {G1_EARLIER_MS['b4']['mont']} ms), plain "
          f"{mont_plain_ms:.1f} ms; X, Y, Z equal the plain version's mod q, the point the oracle's; "
          f"{REPEATED_LAUNCHES} launches equal [{card}]")
    for kernel in ("g1_aggregate_kernel", "g1_running_add_kernel", "g1_scalar_mult_kernel"):
        print(f"ptxas {kernel}: {'; '.join(ptxas_lines('g1', kernel))}")
    print(f"(k1) G1 kernels vs plain and oracle: launches {dict(G.launches)}; "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


def bls_oracle(claim) -> bool:
    """The native pairing's verdict on a claim (``("one", d, pk, sig)``
    or ``("shared", d, votes)``)."""
    from hotstuff_tpu_torch.crypto.bls import native

    if claim[0] == "one":
        return native.verify_one(claim[1], claim[2], claim[3])
    return all(native.verify_one(claim[1], pk, sig) for pk, sig in claim[2])


def bls_storm_phase(card: str, nodes: int = COMMITTEE, torch_device=None) -> dict:
    """(k2) The storm's BLS rows at N = 256, quorum 171 (``bench/storm.py``):
    ``bls-cpu`` with its off-loop TC row and ``bls-cuda-storm-offload``
    (refused unless ``storm_offload_engaged``), every signature of the
    storm checked against the native pairing, a forged vote, timeout and
    TC entry rejected through the offload verifier; then
    ``bench_agg_qc`` at n = 64, 256 and 512.  Returns the G1 kernels'
    launches in the phase, counted from 0."""
    from hotstuff_tpu_torch.bench import storm, verifier as bench
    from hotstuff_tpu_torch.consensus import InvalidSignature, TC, Timeout, Vote
    from hotstuff_tpu_torch.crypto.scheme import make_device_verifier
    from hotstuff_tpu_torch.gpu import bls as G

    quorum = 2 * nodes // 3 + 1
    t0 = time.perf_counter()
    fixture = storm._bls_fixture(nodes, quorum)
    committee, timeouts, (tc, tc_worst), high_qc = fixture
    want = [bls_oracle(("one", t.digest().to_bytes(), t.author.to_bytes(), t.signature.to_bytes()))
            for t in timeouts]
    want += [bls_oracle(c) for c in high_qc.claims() + tc.claims() + tc_worst.claims()]
    check(all(want), "BLS storm fixture: every signature valid for the native pairing")
    print(f"BLS storm fixture + native oracle: {len(want)} claims in {time.perf_counter() - t0:.1f} s (host)")
    from hotstuff_tpu_torch.crypto import Digest
    from hotstuff_tpu_torch.crypto.bls import native
    from hotstuff_tpu_torch.crypto.bls.service import BlsSigningService
    from hotstuff_tpu_torch.crypto.scheme import bls_keygen

    pk, secret = bls_keygen(b"\x53" * 32, 0)
    signer = BlsSigningService(secret)
    digests = [Digest.of(b"sign timing %d" % i) for i in range(20)]
    t0 = time.perf_counter()
    sigs = [signer.sign_sync(d) for d in digests]
    sign_ms = (time.perf_counter() - t0) / len(digests) * 1e3
    t0 = time.perf_counter()
    check(all(native.verify_one(d.to_bytes(), pk.to_bytes(), s.to_bytes()) for d, s in zip(digests, sigs)),
          "BLS signing: every signature verifies natively")
    verify_ms = (time.perf_counter() - t0) / len(digests) * 1e3
    print(f"BLS on the host: {sign_ms:.2f} ms a signature (pure-Python hash-to-G1 and G1 multiply), "
          f"{verify_ms:.2f} ms a native single verify (libhs_bls), mean of {len(digests)} [{card}]")

    G.reset_launches()
    t0 = time.perf_counter()
    results = storm.bls_rows(fixture, quorum, device=True, torch_device=torch_device)
    wall = time.perf_counter() - t0
    check("bls-cuda-storm-offload" in results, "BLS storm: the offload row was measured (offload engaged)")
    print(storm.format_report(nodes, results))
    storm_launches = dict(G.launches)
    check(storm_launches["g1_scalar_mult"] > 0, "BLS storm: the ladder kernel launched")
    check(storm_launches["g1_aggregate"] > 0, "BLS storm: the tree kernel launched")

    v = make_device_verifier("bls", "cuda", device=torch_device)
    v.warmup_storm_offload(quorum)
    check(v.storm_offload_engaged(quorum), "BLS storm: the offload engages at quorum 171")

    def rejected(msg) -> bool:
        try:
            msg.verify(committee, v)
        except InvalidSignature:
            return True
        return False

    # forgeries: another member's valid signature in the place of each
    votes = list(high_qc.votes)
    forged_vote = Vote(hash=high_qc.hash, round=high_qc.round, author=votes[5][0], signature=votes[6][1])
    t = timeouts[3]
    forged_timeout = Timeout(high_qc=t.high_qc, round=t.round, author=t.author,
                             signature=timeouts[4].signature)
    entries = list(tc_worst.votes)
    k = quorum // 2
    entries[k] = (entries[k][0], entries[k + 1][1], entries[k][2])
    forged_tc = TC(round=tc_worst.round, votes=entries)
    for what, msg in (("vote", forged_vote), ("timeout", forged_timeout), ("TC entry", forged_tc)):
        claims = msg.claims() if hasattr(msg, "claims") else []
        if claims:
            check(not all(bls_oracle(c) for c in claims), f"BLS storm: the native pairing rejects the forged {what}")
        check(rejected(msg), f"BLS storm: a forged {what} is rejected")
    digests = [c[1] for c in forged_tc.claims()]
    pks = [c[2] for c in forged_tc.claims()]
    sigs = [c[3] for c in forged_tc.claims()]
    verdicts = v.verify_many(digests, pks, sigs, aggregate_ok=True)
    check(verdicts == [i != k for i in range(quorum)], "BLS storm: the offload pins the forged TC entry")
    digests = [c[1] for c in tc_worst.claims()]
    pks = [c[2] for c in tc_worst.claims()]
    sigs = [c[3] for c in tc_worst.claims()]
    t1 = time.perf_counter()
    check(all(v.verify_many(digests, pks, sigs, aggregate_ok=True)), "BLS storm: the offload accepts the worst TC")
    offload_ms = (time.perf_counter() - t1) * 1e3
    print(f"BLS storm phase: {wall:.1f} s host clock; worst-case TC through StormOffload {offload_ms:.1f} ms; "
          f"G1 launches in the storm {storm_launches}; every verdict equals the native pairing's; forged vote, "
          f"timeout and TC entry rejected [{card}]")

    from hotstuff_tpu_torch.consensus.handel import HandelTopology

    t0 = time.perf_counter()
    agg = bench.bench_agg_qc(device=torch_device or "cuda")
    print("bench_agg_qc result: " + json.dumps(agg))
    for n in ("64", "256", "512"):
        row = agg[n]
        print(f"bench_agg_qc n={n}: QC bytes compact {row['qc_bytes_compact']} vs vote-list "
              f"{row['qc_bytes_votelist']}; form p50 {row['form_p50_ms']} vs {row['form_votelist_p50_ms']} ms; "
              f"verify p50 {row['verify_p50_ms']} ms (cold {row['verify_cold_ms']}) vs vote-list "
              f"{row['verify_votelist_p50_ms']} ms; Handel levels {row['handel_levels']}, leader merges "
              f"{row['handel_leader_merges']} [{card}]")
        levels = HandelTopology.for_round(int(n), 3).levels
        check(row["handel_levels"] == levels,
              f"bench_agg_qc n={n}: Handel levels {row['handel_levels']} (the round-3 tree's {levels})")
        check(0 < row["handel_leader_merges"] <= levels,
              f"bench_agg_qc n={n}: the leader merges at most once a level ({row['handel_leader_merges']})")
    print(f"bench_agg_qc: flat_ratio {agg['flat_ratio']}, {time.perf_counter() - t0:.1f} s; card "
          f"{agg['device']['name']}, {agg['device']['power_limit']} [{card}]")
    check(agg["device"]["platform"] == ("gpu" if torch_device in (None, "cuda") else "cpu"),
          "bench_agg_qc: the result names where it ran")
    return dict(G.launches)


G1_COMMITTEE_S = 30  # (k3)'s window of load, s


def bls_phase(card: str, torch_device=None, nodes: int = 64, duration: float = G1_COMMITTEE_S,
              verifier: str = "cuda"):
    """(k): (k1) ``g1_phase``, (k2) ``bls_storm_phase``, (k3) the 64-node
    ``run-many --verifier cuda`` committee on BLS files (``node_phase``
    with ``scheme="bls"``, logs in ``chiprun_out/bls_phase/``) for
    ``G1_COMMITTEE_S`` s of load: in 20 s it made 6 and 11 rounds on an
    H100, each run with one 5 s view change a node, so 30 s keeps "3
    commits a node" clear of one more.  Returns (the kernels line's
    numbers, the G1 launches of (k2) and (k3))."""
    t0 = time.perf_counter()
    numbers = g1_phase(card, torch_device)
    print(f"phase (k1) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k2 = bls_storm_phase(card, torch_device=torch_device)
    print(f"phase (k2) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k3_launches, r = node_phase(card, nodes=nodes, duration=duration, verifier=verifier, label="bls phase",
                                scheme="bls")
    print(f"phase (k3) took {time.perf_counter() - t0:.1f} s")
    k3 = {name: (k3_launches or {}).get(name, 0) for name in k2}
    launches = {name: k2[name] + k3[name] for name in k2}
    print(f"(k) G1 launches: (k2) {k2}, (k3) {k3} [{card}]")
    return numbers, launches, r



MESH_SHARDS = 4  # the four-shard mesh of one card (XLA's forced host device count)
MESH_WAVES = 20  # back-to-back waves, one forged claim moving across the shards
MESH_WORD_CALLS = 5  # all-valid QCs whose readback must be the word alone


def mesh_phase(card: str, claims, single, torch_device=None, waves: int = MESH_WAVES, qc: int = 256,
               node_duration: float | None = 20) -> dict:
    """(l) The mesh verifier (``parallel/mesh.py``) and the sharded G1
    aggregate on two meshes: every visible card (``default_mesh()``) and
    ``MESH_SHARDS`` shards of card 0.  (l1) ``ShardedBatchVerifier``:
    ``precompute`` and ``warmup``, step 3's wave, the 171-vote QC and the
    forged one (verdicts equal to ``single``'s, the single-device
    verifier, and the oracle's), ``waves`` back-to-back waves with one
    forged claim moving across the shards, the word-only readback of an
    all-valid QC (its spans hold ``mesh.psum`` and no ``readback``),
    ``make_sharded_qc_check`` and the word, and K1 launched once a shard a
    dispatch; (l2) ``bench_sharded`` (QC-``qc``); (l3)
    ``G1Aggregator(mesh=...)`` at 171 points: X, Y, Z equal to the plain
    sharded sum's mod q (the same rows through a CPU mesh of the same
    size), the point equal to ``aggregate_plain``'s and the oracle's, and
    ``BlsVerifier(aggregator="cuda-sharded").verify_shared_msg`` on a
    171-vote QC and a forged one; (l4) ``node_phase`` with ``--verifier
    mesh --mesh-devices 1`` (``mesh=`` > 0 and equal to ``device=``).
    ``torch_device="cpu"`` rehearses (l1)-(l3) on CPU meshes (then no
    kernel launches; ``node_duration=None`` skips (l4)).  Prints a
    ``mesh {json}`` line; returns its numbers with the K1 and B4 launches
    of the phase."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.bench import verifier as bench
    from hotstuff_tpu_torch.crypto import Digest
    from hotstuff_tpu_torch.crypto.bls.curve import G1Point
    from hotstuff_tpu_torch.crypto.bls.fields import P as Q
    from hotstuff_tpu_torch.crypto.bls.service import BlsSigningService
    from hotstuff_tpu_torch.crypto.scheme import bls_keygen, make_device_verifier
    from hotstuff_tpu_torch.gpu import bls as G, dsm
    from hotstuff_tpu_torch.parallel import mesh as M
    from hotstuff_tpu_torch.telemetry import spans

    t_phase = time.perf_counter()
    on_card = torch_device != "cpu"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    first = M.default_mesh() if on_card else M.Mesh([dev])
    meshes = {f"{first.size} card(s)" if on_card else "one shard": first,
              f"{MESH_SHARDS} shards": M.Mesh([dev] * MESH_SHARDS)}
    out = {"meshes": {}, "k1_launches": 0, "b4_launches": 0}

    # (l1) the sharded verifier
    msgs, wpks, sigs, expect_wave = claims["wave"]
    n = len(msgs)
    single_wave = single.verify_device(msgs, wpks, sigs).tolist()
    check(single_wave == expect_wave, "(l1) the single-device verifier's wave verdicts")
    digest, votes, want_qc = claims["qc"]
    _, bad_votes, want_bad = claims["qc_bad"]
    check(want_qc and not want_bad, "(l1) the oracle: the QC valid, the forged QC not")
    qc_cols = ([digest.to_bytes()] * len(votes), [p.to_bytes() for p, _ in votes],
               [s.to_bytes() for _, s in votes])
    bad_cols = (qc_cols[0], qc_cols[1], [s.to_bytes() for _, s in bad_votes])
    n_bad = sum(a != b for a, b in zip(qc_cols[2], bad_cols[2]))
    # a wave of valid claims only (those of step 3's wave, repeated)
    clean = [c for c, ok in zip(zip(msgs, wpks, sigs), expect_wave) if ok]
    clean = (clean * (n // len(clean) + 1))[:n]
    c_msgs, c_pks, c_sigs = (list(col) for col in zip(*clean))
    for label, mesh in meshes.items():
        row = {"devices": [str(d) for d in mesh.devices]}
        t0 = time.perf_counter()
        sv = M.ShardedBatchVerifier(mesh, min_device_batch=0)
        sv.precompute(claims["pks"])
        sv.warmup(COMMITTEE)
        row["warmup_s"] = time.perf_counter() - t0
        lanes = next(p for p in sv.pad_sizes if p >= n) // mesh.size
        dsm.reset_launches()
        dispatches = 0
        got = sv.verify_device(msgs, wpks, sigs).tolist()
        dispatches += 1
        check(got == expect_wave == single_wave,
              f"(l1) {label}: the {n}-claim wave equals the single-device verifier and the oracle")
        check(sv.verify_shared_msg(digest, votes), f"(l1) {label}: the {len(votes)}-vote QC")
        check(not sv.verify_shared_msg(digest, bad_votes), f"(l1) {label}: the forged QC")
        dispatches += 2
        for k in range(waves):
            f = (k * n // waves + k) % n
            m_k = list(c_msgs)
            m_k[f] = Digest.of(b"mesh phase forged %d" % k).to_bytes()
            check(sv.verify_device(m_k, c_pks, c_sigs).tolist() == [i != f for i in range(n)],
                  f"(l1) {label}: back-to-back wave {k}, forged claim {f} on shard {f // lanes}")
        dispatches += waves
        rec = spans.enable()
        try:
            word_only = 0
            for _ in range(MESH_WORD_CALLS):
                check(sv.verify_shared_msg(digest, votes), f"(l1) {label}: the QC, profiled")
                names = [span[0] for span in rec.drain()]
                word_only += "mesh.psum" in names and "readback" not in names
            check(not sv.verify_shared_msg(digest, bad_votes), f"(l1) {label}: the forged QC, profiled")
            names = [span[0] for span in rec.drain()]
        finally:
            spans.disable()
        dispatches += MESH_WORD_CALLS + 1
        check(word_only == MESH_WORD_CALLS, f"(l1) {label}: every all-valid QC read back the word alone")
        check("mesh.psum" in names and "readback" in names, f"(l1) {label}: the forged QC read its lanes")
        _, ops = sv.prepare(*qc_cols)
        check(bool(M.make_sharded_qc_check(mesh)(*ops)), f"(l1) {label}: make_sharded_qc_check, valid QC")
        _, ops = sv.prepare(*bad_cols)
        check(not bool(M.make_sharded_qc_check(mesh)(*ops)), f"(l1) {label}: make_sharded_qc_check, forged")
        _, word = M.make_sharded_verify(mesh, psum_word=True)(*ops)
        check(int(word) == n_bad, f"(l1) {label}: the word counts the forged votes")
        dispatches += 3
        launched = dsm.launches["verify_compressed"]
        check(launched == (mesh.size * dispatches if on_card else 0),
              f"(l1) {label}: K1 once a shard a dispatch ({launched} launches, {mesh.size} x {dispatches})")
        t0 = time.perf_counter()
        for _ in range(QC_CALLS):
            sv.verify_shared_msg(digest, votes)
        row["qc_ms"] = (time.perf_counter() - t0) / QC_CALLS * 1e3
        t0 = time.perf_counter()
        for _ in range(5):
            sv.verify_device(msgs, wpks, sigs)
        row["wave_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        row.update(pad_sizes=list(sv.pad_sizes), buckets=list(sv.wave_bucket_shapes), dispatches=dispatches,
                   word_only=word_only, k1_launches=dsm.launches["verify_compressed"])
        out["k1_launches"] += dsm.launches["verify_compressed"]
        if on_card:
            # CUDA-event times at the QC's pad: B1 (the lanes and the
            # word), B2 (the bool); B3 (each shard's row gather) at the
            # wave's pad; the bounds are K1's for the same lanes and the
            # gather's bytes (rows read and written once, the indices)
            _, ops = sv.prepare(*qc_cols)
            ops = tuple(tuple(t.clone() for t in op) for op in ops)
            qc_pad = sum(t.shape[0] for t in ops[0])
            word_fn, check_fn = M.make_sharded_verify(mesh, psum_word=True), M.make_sharded_qc_check(mesh)
            word_fn(*ops)
            row["b1_ms"] = cuda_ms(lambda: word_fn(*ops), TIMED_LAUNCHES)
            row["b2_ms"] = cuda_ms(lambda: check_fn(*ops), TIMED_LAUNCHES)
            row["b1_bound"] = bounds(qc_pad)[0][0]
            sv.prepare(msgs, wpks, sigs)
            wave_pad = lanes * mesh.size
            slot, build = sv._scratch.pool[wave_pad], sv._tables
            row["b3_ms"] = cuda_ms(lambda: [sv._gather_device_rows(build, i, sh) for i, sh in enumerate(slot.shards)],
                                   TIMED_LAUNCHES)
            row["b3_bound"] = (2 * 4 * wave_pad * 20 * 4 + wave_pad * 8) / HBM_BYTES_PER_S * 1e3
            row["qc_pad"] = qc_pad
            print(f"(l1) {label}: B1 sharded verify with the word {row['b1_ms']:.4f} ms, B2 QC check "
                  f"{row['b2_ms']:.4f} ms at B={qc_pad} (bound {row['b1_bound']:.4f} ms, K1's); B3 row gather "
                  f"{row['b3_ms']:.4f} ms at B={wave_pad} (bound {row['b3_bound']:.6f} ms, bytes); "
                  f"CUDA events, means of {TIMED_LAUNCHES} [{card}]")
        print(f"(l1) {label} {row['devices']}: pad grid {sv.pad_sizes}, buckets {sv.wave_bucket_shapes}; the "
              f"{n}-claim wave, the QC, the forged QC, {waves} waves with a forged claim moving over the shards, "
              f"the word and make_sharded_qc_check right; {word_only} of {MESH_WORD_CALLS} all-valid QCs read "
              f"back the word alone; K1 {launched} launches = {mesh.size} shards x {dispatches} dispatches; "
              f"QC {row['qc_ms']:.3f} ms, wave {row['wave_ms']:.1f} ms host clock (means of {QC_CALLS} and 5); "
              f"warmup {row['warmup_s']:.1f} s [{card}]")

        # (l2) bench_sharded: a measurement, so its launches (its checks
        # and its CUDA-event loops) stay out of the path's K1 count
        qm, qp, qs = bench.make_qc_batch(qc)
        b = bench.bench_sharded(qm, qp, qs, mesh=mesh, qc=qc)
        row["bench"] = b
        print(f"(l2) {label}: bench_sharded {json.dumps(b)} [{card}]")
        out["meshes"][label] = row

    # (l3) the sharded G1 aggregate, and the BLS verifier on it
    pts = g1_points(QUORUM, seed=8)
    want = G1Point.sum(pts)
    for label, mesh in meshes.items():
        row = out["meshes"][label]
        agg = G.G1Aggregator(mesh=mesh)
        padded = agg._padded_size(QUORUM)
        rows = np.zeros((3, padded, G.NLIMBS), np.int32)
        rows[0, :QUORUM] = G.ints_to_limbs_batch([p.x for p in pts])
        rows[1, :QUORUM] = G.ints_to_limbs_batch([p.y for p in pts])
        rows[2, :QUORUM, 0] = 1
        rows[1, QUORUM:, 0] = 1
        blocks = np.ascontiguousarray(rows.reshape(3, mesh.size, -1, G.NLIMBS).transpose(1, 0, 2, 3))
        on_mesh = list(zip(*(torch.from_numpy(b).to(d).unbind(0) for b, d in zip(blocks, mesh.devices))))
        on_cpu = list(zip(*(torch.from_numpy(b).unbind(0) for b in blocks)))
        # the path: G1Aggregator.aggregate, counted; the comparisons and
        # the CUDA-event loops below launch B4 uncounted
        G.reset_launches()
        check(agg.aggregate(pts) == want, f"(l3) {label}: G1Aggregator at {QUORUM} points vs the oracle")
        check(G.launches["g1_aggregate"] == (mesh.size + 1 if on_card else 0),
              f"(l3) {label}: B4 once a shard and once on the partials ({G.launches['g1_aggregate']})")
        t0 = time.perf_counter()
        for _ in range(QC_CALLS):
            agg.aggregate(pts)
        aggregate_ms = (time.perf_counter() - t0) / QC_CALLS * 1e3
        b4_launches = G.launches["g1_aggregate"]
        out["b4_launches"] += b4_launches
        xyz = [c.cpu().numpy() for c in agg._sharded(*on_mesh)]
        plain = [c.numpy() for c in G.make_sharded_g1_aggregate(M.Mesh(["cpu"] * mesh.size))(*on_cpu)]
        err = max(abs(G.limbs_to_int(a) * pow(G.R_MONT, -1, Q) % Q - G.limbs_to_int(b) * pow(G.R_MONT, -1, Q) % Q)
                  for a, b in zip(xyz, plain))
        check(err == 0, f"(l3) {label}: X, Y, Z equal the plain sharded sum's mod q")
        single_plain = G.aggregate_plain(*torch.from_numpy(rows).unbind(0))
        check(G.projective_to_affine(*xyz) == G.projective_to_affine(*(c.numpy() for c in single_plain)) == want,
              f"(l3) {label}: the point equals aggregate_plain's (wide columns) and the oracle's")
        row["g1"] = {"padded": padded, "err": err, "aggregate_ms": aggregate_ms, "b4_launches": b4_launches,
                     "bound": g1_bound(padded - 1, 3 * padded * G.NLIMBS * 4 + 3 * G.NLIMBS * 4)}
        if on_card:
            agg._sharded(*on_mesh)  # warm
            row["g1"]["ms"] = cuda_ms(lambda: agg._sharded(*on_mesh), TIMED_LAUNCHES)
            one = torch.from_numpy(rows).to(dev).unbind(0)
            row["g1"]["one_device_ms"] = cuda_ms(lambda: G.aggregate(*one, plain=True), TIMED_LAUNCHES)
        print(f"(l3) {label}: G1Aggregator(mesh) at {QUORUM} points (pad {padded}): X, Y, Z equal the plain "
              f"sharded sum's mod q, the point aggregate_plain's and the oracle's; sharded sum "
              f"{row['g1'].get('ms')} ms CUDA events beside B4 on one device {row['g1'].get('one_device_ms')} ms "
              f"(means of {TIMED_LAUNCHES}; bound {row['g1']['bound'][0]:.6f} ms, {row['g1']['bound'][1]}); "
              f"G1Aggregator.aggregate {row['g1']['aggregate_ms']:.3f} ms host clock "
              f"(mean of {QC_CALLS}); B4 {b4_launches} launches on the path [{card}]")
    t0 = time.perf_counter()
    members = [bls_keygen(b"\x6c" * 32, i) for i in range(QUORUM)]
    d = Digest.of(b"mesh phase BLS block")
    bls_votes = [(pk.to_bytes(), BlsSigningService(sec).sign_sync(d).to_bytes()) for pk, sec in members]
    forged = bls_votes[:-1] + [(bls_votes[-1][0], bls_votes[0][1])]
    keys_s = time.perf_counter() - t0
    bv = make_device_verifier("bls", "cuda-sharded", device=torch_device)
    check(bv.name == "bls-cuda-sharded" and bv._dev_agg.mesh.size == first.size,
          "(l3) BlsVerifier(aggregator='cuda-sharded') spans the visible cards")
    G.reset_launches()
    check(bv.verify_shared_msg(d, bls_votes), f"(l3) the sharded BLS verifier on a {QUORUM}-vote QC")
    check(not bv.verify_shared_msg(d, forged), "(l3) the sharded BLS verifier on a forged QC")
    t0 = time.perf_counter()
    for _ in range(5):
        bv.verify_shared_msg(d, bls_votes)
    bls_ms = (time.perf_counter() - t0) / 5 * 1e3
    check(G.launches["g1_aggregate"] == ((first.size + 1) * 7 if on_card else 0),
          f"(l3) the BLS verifier's sums ran on the mesh ({G.launches['g1_aggregate']} B4 launches)")
    out["b4_launches"] += G.launches["g1_aggregate"]
    out["bls_qc_ms"] = bls_ms
    print(f"(l3) BlsVerifier(aggregator='cuda-sharded') on {first.size} card(s): {QUORUM}-vote QC verify "
          f"{bls_ms:.2f} ms host clock (mean of 5), the forged QC refused; {QUORUM} BLS keys and signatures made "
          f"in {keys_s:.1f} s (host) [{card}]")

    # (l4) the node CLI on the mesh verifier
    if node_duration is not None:
        t0 = time.perf_counter()
        launches, r = node_phase(card, duration=node_duration, verifier="mesh", label="mesh phase",
                                 extra_args=("--mesh-devices", "1"))
        out["k1_launches"] += launches
        out["node"] = {k: r[k] for k in ("committed_rounds", "consensus_payloads_per_s", "timeouts", "stats",
                                         "launches", "launches_after_boot")}
        print(f"phase (l4) took {time.perf_counter() - t0:.1f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    print("mesh " + json.dumps(out))
    return out


def running_total(t_start: float, phase: str) -> float:
    """Print the script's wall time so far, before ``phase`` starts, and
    return the phase's start."""
    now = time.perf_counter()
    print(f"running total before phase {phase}: {now - t_start:.1f} s (host clock)")
    return now


def main() -> int:
    import torch

    t_start = time.perf_counter()

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

    # 1. build: one nvcc a kernel source, all started together, and the
    #    port's native libraries (g++) beside them, so that no node
    #    compiles one on its event loop at its first use of it
    from hotstuff_tpu_torch import _native_build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(lambda: [_native_build.build(name) for name in _native_build.LIBRARIES])
        _build.build_all()
        native_libs = native.result()
    _build.load("dsm")
    _build.load("g1")
    print(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(_build.library_path(name).name for name in _build.LIBRARIES)
          + "; native libraries: " + ", ".join(path.name for path in native_libs))
    for name in _build.LIBRARIES:
        report = _build.library_path(name).with_suffix(".ptxas.txt")
        if report.exists():
            keys = ("Compiling entry", "Function properties", "stack frame", "registers")
            for line in report.read_text().splitlines():
                if any(key in line for key in keys):
                    print("ptxas:", line.strip())
    print(f"dynamic shared memory per block (both Ed25519 kernels): {_build.load().dsm_smem_bytes()} bytes")
    for name in _build.LIBRARIES:
        sass_mix(_build.library_path(name))

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
    t0 = running_total(t_start, "(a)")
    storm_launches = storm_phase(card)
    print(f"phase (a) took {time.perf_counter() - t0:.1f} s")
    check(storm_launches > 0, "the storm never launched the verify kernel")
    t0 = running_total(t_start, "(b)")
    wave_launches = coalesced_phase(card)
    print(f"phase (b) took {time.perf_counter() - t0:.1f} s")
    check(wave_launches > 0, "the coalesced waves never launched the verify kernel")
    t0 = running_total(t_start, "(c)")
    committee_launches = committee_phase(card)
    print(f"phase (c) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(d)")
    restart_launches = restart_phase(card)
    print(f"phase (d) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(e)")
    node_launches, node_r = node_phase(card)
    print(f"phase (e) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(f)")
    ingest_launches = ingest_phase(card)
    print(f"phase (f) took {time.perf_counter() - t0:.1f} s")
    check(ingest_launches > 0, "the ingest phase never launched the verify kernel")
    t0 = running_total(t_start, "(g)")
    native_launches, native_r = node_phase(card, transport="native")
    print(f"phase (g) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(h)")
    bench_launches = verifier_phase(card, claims)
    print(f"phase (h) took {time.perf_counter() - t0:.1f} s")
    check(bench_launches > 0, "the verifier bench never launched the verify kernel")
    t0 = running_total(t_start, "(i)")
    telemetry_launches, telemetry_r = telemetry_phase(card)
    print(f"phase (i) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(j)")
    health_launches, health_r = health_phase(card)
    print(f"phase (j) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(m)")
    wan_launches, wan_r = wan_phase(card, node_r, telemetry_r["flows"]["classes"])
    print(f"phase (m) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(n1)")
    split_launches, split_r = split_brain_phase(card, node_r)
    print(f"phase (n1) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(n2)")
    flap_launches, flap_r = flapping_phase(card, native_r)
    print(f"phase (n2) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(o)")
    adv_kernels = adversary_kernel_check(card)
    adv_launches, adv_r = adversary_phase(card, node_r)
    print(f"phase (o) took {time.perf_counter() - t0:.1f} s")
    t0 = running_total(t_start, "(k)")
    g1, g1_launches, bls_r = bls_phase(card)
    print(f"phase (k) took {time.perf_counter() - t0:.1f} s")
    for name, count in g1_launches.items():
        check(count > 0, f"(k) the main path never launched {name}")
    t0 = running_total(t_start, "(l)")
    mesh = mesh_phase(card, claims, v)
    print(f"phase (l) took {time.perf_counter() - t0:.1f} s")
    check(mesh["k1_launches"] > 0 and mesh["b4_launches"] > 0, "(l) the mesh never launched K1 and B4")
    keys = ("boot_s", "committed_rounds", "consensus_payloads_per_s", "latency_mean_s", "latency_p50_s",
            "timeouts", "launches", "stop_s")
    print(f"telemetry overhead, same call: (e) {node_r['committed_rounds']} rounds, "
          f"{node_r['consensus_payloads_per_s']:.1f} payloads/s; (i) {telemetry_r['committed_rounds']} rounds, "
          f"{telemetry_r['consensus_payloads_per_s']:.1f} payloads/s [{card}]")
    print(f"health plane beside telemetry, same call: (i) {telemetry_r['committed_rounds']} rounds, "
          f"{telemetry_r['consensus_payloads_per_s']:.1f} payloads/s; (j1) {health_r['committed_rounds']} "
          f"rounds, {health_r['consensus_payloads_per_s']:.1f} payloads/s [{card}]")
    print(f"flow accounting beside (e), same call: (e) {node_r['committed_rounds']} rounds, (i) "
          f"{telemetry_r['committed_rounds']} rounds, ratio "
          f"{telemetry_r['committed_rounds'] / max(node_r['committed_rounds'], 1):.3f} [{card}]")
    for label, r in (("(e) asyncio", node_r), ("(g) native", native_r), ("(i) telemetry", telemetry_r),
                     ("(j1) health", health_r), ("(m) wan", wan_r), ("(n1) split brain", split_r),
                     ("(n2) flapping link", flap_r), ("(o) adversary", adv_r)):
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
                         + ingest_launches + native_launches + bench_launches
                         + telemetry_launches + health_launches + wan_launches
                         + split_launches + flap_launches + adv_launches + adv_kernels["k1"]
                         + mesh["k1_launches"]),
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
    b4, b6, b7 = (g1[k] for k in ("g1_aggregate_kernel", "g1_running_add_kernel", "g1_scalar_mult_kernel"))
    b4_main = b4["b4"][512]  # a 171-vote QC, the aggregator's pad
    kernels += [
        {
            "name": "g1_aggregate_kernel",
            "route": "cuda",
            "source": "hotstuff_tpu_torch/gpu/csrc/g1_kernels.cu",
            "replaces": "hotstuff_tpu/tpu/bls.py:255",
            "launches": g1_launches["g1_aggregate"] + mesh["b4_launches"] + adv_kernels["b4"],
            "max_abs_err": b4["b4"]["err"],
            "ms": b4_main["ms"],
            "plain_ms": b4_main["plain_ms"],
            "bound_ms": b4_main["bound"][0],
            "bound_by": b4_main["bound"][1],
            "library_ms": None,
        },
        {
            "name": "g1_running_add_kernel",
            "route": "cuda",
            "source": "hotstuff_tpu_torch/gpu/csrc/g1_kernels.cu",
            "replaces": "hotstuff_tpu/tpu/bls.py:468",
            "launches": g1_launches["g1_running_add"],
            "max_abs_err": b6["err"],
            "ms": b6["ms"],
            "plain_ms": b6["plain_ms"],
            "bound_ms": b6["bound"][0],
            "bound_by": b6["bound"][1],
            "library_ms": None,
            "b2b_ms": b6["b2b_ms"],
            "floor_ms": b6["floor_ms"],
        },
        {
            "name": "g1_scalar_mult_kernel",
            "route": "cuda",
            "source": "hotstuff_tpu_torch/gpu/csrc/g1_kernels.cu",
            "replaces": "hotstuff_tpu/tpu/bls.py:579",
            "launches": g1_launches["g1_scalar_mult"],
            "max_abs_err": b7["err"],
            "ms": b7["ms"],
            "plain_ms": b7["plain_ms"],
            "bound_ms": b7["bound"][0],
            "bound_by": b7["bound"][1],
            "library_ms": None,
        },
    ]
    print(f"script wall time {time.perf_counter() - t_start:.1f} s (host clock) [{card}]")
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
