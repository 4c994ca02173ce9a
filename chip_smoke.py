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
   (prepare / dispatch / device.execute / readback);
7. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Any mismatch raises, so the exit code is not 0 and no result line is
printed.  Without a CUDA device it exits with 2 and prints no result.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
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
    rec = spans.enable()
    try:
        for _ in range(reps):
            v.verify_device(msgs, wpks, sigs)
        stages = {}
        for name, _t0, dur, _depth, _thread in rec.drain():
            stages[name] = stages.get(name, 0) + dur / reps / 1e6
    finally:
        spans.disable()
    print("verify_device stages (ms, mean of %d): %s" % (
        reps, ", ".join(f"{k} {ms:.3f}" for k, ms in stages.items())))

    B = WAVE
    v_bound, s_bound = bounds(B)
    kernels = [
        {
            "name": "dsm_verify_kernel",
            "route": "cuda",
            "source": "hotstuff_tpu_torch/gpu/csrc/dsm_kernels.cu",
            "replaces": "hotstuff_tpu/tpu/pallas_dsm.py:587",
            "launches": main_launches["verify_compressed"],
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
