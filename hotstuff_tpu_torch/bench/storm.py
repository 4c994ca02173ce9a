"""View-change-storm micro-benchmark (BASELINE config 4).

A copy of ``benchmark/storm.py`` for the port.  The storm shape: a
committee of N = 256 (f = 85) hits a round timeout.  Every correct node
then has to process, on its consensus loop:

1. a **timeout flood** — 2f+1 = 171 incoming ``Timeout`` messages, each
   carrying the sender's single signature AND the same 171-vote
   ``high_qc`` (the per-core verified-QC memo collapses the n identical
   embedded-QC verifications to one — measured here with and without
   the memo, and through the burst path);
2. **TC verification**, two shapes — the realistic certificate (every
   entry shares one timeout digest) and the adversarial worst case (171
   DISTINCT digests, the full ``verify_many`` batch);
3. the 171-vote QC alone;
4. with the device host, the worst-case TC through the production async
   claims path: its wall time and the worst event-loop stall seen by a
   5 ms heartbeat meanwhile.

Backends: ``ed25519-cpu`` (the host verifier) and, with ``device=True``,
``ed25519-cuda``: the host a node uses, ``make_verifier("cuda")``, after
``precompute`` and ``warmup(quorum)``; the async service's bucket shapes
are warmed with ``warm_buckets()`` before the off-loop row.  With
``bls=True`` (off by default here; the reference runs them by default)
the BLS rows follow: ``bls-cpu`` (the aggregate QC is one pairing
equality; the TC's same-digest groups aggregate; the native multi-pairing
for the distinct-digest worst case) with its off-loop TC row, and, with
``device=True`` too, ``bls-cuda-storm-offload``: the worst-case TC's
3n G1 ladders and the weighted-signature sum on the card's G1 kernels
(``StormOffload``), measured only when the offload engages at this
quorum (``storm_offload_engaged``), as in ``benchmark/storm.py``.
"""

from __future__ import annotations

import time

N_DEFAULT = 256


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:.1f} ms"


def _ed25519_fixture(n: int, quorum: int):
    """(committee, timeouts, (tc_realistic, tc_worst), high_qc)."""
    from ..consensus import QC, TC, Timeout, Vote
    from ..consensus.config import Committee
    from ..consensus.messages import timeout_digest
    from ..crypto import Digest, Signature, generate_keypair

    seed = b"\x51" * 32
    members = [generate_keypair(seed, i) for i in range(n)]
    committee = Committee.new(
        [(pk, 1, ("127.0.0.1", 40_000 + i)) for i, (pk, _) in enumerate(members)]
    )
    # the storm's shared high_qc: a full-quorum QC for round 9
    block_digest = Digest.of(b"storm high-qc block")
    vote_digest = Vote(hash=block_digest, round=9, author=members[0][0]).digest()
    high_qc = QC(
        hash=block_digest,
        round=9,
        votes=[
            (pk, Signature.new(vote_digest, sk)) for pk, sk in members[:quorum]
        ],
    )
    timeouts = []
    for pk, sk in members[:quorum]:
        t = Timeout(high_qc=high_qc, round=10, author=pk)
        t.signature = Signature.new(t.digest(), sk)
        timeouts.append(t)
    # the REALISTIC TC formed from the flood above: every entry carries
    # high_qc_round = 9, so all entries sign the SAME timeout digest
    tc = TC(
        round=10,
        votes=[
            (pk, Signature.new(timeout_digest(10, 9), sk), 9)
            for pk, sk in members[:quorum]
        ],
    )
    # adversarial worst case: DISTINCT per-entry digests (each entry
    # claims its own high_qc_round) — defeats same-digest grouping
    tc_worst = TC(
        round=10,
        votes=[
            (pk, Signature.new(timeout_digest(10, i), sk), i)
            for i, (pk, sk) in enumerate(members[:quorum])
        ],
    )
    return committee, timeouts, (tc, tc_worst), high_qc


def _bls_fixture(n: int, quorum: int):
    """The same storm over a BLS committee (PoPs in the committee file):
    (committee, timeouts, (tc_realistic, tc_worst), high_qc)."""
    from ..consensus import QC, TC, Timeout, Vote
    from ..consensus.config import Committee
    from ..consensus.messages import timeout_digest
    from ..crypto import Digest
    from ..crypto.bls.service import BlsSigningService
    from ..crypto.scheme import bls_keygen, bls_pop

    seed = b"\x52" * 32
    members = [bls_keygen(seed, i) for i in range(n)]
    committee = Committee.new(
        [(pk, 1, ("127.0.0.1", 41_000 + i)) for i, (pk, _) in enumerate(members)],
        scheme="bls",
        pops={pk: bls_pop(secret) for pk, secret in members},
    )
    signers = [BlsSigningService(secret) for _, secret in members[:quorum]]
    block_digest = Digest.of(b"storm high-qc block")
    vote_digest = Vote(hash=block_digest, round=9, author=members[0][0]).digest()
    high_qc = QC(
        hash=block_digest,
        round=9,
        votes=[
            (members[i][0], signers[i].sign_sync(vote_digest))
            for i in range(quorum)
        ],
    )
    timeouts = []
    for i in range(quorum):
        t = Timeout(high_qc=high_qc, round=10, author=members[i][0])
        t.signature = signers[i].sign_sync(t.digest())
        timeouts.append(t)
    # realistic TC (every entry shares high_qc_round = 9 — same digest)
    tc = TC(
        round=10,
        votes=[
            (members[i][0], signers[i].sign_sync(timeout_digest(10, 9)), 9)
            for i in range(quorum)
        ],
    )
    # adversarial worst case: distinct per-entry digests
    tc_worst = TC(
        round=10,
        votes=[
            (members[i][0], signers[i].sign_sync(timeout_digest(10, i)), i)
            for i in range(quorum)
        ],
    )
    return committee, timeouts, (tc, tc_worst), high_qc


def _measure(committee, timeouts, tc, verifier) -> dict[str, float]:
    out: dict[str, float] = {}
    if hasattr(verifier, "precompute"):
        # epoch setup, exactly like node boot: committee key decode and
        # caching is not storm work
        verifier.precompute([pk.to_bytes() for pk in committee.authorities])
    # 1a. timeout flood WITH the per-core verified-QC memo (product path)
    cache: set = set()
    t0 = time.perf_counter()
    for t in timeouts:
        t.verify(committee, verifier, qc_cache=cache)
    out["flood_memo_s"] = time.perf_counter() - t0
    # 1b. naive flood: every timeout re-verifies the embedded high_qc
    sampled = max(4, len(timeouts) // 16)
    t0 = time.perf_counter()
    for t in timeouts[:sampled]:  # sampled — O(n) QCs
        t.verify(committee, verifier, qc_cache=None)
    out["flood_naive_s"] = (time.perf_counter() - t0) / sampled * len(timeouts)
    # 1c. the burst path (Core._preverify_timeout_burst): per 64-message
    # burst ONE aggregate signature check over the shared timeout
    # digest, then per-timeout stake + memoized-QC checks only
    cache2: set = set()
    t0 = time.perf_counter()
    for start in range(0, len(timeouts), 64):
        chunk = timeouts[start : start + 64]
        if not verifier.verify_shared_msg(
            chunk[0].digest(), [(t.author, t.signature) for t in chunk]
        ):
            raise RuntimeError("storm: a valid timeout burst was rejected")
        for t in chunk:
            t.verify(committee, verifier, qc_cache=cache2, sig_verified=True)
    out["flood_burst_s"] = time.perf_counter() - t0
    # 2. TC verification: realistic (all entries share one timeout
    # digest) and adversarial worst case (every digest distinct)
    tc_real, tc_worst = tc
    t0 = time.perf_counter()
    tc_real.verify(committee, verifier)
    out["tc_verify_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tc_worst.verify(committee, verifier)
    out["tc_worst_verify_s"] = time.perf_counter() - t0
    # 3. the shared high_qc alone (the QC shape at committee scale)
    t0 = time.perf_counter()
    timeouts[0].high_qc.verify(committee, verifier)
    out["qc_verify_s"] = time.perf_counter() - t0
    return out


def _measure_offloop_tc(committee, tc_worst, verifier) -> dict[str, float]:
    """The adversarial TC through the PRODUCTION async claims path: the
    device dispatch runs on a slot thread, so the loop keeps serving
    timers and messages while the verdict computes.  Reports the verify
    wall time AND the worst event-loop stall observed by a 5 ms
    heartbeat during it — the stall, not the wall, is what a view
    change feels."""
    import asyncio

    from ..crypto.async_service import AsyncVerifyService

    out: dict[str, float] = {}

    async def run() -> None:
        service = AsyncVerifyService.for_backend(verifier)
        try:
            service.warm_buckets()
            lags: list[float] = []
            stop = asyncio.Event()

            async def heartbeat():
                loop = asyncio.get_running_loop()
                while not stop.is_set():
                    t0 = loop.time()
                    await asyncio.sleep(0.005)
                    lags.append(loop.time() - t0 - 0.005)

            hb = asyncio.ensure_future(heartbeat())
            await asyncio.sleep(0.05)  # heartbeat baseline
            t0 = time.perf_counter()
            verdicts = await service.verify_claims(tc_worst.claims())
            out["offloop_tc_worst_s"] = time.perf_counter() - t0
            stop.set()
            await hb
            if not all(verdicts):
                raise RuntimeError("storm: the off-loop TC was rejected")
            out["offloop_max_stall_s"] = max(lags) if lags else 0.0
        finally:
            service.close()

    asyncio.run(run())
    return out


def run_storm(
    nodes: int = N_DEFAULT, device: bool = False, torch_device=None,
    bls: bool = True,
) -> dict[str, dict[str, float]]:
    """The storm's rows per backend.  ``device=True`` adds the
    ``ed25519-cuda`` row on ``make_verifier("cuda", device=torch_device)``
    (the current CUDA device by default; ``"cpu"`` runs the kernels'
    plain versions); ``bls=True`` the BLS rows (``bls_rows``)."""
    from ..crypto.service import CpuVerifier

    quorum = 2 * nodes // 3 + 1
    results: dict[str, dict[str, float]] = {}

    committee, timeouts, tc, _ = _ed25519_fixture(nodes, quorum)
    results["ed25519-cpu"] = _measure(committee, timeouts, tc, CpuVerifier())

    if device:
        from ..node.node import make_verifier

        # production hybrid routing: single-signature verifies stay on
        # the CPU, certificate-sized batches go to the device
        v = make_verifier("cuda", device=torch_device)
        v.precompute([pk.to_bytes() for pk in committee.authorities])
        v.warmup(batch=quorum)
        row = _measure(committee, timeouts, tc, v)
        row.update(_measure_offloop_tc(committee, tc[1], v))
        results["ed25519-cuda"] = row

    if bls:
        results.update(
            bls_rows(_bls_fixture(nodes, quorum), quorum, device, torch_device)
        )
    return results


def bls_rows(
    fixture, quorum: int, device: bool = False, torch_device=None
) -> dict[str, dict[str, float]]:
    """The BLS rows on a ``_bls_fixture`` result: ``bls-cpu`` (with its
    off-loop TC row) and, with ``device=True``, ``bls-cuda-storm-offload``
    when the offload engages at ``quorum``."""
    from ..crypto.scheme import make_cpu_verifier, make_device_verifier

    committee, timeouts, tc, _ = fixture
    results: dict[str, dict[str, float]] = {}
    bls_verifier = make_cpu_verifier("bls")
    results["bls-cpu"] = _measure(committee, timeouts, tc, bls_verifier)
    if getattr(bls_verifier, "async_kind", None):
        results["bls-cpu"].update(
            _measure_offloop_tc(committee, tc[1], bls_verifier)
        )
    if device:
        # the device ladder offload for the all-distinct storm, measured
        # next to the host route
        v = make_device_verifier("bls", "cuda", device=torch_device)
        v.warmup_storm_offload(quorum)
        # only publish the row when the offload will serve this quorum
        # size — a declined offload (quorum < 16) would measure the host
        # route under the offload label
        if v.storm_offload_engaged(quorum):
            results["bls-cuda-storm-offload"] = _measure(
                committee, timeouts, tc, v
            )
        else:
            print(
                f" storm offload declined for quorum={quorum} "
                "(not warmed or below the n>=16 floor); "
                "bls-cuda-storm-offload row skipped"
            )
    return results


def format_report(nodes: int, results: dict[str, dict[str, float]]) -> str:
    quorum = 2 * nodes // 3 + 1
    lines = [
        "-" * 64,
        " VIEW-CHANGE STORM (BASELINE config 4)",
        f" Committee: {nodes} nodes (f = {(nodes - 1) // 3}), quorum = {quorum}",
        "-" * 64,
    ]
    for backend, m in results.items():
        lines += [
            f" + {backend}:",
            f"   Timeout flood x{quorum} (verified-QC memo): "
            f"{_fmt_ms(m['flood_memo_s'])}",
            f"   Timeout flood x{quorum} (naive, extrapolated): "
            f"{_fmt_ms(m['flood_naive_s'])}",
            f"   Timeout flood x{quorum} (burst aggregate): "
            f"{_fmt_ms(m['flood_burst_s'])}",
            f"   TC verify ({quorum} entries, shared high_qc_round): "
            f"{_fmt_ms(m['tc_verify_s'])}",
            f"   TC verify ({quorum} DISTINCT digests, worst case): "
            f"{_fmt_ms(m['tc_worst_verify_s'])}",
            f"   QC verify ({quorum} votes, shared digest): "
            f"{_fmt_ms(m['qc_verify_s'])}",
        ]
        if "offloop_tc_worst_s" in m:
            lines += [
                f"   TC worst case OFF-LOOP (async claims path): "
                f"{_fmt_ms(m['offloop_tc_worst_s'])} wall, "
                f"max event-loop stall "
                f"{_fmt_ms(m['offloop_max_stall_s'])}",
            ]
    lines.append("-" * 64)
    return "\n".join(lines)
