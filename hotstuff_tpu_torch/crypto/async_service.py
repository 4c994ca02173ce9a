"""Asynchronous, coalescing signature verification.

A copy of ``hotstuff_tpu.crypto.async_service``, the dispatch layer
between the consensus cores and the device verifier: a core collects
every signature check a message burst needs as *claims*, submits them
here, and awaits ONE verdict per claim, while the device dispatch runs
on a worker thread so the event loop keeps processing votes, proposals
and payload ingest.  The worker thread parks on the device for free
because the kernel launch (``ctypes``) and the verdict readback
(``Tensor.cpu``) release the GIL.  The CPU route runs inline, as in the
JAX package: its batch equation releases the GIL too, but its per-item
attribution on a failing batch holds it.

Claims (the burst-level accumulate-then-dispatch unit):

- ``("one", digest_bytes, pk_bytes, sig_bytes)`` — a single signature
  over its own message (votes, block author sigs, TC entries);
- ``("shared", digest_bytes, ((pk_bytes, sig_bytes), ...))`` — many
  signatures over ONE message (the QC shape; also grouped timeout
  floods).  Verdict is all-or-nothing;
- ``("agg", digest_bytes, agg_sig_bytes, (pk_bytes, ...))`` — a compact
  (aggregated BLS) certificate; an Ed25519 backend rejects it.

Everything else is flattened into one ``verify_many`` batch — one device
dispatch for the whole wave.

Adaptive routing: the service tracks an EWMA of device dispatch wall
time and routes each batch to the device only when that estimate beats
the CPU cost model: the native batch equation's
(``cpu_batch_estimate_s``) for waves of ``NATIVE_BATCH_MIN`` signatures
or more while the batch path is on, else ``CPU_US_PER_SIG`` a
signature.  When the device
degrades the service degrades to the CPU path instead of stalling
consensus, and keeps probing the device so it notices a recovery.

Pipelined dispatch: up to ``pipeline_depth`` device waves may be in
flight at once (default 2, ``HOTSTUFF_VERIFY_PIPELINE``).  While wave N
waits on the device, wave N+1 flattens, pads and stages on a second
slot thread.  Each wave lands through its own completion future:
out-of-order completion resolves each batch's own waiters, and a failed
wave poisons only its own futures.  With waves already in flight the
EWMA is discounted by ``PIPELINE_MARGINAL_COST``.  At full occupancy a
device-preferred wave QUEUES for a slot (bounded by the earliest
in-flight deadline) rather than spilling to the CPU; an OVERDUE
in-flight wave routes everything to the CPU.

The slot threads (``_DispatchLoop``) each keep their own staging buffers
and CUDA stream in the device backend (``gpu/ed25519.py`` keys both by
thread), so the slots are a ring of preallocated staging buffers.
Waves routed to a padding-capable backend (``supports_wave_padding``)
are pre-padded to fixed bucket shapes (``HOTSTUFF_WAVE_BUCKETS``,
default 16/64/256/1024) with always-valid pad claims, so every dispatch
lands on a shape ``warm_buckets`` already ran; an optional round window
(``HOTSTUFF_COALESCE_WINDOW_MS``) holds the wave open so QC and TC
claims from the same round merge into one dispatch with a claim-table
fanout on readback.

Zero-copy ingest: receivers note vote frames to a native wave packer
(``ZeroCopyIngest`` over ``native/wave_pack.cpp``), and a dispatch wave
whose claims are exactly the packed prefix adopts the arena the packer
filled (``AdoptedWave``), staged by ``verify_packed`` from ``frombuffer``
views on the device route, or verified by one native batch equation from
the arena's column addresses on the CPU route.  With telemetry on
(``hotstuff_tpu_torch.telemetry``) the service registers the reference's
instruments: claims submitted and unique, the wave-size histogram, the
device and host wall seconds, the waves a route and the ingest
counters.  Backends that prefer aggregate verification of shared claims
(BLS: one pairing equality a claim instead of one a signature) advertise
``prefers_aggregate = True`` and get their own branch of
``eval_claims_sync``; ``always_offload`` backends always take the worker
threads.
"""

from __future__ import annotations

import asyncio
import atexit
import logging
import queue
import threading
import time

from ..telemetry import spans as _spans
from . import native_ed25519
from .digest import DIGEST_SIZE
from .native_ed25519 import NATIVE_BATCH_MIN

log = logging.getLogger(__name__)

# Single-signature CPU verify cost, measured for the JAX package's host
# (OpenSSL Ed25519 via `cryptography`: ~123-142 us).  Only used as the
# device-vs-CPU routing threshold — an order-of-magnitude estimate is
# enough.  A host without `cryptography` runs the pure-Python oracle,
# which is slower: chip_smoke.py prints the measured figure beside this.
CPU_US_PER_SIG = 130.0

# Native-batch cost model: per-sig cost ~ asymptote + fixed/n (the
# multiscalar's bucket cost amortizes with n).  The JAX package's fit to
# its host's measurements (~108 us/sig at 11, ~54 at 32, ~46 at 128, ~36
# at 256); kept as it is so both packages route alike.
CPU_BATCH_US_PER_SIG = 45.0
CPU_BATCH_FIXED_US = 700.0


def cpu_batch_estimate_s(n_sigs: int) -> float:
    """Estimated batched-CPU wall seconds for an n_sigs wave."""
    return n_sigs * (CPU_BATCH_US_PER_SIG + CPU_BATCH_FIXED_US / n_sigs) * 1e-6

# EWMA smoothing for device dispatch wall time.
_EWMA_ALPHA = 0.3

# When the device EWMA says "lose", still probe the device this often so
# a recovered device is noticed (seconds).
_PROBE_INTERVAL_S = 3.0

# Default dispatch pipeline depth: waves in flight on the device at
# once.  2 gives staging/execute overlap without queueing enough work
# behind a device stall to hurt (the deadline + overdue routing below
# bound the damage to one deadline regardless of depth).
DEFAULT_PIPELINE_DEPTH = 2

# Marginal cost factor for a device dispatch when waves are already in
# flight: concurrent dispatches pipeline (measured: 16 in flight ≈ the
# cost of 1), so the route cost model discounts the EWMA for every wave
# after the first instead of charging each a full round trip.
PIPELINE_MARGINAL_COST = 0.25


def pipeline_depth_from_env() -> int:
    """Dispatch pipeline depth from HOTSTUFF_VERIFY_PIPELINE (min 1)."""
    import os

    raw = os.environ.get("HOTSTUFF_VERIFY_PIPELINE", "")
    try:
        depth = int(raw)
    except ValueError:
        depth = DEFAULT_PIPELINE_DEPTH
    return max(1, depth)


# Fixed wave shapes: device-routed waves on padding-capable backends are
# pre-padded with always-valid pad claims to the smallest of these bucket
# sizes, so every dispatch lands on a warmed shape.  The verifier pads
# again to its own grid (gpu/ed25519.py PAD_SIZES, 128/256/1024), as the
# JAX package's verifier does.
DEFAULT_WAVE_BUCKETS: tuple[int, ...] = (16, 64, 256, 1024)


def wave_buckets_from_env() -> tuple[int, ...]:
    """Wave bucket sizes from HOTSTUFF_WAVE_BUCKETS (comma-separated,
    e.g. "16,64,256,1024"); "0"/"off" disables fixed-shape padding
    (returns an empty tuple).  Unset or unparsable -> the default."""
    import os

    raw = os.environ.get("HOTSTUFF_WAVE_BUCKETS")
    if raw is None:
        return DEFAULT_WAVE_BUCKETS
    raw = raw.strip().lower()
    if raw in ("", "0", "off", "none", "no", "false"):
        return ()
    try:
        sizes = sorted({int(tok) for tok in raw.split(",") if tok.strip()})
    except ValueError:
        return DEFAULT_WAVE_BUCKETS
    return tuple(s for s in sizes if s > 0)


def resolve_wave_buckets(backend) -> tuple[int, ...]:
    """The bucket ladder for ``backend``: an explicit
    ``HOTSTUFF_WAVE_BUCKETS`` always wins; otherwise a backend that
    advertises ``wave_bucket_shapes`` gets its own shapes; everything
    else gets the canonical default ladder."""
    import os

    if "HOTSTUFF_WAVE_BUCKETS" in os.environ:
        return wave_buckets_from_env()
    shapes = getattr(backend, "wave_bucket_shapes", None)
    if shapes:
        return tuple(sorted({int(b) for b in shapes if int(b) > 0}))
    return DEFAULT_WAVE_BUCKETS


def coalesce_window_s_from_env() -> float:
    """QC+TC coalescing window from HOTSTUFF_COALESCE_WINDOW_MS, in
    SECONDS.  Default 0: coalescing stays yield-based (two event-loop
    passes), adding zero latency; a positive window holds each wave
    open so both certificate kinds from one round share a dispatch."""
    import os

    raw = os.environ.get("HOTSTUFF_COALESCE_WINDOW_MS", "")
    try:
        ms = float(raw)
    except ValueError:
        ms = 0.0
    return max(0.0, ms) * 1e-3


def claim_sig_count(c) -> int:
    """Signatures a claim carries: 1 for "one", the vote-list length for
    "shared", the SIGNER count for "agg" (whose c[2] is the 48-byte
    aggregate-signature blob — len(c[2]) would miscount it as 48)."""
    if c[0] == "one":
        return 1
    if c[0] == "agg":
        return len(c[3])
    return len(c[2])


def flatten_claims(claims: list) -> tuple[list, list, list, list]:
    """Claims -> (digests, pks, sigs, spans); spans[i] = (start, end)
    slice of the flat arrays belonging to claims[i].

    Kept allocation-lean: the column lists are preallocated at their
    final length in one sizing pass and filled by index, so the hot loop
    never grows a list or re-reads ``len`` per claim."""
    n_claims = len(claims)
    spans: list = [None] * n_claims
    total = 0
    for i, claim in enumerate(claims):
        k = 1 if claim[0] == "one" else len(claim[2])
        spans[i] = (total, total + k)
        total += k
    digests: list = [None] * total
    pks: list = [None] * total
    sigs: list = [None] * total
    pos = 0
    for claim in claims:
        if claim[0] == "one":
            digests[pos] = claim[1]
            pks[pos] = claim[2]
            sigs[pos] = claim[3]
            pos += 1
        else:  # "shared"
            d = claim[1]
            for pk, sig in claim[2]:
                digests[pos] = d
                pks[pos] = pk
                sigs[pos] = sig
                pos += 1
    return digests, pks, sigs, spans


def eval_claims_sync(backend, claims: list) -> list[bool]:
    """Synchronous claim evaluation on ``backend`` (the inline path and
    the worker-thread body).  Shared claims go through the backend's
    aggregate check when it prefers one (BLS: one pairing equality a
    claim); otherwise everything flattens into a single batch — one
    native batch equation on a ``supports_flat_batch`` backend,
    ``verify_many`` otherwise or when that equation fails — and each
    claim's verdict is ``all()`` over its own span."""
    if getattr(backend, "prefers_aggregate", False):
        with _spans.span("agg.verify"):
            from .digest import Digest
            from .keys import PublicKey
            from .signature import Signature

            out: list[bool] = []
            singles: list[tuple[int, tuple]] = []
            for claim in claims:
                if claim[0] == "shared":
                    votes = [
                        (PublicKey(pk), Signature(sig))
                        for pk, sig in claim[2]
                    ]
                    # zero signatures prove nothing (flatten path below)
                    out.append(
                        bool(votes)
                        and bool(
                            backend.verify_shared_msg(Digest(claim[1]), votes)
                        )
                    )
                elif claim[0] == "agg":
                    # compact certificate: pre-aggregated signature +
                    # bitmap-resolved signer keys — ONE pairing however
                    # large the committee.  claim[2] is the agg-sig
                    # BYTES (not a vote list): it must never reach the
                    # flatten/verify_many shapes.
                    fn = getattr(backend, "verify_aggregate_msg", None)
                    out.append(
                        fn is not None
                        and bool(
                            fn(Digest(claim[1]), list(claim[3]), claim[2])
                        )
                    )
                else:
                    singles.append((len(out), claim))
                    out.append(False)  # placeholder
            if singles:
                ok = backend.verify_many(
                    [c[1] for _, c in singles],
                    [c[2] for _, c in singles],
                    [c[3] for _, c in singles],
                )
                for (pos, _), valid in zip(singles, ok):
                    out[pos] = bool(valid)
            return out

    if any(c[0] == "agg" for c in claims):
        # non-aggregating backend (ed25519) handed a compact
        # certificate: resolve each "agg" claim directly (False when the
        # backend has no aggregate verify — the wire layer already
        # rejects compact forms for such committees, this is the
        # loopback/defence-in-depth path) and recurse on the rest.
        from .digest import Digest

        fn = getattr(backend, "verify_aggregate_msg", None)
        out = []
        rest = [c for c in claims if c[0] != "agg"]
        rest_verdicts = iter(
            eval_claims_sync(backend, rest) if rest else ()
        )
        for c in claims:
            if c[0] == "agg":
                out.append(
                    fn is not None
                    and bool(fn(Digest(c[1]), list(c[3]), c[2]))
                )
            else:
                out.append(next(rest_verdicts))
        return out

    with _spans.span("flatten"):
        digests, pks, sigs, spans = flatten_claims(claims)
    if not digests:
        # every claim here is an empty "shared" (zero members): a
        # certificate with no signatures proves nothing — vacuous truth
        # (all() over an empty span) would verify a votes=[] forgery
        return [False] * len(claims)
    # Wave-level fast path (CPU backend): ONE dalek-parity batch
    # equation over the whole flattened wave — in the common all-valid
    # case this replaces len(digests) OpenSSL verifies with a single
    # multiscalar.  Sound because every claim's verdict here is
    # all(span): a passing batch implies every span passes.  On a
    # failing batch fall through to per-item attribution (the adversary
    # pays for that path).
    if (
        len(digests) >= NATIVE_BATCH_MIN
        and getattr(backend, "supports_flat_batch", False)
        and all(len(d) == DIGEST_SIZE for d in digests)
    ):
        with _spans.span("host.verify"):
            fast_ok = native_ed25519.available() and native_ed25519.batch_verify(
                b"".join(digests),
                DIGEST_SIZE,
                b"".join(pks),
                b"".join(sigs),
                len(digests),
                shared=False,
            )
        if fast_ok:
            return [e > s for s, e in spans]
    ok = backend.verify_many(digests, pks, sigs)
    return [all(ok[s:e]) if e > s else False for s, e in spans]


_pad_claim_cached: tuple | None = None


def make_pad_claim() -> tuple:
    """The deterministic filler claim for fixed-shape padding: one VALID
    self-contained ed25519 signature over a reserved digest, the same
    bytes as the JAX package's pad claim.  Claim verdicts are per claim
    (``all()`` over each claim's own span of the flat arrays), so a
    valid pad can never flip a real claim's verdict."""
    global _pad_claim_cached
    if _pad_claim_cached is None:
        from .digest import Digest
        from .keys import generate_keypair
        from .signature import Signature

        pk, sk = generate_keypair(b"\xa5" * 32, 0xFFFF)
        digest = Digest.of(b"hotstuff_tpu wave pad claim v1")
        sig = Signature.new(digest, sk)
        _pad_claim_cached = (
            "one", digest.to_bytes(), pk.to_bytes(), sig.to_bytes()
        )
    return _pad_claim_cached


# ---------------------------------------------------------------------------
# Zero-copy wire -> device ingest
#
# Receivers note every vote frame to a native wave packer
# (native/wave_pack.cpp), which parses it and packs its digest, pk and
# sig columns straight into bucket-shaped staging arenas.  When a
# dispatch wave's claim stream turns out to be exactly the packed arena
# prefix (receive order == claim submission order), the service ADOPTS
# the arena — the verifier stages from frombuffer views over memory the
# native parser already filled — instead of walking Python claim
# tuples.  Adoption is an exact byte-level match; any divergence
# (deduped duplicates, dropped votes, mixed QC+vote waves, co-located
# multi-node dedup) falls back to flatten_claims.  The arena is an
# accelerator, never a correctness dependency.
# ---------------------------------------------------------------------------

#: wire tag of a vote frame (consensus/wire.py TAG_VOTE); importing
#: consensus.wire here would cycle (wire imports crypto), so the tests
#: hold this constant against the live one
INGEST_TAG_VOTE = 1

DEFAULT_INGEST_RING_DEPTH = 6


def zero_copy_from_env() -> bool:
    """HOTSTUFF_ZERO_COPY: "0"/"off" disables the ingest arenas;
    default on."""
    import os

    raw = os.environ.get("HOTSTUFF_ZERO_COPY", "").strip().lower()
    return raw not in ("0", "off", "no", "false", "none")


def ingest_arena_rows_from_env() -> int:
    """HOTSTUFF_INGEST_ARENA_ROWS: staging-arena capacity in claim rows;
    default the largest canonical wave bucket, so every bucket-shaped
    wave is a prefix view of one arena."""
    import os

    raw = os.environ.get("HOTSTUFF_INGEST_ARENA_ROWS", "")
    try:
        rows = int(raw)
    except ValueError:
        rows = 0
    return rows if rows > 0 else DEFAULT_WAVE_BUCKETS[-1]


def ingest_ring_from_env() -> int:
    """HOTSTUFF_INGEST_RING: staging arenas in the native ring (min 2:
    one open for packing while sealed ones are in flight); default 6 —
    pipeline depth 2, a probe, and headroom before packing resyncs."""
    import os

    raw = os.environ.get("HOTSTUFF_INGEST_RING", "")
    try:
        depth = int(raw)
    except ValueError:
        depth = 0
    return depth if depth >= 2 else DEFAULT_INGEST_RING_DEPTH


class AdoptedWave:
    """A sealed native staging arena adopted as one verification wave:
    ``n`` real claim rows followed by valid pad rows up to ``rows`` (the
    wave bucket).  The column views die when ``release`` recycles the
    arena — every consumer releases in a ``finally``, after its last
    read of the columns."""

    __slots__ = (
        "ingest", "arena", "n", "rows",
        "dig", "pk", "sig", "dig_addr", "pk_addr", "sig_addr",
        "_released",
    )

    def __init__(self, ingest, arena: int, n: int, rows: int, info):
        from .native_ed25519 import column_view

        self.ingest = ingest
        self.arena = arena
        self.n = n
        self.rows = rows
        self.dig_addr, self.pk_addr, self.sig_addr = info[0], info[1], info[2]
        self.dig = column_view(self.dig_addr, rows * 32)
        self.pk = column_view(self.pk_addr, rows * 32)
        self.sig = column_view(self.sig_addr, rows * 64)
        self._released = False

    def release(self) -> None:
        """Recycle the arena (idempotent; runs on verifier slot threads
        — the native mutex serializes it with event-loop packing)."""
        if not self._released:
            self._released = True
            self.ingest.packer.recycle(self.arena)


class ZeroCopyIngest:
    """Process-global zero-copy ingest plane: owns the native arena
    ring and the Python-side key mirror that proves adoption safe.

    ``note_vote_frame`` (event loop, receive path) packs each vote's
    digest/pk/sig columns natively and mirrors the claim KEY (the exact
    bytes ``Vote.claim()`` would produce).  ``try_adopt`` (event loop,
    dispatcher) hands the arena over iff the wave's claims are exactly
    the packed key prefix — verdicts bind positionally downstream, so
    the match must be exact, and the mirror makes it checkable without
    decoding anything twice."""

    def __init__(
        self, capacity: int | None = None, ring_depth: int | None = None
    ):
        from .native_ed25519 import WavePacker

        cap = capacity if capacity else ingest_arena_rows_from_env()
        depth = ring_depth if ring_depth else ingest_ring_from_env()
        self.packer = WavePacker(cap, depth)
        pad = make_pad_claim()
        if not self.packer.set_pad(pad[1], pad[2], pad[3]):
            raise RuntimeError("wave packer pad install failed")
        self._keys: list[tuple] = []
        self.packed_votes = 0
        self.zero_copy_waves = 0
        self.fallback_waves = 0

    @property
    def active(self) -> bool:
        """Any packed votes pending adoption?  The dispatcher skips the
        adoption attempt entirely when nothing was packed."""
        return bool(self._keys)

    def note_vote_frame(self, frame: bytes) -> bool:
        r = self.packer.pack_vote(frame)
        if isinstance(r, int):
            if r == -2:
                # open arena full: the pack stream outran adoption (an
                # idle service, or votes that never became claims) —
                # resync rather than wedge with a full arena forever
                self._resync()
            return False
        _slot, digest = r
        # the claim key mirrors Vote.claim(): (digest, author pk, sig) —
        # pk/sig slices at the fixed ed25519 vote-frame offsets
        self._keys.append((digest, frame[45:77], frame[81:145]))
        self.packed_votes += 1
        return True

    def try_adopt(self, claims: list, buckets) -> AdoptedWave | None:
        """Adopt the packed prefix as ``claims``' wave, or None.

        On a mismatch that OVERLAPS the packed stream (a packed vote is
        in this wave but not at its packed position: dedup, a dropped
        vote, a mixed QC+vote wave) the open arena is discarded — those
        rows can never line up again.  A wave fully DISJOINT from the
        packed keys (a pure QC/proposal wave between vote bursts) leaves
        the arena untouched for the next wave."""
        keys = self._keys
        n = len(claims)
        if n <= len(keys):
            for i in range(n):
                c = claims[i]
                if c[0] != "one" or (c[1], c[2], c[3]) != keys[i]:
                    break
            else:
                rows = next((b for b in buckets if b >= n), None)
                if rows is None or rows > self.packer.capacity:
                    rows = n
                arena = self.packer.seal(n)
                if arena is None:
                    self._resync()
                    return None
                info = self.packer.arena_info(arena)
                if info is None:  # unreachable right after seal
                    self.packer.recycle(arena)
                    self._resync()
                    return None
                del keys[:n]
                self.zero_copy_waves += 1
                return AdoptedWave(self, arena, n, rows, info)
        key_set = set(keys)
        if any(
            c[0] == "one" and (c[1], c[2], c[3]) in key_set for c in claims
        ):
            self._resync()
            self.fallback_waves += 1
        return None

    def _resync(self) -> None:
        self.packer.discard()
        self._keys.clear()

    def counters(self) -> dict:
        out = self.packer.counters()
        out["zero_copy_waves"] = self.zero_copy_waves
        out["fallback_waves"] = self.fallback_waves
        return out


#: None = never created; False = disabled (HOTSTUFF_ZERO_COPY=0); else
#: the live ZeroCopyIngest
_zero_copy: "ZeroCopyIngest | bool | None" = None


def zero_copy_ingest() -> "ZeroCopyIngest | None":
    """The process-global ingest plane, created by the first receiver;
    None when disabled (``HOTSTUFF_ZERO_COPY=0``).  With the plane
    enabled, a library that fails to build or load raises here — the
    JAX package logs and goes on without the plane; the port names the
    switch instead of degrading quietly."""
    global _zero_copy
    if _zero_copy is None:
        if not zero_copy_from_env():
            _zero_copy = False
        else:
            try:
                _zero_copy = ZeroCopyIngest()
            except Exception as e:
                raise RuntimeError(
                    f"the zero-copy ingest plane failed to start ({e}); "
                    "set HOTSTUFF_ZERO_COPY=0 to run without it"
                ) from e
    return _zero_copy if type(_zero_copy) is ZeroCopyIngest else None


def zero_copy_ingest_if_active() -> "ZeroCopyIngest | None":
    """The ingest plane IF a receiver already created it — the
    dispatcher-side accessor: never triggers a native build from the
    verify path."""
    return _zero_copy if type(_zero_copy) is ZeroCopyIngest else None


def ingest_note_frame(frame: bytes) -> None:
    """Receiver-side hook: feed one raw inbound frame to the zero-copy
    plane just before handler dispatch.  Only vote frames are packed;
    anything else is a cheap tag test.  A packing error never reaches
    the receive loop: the wave falls back to the Python path."""
    if not frame or frame[0] != INGEST_TAG_VOTE:
        return
    ing = zero_copy_ingest()
    if ing is not None:
        try:
            ing.note_vote_frame(frame)
        except Exception:  # noqa: BLE001 — a packer bug must not kill
            # the connection; the wave simply falls back to Python
            log.exception("zero-copy vote pack failed")


def eval_claims_arena(backend, wave: AdoptedWave, claims: list) -> list[bool]:
    """Evaluate an adopted zero-copy wave: the arena columns ARE the
    staging arrays — no flatten, no per-claim bytes.  Device backends
    verify through ``verify_packed`` (frombuffer views over the columns,
    at the pre-padded bucket shape), which has consumed every arena byte
    by the time it returns: ``BatchVerifier.prepare_packed`` copies the
    rows into its own staging slot before any asynchronous copy to the
    card.  CPU backends run ONE native batch equation straight from the
    column addresses.  Any miss (a failing batch equation, which needs
    per-item attribution, or a backend with neither path) evaluates the
    claim list with ``eval_claims_sync``.  Always releases the arena."""
    try:
        n = wave.n
        fn = getattr(backend, "verify_packed", None)
        if fn is not None:
            out = fn(wave.dig, wave.pk, wave.sig, wave.rows)
            return [bool(v) for v in out[:n]]
        if (
            n >= NATIVE_BATCH_MIN
            and getattr(backend, "supports_flat_batch", False)
            and native_ed25519.available()
        ):
            with _spans.span("host.verify"):
                fast_ok = native_ed25519.batch_verify_columns(
                    wave.dig_addr, wave.pk_addr, wave.sig_addr, n
                )
            if fast_ok:
                return [True] * n
        return eval_claims_sync(backend, claims)
    finally:
        wave.release()


#: every live _DispatchLoop, for interpreter-exit shutdown: slot threads
#: are daemons AND get an explicit sentinel at atexit
_live_dispatch_loops: "set[_DispatchLoop]" = set()


@atexit.register
def _shutdown_dispatch_loops() -> None:
    for dl in list(_live_dispatch_loops):
        dl.close()


class _DispatchLoop:
    """The dedicated dispatch loop: ``depth`` long-lived slot
    threads over one queue, replacing the per-service
    ``ThreadPoolExecutor`` hop (thread-pool bookkeeping, per-submit
    ``concurrent.futures`` machinery, idle-timeout respawn).  Each slot
    thread keeps its own thread-local staging scratch in the device
    backend, so a slot is one entry of a preallocated staging-buffer
    ring: with ``depth`` slots, up to ``depth`` waves stage/execute
    concurrently and never allocate fresh host buffers.

    Completion callbacks run ON the slot thread — callers hop back to
    their event loop with ``call_soon_threadsafe``.  Threads are lazy
    (first ``submit`` starts them), daemonic, and shut down cleanly on
    ``close()`` and at interpreter exit."""

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._threads: list[threading.Thread] = []
        self._closed = False
        _live_dispatch_loops.add(self)

    def submit(self, fn, on_done) -> None:
        """Queue ``fn`` for the next free slot thread;
        ``on_done(result, exc)`` runs on that thread when it finishes."""
        if self._closed:
            raise RuntimeError("dispatch loop is closed")
        if not self._threads:
            for i in range(self.depth):
                t = threading.Thread(
                    target=self._worker,
                    name=f"verify-slot-{i}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
        self._q.put((fn, on_done))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, on_done = item
            try:
                result, exc = fn(), None
            except BaseException as e:  # noqa: BLE001 — delivered to the
                result, exc = None, e  # waiter, never raised in the slot
            try:
                on_done(result, exc)
            except Exception:  # noqa: BLE001 — a delivery failure must
                log.exception("verify dispatch delivery failed")

    def close(self, wait: bool = False) -> None:
        """Stop the slot threads after their current job (idempotent)."""
        if self._closed:
            return
        self._closed = True
        _live_dispatch_loops.discard(self)
        for _ in range(len(self._threads)):
            self._q.put(None)
        if wait:
            for t in self._threads:
                t.join(timeout=1.0)
        self._threads = []


class AsyncVerifyService:
    """Coalesces claim batches and (for device backends) dispatches them
    from a worker thread.

    One service instance per (event loop, device backend): in-process
    committees share the backend object (node.LazyDeviceVerifier keeps a
    per-kind singleton), so every node's claims coalesce into the same
    dispatch stream — one device dispatch covers the whole committee's
    wave.  CPU backends get an inline service (``device=False``): claims
    evaluate synchronously at the submit point, zero added latency.
    """

    _registry: dict[tuple, tuple] = {}  # (loop id, kind) -> (loop, service)
    _serial = 0  # distinguishes private services' cumulative stat lines

    def __init__(
        self, backend, device: bool = False, pipeline_depth: int | None = None
    ):
        AsyncVerifyService._serial += 1
        # stable tag for the scraped stats line: kind#pid.serial —
        # cumulative counters from different service instances must be
        # separable in MERGED logs: the serial separates private
        # per-core services (--no-claim-dedup) within one process, the
        # pid separates processes (every node process restarts the
        # class counter at 1, and the parser sums the last line per tag)
        import os

        kind = getattr(backend, "async_kind", None) or getattr(
            backend, "name", "cpu"
        )
        self._backend_kind = kind
        self._stats_tag = f"{kind}#{os.getpid()}.{AsyncVerifyService._serial}"
        # For inline services ``backend`` is the VerifierBackend itself.
        # For device services it is the HOST (node.LazyDeviceVerifier):
        # ``host.device_ready`` gates routing (never build the kernels or
        # stage a new shape mid-consensus), ``host.async_backend`` is the
        # forced-device dispatch view, ``host.cpu_backend`` the fallback.
        self.backend = backend
        self.device = device
        self._pending: list[tuple[list, asyncio.Future]] = []
        # profiling: perf_counter_ns stamps of device-path submissions in
        # the current coalescing window (empty unless spans.enable() ran)
        self._arrivals: list[int] = []
        self._task: asyncio.Task | None = None
        self._dispatch: _DispatchLoop | None = None
        # fixed-shape wave padding + round coalescing.  Packing only
        # applies when the backend advertises supports_wave_padding (real
        # device verifiers): synthetic test hosts and CPU backends see
        # exactly the claims submitted.  Bucket shapes resolve per
        # access (see the wave_buckets property).
        self.coalesce_window_s = coalesce_window_s_from_env()
        self.packed_waves = 0
        self.pad_sigs = 0
        # adaptive routing state
        self._device_ewma_s: float | None = None
        self._last_probe = 0.0
        # dispatch pipeline: wave serial -> monotonic deadline
        # stamp for every device dispatch currently in flight.  Routing
        # reads occupancy (len) and overdue-ness; landers and probe
        # done-callbacks remove their wave and signal _slot_free.
        self.pipeline_depth = (
            max(1, int(pipeline_depth))
            if pipeline_depth
            else pipeline_depth_from_env()
        )
        self._inflight: dict[int, float] = {}
        self._wave_serial = 0
        self._slot_free: asyncio.Event | None = None
        self._landers: set[asyncio.Task] = set()
        self.dispatches = 0
        self.device_dispatches = 0
        self.cpu_dispatches = 0
        self.probe_dispatches = 0
        self.device_sigs = 0
        self.cpu_sigs = 0
        # compact-certificate ("agg") claims and the signer count they
        # covered, surfaced on the stats line
        self.agg_claims = 0
        self.agg_sigs = 0
        self.deadline_misses = 0
        self.pipeline_waits = 0
        self.peak_inflight = 0
        # zero-copy ingest plane: waves adopted straight from a native
        # staging arena vs. vote-overlapping waves that had to resync
        self.zero_copy_waves = 0
        self.zero_copy_sigs = 0
        self.fallback_waves = 0
        self._next_stats_log = 0.0
        # Telemetry instruments, labelled by the service tag and the
        # backend kind.  All None when telemetry is off — every hot-path
        # touch below is guarded on ``_tel_wave`` (or its own
        # instrument) so the disabled cost is one attribute test a wave.
        self._tel_wave = None
        self._tel_claims_submitted = None
        self._tel_claims_unique = None
        self._tel_device_wall = None
        self._tel_host_wall = None
        self._tel_route = None
        self._tel_zero_copy = None
        self._tel_fallback = None
        from .. import telemetry

        if telemetry.enabled():
            reg = telemetry.registry()
            # the backend label is the kind without its torch device
            # (``cuda`` for ``cuda@cuda:0``); the svc tag keeps the rest
            labels = {"svc": self._stats_tag, "backend": kind.partition("@")[0]}
            self._tel_claims_submitted = reg.counter(
                "verify_claims_submitted",
                "Verification claims submitted (pre-dedup, all cores)",
                labels,
            )
            self._tel_claims_unique = reg.counter(
                "verify_claims_unique",
                "Unique claims actually evaluated after cross-core dedup",
                labels,
            )
            self._tel_wave = reg.histogram(
                "verify_wave_sigs",
                "Signatures per coalesced dispatch wave",
                labels,
                bounds=telemetry.SIZE_BOUNDS,
            )
            self._tel_device_wall = reg.float_counter(
                "verify_device_wall_seconds",
                "Wall seconds spent inside device verify dispatches",
                labels,
            )
            self._tel_host_wall = reg.float_counter(
                "verify_host_wall_seconds",
                "Wall seconds spent in host (CPU) claim evaluation",
                labels,
            )
            # "mesh" stays 0 until the mesh verifier is ported: the
            # family carries the reference's five routes
            self._tel_route = {
                r: reg.counter(
                    "verify_route",
                    "Dispatch waves by routing decision",
                    {**labels, "route": r},
                )
                for r in ("device", "mesh", "cpu", "probe", "wait")
            }
            self._tel_zero_copy = reg.counter(
                "ingest_zero_copy_waves",
                "Waves adopted straight from a native ingest arena",
                labels,
            )
            self._tel_fallback = reg.counter(
                "ingest_fallback_waves",
                "Vote-overlapping waves that fell back to Python flatten",
                labels,
            )
            reg.gauge(
                "verify_pending_batches",
                "Submissions queued for the next dispatch wave",
                labels,
                fn=lambda: len(self._pending),
            )
            reg.gauge(
                "verify_inflight_waves",
                "Device dispatch waves currently in flight",
                labels,
                fn=lambda: len(self._inflight),
            )

    @property
    def wave_buckets(self) -> tuple[int, ...]:
        """The fixed wave shapes for this service's backend, resolved
        per access: a device host only advertises its
        ``wave_bucket_shapes`` once its device verifier materializes."""
        return resolve_wave_buckets(self.backend)

    @property
    def _device_busy(self) -> bool:
        """Compat view of the pre-pipeline single-in-flight gate: true
        while ANY device dispatch is in flight."""
        return bool(self._inflight)

    # ---- acquisition -------------------------------------------------------

    @classmethod
    def for_backend(cls, backend) -> "AsyncVerifyService":
        """The service for ``backend`` on the running loop.  Device-host
        backends (``async_kind`` set) share one service per (loop, kind)
        pair — in-process committees all submit into the same dispatch
        stream; everything else gets a private inline service.

        ``HOTSTUFF_NO_CLAIM_DEDUP=1`` gives every core a PRIVATE device
        service instead: no cross-core claim coalescing or dedup.  This
        is the honesty knob for in-process scale results — a real
        one-node-per-host deployment gets zero dedup,
        and the per-node capability must be measurable without the
        co-location artifact."""
        import os

        kind = getattr(backend, "async_kind", None)
        if kind is None:
            return cls(backend, device=False)
        if os.environ.get("HOTSTUFF_NO_CLAIM_DEDUP"):
            return cls(backend, device=True)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # constructed outside a loop (direct-construction tests):
            # a private service — coalescing across cores is lost but
            # nothing binds to a wrong loop
            return cls(backend, device=True)
        # prune entries bound to closed loops (repeated benchmark runs /
        # test loops in one process): each would otherwise pin its loop
        # object plus an idle dispatch loop's slot threads forever
        stale = [
            (k, svc)
            for k, (stored, svc) in cls._registry.items()
            if stored.is_closed()
        ]
        for k, svc in stale:
            cls._registry.pop(k, None)
            svc._shutdown_dispatch()
        key = (id(loop), kind)
        hit = cls._registry.get(key)
        # the stored loop is compared by identity and liveness: an id()
        # reused by a new loop (or a closed loop's leftover) must get a
        # fresh service, or submissions would wait on a dead dispatcher
        if hit is not None and hit[0] is loop and not loop.is_closed():
            return hit[1]
        service = cls(backend, device=True)
        cls._registry[key] = (loop, service)
        return service

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for lander in list(self._landers):
            lander.cancel()
        self._landers.clear()
        self._shutdown_dispatch()
        for key, (_, service) in list(self._registry.items()):
            if service is self:
                del self._registry[key]

    def _shutdown_dispatch(self) -> None:
        """Stop this service's dispatch loop (service close / stale-loop
        eviction in for_backend / interpreter exit via the loop's own
        atexit hook)."""
        if self._dispatch is not None:
            self._dispatch.close()
            self._dispatch = None

    # ---- submission --------------------------------------------------------

    async def verify_claims(self, claims: list) -> list[bool]:
        """Verdict per claim.  Inline services evaluate immediately;
        device services enqueue and await the coalesced dispatch."""
        if not claims:
            return []
        if not self.device:
            if self._tel_wave is None:
                return eval_claims_sync(self.backend, claims)
            # inline services have no dedup stage: submitted == unique
            t0 = time.perf_counter()
            out = eval_claims_sync(self.backend, claims)
            self._tel_host_wall.add(time.perf_counter() - t0)
            self._tel_claims_submitted.inc(len(claims))
            self._tel_claims_unique.inc(len(claims))
            self._tel_wave.observe(
                sum(claim_sig_count(c) for c in claims)
            )
            return out

        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((claims, fut))
        if _spans.recorder() is not None:
            self._arrivals.append(time.perf_counter_ns())
        if self._task is None or self._task.done():
            # the dispatcher task drains all pending batches then exits —
            # no long-lived task to leak across loops or shutdowns
            self._task = loop.create_task(
                self._run(), name="verify-dispatcher"
            )
        return await fut

    # ---- the dispatcher ----------------------------------------------------

    def _deadline_s(self) -> float:
        """Per-dispatch deadline: a device stall mid-dispatch must not
        stall the committee.  Backends may raise the floor
        (``dispatch_deadline_s``)."""
        return max(
            getattr(self.backend, "dispatch_deadline_s", 0.1),
            4 * (self._device_ewma_s or 0.1),
        )

    def _cpu_estimate_s(self, n_sigs: int) -> float:
        # the CPU alternative is the batched equation for waves of
        # NATIVE_BATCH_MIN or more (eval_claims_sync's flat fast path)
        # while the batch path is on; else the per-signature loop
        if n_sigs >= NATIVE_BATCH_MIN and native_ed25519.available():
            return cpu_batch_estimate_s(n_sigs)
        return n_sigs * CPU_US_PER_SIG * 1e-6

    # ---- fixed-shape wave packing -----------------------------------------

    @property
    def _packing_on(self) -> bool:
        """Padding applies only when buckets are configured AND the
        backend opted in (``supports_wave_padding`` — the real ed25519
        device verifiers).  CPU fallbacks see exactly the submitted
        claims."""
        return bool(
            self.wave_buckets
            and getattr(self.backend, "supports_wave_padding", False)
        )

    def _pack_wave(self, claims: list, n_sigs: int) -> list:
        """Pad a device-routed wave to the smallest bucket >= n_sigs
        with copies of the pad claim.  Exact fits and waves past the
        largest bucket pass through unpadded (the backend chunks
        oversized batches on its own grid)."""
        bucket = next((b for b in self.wave_buckets if b >= n_sigs), None)
        if bucket is None or bucket == n_sigs:
            return claims
        pad = make_pad_claim()
        self.packed_waves += 1
        self.pad_sigs += bucket - n_sigs
        return list(claims) + [pad] * (bucket - n_sigs)

    def warm_buckets(self) -> None:
        """Warm every wave bucket shape: drive one pad-only wave per
        bucket size through the forced-device dispatch view,
        synchronously, so the first real wave of any bucket finds its
        staging buffers allocated and its kernels built instead of
        paying for them mid-consensus.  On the verifier's pad grid the
        buckets land on 128, 128, 256 and 1024 lanes.  No-op for inline
        services, non-padding backends, and hosts whose device isn't
        warm yet."""
        if not (self.device and self._packing_on):
            return
        if not getattr(self.backend, "device_ready", True):
            return
        target = getattr(self.backend, "async_backend", self.backend)
        pad = make_pad_claim()
        for bucket in self.wave_buckets:
            eval_claims_sync(target, [pad] * bucket)

    def _route_device(self, n_sigs: int) -> str:
        """Route this batch: "device", "cpu", "probe", or "wait".

        Never the device before its backend is materialized AND warm (a
        kernel build mid-consensus would blow the round timeout — the
        host sets ``device_ready`` at warmup), and never while any
        in-flight dispatch is OVERDUE: queueing waves behind a stalled
        dispatch stalls the whole committee, so a stall pushes traffic
        to the CPU.  Below the depth cap, compare the
        occupancy-discounted device EWMA (waves already in flight
        overlap) against the CPU estimate.
        "wait": the pipeline is full but healthy and the device is
        still the right answer — the dispatcher queues for a slot
        (bounded by the earliest in-flight deadline) instead of
        spilling to the CPU.  "probe": the EWMA says the device loses,
        but it's time to re-measure — the caller dispatches a
        measurement-only copy and serves the batch from the CPU, so
        probing a degraded device never adds wave latency; probes take
        a pipeline slot, so a full pipeline never probes."""
        import os

        if os.environ.get("HOTSTUFF_FORCE_CPU_ROUTE"):
            return "cpu"  # diagnostic: keep the device warm but never dispatch
        if not getattr(self.backend, "device_ready", True):
            return "cpu"
        now = time.monotonic()
        if any(stamp < now for stamp in self._inflight.values()):
            # an in-flight dispatch blew its deadline — the device is
            # stalling; route around it until the stuck wave lands
            return "cpu"
        occupancy = len(self._inflight)
        forced = bool(os.environ.get("HOTSTUFF_FORCE_DEVICE_ROUTE"))
        offload = getattr(self.backend, "always_offload", False)
        if occupancy >= self.pipeline_depth:
            # depth cap: queue when the device is (or is forced to be)
            # the right route, otherwise serve from the CPU.  No probe
            # here — a probe would need the slot we don't have.
            if forced or offload or self._device_ewma_s is None:
                return "wait"
            marginal = self._device_ewma_s * PIPELINE_MARGINAL_COST
            if marginal <= self._cpu_estimate_s(n_sigs):
                return "wait"
            return "cpu"
        if forced:
            # profiling knob: pin warmed-up waves to the device so the waterfall measures the
            # dispatch pipeline, not the cost-model's mood — gated AFTER
            # the readiness/overdue/depth checks, which stay load-bearing
            return "device"
        if offload:
            # backends whose offload frees the loop unconditionally
            # (BLS native pairings: ctypes releases the GIL) — no
            # cost-model routing needed
            return "device"
        if self._device_ewma_s is None:
            return "device"  # optimistic first dispatch
        marginal = self._device_ewma_s * (
            1.0 if occupancy == 0 else PIPELINE_MARGINAL_COST
        )
        if marginal <= self._cpu_estimate_s(n_sigs):
            return "device"
        if now - self._last_probe >= _PROBE_INTERVAL_S:
            self._last_probe = now
            return "probe"
        return "cpu"

    def _spawn_device(
        self,
        loop,
        claims: list,
        measure_only: bool = False,
        deadline: float | None = None,
        wave: "AdoptedWave | None" = None,
    ):
        """Start a device dispatch on the dedicated dispatch loop and
        register it in the in-flight table (occupancy + deadline stamp
        drive routing).  The slot thread delivers completion back to the
        event loop with ``call_soon_threadsafe``; delivery frees the
        slot, wakes any dispatcher queued in _wait_for_slot, and marks
        exceptions retrieved so abandoned waves (deadline-miss /
        measurement-only) never warn.  Returns ``(completion_future,
        end_holder)``; the slot thread appends its completion stamp to
        ``end_holder`` under the profiler so the lander can charge the
        slot-thread -> loop wakeup gap to verdict.fanout."""
        if self._dispatch is None:
            # one slot thread per pipeline stage: the kernel launch and
            # the readback release the GIL, so while wave N waits on the
            # device, wave N+1 stages on the next slot — that overlap IS
            # the pipeline.  The backend is thread-compatible (table
            # rebuilds publish atomically under its own lock) and keeps
            # staging buffers and a CUDA stream per thread, so each slot
            # reuses its own buffers wave after wave.
            self._dispatch = _DispatchLoop(self.pipeline_depth)
        self._wave_serial += 1
        serial = self._wave_serial
        # guarded-by: gil -- written here on the event loop, popped by
        # _deliver (loop) and by _on_done's loop-closed fallback (slot
        # thread); every access is a single dict bytecode, atomic under
        # the GIL, and the routing reads tolerate one-wave staleness
        self._inflight[serial] = time.monotonic() + (
            deadline if deadline is not None else self._deadline_s()
        )
        self.peak_inflight = max(self.peak_inflight, len(self._inflight))
        rec = _spans.recorder()
        t_spawn = time.perf_counter_ns() if rec is not None else None
        if rec is not None:
            # occupancy annotation (value encoded in the dur field, not
            # a duration — rendered as a counter on the Perfetto track)
            rec.add("pipeline.occupancy", t_spawn, len(self._inflight))
        end_holder: list[int] = []
        fut: asyncio.Future = loop.create_future()

        def _deliver(result, exc):
            # on the event loop: free the slot, resolve the wave future
            self._inflight.pop(serial, None)
            if self._slot_free is not None:
                self._slot_free.set()
            if fut.cancelled():
                return
            if exc is None:
                fut.set_result(result)
            elif measure_only:
                log.warning("device measurement dispatch failed: %s", exc)
                fut.set_result(None)
            else:
                fut.set_exception(exc)
                # mark retrieved: the lander re-raises via result(), but
                # a deadline-missed wave is abandoned — without this the
                # GC would warn about the never-retrieved exception
                fut.exception()

        def _on_done(result, exc):
            # on the slot thread: hop back to the service's event loop
            try:
                loop.call_soon_threadsafe(_deliver, result, exc)
            except RuntimeError:
                # the loop closed mid-flight (benchmark loop teardown /
                # interpreter exit): free the slot directly so routing
                # never sees a phantom in-flight wave
                self._inflight.pop(serial, None)

        self._dispatch.submit(
            lambda: self._dispatch_sync(claims, t_spawn, end_holder, wave),
            _on_done,
        )
        return fut, end_holder

    def _dispatch_sync(
        self,
        claims: list,
        t_spawn: int | None = None,
        end_holder: list | None = None,
        wave: "AdoptedWave | None" = None,
    ) -> list[bool]:
        """Slot-thread body: evaluate on the forced-device dispatch
        view, timing the dispatch for the routing EWMA.  An adopted
        zero-copy wave stages from its arena columns instead of
        flattening claim tuples (released inside eval_claims_arena)."""
        rec = _spans.recorder()
        if rec is not None:
            t_enter = time.perf_counter_ns()
            if t_spawn is not None:
                # dispatch-loop handoff -> slot thread entry (thread
                # wakeup + any queueing behind a previous dispatch)
                rec.add("stage.slot_wait", t_spawn, t_enter - t_spawn)
        target = getattr(self.backend, "async_backend", self.backend)
        t0 = time.perf_counter()
        if wave is not None:
            out = eval_claims_arena(target, wave, claims)
        else:
            out = eval_claims_sync(target, claims)
        wall = time.perf_counter() - t0
        if rec is not None:
            end_ns = time.perf_counter_ns()
            rec.add("dispatch.wall", t_enter, end_ns - t_enter)
            if end_holder is not None:
                end_holder.append(end_ns)
        if self._tel_device_wall is not None:
            self._tel_device_wall.add(wall)
        ewma = self._device_ewma_s
        # guarded-by: gil -- written on the slot thread, read by the
        # loop-side router (_route_device/_deadline_s); a float rebind
        # is one atomic store and a stale read only skews the EWMA by
        # one sample
        self._device_ewma_s = (
            wall if ewma is None else (1 - _EWMA_ALPHA) * ewma + _EWMA_ALPHA * wall
        )
        return out

    async def _wait_for_slot(self) -> None:
        """Depth-cap backpressure: park until an in-flight wave lands or
        the earliest in-flight deadline expires (the wave went overdue —
        the next routing pass serves from the CPU)."""
        if self._slot_free is None:
            self._slot_free = asyncio.Event()
        self._slot_free.clear()
        if len(self._inflight) < self.pipeline_depth:
            return  # a wave landed between the route decision and here
        earliest = min(self._inflight.values())
        timeout = max(0.005, earliest - time.monotonic() + 0.005)
        try:
            await asyncio.wait_for(self._slot_free.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        # fresh per dispatcher spawn: the event must belong to the loop
        # this dispatcher runs on (services can outlive benchmark loops)
        self._slot_free = asyncio.Event()
        while True:
            # let every task woken by the same network wave enqueue its
            # claims before the batch departs (two passes: receiver ->
            # core handoff, core -> submit)
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            if self.coalesce_window_s > 0.0 and self._pending:
                # QC+TC coalescing: hold the wave open for a round
                # window so both certificate kinds produced by the same
                # round merge into ONE device dispatch — the
                # verdict table fans each claim back to its own
                # submitters on readback
                await asyncio.sleep(self.coalesce_window_s)
            batch, self._pending = self._pending, []
            arrivals, self._arrivals = self._arrivals, []
            if not batch:
                return  # drained — the next submit respawns the task
            rec = _spans.recorder()
            wave_t0 = min(arrivals) if (rec is not None and arrivals) else None
            if wave_t0 is not None:
                rec.add(
                    "coalesce.wait",
                    wave_t0,
                    time.perf_counter_ns() - wave_t0,
                )
            # Deduplicate identical claims across submissions: a claim's
            # verdict is a PURE function of (digest, pk, sig) bytes, so
            # one evaluation serves every submitter — in a co-located
            # committee one broadcast proposal arrives at every core in
            # the same wave, and without dedup the service would verify
            # the same certificate once per node (n x the work this
            # layer exists to avoid).  Each core still applies its OWN
            # stake/quorum/safety rules to the verdicts; no per-node
            # acceptance state crosses node boundaries.
            unique: dict = {}
            for cs, _ in batch:
                for c in cs:
                    unique.setdefault(c, None)
            claims = list(unique.keys())
            n_sigs = sum(claim_sig_count(c) for c in claims)
            agg_in_wave = [c for c in claims if c[0] == "agg"]
            if agg_in_wave:
                self.agg_claims += len(agg_in_wave)
                self.agg_sigs += sum(len(c[3]) for c in agg_in_wave)
            self.dispatches += 1
            if self._tel_wave is not None:
                self._tel_claims_submitted.inc(sum(len(cs) for cs, _ in batch))
                self._tel_claims_unique.inc(len(claims))
                self._tel_wave.observe(n_sigs)

            # zero-copy adoption: if a receiver packed this wave's votes
            # into a staging arena and the claim stream matches the
            # packed prefix exactly, adopt the arena — staging becomes
            # frombuffer views.  Passive accessor: the verify path never
            # triggers a native build; only receivers create the plane.
            adopted = None
            ing = zero_copy_ingest_if_active()
            if ing is not None and ing.active:
                with _spans.span("native.pack"):
                    fb_before = ing.fallback_waves
                    adopted = ing.try_adopt(claims, self.wave_buckets)
                if adopted is not None:
                    self.zero_copy_waves += 1
                    self.zero_copy_sigs += n_sigs
                    if self._tel_zero_copy is not None:
                        self._tel_zero_copy.inc()
                elif ing.fallback_waves != fb_before:
                    self.fallback_waves += 1
                    if self._tel_fallback is not None:
                        self._tel_fallback.inc()
            try:
                with _spans.span("route.decide"):
                    route = self._route_device(n_sigs)
                waited = False
                while route == "wait":
                    # full pipeline, healthy and device-preferred: queue
                    # for a slot (wave K+1 backpressure) instead of
                    # spilling to the CPU, then re-route — a freed slot
                    # goes to the device, an expired deadline to the CPU
                    if not waited:
                        waited = True
                        self.pipeline_waits += 1
                        if self._tel_route is not None:
                            self._tel_route["wait"].inc()
                    t_w = (
                        time.perf_counter_ns() if rec is not None else None
                    )
                    await self._wait_for_slot()
                    if t_w is not None:
                        rec.add(
                            "pipeline.wait",
                            t_w,
                            time.perf_counter_ns() - t_w,
                        )
                    route = self._route_device(n_sigs)
                if self._tel_route is not None:
                    self._tel_route[route].inc()
                dispatch_claims = claims
                if (
                    route in ("device", "probe")
                    and self._packing_on
                    and adopted is None
                ):
                    # fixed-shape wave: pad to the bucket so
                    # the dispatch hits a warmed shape.  Probes pack
                    # too — they measure the shape real waves use.
                    # Adopted waves skip this: the arena is already
                    # bucket-shaped with native-padded rows.
                    with _spans.span("stage.pack"):
                        dispatch_claims = self._pack_wave(claims, n_sigs)
                if route == "probe":
                    # measurement-only device dispatch: results are
                    # discarded (EWMA updates when it lands); the batch
                    # itself is served from the CPU so a degraded device
                    # never adds wave latency
                    self.probe_dispatches += 1
                    self._spawn_device(
                        loop, dispatch_claims, measure_only=True,
                        wave=adopted,
                    )
                    adopted = None  # released by the probe dispatch
                if route == "device":
                    self.device_dispatches += 1
                    self.device_sigs += n_sigs
                    deadline = self._deadline_s()
                    exec_fut, end_holder = self._spawn_device(
                        loop, dispatch_claims, deadline=deadline,
                        wave=adopted,
                    )
                    adopted = None  # released by the slot thread
                    # async readback: the dispatcher does NOT
                    # await the device — a per-wave lander task lands
                    # this wave's verdicts when its completion future
                    # resolves, so waves complete out of order and a
                    # failure poisons only its own batch.  The
                    # dispatcher loops straight back to staging the
                    # next wave.
                    lander = loop.create_task(
                        self._land_device(
                            batch, dispatch_claims, exec_fut, end_holder,
                            wave_t0, deadline,
                        ),
                        name="verify-lander",
                    )
                    self._landers.add(lander)
                    lander.add_done_callback(self._landers.discard)
                    continue
                self.cpu_dispatches += 1
                self.cpu_sigs += n_sigs
                if adopted is not None:
                    wave_held, adopted = adopted, None
                    await self._serve_cpu_arena(batch, claims, wave_held)
                else:
                    await self._serve_cpu(batch)
                if wave_t0 is not None:
                    rec.add(
                        "e2e", wave_t0, time.perf_counter_ns() - wave_t0
                    )
                self._log_stats()
            except asyncio.CancelledError:
                if adopted is not None:
                    adopted.release()
                for _, fut in batch:
                    if not fut.done():
                        fut.cancel()
                raise
            except Exception as e:  # noqa: BLE001 — backend failure must
                # reach every waiter, not kill the dispatcher
                if adopted is not None:
                    adopted.release()
                log.warning("verify dispatch failed: %s", e)
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            RuntimeError(f"verify dispatch failed: {e}")
                        )
                continue

    async def _serve_cpu(self, batch) -> None:
        # CPU serving holds the GIL either way (measured) — run
        # inline, but per SUBMISSION with yields between, so a
        # large coalesced wave doesn't block the loop in one
        # chunk (each core's future resolves as soon as its own
        # claims are done, matching the inline service's latency
        # profile).  The memo carries each unique claim's
        # verdict across the wave's submissions (same purity
        # argument as the batch dedup in _run).
        cpu = getattr(self.backend, "cpu_backend", self.backend)
        memo: dict = {}
        for cs, fut in batch:
            todo = [c for c in cs if c not in memo]
            if todo:
                t0 = time.perf_counter()
                results = eval_claims_sync(cpu, todo)
                if self._tel_host_wall is not None:
                    self._tel_host_wall.add(time.perf_counter() - t0)
                for c, r in zip(todo, results):
                    memo[c] = r
            if not fut.done():
                fut.set_result([memo[c] for c in cs])
            await asyncio.sleep(0)

    async def _serve_cpu_arena(self, batch, claims: list, wave) -> None:
        """CPU serving for an adopted zero-copy wave: ONE native batch
        equation straight from the arena columns covers every unique
        claim (no b"".join flatten, no per-claim re-verify), then
        verdicts fan out per submission exactly like _serve_cpu."""
        cpu = getattr(self.backend, "cpu_backend", self.backend)
        t0 = time.perf_counter()
        results = eval_claims_arena(cpu, wave, claims)
        if self._tel_host_wall is not None:
            self._tel_host_wall.add(time.perf_counter() - t0)
        memo = dict(zip(claims, results))
        for cs, fut in batch:
            if not fut.done():
                fut.set_result([memo[c] for c in cs])
            await asyncio.sleep(0)

    async def _land_device(
        self,
        batch,
        claims: list,
        exec_fut,
        end_holder: list,
        wave_t0: int | None,
        deadline: float,
    ) -> None:
        """Land one in-flight device wave: await its completion future
        (bounded by the dispatch deadline), fan its verdicts out to this
        wave's waiters ONLY.  Deadline overrun serves this batch from
        the CPU and lets the stuck dispatch land as a (bad) EWMA
        measurement; a backend exception poisons this wave's futures and
        nothing else (per-wave error isolation)."""
        rec = _spans.recorder()
        try:
            done, _ = await asyncio.wait({exec_fut}, timeout=deadline)
            if exec_fut not in done:
                self.deadline_misses += 1
                self._last_probe = time.monotonic()
                log.warning(
                    "device verify dispatch overran its %.0f ms "
                    "deadline; serving the batch from the CPU",
                    deadline * 1e3,
                )
                await self._serve_cpu(batch)
                if rec is not None and wave_t0 is not None:
                    rec.add(
                        "e2e", wave_t0, time.perf_counter_ns() - wave_t0
                    )
                self._log_stats()
                return
            results = exec_fut.result()
        except asyncio.CancelledError:
            for _, fut in batch:
                if not fut.done():
                    fut.cancel()
            raise
        except Exception as e:  # noqa: BLE001 — a failed wave must reach
            # its own waiters, and ONLY its own waiters
            log.warning("verify dispatch failed: %s", e)
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError(f"verify dispatch failed: {e}")
                    )
            return
        verdict = dict(zip(claims, results))
        fan_t0 = end_holder[0] if (rec is not None and end_holder) else None
        for cs, fut in batch:
            if not fut.done():
                fut.set_result([verdict[c] for c in cs])
        if rec is not None:
            end_ns = time.perf_counter_ns()
            if fan_t0 is not None:
                # worker completion -> every waiter's future resolved
                # (captures the executor -> loop wakeup gap)
                rec.add("verdict.fanout", fan_t0, end_ns - fan_t0)
            if wave_t0 is not None:
                rec.add("e2e", wave_t0, end_ns - wave_t0)
        self._log_stats()

    def stats_line(self) -> str:
        """The routing split, padding and dispatch EWMA of this service
        so far, as one log line.  The fields up to ``fb=`` are the JAX
        package's, in its order (the harness's log contract,
        ``hotstuff_tpu/crypto/async_service.py`` ``_log_stats``):
        ``zc`` counts waves adopted from an ingest arena and ``fb``
        vote-overlapping waves that resynced the plane and flattened;
        the mesh is not ported, so ``mesh`` stays 0.  The port's own
        fields follow."""
        return (
            f"Verify service stats [{self._stats_tag}]: "
            f"dispatches={self.dispatches} device={self.device_dispatches} "
            f"cpu={self.cpu_dispatches} probe={self.probe_dispatches} "
            f"device_sigs={self.device_sigs} cpu_sigs={self.cpu_sigs} "
            f"deadline_misses={self.deadline_misses} "
            f"waits={self.pipeline_waits} depth={self.pipeline_depth} "
            f"mesh=0 agg={self.agg_claims} agg_sigs={self.agg_sigs} "
            f"ewma_ms={(self._device_ewma_s or 0.0) * 1e3:.1f} "
            f"zc={self.zero_copy_waves} fb={self.fallback_waves} "
            f"peak_inflight={self.peak_inflight} "
            f"packed={self.packed_waves} pad_sigs={self.pad_sigs}"
        )

    def _log_stats(self) -> None:
        now = time.monotonic()
        if self.device and now >= self._next_stats_log:
            self._next_stats_log = now + 5.0
            log.info("%s", self.stats_line())

    def log_stats(self) -> None:
        """Log the stats line now, whenever the last one was (a stopping
        node's totals)."""
        log.info("%s", self.stats_line())


__all__ = [
    "AdoptedWave",
    "AsyncVerifyService",
    "ZeroCopyIngest",
    "eval_claims_arena",
    "ingest_arena_rows_from_env",
    "ingest_note_frame",
    "ingest_ring_from_env",
    "zero_copy_from_env",
    "zero_copy_ingest",
    "zero_copy_ingest_if_active",
    "INGEST_TAG_VOTE",
    "claim_sig_count",
    "eval_claims_sync",
    "flatten_claims",
    "make_pad_claim",
    "pipeline_depth_from_env",
    "wave_buckets_from_env",
    "resolve_wave_buckets",
    "coalesce_window_s_from_env",
    "cpu_batch_estimate_s",
    "CPU_BATCH_FIXED_US",
    "CPU_BATCH_US_PER_SIG",
    "CPU_US_PER_SIG",
    "DEFAULT_PIPELINE_DEPTH",
    "DEFAULT_WAVE_BUCKETS",
    "PIPELINE_MARGINAL_COST",
]
