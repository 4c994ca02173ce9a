"""Batched Ed25519 verification on a CUDA device — the port of
``hotstuff_tpu/tpu/ed25519.py``.

Verification equation: a signature (R, s) by pubkey A over message M is
valid iff [s]B == R + [k]A with k = SHA-512(R||A||M) mod L, i.e. iff
P := [s]B + [k](-A) compresses to the R bytes.  The kernel evaluates P
for the whole batch and compares compressed encodings, so:

- SHA-512 and the mod-L reductions stay on the host;
- committee public keys are decompressed ONCE on the host and cached,
  and their limb tables are staged on the device once per rebuild;
- R is never decompressed: the compressed-encoding comparison subsumes
  point validity.

Semantics: cofactorless ("strict") verification with rejection of
s >= L and non-canonical R encodings, agreeing with the oracle
``ed25519_ref.verify`` on every input.  Batches pad to (128, 256, 1024),
multiples of the kernel tile; larger batches go in 1024-lane chunks.
"""

from __future__ import annotations

import threading
from contextlib import ExitStack

import numpy as np
import torch

from ..crypto import ed25519_ref as ref
from ..telemetry import spans as _spans
from . import curve, dsm, field as F

# Padded batch shapes: multiples of the kernel tile, 1024 per dispatch.
PAD_SIZES = (128, 256, 1024)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device.  Without a CUDA device
    only an explicit ``device="cpu"`` runs: nothing falls back quietly."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch version"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


_LIMB_WEIGHTS = (1 << np.arange(F.LIMB_BITS, dtype=np.int32)).astype(np.int32)

# big-endian bytes of the group order, for the vectorized s < L check
_L_BE = np.frombuffer(ref.L.to_bytes(32, "big"), np.uint8)

_WIN_WEIGHTS = (1 << np.arange(curve.WINDOW - 1, -1, -1)).astype(np.int32)


def _bytes_to_windows_msb(rows: np.ndarray) -> np.ndarray:
    """[n, W] little-endian scalar bytes -> [n, 2W] MSB-first 4-bit
    windows (W = 32 for full scalars < L < 2^253)."""
    bits = np.unpackbits(rows[:, ::-1], axis=1, bitorder="big").astype(np.int32)
    nwin = rows.shape[1] * 8 // curve.WINDOW
    groups = bits.reshape(rows.shape[0], nwin, curve.WINDOW)
    return groups @ _WIN_WEIGHTS


def _bytes_rows_to_limbs(rows: np.ndarray) -> np.ndarray:
    """[n, 32] little-endian encodings -> [n, NLIMBS] raw 13-bit split of
    the low 255 bits (NOT reduced mod p — see compressed_equals)."""
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :255]
    bits = np.pad(bits, [(0, 0), (0, F.NLIMBS * F.LIMB_BITS - 255)])
    groups = bits.reshape(rows.shape[0], F.NLIMBS, F.LIMB_BITS).astype(np.int32)
    return groups @ _LIMB_WEIGHTS


def _s_below_l(sig_rows: np.ndarray) -> np.ndarray:
    """s < L per row, vectorized: lexicographic compare of each scalar
    (big-endian view of sig[32:]) against L; rows equal to L have no
    differing byte and are rejected too."""
    n = sig_rows.shape[0]
    s_be = sig_rows[:, :31:-1]
    diff = s_be != _L_BE
    any_diff = diff.any(axis=1)
    first = np.where(any_diff, diff.argmax(axis=1), 0)
    return (s_be[np.arange(n), first] < _L_BE[first]) & any_diff


class _Slot:
    """One thread's staging buffers for one pad size: host arrays (pinned
    when the device is CUDA, so the H2D copies run non-blocking) and the
    device buffers the kernel reads.  Reused wave after wave; ``copied``
    marks when the last wave's H2D copies finished reading the host side."""

    def __init__(self, padded: int, device: torch.device):
        pin = device.type == "cuda"

        def host(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)

        self.h_sig = host((padded, 64), torch.uint8)
        self.h_k = host((padded, 32), torch.uint8)
        self.h_r_sign = host((padded,), torch.int32)
        self.h_idxs = host((padded,), torch.int64)
        self.h_s_win = host((curve.NWIN, padded), torch.int32)
        self.h_k_win = host((curve.NWIN, padded), torch.int32)
        self.h_r_y = host((padded, F.NLIMBS), torch.int32)
        # numpy views of the host buffers (the staging code is numpy)
        self.sig = self.h_sig.numpy()
        self.k = self.h_k.numpy()
        self.r_sign = self.h_r_sign.numpy()
        self.idxs = self.h_idxs.numpy()

        def dev(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.d_s_win = dev((curve.NWIN, padded), torch.int32)
        self.d_k_win = dev((curve.NWIN, padded), torch.int32)
        self.d_r_y = dev((padded, F.NLIMBS), torch.int32)
        self.d_r_sign = dev((padded,), torch.int32)
        self.d_idxs = dev((padded,), torch.int64)
        self.d_a = dev((4, padded, F.NLIMBS), torch.int32)
        self.copied = torch.cuda.Event() if pin else None

    def reset(self) -> None:
        if self.copied is not None:
            self.copied.synchronize()
        for a in (self.sig, self.k, self.r_sign, self.idxs):
            a.fill(0)


class BatchVerifier:
    """Host-side driver: prepares batches, caches committee points, runs
    the verify kernel.  Thread-compatible: per-thread staging slots and
    CUDA streams, and caches keyed by immutable bytes.

    Hybrid routing: batches smaller than ``min_device_batch`` are
    verified on the host instead — a dispatch has a fixed cost that
    swamps the work of a handful of signatures.  ``min_device_batch=0``
    sends everything to the device.

    ``device`` defaults to ``cuda`` and raises without one; the tests
    pass ``device="cpu"``, which runs the kernels' plain versions."""

    def __init__(self, min_device_batch: int = 64, device=None):
        self.device = resolve_device(device)
        # pk bytes -> (ax, ay, az, at) limb rows of the negated point, or None
        self._point_cache: dict[bytes, tuple | None] = {}
        # pk bytes -> row index into the stacked point table (row 0 is a
        # zero dummy for invalid items), rebuilt lazily on new keys
        self._row_index: dict[bytes, int] = {}
        # the published build (coordinate tables, row index) or None;
        # _table_lock serializes cache inserts and rebuilds
        self._table_lock = threading.Lock()
        self._tables: tuple | None = None
        # (build, device-resident copy of its tables [4, k, 20]),
        # published with one assignment
        self._device_staged: tuple | None = None
        # per-thread staging slots (keyed by padded size) and, on CUDA,
        # the thread's own stream: the wave service's slot threads stage
        # and launch concurrently, and each waits only on its own work
        self._scratch = threading.local()
        # challenge-hash memo: k = H(R||A||M) per claim; pad claims and
        # re-verified claims hit it.  Bounded; cleared when full.
        self._challenge_memo: dict[tuple, bytes] = {}
        self.pad_sizes = PAD_SIZES
        self.min_device_batch = min_device_batch
        self._cpu = None  # lazy host verify for small batches

    def precompute(self, pubkeys: list[bytes]) -> None:
        """Decompress + negate committee keys ahead of time (epoch
        setup) so no point decompression lands inside a QC verify."""
        for pk in pubkeys:
            self._neg_point(pk)

    def warmup(self, batch: int | None = None) -> None:
        """Build the kernels and stage every pad shape a production batch
        can land on, BEFORE the consensus hot path.

        ``batch`` is the largest batch the caller expects (the committee
        size).  Every pad size at or below the one it pads to is run,
        down to the smallest: waves pre-padded to fixed buckets can land
        on any of them."""
        seed = b"\x5a" * 32
        msg = b"hotstuff_tpu verifier warmup"
        pk = ref.public_from_seed(seed)
        sig = ref.sign(seed, msg)
        n = max(batch or 0, self.min_device_batch, 1)
        grid = self.pad_sizes
        ceiling = next((p for p in grid if n <= p), grid[-1])
        for size in [p for p in grid if p <= ceiling]:
            out = self.verify_device([msg] * size, [pk] * size, [sig] * size)
            if not out.all():
                raise RuntimeError("verifier warmup produced invalid result")

    def _neg_point(self, pk: bytes):
        hit = self._point_cache.get(pk)
        if hit is None and pk not in self._point_cache:
            p = ref.point_decompress(pk)
            hit = None if p is None else curve.point_to_limbs(ref.point_neg(p))
            with self._table_lock:
                self._point_cache[pk] = hit
                self._tables = None  # stacked table is stale
        return hit

    # staged device-side committee gather
    device_key_cache = True

    def _device_build(self, build) -> torch.Tensor:
        """The device-resident copy of ``build``'s stacked tables, staged
        on first use after each rebuild and published with the build it
        mirrors in one assignment (last writer wins; every copy is of
        the same immutable build)."""
        staged = self._device_staged
        if staged is None or staged[0] is not build:
            tables, _ = build
            staged = (build, torch.from_numpy(np.stack(tables)).to(self.device))
            if self.device.type == "cuda":
                # the upload ran on this thread's stream: finish it
                # before another thread's stream can read the table
                torch.cuda.current_stream(self.device).synchronize()
            self._device_staged = staged
        table = staged[1]
        if self.device.type == "cuda":
            # read on this thread's stream: the allocator must not reuse
            # the memory after a rebuild until that read is done
            table.record_stream(torch.cuda.current_stream(self.device))
        return table

    def _slot_for(self, padded: int) -> _Slot:
        pool = getattr(self._scratch, "pool", None)
        if pool is None:
            pool = self._scratch.pool = {}
        slot = pool.get(padded)
        if slot is None:
            slot = pool[padded] = _Slot(padded, self.device)
        else:
            slot.reset()
        return slot

    def _rebuild_tables(self):
        """Build (tables, row_index) fully in locals, then publish with
        one assignment: a reader snapshots ``self._tables`` once and never
        sees a partially-built index."""
        with self._table_lock:
            valid = [
                (pk, pt) for pk, pt in self._point_cache.items() if pt is not None
            ]
            k = len(valid) + 1
            tables = tuple(np.zeros((k, F.NLIMBS), np.int32) for _ in range(4))
            row_index: dict[bytes, int] = {}
            for row, (pk, pt) in enumerate(valid, start=1):
                row_index[pk] = row
                for t, coord in zip(tables, pt):
                    t[row] = coord
            build = (tables, row_index)
            self._tables = build
            self._row_index = row_index
            return build

    def load_jax_tables(self, tables, row_index: dict[bytes, int]) -> None:
        """Adopt a key-table build published by the JAX package's
        verifier (``hotstuff_tpu.tpu.ed25519.BatchVerifier._tables``):
        four [k, 20] int32 tables of negated committee points (row 0 the
        zero dummy) and the pk -> row map.  Replaces this verifier's key
        cache and stages the tables on the device."""
        tables = tuple(np.array(t, dtype=np.int32) for t in tables)
        if len(tables) != 4 or any(t.shape != tables[0].shape for t in tables):
            raise ValueError("expected four equal [k, 20] tables")
        k = tables[0].shape[0]
        if tables[0].shape[1:] != (F.NLIMBS,) or k < 1:
            raise ValueError(f"expected [k, {F.NLIMBS}] tables")
        rows = sorted(row_index.items(), key=lambda kv: kv[1])
        if any(not 1 <= row < k for _, row in rows):
            raise ValueError("row index out of the tables' range")
        with self._table_lock:
            self._point_cache = {
                pk: tuple(t[row].copy() for t in tables) for pk, row in rows
            }
            build = (tables, dict(rows))
            self._tables = build
            self._row_index = build[1]
        self._device_build(build)

    def verify(
        self,
        messages: list[bytes],
        pubkeys: list[bytes],
        signatures: list[bytes],
    ) -> np.ndarray:
        """Per-item validity for distinct (message, pk, sig) triples."""
        n = len(messages)
        if not (n == len(pubkeys) == len(signatures)):
            raise ValueError("length mismatch")
        if n == 0:
            return np.zeros(0, bool)
        if n < self.min_device_batch:
            if self._cpu is None:
                from ..crypto.signature import batch_verify_arrays

                self._cpu = batch_verify_arrays
            with _spans.span("host.verify"):
                return np.asarray(self._cpu(messages, pubkeys, signatures))
        return self.verify_device(messages, pubkeys, signatures)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _on_thread_stream(self) -> ExitStack:
        """Make the verifier's device and this thread's stream current
        (nothing on the CPU).  The CUDA current device and stream are
        per thread, so every slot thread sets both."""
        ctx = ExitStack()
        if self.device.type == "cuda":
            stream = getattr(self._scratch, "stream", None)
            if stream is None:
                stream = self._scratch.stream = torch.cuda.Stream(self.device)
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(stream))
        return ctx

    def _run_staged(self, stage_fn, n: int) -> np.ndarray:
        """Stage, launch and read back one wave of ``n`` claims on this
        thread's stream."""
        rec = _spans.recorder()
        with self._on_thread_stream():
            if rec is None:
                valid_host, arrays = stage_fn()
                ok = self._run_kernel(*arrays)
                return ok[:n].cpu().numpy() & valid_host
            # profiling: the dispatch split into its waterfall stages
            with rec.span("prepare"):
                valid_host, arrays = stage_fn()
            with rec.span("dispatch"):
                ok = self._run_kernel(*arrays)
            with rec.span("device.execute"):
                self._sync()
            with rec.span("readback"):
                return ok[:n].cpu().numpy() & valid_host

    def verify_device(
        self,
        messages: list[bytes],
        pubkeys: list[bytes],
        signatures: list[bytes],
    ) -> np.ndarray:
        """Per-item validity, forced onto the device kernel regardless of
        ``min_device_batch``."""
        n = len(messages)
        if n == 0:
            return np.zeros(0, bool)
        step = self.pad_sizes[-1]
        if n > step:
            return np.concatenate(
                [
                    self.verify_device(
                        messages[i : i + step],
                        pubkeys[i : i + step],
                        signatures[i : i + step],
                    )
                    for i in range(0, n, step)
                ]
            )
        return self._run_staged(
            lambda: self.prepare(messages, pubkeys, signatures), n
        )

    def verify_packed(self, dig_buf, pk_buf, sig_buf, rows: int) -> np.ndarray:
        """Verify over packed claim columns: the ``*_buf`` objects expose
        digest / pk / sig column memory (buffer protocol), ``rows`` rows
        of 32 / 32 / 64 bytes.  Staging reads the columns through
        ``frombuffer`` views; the memory is never written."""
        if rows == 0:
            return np.zeros(0, bool)
        dig_v = np.frombuffer(dig_buf, np.uint8).reshape(rows, 32)
        pk_v = np.frombuffer(pk_buf, np.uint8).reshape(rows, 32)
        sig_v = np.frombuffer(sig_buf, np.uint8).reshape(rows, 64)
        if rows > self.pad_sizes[-1]:
            # oversize wave: materialize rows and chunk via verify_device
            return self.verify_device(
                [r.tobytes() for r in dig_v],
                [r.tobytes() for r in pk_v],
                [r.tobytes() for r in sig_v],
            )
        return self._run_staged(
            lambda: self.prepare_packed(dig_v, pk_v, sig_v), rows
        )

    def prepare_packed(self, dig_v, pk_v, sig_v) -> tuple[np.ndarray, tuple]:
        """``prepare`` over column views: signature staging is ONE block
        copy off the column (lengths are fixed by the layout)."""
        n = dig_v.shape[0]
        padded = next(p for p in self.pad_sizes if p >= n)
        slot = self._slot_for(padded)
        slot.sig[:n] = sig_v
        valid_host = _s_below_l(slot.sig[:n])
        pk_b = [r.tobytes() for r in pk_v]
        return valid_host, self._stage_rows(
            slot,
            n,
            valid_host,
            pk_b,
            lambda i: (sig_v[i].tobytes(), pk_b[i], dig_v[i].tobytes()),
        )

    def stage(self, messages, pubkeys, signatures):
        """(kernel_fn, kernel arrays, host_validity) for this batch — the
        production dispatch point.  The arrays are this thread's staging
        slot: valid until its next prepare of the same pad size."""
        valid_host, arrays = self.prepare(messages, pubkeys, signatures)
        return self._run_kernel, arrays, valid_host

    def prepare(
        self,
        messages: list[bytes],
        pubkeys: list[bytes],
        signatures: list[bytes],
    ) -> tuple[np.ndarray, tuple]:
        """Host-side batch preparation: decompressed-point lookups,
        challenge hashing, limb/window decomposition, shape padding, and
        the copies to the device.  Returns (host_validity[n],
        kernel_arrays); the arrays are device tensors that feed
        ``_run_kernel`` directly."""
        n = len(messages)
        padded = next(p for p in self.pad_sizes if p >= n)
        slot = self._slot_for(padded)

        # malformed-length rejections (rare; everything else vectorizes)
        valid_host = np.array(
            [len(sig) == 64 and len(pk) == 32 for sig, pk in zip(signatures, pubkeys)],
            dtype=bool,
        )
        if valid_host.all():
            slot.sig[:n] = np.frombuffer(b"".join(signatures), np.uint8).reshape(n, 64)
        else:
            for i in np.flatnonzero(valid_host):
                slot.sig[i] = np.frombuffer(signatures[i], np.uint8)
        valid_host &= _s_below_l(slot.sig[:n])
        return valid_host, self._stage_rows(
            slot,
            n,
            valid_host,
            pubkeys,
            lambda i: (signatures[i], pubkeys[i], messages[i]),
        )

    def _stage_rows(self, slot: _Slot, n: int, valid_host, pks, claim) -> tuple:
        """The shared tail of ``prepare`` / ``prepare_packed``: key rows,
        challenge hashes, decompositions, padding, H2D copies and the
        device-side key gather.  Updates ``valid_host`` in place."""
        # committee points: decompress any unseen key once (the insert
        # marks the build stale), THEN snapshot one build, which covers
        # every valid pk here.  Row 0 is the zero dummy: invalid items
        # keep it with zeroed scalars, so their lanes compute the
        # identity, and valid_host masks them out.
        for i in np.flatnonzero(valid_host):
            if pks[i] not in self._point_cache:
                self._neg_point(pks[i])
        build = self._tables
        if build is None:
            build = self._rebuild_tables()
        row_of = build[1]
        for i in np.flatnonzero(valid_host):
            row = row_of.get(pks[i], 0)
            if row:
                slot.idxs[i] = row
            else:
                valid_host[i] = False  # key decompresses to no point

        # challenge hashes, memoized per claim
        memo = self._challenge_memo
        for i in np.flatnonzero(valid_host):
            key = claim(i)
            kb = memo.get(key)
            if kb is None:
                kb = ref.verify_challenge(*key).to_bytes(32, "little")
                if len(memo) >= 8192:
                    memo.clear()
                memo[key] = kb
            slot.k[i] = np.frombuffer(kb, np.uint8)
        bad = ~valid_host
        if bad.any():
            slot.sig[:n][bad] = 0  # zero scalars -> identity lanes
        slot.r_sign[:n] = slot.sig[:n, 31] >> 7

        # pad lanes are all-zero rows (s=0, k=0 -> P = identity, which
        # compresses to y=1, sign=0; r_y gets matching 'one' rows)
        slot.h_s_win.numpy()[...] = _bytes_to_windows_msb(slot.sig[:, 32:]).T
        slot.h_k_win.numpy()[...] = _bytes_to_windows_msb(slot.k).T
        r_y = slot.h_r_y.numpy()
        r_y[...] = _bytes_rows_to_limbs(slot.sig[:, :32])
        r_y[n:, 0] = 1

        for d, h in (
            (slot.d_s_win, slot.h_s_win),
            (slot.d_k_win, slot.h_k_win),
            (slot.d_r_y, slot.h_r_y),
            (slot.d_r_sign, slot.h_r_sign),
        ):
            d.copy_(h, non_blocking=True)
        # committee rows by id from the device-resident key tables
        slot.d_idxs.copy_(slot.h_idxs, non_blocking=True)
        torch.index_select(self._device_build(build), 1, slot.d_idxs, out=slot.d_a)
        if slot.copied is not None:
            slot.copied.record()
        ax, ay, az, at = slot.d_a.unbind(0)
        return (ax, ay, az, at, slot.d_s_win, slot.d_k_win, slot.d_r_y, slot.d_r_sign)

    def _run_kernel(self, ax, ay, az, at, s_win, k_win, r_y, r_sign) -> torch.Tensor:
        """Device dispatch: bool [padded] verdict lanes (on the device)."""
        return dsm.verify_compressed(s_win, k_win, (ax, ay, az, at), r_y, r_sign)

    # -- VerifierBackend protocol (hotstuff_tpu_torch.crypto.service) ---------

    name = "cuda"

    #: device waves may be pre-padded to fixed bucket shapes with
    #: always-valid filler claims (verdicts are per claim)
    supports_wave_padding = True

    def verify_many(
        self,
        digests: list[bytes],
        pks: list[bytes],
        sigs: list[bytes],
        aggregate_ok: bool = False,
    ) -> list[bool]:
        # aggregate_ok is irrelevant for ed25519: verification is
        # per-signature on the device regardless
        return [bool(v) for v in self.verify(digests, pks, sigs)]

    def verify_one(self, digest, pk, sig) -> bool:
        return bool(
            self.verify([digest.to_bytes()], [pk.to_bytes()], [sig.to_bytes()])[0]
        )

    def verify_shared_msg(self, digest, votes) -> bool:
        msg = digest.to_bytes()
        out = self.verify(
            [msg] * len(votes),
            [pk.to_bytes() for pk, _ in votes],
            [sig.to_bytes() for _, sig in votes],
        )
        return bool(out.all())
