"""The fused double-scalar-multiplication verifier: CUDA kernels, their
wrappers and launch counts, and their plain PyTorch versions.

Two kernels, in ``csrc/dsm_kernels.cu`` (math in ``csrc/ed25519_field.cuh``):

=====================  ==================================================
wrapper                replaces (JAX package)
=====================  ==================================================
``verify_compressed``  ``hotstuff_tpu/tpu/pallas_dsm.py`` ``verify_compressed``
                       (kernel ``_dsm_verify_kernel``): P = [s]B + [k](-A)
                       by a 32-step Straus scan, then the check that P
                       compresses to R.  Every device verify runs it.
``dual_scalar_mult``   ``pallas_dsm.dual_scalar_mult`` (``_dsm_kernel``):
                       the same scan, returning X, Y, Z (T = 0); checks
                       the scan by itself at coordinate level.
=====================  ==================================================

What bounds them on an H100 is integer arithmetic: ~0.94M int32
multiply-adds per signature (2955 field multiplies, 1278 of them
squarings; 0.88M without the epilogue), against ~1.3 KB of operands.
A signature is one chain of dependent point operations, so at the
production batch of 1024 the time is the length of one warp's
instruction stream, not the total work.  The kernels run each signature
on a team of eight threads: a pair per product of the point formulas'
four-wide waves (the waves ``_mul_wave_t`` batches in the Pallas
kernel), each pair splitting its field operations by limbs, with the
team's state in shared memory (see ``csrc/ed25519_field.cuh`` and
PERF.md).

A wrapper given CPU tensors runs the plain version (``plain_*``), which
is ``curve.dual_scalar_mult`` (+ ``curve.compressed_equals``); given
CUDA tensors it launches its kernel or raises.  ``launches`` counts
kernel launches per wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import ed25519_ref as ref
from . import _build, curve, field as F

NL = F.NLIMBS  # 20
LANE_TILE = 128  # batches are multiples of this (the verifier's pad sizes are)

# Field multiplies per signature, counted from the kernels' schedule: the
# [0..15]A table (14 additions of 8 multiplies + 16 T*2d conversions), 32
# macro steps of 8 doublings and 3 additions (need_t schedule: 80), and
# the epilogue (265 in the inversion chain + 2 to affine coordinates).
MULS_TABLE = 14 * 8 + 16
MULS_STEP = (3 * 7 + 8) * 2 + (7 + 8 + 7)
MULS_EPILOGUE = 265 + 2
MULS_SCAN = MULS_TABLE + curve.NWIN // 2 * MULS_STEP  # 2688
MULS_VERIFY = MULS_SCAN + MULS_EPILOGUE  # 2955
# Of those, squarings: 4 in each doubling (X^2, Y^2, Z^2, (X+Y)^2) and
# 254 in the inversion chain (the 1, 2, 1 and 5+10+20+10+50+100+50+5 runs).
SQRS_SCAN = curve.NWIN // 2 * 8 * 4  # 1024
SQRS_VERIFY = SQRS_SCAN + 1 + 2 + 1 + 250  # 1278
MADS_PER_MUL = NL * NL  # int32 multiply-adds of one schoolbook product
MADS_PER_SQR = NL * (NL + 1) // 2  # a square needs only the pairs i <= j
# The least int32 multiply-adds a signature needs: the bound's count.  The
# kernels split each product between two threads that both compute the
# shared columns 9, 19 and 29: 440 multiply-adds a product, 230 a square.
MADS_SCAN = (MULS_SCAN - SQRS_SCAN) * MADS_PER_MUL + SQRS_SCAN * MADS_PER_SQR
MADS_VERIFY = (MULS_VERIFY - SQRS_VERIFY) * MADS_PER_MUL + SQRS_VERIFY * MADS_PER_SQR


def _bake_t2d(table: np.ndarray) -> np.ndarray:
    """Copy of a [n, 4, NL] base table with the T column premultiplied by
    the curve constant 2d: table points are only ever the q operand of an
    addition, whose c-term 2d*T1*T2 then needs one multiply."""
    out = table.copy()
    d2_int = 2 * ref.D % ref.P
    for m in range(out.shape[0]):
        x = F.int_from_limbs(out[m, 0])
        y = F.int_from_limbs(out[m, 1])
        out[m, 3] = F.limbs_from_int(x * y % ref.P * d2_int % ref.P)
    return out


BTAB_T2D = _bake_t2d(curve.B_TABLE8)  # [256, 4, 20] int32, T -> T*2d
F.register_const("btab_t2d", BTAB_T2D)

launches = {"verify_compressed": 0, "dual_scalar_mult": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---- plain versions ---------------------------------------------------------


def plain_dual_scalar_mult(s_win, k_win, a_point):
    """The kernel's contract in plain PyTorch: X, Y, Z of [s]B + [k]A, T
    zeroed (the kernel's need_t schedule never computes it)."""
    x, y, z, _ = curve.dual_scalar_mult(s_win, k_win, a_point)
    return x, y, z, torch.zeros_like(x)


def plain_verify_compressed(s_win, k_win, a_point, r_y, r_sign):
    p = curve.dual_scalar_mult(s_win, k_win, a_point)
    return curve.compressed_equals(p, r_y, r_sign)


# ---- kernel wrappers ----------------------------------------------------------


def _check_operands(s_win, k_win, a_point, extra=()) -> int:
    """Raise unless every operand is a contiguous int32 tensor of its
    shape on one device; returns the batch size."""
    batch = s_win.shape[-1]
    if batch % LANE_TILE:
        raise ValueError(f"batch {batch} not a multiple of {LANE_TILE}")
    win = (curve.NWIN, batch)
    expected = [(s_win, win), (k_win, win)] + [(c, (batch, NL)) for c in a_point]
    for t, shape in expected + list(extra):
        if t.device != s_win.device:
            raise ValueError("operands on different devices")
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"expected int32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return batch


def _launch(fn, device: torch.device, tensors, batch: int) -> None:
    consts = (F.const(n, device) for n in ("btab_t2d", "d2", "sub_pad"))
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    rc = fn(*(t.data_ptr() for t in (*consts, *tensors)), batch, index, stream)
    if rc != 0:
        msg = _build.load().dsm_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({rc})")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def verify_compressed(s_win, k_win, a_point, r_y, r_sign) -> torch.Tensor:
    """Fused verify: does [s]B + [k]A compress to (r_y, r_sign)?

    s_win, k_win: int32 [64, batch] MSB-first 4-bit windows; a_point:
    (X, Y, Z, T) int32 [batch, 20] each (the NEGATED public keys);
    r_y: int32 [batch, 20] raw limb split of each R's low 255 bits;
    r_sign: int32 [batch] bit 255 of R.  Returns bool [batch].
    """
    if s_win.device.type == "cpu":
        return plain_verify_compressed(s_win, k_win, a_point, r_y, r_sign)
    _require_cuda(s_win)
    batch = s_win.shape[-1]
    _check_operands(s_win, k_win, a_point, [(r_y, (batch, NL)), (r_sign, (batch,))])
    ok = torch.empty(batch, dtype=torch.int32, device=s_win.device)
    _launch(
        _build.load().dsm_verify_launch,
        s_win.device,
        (*a_point, s_win, k_win, r_y, r_sign, ok),
        batch,
    )
    launches["verify_compressed"] += 1
    return ok != 0


def dual_scalar_mult(s_win, k_win, a_point):
    """[s]B + [k]A: (X, Y, Z, T) int32 [batch, 20] each, T zero.  Same
    operands as :func:`verify_compressed` without R."""
    if s_win.device.type == "cpu":
        return plain_dual_scalar_mult(s_win, k_win, a_point)
    _require_cuda(s_win)
    batch = _check_operands(s_win, k_win, a_point)
    out = torch.empty((4, batch, NL), dtype=torch.int32, device=s_win.device)
    _launch(
        _build.load().dsm_scan_launch,
        s_win.device,
        (*a_point, s_win, k_win, *out.unbind(0)),
        batch,
    )
    launches["dual_scalar_mult"] += 1
    return tuple(out.unbind(0))
