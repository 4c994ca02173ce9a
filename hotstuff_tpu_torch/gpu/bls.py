"""BLS12-381 G1 on the card: the G1 kernels, their wrappers and launch
counts, their plain PyTorch versions, and the host classes.

The counterpart of ``hotstuff_tpu/tpu/bls.py``.  The device sums vote
signatures (G1 points); the pairing equality stays on the host
(``crypto/bls``), one constant-cost call per certificate.

Three kernels, in ``csrc/g1_kernels.cu`` (math in ``csrc/g1_field.cuh``):

=================  =====================================================
wrapper            replaces (JAX package, ``tpu/bls.py``)
=================  =====================================================
``aggregate``      ``_aggregate_impl`` / ``_aggregate_plain_impl``
                   (:255-287): the tree sum of a power-of-two batch of
                   projective points (``g1_aggregate_kernel``)
``running_add_``   ``_running_add_impl`` + ``_freshen`` (:468-490,
                   :566): acc <- acc + P, one vote a call
                   (``g1_running_add_kernel``)
``scalar_mult``    ``_scalar_mult_kernel`` (:579-601): the batched
                   MSB-first double-and-add [k_i]P_i
                   (``g1_scalar_mult_kernel``)
=================  =====================================================

Why kernels and not plain torch on the card: under ``jax.jit`` each of
those functions is one fused program, one dispatch a call.  Eager torch
launches a kernel an operation: ``mont_mul`` is ~380 launches, a point
addition ~4,600, a running-sum add ~7,000 (on the consensus loop, every
vote), a 128-bit ladder ~1.3 M.  So each is one hand kernel, one launch
a call.  What bounds a kernel on an H100 is its chain of dependent point
additions (see the kernel source): ~3,500 int32 multiply-adds an
addition (``MADS_PER_ADD``), a few hundred bytes of operands.

The interface is the JAX package's: a coordinate is a row of 30 int32
limbs of 13 bits in Montgomery form for radix 2^390 (``to_mont_limbs``),
or plain where the JAX function takes plain rows.  The plain versions
below are the JAX functions in PyTorch, limb for limb (the same
signed-loose CIOS, carry passes and ``_freshen``), in the dtype of their
inputs: int32 rows give the JAX package's limbs exactly.  The wrappers'
plain versions (``aggregate_plain``, ``running_add_plain``,
``scalar_mult_plain``) run the same code with int64 columns and return
int32 rows: the JAX limbs wherever its int32 columns hold, and the right
point where they overflow.  They do overflow: ``mont_mul``'s fold of a
negative overflow column leaves an output near 8000q instead of the
audited < 3.2q, the growth compounds, and a CIOS column passes 2^31 —
a wrong point from the tree at depth 9 or more (1024 points; 171
identity-padded to 512) and from 4 of 171 lanes of a 128-bit ladder
(ROADMAP.md section C).  The kernels compute
the same points with their own canonical 12-word field (``g1_field.cuh``)
and return canonical rows: equal to the plain versions' rows as integers
mod q, X, Y and Z alike (the same formulas in the same order), not limb
for limb.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel or raises.  ``launches`` counts kernel launches
per wrapper.  The host classes (``G1Aggregator``, ``G1RunningSum``,
``G1ScalarMul``, ``StormOffload``) take an explicit ``device``: ``cuda``
(the default; it raises without a card) or ``cpu`` (the plain versions).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..crypto.bls.curve import G1Point
from ..crypto.bls.fields import P as Q
from ..telemetry import spans as _spans
from . import _build

NLIMBS = 30
LIMB_BITS = 13
MASK = (1 << LIMB_BITS) - 1
NCOLS = NLIMBS + 2  # lazy CIOS accumulator columns (carry headroom)

RADIX = 1 << (NLIMBS * LIMB_BITS)  # 2^390
R_MONT = RADIX % Q
# mu = -q^{-1} mod 2^13 (the CIOS per-limb quotient constant)
MU = (-pow(Q, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

_CARRY_EVERY = 8
B3 = 12  # 3*b for y^2 = x^3 + 4
SCALAR_BITS = 128  # random small-exponent weights (crypto/bls/service.py)

# The bound's count: int32 multiply-adds of one point addition in the
# kernels' field, 12 CIOS products of 2 x 144 multiply-adds (the additions,
# subtractions and the four doublings of each x12 are not counted).
MADS_PER_MUL = 2 * 12 * 12
MADS_PER_ADD = 12 * MADS_PER_MUL


def _int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    out = np.zeros(n, np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= LIMB_BITS
    assert x == 0
    return out


def limbs_to_int(limbs) -> int:
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr.tolist()))


Q_LIMBS = _int_to_limbs(Q)
Q_EXT = np.concatenate([Q_LIMBS, np.zeros(NCOLS - NLIMBS, np.int32)])

# Fold vectors for the two overflow columns of the CIOS accumulator
# (weights 2^390, 2^403, 2^416 mod q); see ``mont_mul``.
_C390 = _int_to_limbs((1 << 390) % Q)
_C403 = _int_to_limbs((1 << 403) % Q)
_C416 = _int_to_limbs((1 << 416) % Q)


def to_mont_limbs(x: int) -> np.ndarray:
    """Host: integer mod q -> Montgomery-form limb vector."""
    return _int_to_limbs((x % Q) * R_MONT % Q)


# R^2 mod q in limb form: mont_mul(a_plain, R2) = a*R, one multiply from
# a plain row to Montgomery form
R2_LIMBS = _int_to_limbs(RADIX * RADIX % Q)
_ONE_MONT = to_mont_limbs(1)

_LIMB_WEIGHTS = (1 << np.arange(LIMB_BITS, dtype=np.int32)).astype(np.int32)


def ints_to_limbs_batch(vals: list[int]) -> np.ndarray:
    """[n] integers mod q -> [n, NLIMBS] PLAIN (non-Montgomery) limb
    rows, vectorized: one bytes join and a bit-matrix split instead of n
    bignum conversions."""
    n = len(vals)
    rows = np.frombuffer(
        b"".join(v.to_bytes(48, "big") for v in vals), np.uint8
    ).reshape(n, 48)
    bits = np.unpackbits(rows[:, ::-1], axis=1, bitorder="little")
    bits = np.pad(bits, [(0, 0), (0, NLIMBS * LIMB_BITS - 384)])
    groups = bits.reshape(n, NLIMBS, LIMB_BITS).astype(np.int32)
    return groups @ _LIMB_WEIGHTS


def from_mont_int(limbs) -> int:
    """Host: loose Montgomery-form limbs -> canonical integer mod q."""
    return limbs_to_int(limbs) * pow(R_MONT, -1, Q) % Q


_HOST_CONSTS = {
    "q_ext": Q_EXT,
    "c390": _C390,
    "c403": _C403,
    "c416": _C416,
    "r2": R2_LIMBS,
    "one_mont": _ONE_MONT,
}
_CONST_CACHE: dict[tuple, torch.Tensor] = {}
_const_lock = threading.Lock()


def _const(name: str, device, dtype=torch.int32) -> torch.Tensor:
    """A host constant as a ``dtype`` tensor on ``device``, copied once."""
    key = (name, torch.device(device), dtype)
    t = _CONST_CACHE.get(key)
    if t is None:
        with _const_lock:
            t = _CONST_CACHE.get(key)
            if t is None:
                t = _CONST_CACHE[key] = torch.as_tensor(
                    _HOST_CONSTS[name], dtype=dtype, device=device
                )
    return t


# ---- plain versions: hotstuff_tpu/tpu/bls.py in PyTorch, limb for limb -------


def _pass(t):
    """One parallel carry pass.  The TOP limb accumulates its incoming
    carry unmasked (values stay < 2^390-ish; masking would drop bits)."""
    r = torch.cat([t[..., :-1] & MASK, t[..., -1:]], dim=-1)
    c = t[..., :-1] >> LIMB_BITS
    return r + torch.cat([torch.zeros_like(t[..., :1]), c], dim=-1)


def mont_mul(a, b):
    """Batched Montgomery product of signed-loose inputs, loose limbs
    out: the CIOS recurrence of ``hotstuff_tpu/tpu/bls.py`` ``mont_mul``
    (lazy column accumulators, the exact limb-0 carry a step, a parallel
    carry pass every 8 steps, the overflow columns folded back mod q).
    The JAX package's audit puts inputs at |value| < ~60q, |limb| <
    2^13.1 and outputs at < 3.2q; a negative overflow column folds into
    an output near 8000q (see the module docstring).  a, b: int32 (the
    JAX limbs) or int64 (wide columns) [..., NLIMBS]."""
    dev, dt = a.device, a.dtype
    b_ext = torch.cat(
        [b, torch.zeros(b.shape[:-1] + (NCOLS - NLIMBS,), dtype=b.dtype, device=dev)],
        dim=-1,
    )
    q_ext = _const("q_ext", dev, dt)
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (NCOLS,)
    t = torch.zeros(shape, dtype=dt, device=dev)
    zero_col = torch.zeros(shape[:-1] + (1,), dtype=dt, device=dev)
    for i in range(NLIMBS):
        t = t + a[..., i : i + 1] * b_ext
        m = ((t[..., :1] & MASK) * MU) & MASK
        t = t + m * q_ext
        # t0 is now = 0 mod 2^13; propagate its exact carry and shift the
        # limb window down one position
        carry0 = t[..., :1] >> LIMB_BITS
        t = torch.cat([t[..., 1:2] + carry0, t[..., 2:], zero_col], dim=-1)
        if (i % _CARRY_EVERY) == _CARRY_EVERY - 1:
            t = _pass(t)
    t = _pass(_pass(t))
    c30 = t[..., NLIMBS : NLIMBS + 1]
    c31 = t[..., NLIMBS + 1 : NLIMBS + 2]
    lo30, hi30 = c30 & MASK, c30 >> LIMB_BITS
    lo31, hi31 = c31 & MASK, c31 >> LIMB_BITS
    head = (
        t[..., :NLIMBS]
        + lo30 * _const("c390", dev, dt)
        + (hi30 + lo31) * _const("c403", dev, dt)
        + hi31 * _const("c416", dev, dt)
    )
    return _pass(_pass(head))


def madd(a, b):
    return _pass(a + b)


def msub(a, b):
    # signed-loose: negative limbs/values are fine
    return _pass(a - b)


def mul_small(a, k: int):
    """Multiply by a small non-negative integer constant (k <= 16);
    Montgomery form is linear, so integer scaling stays in-form."""
    return _pass(a * k)


def point_add(p, q):
    """Complete addition (Renes-Costello-Batina 2015, Algorithm 7, a = 0,
    b3 = 12): valid for every pair of points, P == Q, P == -Q and the
    identity (0 : 1 : 0) included."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = mont_mul(x1, x2)
    t1 = mont_mul(y1, y2)
    t2 = mont_mul(z1, z2)
    t3 = mont_mul(madd(x1, y1), madd(x2, y2))
    t3 = msub(t3, madd(t0, t1))
    t4 = mont_mul(madd(y1, z1), madd(y2, z2))
    t4 = msub(t4, madd(t1, t2))
    x3 = mont_mul(madd(x1, z1), madd(x2, z2))
    y3 = msub(x3, madd(t0, t2))
    x3 = madd(t0, t0)
    t0 = madd(x3, t0)
    t2 = mul_small(t2, B3)
    z3 = madd(t1, t2)
    t1 = msub(t1, t2)
    y3 = mul_small(y3, B3)
    x3 = mont_mul(t4, y3)
    t2 = mont_mul(t3, t1)
    x3 = msub(t2, x3)
    y3 = mont_mul(y3, t0)
    t1 = mont_mul(t1, z3)
    y3 = madd(t1, y3)
    t0 = mont_mul(t0, t3)
    z3 = mont_mul(z3, t4)
    z3 = madd(z3, t0)
    return (x3, y3, z3)


def _tree_reduce(p):
    while p[0].shape[0] > 1:
        half = p[0].shape[0] // 2
        p = point_add(tuple(c[:half] for c in p), tuple(c[half:] for c in p))
    return p


def _aggregate_impl(xs, ys, zs):
    """Tree-reduce a [B, NLIMBS] batch of Montgomery projective points to
    one point ([NLIMBS] each).  B must be a power of two (callers pad
    with the identity)."""
    return tuple(c[0] for c in _tree_reduce((xs, ys, zs)))


def _aggregate_plain_impl(xs, ys, zs):
    """``_aggregate_impl`` over PLAIN limb rows: the Montgomery
    conversion (one mont_mul by R^2 a coordinate) comes first.  Identity
    pads are plain (0 : 1 : 0)."""
    r2 = _const("r2", xs.device, xs.dtype).expand(xs.shape)
    return tuple(
        c[0] for c in _tree_reduce(tuple(mont_mul(c, r2) for c in (xs, ys, zs)))
    )


def _freshen(a):
    """Re-normalize a signed-loose value by one Montgomery multiply with
    the form of 1 (the JAX audit says to < ~1.3q; a negative overflow
    column leaves more, see the module docstring).  A sequential chain
    (the running sum, the ladder) needs it every step: unfreshened
    point_add outputs compound a step at a time until the CIOS columns
    overflow int32."""
    return mont_mul(a, _const("one_mont", a.device, a.dtype).expand(a.shape))


def _running_add_impl(ax, ay, az, px, py, pz):
    """One incremental accumulate: the new point arrives as PLAIN
    [1, NLIMBS] rows, is Montgomery-converted (one R^2 multiply a
    coordinate), ``point_add``ed into the Montgomery accumulator, and the
    result ``_freshen``ed."""
    r2 = _const("r2", px.device, px.dtype).expand(px.shape)
    p = tuple(mont_mul(c, r2) for c in (px, py, pz))
    out = point_add((ax, ay, az), p)
    return tuple(_freshen(c) for c in out)


def _scalar_mult_impl(bits, xs, ys, zs, nbits: int = SCALAR_BITS):
    """The plain version of ``hotstuff_tpu/tpu/bls.py``
    ``_scalar_mult_kernel``: bits [nbits, B] int32 (MSB first); points
    [B, NLIMBS] loose Montgomery projective.  Returns k_i*P_i, [B,
    NLIMBS] each: a branchless double-and-add (the add's result selected
    where the bit is set), freshened every step."""
    b = xs.shape[0]
    dev, dt = xs.device, xs.dtype
    acc = (
        torch.zeros((b, NLIMBS), dtype=dt, device=dev),
        _const("one_mont", dev, dt).expand(b, NLIMBS).clone(),
        torch.zeros((b, NLIMBS), dtype=dt, device=dev),
    )
    for i in range(nbits):
        acc = point_add(acc, acc)
        added = point_add(acc, (xs, ys, zs))
        take = (bits[i] != 0)[:, None]
        acc = tuple(torch.where(take, ad, ac) for ac, ad in zip(acc, added))
        acc = tuple(_freshen(c) for c in acc)
    return acc


def _wide(fn, *rows, **kw):
    """``fn`` with int64 columns on int32 rows; int32 rows back (the
    limbs of a value < 2^400 fit)."""
    return tuple(c.to(torch.int32) for c in fn(*(r.long() for r in rows), **kw))


def aggregate_plain(xs, ys, zs, plain: bool = True):
    """The plain version of the ``aggregate`` wrapper:
    ``_aggregate_plain_impl`` (plain rows) or ``_aggregate_impl``
    (Montgomery rows) with int64 columns."""
    return _wide(_aggregate_plain_impl if plain else _aggregate_impl, xs, ys, zs)


def running_add_plain(ax, ay, az, px, py, pz):
    """The plain version of ``running_add_``: ``_running_add_impl`` with
    int64 columns."""
    return _wide(_running_add_impl, ax, ay, az, px, py, pz)


def scalar_mult_plain(bits, xs, ys, zs):
    """The plain version of ``scalar_mult``: ``_scalar_mult_impl`` with
    int64 columns."""
    return _wide(_scalar_mult_impl, bits, xs, ys, zs, nbits=bits.shape[0])


# ---- kernel wrappers ----------------------------------------------------------

launches = {"g1_aggregate": 0, "g1_running_add": 0, "g1_scalar_mult": 0}
# the async service's worker threads and the event loop both launch
_launches_lock = threading.Lock()


def _count_launch(name: str) -> None:
    with _launches_lock:
        launches[name] += 1


def reset_launches() -> None:
    with _launches_lock:
        for name in launches:
            launches[name] = 0


def _check_rows(rows, n: int, device) -> None:
    for t in rows:
        if t.device != device:
            raise ValueError("operands on different devices")
        if t.dtype != torch.int32 or tuple(t.shape) != (n, NLIMBS):
            raise ValueError(
                f"expected int32 {(n, NLIMBS)}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def _launch_args(device: torch.device) -> tuple[int, int]:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int) -> None:
    if rc != 0:
        msg = _build.load("g1").g1_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({rc})")


def aggregate(xs, ys, zs, plain: bool = True):
    """The sum of a [B, 30] batch of projective points (B a power of two,
    identity-padded): (X, Y, Z), [30] each.  ``plain``: the rows are
    plain (``_aggregate_plain_impl``), else 2^390-Montgomery
    (``_aggregate_impl``).  The result is in Montgomery form; the
    kernel's rows are canonical.  CPU tensors: ``aggregate_plain``."""
    if xs.device.type == "cpu":
        return aggregate_plain(xs, ys, zs, plain)
    _require_cuda(xs)
    batch = xs.shape[0]
    if batch < 1 or batch & (batch - 1):
        raise ValueError(f"batch {batch} is not a power of two")
    _check_rows((xs, ys, zs), batch, xs.device)
    out = torch.empty((3, NLIMBS), dtype=torch.int32, device=xs.device)
    scratch = torch.empty((max(batch // 2, 1), 36), dtype=torch.int32, device=xs.device)
    index, stream = _launch_args(xs.device)
    o = out.unbind(0)
    _raise_on(_build.load("g1").g1_aggregate_launch(
        xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), batch, 1 if plain else 0,
        scratch.data_ptr(), o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(),
        index, stream,
    ))
    _count_launch("g1_aggregate")
    return o


def _affine_param(x: int, y: int) -> _build.G1Affine:
    return _build.G1Affine.from_buffer_copy(x.to_bytes(48, "little") + y.to_bytes(48, "little"))


def running_add_(acc: torch.Tensor, x: int, y: int) -> torch.Tensor:
    """acc <- acc + (x : y : 1), in place (the accumulator is dead the
    moment the new one exists).  acc: int32 [3, 30], the X, Y, Z rows in
    Montgomery form; x, y: the new point's affine coordinates (< q).  On
    the card the point travels by value in the launch's parameters: no
    host-to-device copy, no synchronisation."""
    if acc.device.type == "cpu":
        px = torch.from_numpy(ints_to_limbs_batch([x]))
        py = torch.from_numpy(ints_to_limbs_batch([y]))
        pz = torch.zeros((1, NLIMBS), dtype=torch.int32)
        pz[0, 0] = 1
        out = running_add_plain(acc[0:1], acc[1:2], acc[2:3], px, py, pz)
        acc.copy_(torch.cat(out, dim=0))
        return acc
    _require_cuda(acc)
    if acc.dtype != torch.int32 or tuple(acc.shape) != (3, NLIMBS) or not acc.is_contiguous():
        raise ValueError(f"expected a contiguous int32 {(3, NLIMBS)} accumulator")
    if not (0 <= x < Q and 0 <= y < Q):
        raise ValueError("coordinates must be reduced mod q")
    index, stream = _launch_args(acc.device)
    _raise_on(_build.load("g1").g1_running_add_launch(
        acc.data_ptr(), _affine_param(x, y), index, stream
    ))
    _count_launch("g1_running_add")
    return acc


def scalar_mult(bits, xs, ys, zs):
    """[k_i]P_i for a batch: bits int32 [nbits, B] (MSB first), points
    [B, 30] Montgomery projective.  Returns (X, Y, Z), [B, 30] each."""
    nbits = bits.shape[0]
    if xs.device.type == "cpu":
        return scalar_mult_plain(bits, xs, ys, zs)
    _require_cuda(xs)
    batch = xs.shape[0]
    _check_rows((xs, ys, zs), batch, xs.device)
    if (bits.device != xs.device or bits.dtype != torch.int32
            or tuple(bits.shape) != (nbits, batch) or not bits.is_contiguous()):
        raise ValueError(f"expected contiguous int32 bits {(nbits, batch)} on {xs.device}")
    out = torch.empty((3, batch, NLIMBS), dtype=torch.int32, device=xs.device)
    o = out.unbind(0)
    index, stream = _launch_args(xs.device)
    _raise_on(_build.load("g1").g1_scalar_mult_launch(
        bits.data_ptr(), nbits, batch, xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
        o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(), index, stream,
    ))
    _count_launch("g1_scalar_mult")
    return o


# ---- host classes -------------------------------------------------------------


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the G1 kernels need one (device='cpu' runs "
            "their plain versions)"
        )
    return dev


def projective_to_affine(x, y, z) -> G1Point:
    """Host: Montgomery projective rows (loose or canonical) -> the
    affine point (one Fq inversion)."""
    zi = from_mont_int(z)
    if zi == 0:
        return G1Point.identity()
    xi = from_mont_int(x)
    yi = from_mont_int(y)
    z_inv = pow(zi, Q - 2, Q)
    return G1Point(xi * z_inv % Q, yi * z_inv % Q)


class G1Aggregator:
    """Aggregate G1 points (vote signatures) on the device: the device
    does the O(n) part (the tree sum), the caller feeds the aggregate
    into the host pairing check, one constant-cost pairing per QC.  The
    counterpart of ``TpuG1Aggregator`` without its mesh (the sharded
    aggregate is not ported).  Inputs must be subgroup points."""

    PAD_SIZES = (8, 32, 128, 512)

    def __init__(self, device="cuda"):
        self.device = _device(device)

    def _padded_size(self, n: int) -> int:
        return next(
            (s for s in self.PAD_SIZES if s >= n), 1 << (n - 1).bit_length()
        )

    def aggregate(self, points: list[G1Point]) -> G1Point:
        real = [pt for pt in points if not pt.inf]
        if not real:
            return G1Point.identity()
        with _spans.span("prepare"):
            padded = self._padded_size(len(real))
            m = len(real)
            rows = np.zeros((3, padded, NLIMBS), np.int32)
            # plain byte-split rows: (x : y : 1), identity pads (0 : 1 : 0)
            rows[0, :m] = ints_to_limbs_batch([pt.x for pt in real])
            rows[1, :m] = ints_to_limbs_batch([pt.y for pt in real])
            rows[2, :m, 0] = 1
            rows[1, m:, 0] = 1
            staged = torch.from_numpy(rows).to(self.device)
        with _spans.span("dispatch"):
            x, y, z = aggregate(*staged.unbind(0), plain=True)
        with _spans.span("readback"):
            out = torch.stack((x, y, z)).cpu().numpy()
            return projective_to_affine(*out)


class G1RunningSum:
    """Device-resident incremental G1 accumulator: a running sum of
    signatures on the device as votes arrive, one ``running_add_`` launch
    a vote, so QC formation at quorum is a readback of an
    already-computed point.  ``add`` never synchronises; only
    ``snapshot()`` fences.  Callers feed subgroup points."""

    def __init__(self, device="cuda"):
        self.device = _device(device)
        self._acc: torch.Tensor | None = None
        self._count = 0
        self.reset()

    def reset(self) -> None:
        # identity (0 : 1 : 0) in Montgomery form; a device-side copy of a
        # cached constant, so a reset makes no host-to-device transfer
        one = _const("one_mont", self.device)
        acc = torch.zeros((3, NLIMBS), dtype=torch.int32, device=self.device)
        acc[1].copy_(one)
        self._acc = acc
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def add(self, pt: G1Point) -> None:
        """Accumulate one point; returns without waiting on the device."""
        if pt.inf:
            return
        with _spans.span("agg.accumulate"):
            running_add_(self._acc, pt.x, pt.y)
            self._count += 1

    def snapshot(self) -> G1Point:
        """Fence the pending adds and read the aggregate back (affine)."""
        with _spans.span("agg.snapshot"):
            return projective_to_affine(*self._acc.cpu().numpy())


class G1ScalarMul:
    """Batched k_i*P_i on the device (the TC storm's per-entry ladders):
    the host packs scalars into MSB-first bit planes and points into
    Montgomery rows, the device runs one ladder over the batch, the host
    converts to affine (one inversion a point)."""

    PAD_SIZES = (8, 32, 128, 512)

    def __init__(self, nbits: int = SCALAR_BITS, device="cuda"):
        self.nbits = nbits
        self.device = _device(device)

    def _padded(self, n: int) -> int:
        return next(
            (s for s in self.PAD_SIZES if s >= n), 1 << (n - 1).bit_length()
        )

    def stage(self, scalars: list[int], points: list[G1Point]):
        """(bits [nbits, padded], xs, ys, zs [padded, 30]) as host arrays;
        pad lanes are the identity with scalar 0."""
        n = len(points)
        assert len(scalars) == n and n > 0
        padded = self._padded(n)
        nbytes = (self.nbits + 7) // 8
        sbytes = np.zeros((padded, nbytes), np.uint8)
        packed = b"".join(k.to_bytes(nbytes, "little") for k in scalars)
        sbytes[:n] = np.frombuffer(packed, np.uint8).reshape(n, nbytes)
        lsb_first = np.unpackbits(sbytes, axis=1, bitorder="little")
        bits = np.ascontiguousarray(lsb_first[:, : self.nbits][:, ::-1].T.astype(np.int32))
        xs = np.zeros((padded, NLIMBS), np.int32)
        ys = np.zeros((padded, NLIMBS), np.int32)
        zs = np.zeros((padded, NLIMBS), np.int32)
        ys[:] = _ONE_MONT  # identity rows by default (0 : 1 : 0)
        for i, pt in enumerate(points):
            if not pt.inf:
                xs[i] = to_mont_limbs(pt.x)
                ys[i] = to_mont_limbs(pt.y)
                zs[i] = _ONE_MONT
        return bits, xs, ys, zs

    def mul_arrays(self, scalars: list[int], points: list[G1Point]):
        """The ladder; returns the projective result as device tensors
        (X, Y, Z of shape [padded, 30])."""
        with _spans.span("prepare"):
            staged = [torch.from_numpy(a).to(self.device)
                      for a in self.stage(scalars, points)]
        with _spans.span("dispatch"):
            return scalar_mult(*staged)

    def mul(self, scalars: list[int], points: list[G1Point]) -> list[G1Point]:
        """[k_i*P_i]; scalars must fit in ``nbits``."""
        if not points:
            return []
        for k in scalars:
            assert 0 <= k < (1 << self.nbits)
        x, y, z = torch.stack(self.mul_arrays(scalars, points)).cpu().numpy()
        return [
            projective_to_affine(x[i], y[i], z[i]) for i in range(len(points))
        ]


class StormOffload:
    """Batched G1 ladders for distinct-digest TC verification: for an
    all-distinct TC batch, every per-entry G1 ladder (the signature
    subgroup check order*sig, the weighted signature r_i*sig_i, the
    weighted cofactor-cleared hash (r_i*h_eff)*H_base(m_i)) runs as ONE
    batched ladder of 3n points, then the weighted signatures are summed
    on the device.  The host (native/bls_pairing.cpp) keeps
    decompression, hashing and the pairing product.  The counterpart of
    ``TpuStormOffload``."""

    def __init__(self, device="cuda"):
        self._mul = G1ScalarMul(nbits=256, device=device)
        self.device = self._mul.device
        # warmed (ladder_pad, agg_pad) shapes: batch_points refuses the
        # others, so a storm of another size takes the host route
        self._warm_shapes: set[tuple[int, int]] = set()
        self.ready = False

    def _shapes_for(self, n: int) -> tuple[int, int]:
        return self._mul._padded(3 * n), 1 << max(0, (n - 1).bit_length())

    def shape_ready(self, n: int) -> bool:
        return self._shapes_for(n) in self._warm_shapes

    def warmup(self, n: int = 171) -> None:
        """Run the ladder and aggregation shapes of an n-entry storm once
        (the kernels build on the first launch) before the consensus hot
        path."""
        g = G1Point.generator()
        ladder_pad, agg_pad = self._shapes_for(n)
        self._mul.mul([1] * ladder_pad, [g] * ladder_pad)
        self._aggregate_mont(np.zeros((0, NLIMBS), np.int32), None, None, agg_pad)
        self._warm_shapes.add((ladder_pad, agg_pad))
        self.ready = True

    def _aggregate_mont(self, x, y, z, agg_pad: int) -> G1Point:
        """Tree sum of Montgomery rows x, y, z ([m, 30], m <= agg_pad),
        identity-padded to ``agg_pad``."""
        rows = np.zeros((3, agg_pad, NLIMBS), np.int32)
        rows[1] = _ONE_MONT
        m = x.shape[0]
        if m:
            rows[0, :m], rows[1, :m], rows[2, :m] = x, y, z
        staged = torch.from_numpy(rows).to(self.device)
        ax, ay, az = aggregate(*staged.unbind(0), plain=False)
        return projective_to_affine(*torch.stack((ax, ay, az)).cpu().numpy())

    def batch_points(self, weights: list[int], bases, sigs):
        """(whm_points, agg_point, subgroup_ok) for the native pairing
        product.  ``bases`` are PRE-cofactor hash points, ``sigs``
        on-curve (subgroup membership is checked HERE by the order
        ladder).  whm_i = (w_i*h_eff)*base_i; agg = sum w_i*sig_i."""
        from ..crypto.bls.curve import H1
        from ..crypto.bls.fields import R as ORDER

        n = len(bases)
        assert len(weights) == n and len(sigs) == n
        scalars = [w * H1 for w in weights] + list(weights) + [ORDER] * n
        x, y, z = torch.stack(
            self._mul.mul_arrays(scalars, list(bases) + list(sigs) * 2)
        ).cpu().numpy()
        # subgroup: order*sig must be the identity (z == 0 mod q).  The G1
        # cofactor has SMALL prime factors, so a small-order component
        # must be caught per signature
        subgroup_ok = all(from_mont_int(z[2 * n + i]) == 0 for i in range(n))
        whm = [projective_to_affine(x[i], y[i], z[i]) for i in range(n)]
        _, agg_pad = self._shapes_for(n)
        agg = self._aggregate_mont(
            x[n : 2 * n], y[n : 2 * n], z[n : 2 * n], agg_pad
        )
        return whm, agg, subgroup_ok
