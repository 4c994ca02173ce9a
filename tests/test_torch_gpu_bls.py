"""The port's G1 device path (hotstuff_tpu_torch/gpu/bls.py and
gpu/csrc/g1_field.cuh) against the JAX package's (hotstuff_tpu/tpu/bls.py)
and the arbitrary-precision oracle (crypto/bls/curve.py).

Tolerance: none.  The plain PyTorch functions are compared with the JAX
functions limb for limb (int32 rows, exact).  The kernel body, built for
the host with g++ (g1_host_lanes.cpp), returns canonical rows: compared
with the plain versions as integers mod q (X, Y and Z alike) and with the
oracle as affine points.  The kernels themselves run only on a card
(``cuda``-marked, skipped here)."""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hotstuff_tpu.tpu import bls as J
from hotstuff_tpu_torch.crypto.bls.curve import G1Point
from hotstuff_tpu_torch.crypto.bls.fields import P as Q
from hotstuff_tpu_torch.gpu import _build, bls as G

torch.set_num_threads(1)
SEED = 20261017


def _pts(n: int, seed: int = SEED) -> list[G1Point]:
    """n subgroup points from a seed: k0*G, then steps of d*G."""
    rng = random.Random(seed)
    p = G1Point.generator().mul(rng.randrange(1, 2**64))
    d = G1Point.generator().mul(rng.randrange(1, 2**64))
    out = []
    for _ in range(n):
        out.append(p)
        p = p + d
    return out


def _mont_rows(points) -> np.ndarray:
    """[3, n, 30] Montgomery projective rows (x : y : 1), identity (0 : 1 : 0)."""
    rows = np.zeros((3, len(points), G.NLIMBS), np.int32)
    for i, p in enumerate(points):
        if p.inf:
            rows[1, i] = G.to_mont_limbs(1)
        else:
            rows[0, i], rows[1, i], rows[2, i] = (
                G.to_mont_limbs(p.x), G.to_mont_limbs(p.y), G.to_mont_limbs(1))
    return rows


def _plain_rows(points, pad_to: int) -> np.ndarray:
    """[3, pad_to, 30] plain rows, identity-padded, as the aggregator stages them."""
    rows = np.zeros((3, pad_to, G.NLIMBS), np.int32)
    m = len(points)
    rows[0, :m] = G.ints_to_limbs_batch([p.x for p in points])
    rows[1, :m] = G.ints_to_limbs_batch([p.y for p in points])
    rows[2, :m, 0] = 1
    rows[1, m:, 0] = 1
    return rows


def _jax(fn, *arrays, **kw):
    out = fn(*(jnp.asarray(a) for a in arrays), **kw)
    return [np.asarray(c) for c in (out if isinstance(out, tuple) else (out,))]


def _torch(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return [c.numpy() for c in (out if isinstance(out, tuple) else (out,))]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _mod_q(rows) -> list[int]:
    return [G.limbs_to_int(r) % Q for r in rows]


# ---- limb helpers and constants ------------------------------------------------


def test_limb_helpers_and_constants_equal_jax():
    rng = random.Random(SEED)
    vals = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(13)]
    assert np.array_equal(G.ints_to_limbs_batch(vals), J.ints_to_limbs_batch(vals))
    for v in vals:
        m = G.to_mont_limbs(v)
        assert np.array_equal(m, J.to_mont_limbs(v))
        assert G.from_mont_int(m) == J.from_mont_int(m) == v
        assert G.limbs_to_int(m) == J.limbs_to_int(m)
    for name in ("Q_LIMBS", "Q_EXT", "R2_LIMBS", "_C390", "_C403", "_C416", "_ONE_MONT"):
        assert np.array_equal(getattr(G, name), getattr(J, name)), name
    assert (G.MU, G.R_MONT, G.NCOLS, G.B3) == (J.MU, J.R_MONT, J.NCOLS, J.B3)


# ---- the plain versions, limb for limb against JAX --------------------------------


def test_field_ops_equal_jax_limb_for_limb():
    """Signed-loose inputs (negative limbs included), the magnitudes the
    point formulas feed in."""
    rs = np.random.default_rng(SEED)
    a = rs.integers(-(2**13), 2**13, size=(16, 30), dtype=np.int32)
    b = rs.integers(-(2**13), 2**13, size=(16, 30), dtype=np.int32)
    assert _same(_torch(G.mont_mul, a, b), _jax(J.mont_mul, a, b))
    assert _same(_torch(G.madd, a, b), _jax(J.madd, a, b))
    assert _same(_torch(G.msub, a, b), _jax(J.msub, a, b))
    assert _same(_torch(G._freshen, a), _jax(J._freshen, a))
    for k in (2, 3, 12, 16):
        got = G.mul_small(torch.from_numpy(a), k).numpy()
        assert np.array_equal(got, np.asarray(J.mul_small(jnp.asarray(a), k)))
    # broadcasting of a single row against a batch, as the R^2 multiply does
    assert _same(_torch(G.mont_mul, a, G.R2_LIMBS[None, :]),
                 _jax(J.mont_mul, a, J.R2_LIMBS[None, :]))


@pytest.mark.parametrize("case", ["distinct", "equal", "opposite", "identity_left", "identity_both"])
def test_point_add_equals_jax_and_the_oracle(case):
    p, q = _pts(2)
    pair = {
        "distinct": (p, q),
        "equal": (p, p),
        "opposite": (p, -p),
        "identity_left": (G1Point.identity(), q),
        "identity_both": (G1Point.identity(), G1Point.identity()),
    }[case]
    a, b = (_mont_rows([pt]) for pt in pair)
    got = G.point_add(tuple(torch.from_numpy(c) for c in a),
                      tuple(torch.from_numpy(c) for c in b))
    want = J.point_add(tuple(jnp.asarray(c) for c in a), tuple(jnp.asarray(c) for c in b))
    assert _same([c.numpy() for c in got], [np.asarray(c) for c in want])
    aff = G.projective_to_affine(*(c.numpy()[0] for c in got))
    assert aff == pair[0] + pair[1]


def test_tree_and_aggregates_equal_jax():
    pts = _pts(8)
    mont = _mont_rows(pts)
    assert _same(_torch(G._aggregate_impl, *mont), _jax(J._aggregate_impl, *mont))
    assert _same([c.numpy() for c in G._tree_reduce(tuple(torch.from_numpy(c) for c in mont[:, :4]))],
                 [np.asarray(c) for c in J._tree_reduce(tuple(jnp.asarray(c) for c in mont[:, :4]))])
    plain = _plain_rows(pts[:5], 8)
    got = _torch(G._aggregate_plain_impl, *plain)
    assert _same(got, _jax(J._aggregate_plain_impl, *plain))
    assert G.projective_to_affine(*got) == G1Point.sum(pts[:5])


def test_running_add_equals_jax():
    pts = _pts(3)
    acc_j = tuple(jnp.asarray(c) for c in _mont_rows([G1Point.identity()]))
    acc_t = tuple(torch.from_numpy(c) for c in _mont_rows([G1Point.identity()]))
    for p in pts:
        prow = _plain_rows([p], 1)
        acc_j = J._running_add_impl(*acc_j, *(jnp.asarray(c) for c in prow))
        acc_t = G._running_add_impl(*acc_t, *(torch.from_numpy(c) for c in prow))
        assert _same([c.numpy() for c in acc_t], [np.asarray(c) for c in acc_j])
    assert G.projective_to_affine(*(c.numpy()[0] for c in acc_t)) == G1Point.sum(pts)


def test_scalar_mult_equals_jax_at_a_few_bits():
    """The plain ladder against ``_scalar_mult_kernel`` at 6 bits (the
    full 128-bit ladder runs through the host build below)."""
    pts = _pts(4)
    ks = [0, 1, 37, 63]
    m = G.G1ScalarMul(nbits=6, device="cpu")
    bits, xs, ys, zs = m.stage(ks, pts)
    got = _torch(G._scalar_mult_impl, bits, xs, ys, zs, nbits=6)
    want = _jax(J._scalar_mult_kernel, bits, xs, ys, zs, nbits=6)
    assert _same(got, want)
    for i, (k, p) in enumerate(zip(ks, pts)):
        assert G.projective_to_affine(got[0][i], got[1][i], got[2][i]) == p._mul_raw(k)


# ---- the host classes on the plain versions ------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 171])
def test_aggregator_on_the_cpu_matches_the_oracle(n):
    """B = 1, 2 and 171 -> 256 with identity pads; an empty batch is the
    identity without a launch."""
    pts = _pts(n)
    G.reset_launches()
    got = G.G1Aggregator(device="cpu").aggregate(pts + [G1Point.identity()])
    assert got == G1Point.sum(pts)
    assert G.launches == {"g1_aggregate": 0, "g1_running_add": 0, "g1_scalar_mult": 0}


def test_the_jax_int32_columns_overflow_and_the_wide_plain_versions_do_not():
    """A fault of the reference: its mont_mul folds a negative overflow
    column into an output near 8000q (the audit says < 3.2q), the growth
    compounds and a CIOS column passes 2^31.  The JAX package's
    ``_scalar_mult_kernel`` gives a wrong point for lane 105 of
    chip_smoke.py's (k1) ladder data within its first 13 bits (limb for
    limb what the int32 copy here gives); the int32 tree gives a wrong
    point for 171 points identity-padded to 512 (the aggregator's pad for
    a 171-vote QC; 1024 points at B = 1024 in the host-build test below).
    The wrappers' plain versions (the same code with int64 columns), the
    aggregator on them, and the kernel body (the host build, below) give
    the oracle's points."""
    bits, xs, ys, zs, (p, k) = _ladder_lane_105()
    head = np.ascontiguousarray(bits[:13])
    want = p._mul_raw(k >> 115)  # the scalar's top 13 bits
    jax_out = _jax(J._scalar_mult_kernel, head, xs, ys, zs, nbits=13)
    assert _same(_torch(G._scalar_mult_impl, head, xs, ys, zs, nbits=13), jax_out)
    assert G.projective_to_affine(*(c[0] for c in jax_out)) != want
    assert G.projective_to_affine(*(c[0] for c in _torch(G.scalar_mult_plain, head, xs, ys, zs))) == want
    pts = _pts(171)
    rows = _plain_rows(pts, 512)
    want = G1Point.sum(pts)
    assert G.projective_to_affine(*_torch(G._aggregate_plain_impl, *rows)) != want
    assert G.projective_to_affine(*_torch(G.aggregate_plain, *rows)) == want
    assert G.G1Aggregator(device="cpu").aggregate(pts) == want


def _ladder_lane_105():
    """(bits, xs, ys, zs, (point, scalar)) of one lane that overflows the
    JAX ladder's int32 columns."""
    import chip_smoke

    pts = chip_smoke.g1_points(171, seed=5)
    rng = random.Random(7)
    ks = [rng.randrange(1 << 128) for _ in range(171)]
    bits, xs, ys, zs = G.G1ScalarMul(nbits=128, device="cpu").stage(ks[105:106], pts[105:106])
    return bits[:, :1], xs[:1], ys[:1], zs[:1], (pts[105], ks[105])


def test_aggregator_pads_like_jax():
    agg = G.G1Aggregator(device="cpu")
    jagg = J.TpuG1Aggregator()
    for n in (1, 2, 8, 9, 33, 171, 513, 700):
        assert agg._padded_size(n) == jagg._padded_size(n)
    assert G.G1ScalarMul(device="cpu")._padded(513) == J.TpuG1ScalarMul()._padded(513)


def test_a_300_add_running_chain_matches_the_oracle():
    """The sequential chain _freshen exists for: 300 plain running adds
    (13-bit limbs overflow int32 after ~40-50 unfreshened adds), held
    against the oracle along the way and at the end."""
    pts = _pts(300, seed=SEED + 1)
    s = G.G1RunningSum(device="cpu")
    want = G1Point.identity()
    for i, p in enumerate(pts):
        s.add(p)
        want = want + p
        if i in (49, 149):
            assert s.snapshot() == want
    assert len(s) == 300
    assert s.snapshot() == want == G1Point.sum(pts)


def test_storm_offload_split_on_the_plain_versions():
    """StormOffload's split on the plain versions at a tiny width: the
    weighted hash points and the weighted-signature sum equal the
    oracle's, and a non-subgroup signature fails the order ladder."""
    from hotstuff_tpu_torch.crypto.bls.curve import H1

    off = G.StormOffload(device="cpu")
    off._mul.nbits = 12  # a short ladder: the scalars below fit in 12 bits
    bases, sigs = _pts(2), _pts(2, seed=SEED + 2)
    weights = [5, 9]
    # the real split scales by H1 and the group order (256-bit ladders);
    # the 12-bit check exercises the same staging and aggregation
    n = len(bases)
    x, y, z = (c.numpy() for c in off._mul.mul_arrays(weights + weights, bases + sigs))
    whm = [G.projective_to_affine(x[i], y[i], z[i]) for i in range(n)]
    assert whm == [b._mul_raw(w) for b, w in zip(bases, weights)]
    agg = off._aggregate_mont(x[n:2 * n], y[n:2 * n], z[n:2 * n], off._shapes_for(n)[1])
    assert agg == sigs[0]._mul_raw(5) + sigs[1]._mul_raw(9)
    assert H1 > 1 << 12  # why the real storm ladder is 256 bits wide


# ---- the kernel body, built for the host -------------------------------------------------


@pytest.fixture(scope="module")
def host_g1(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel body cannot run")
    out = tmp_path_factory.mktemp("g1_host_lanes") / "libg1_host_lanes.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra", "-Werror",
         "-I", str(_build.CSRC), "-o", str(out), str(_build.CSRC / "g1_host_lanes.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_g1_aggregate.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, ci]
    lib.host_g1_running_add.argtypes = [vp, vp, vp]
    lib.host_g1_scalar_mult.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.host_g1_fe_mul.argtypes = [vp, vp, vp, ci]
    lib.host_g1_row_roundtrip.argtypes = [vp, ci, ci, vp]
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _words(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(48, "little"), np.uint32).copy()


def _host_aggregate(lib, rows, plain: bool, reverse: bool):
    out = np.zeros((3, G.NLIMBS), np.int32)
    rows = np.ascontiguousarray(rows)
    lib.host_g1_aggregate(_p(rows[0]), _p(rows[1]), _p(rows[2]), rows.shape[1],
                          int(plain), _p(out[0]), _p(out[1]), _p(out[2]), int(reverse))
    return out


def test_host_field_matches_python(host_g1):
    """The header's CIOS product (radix 2^384) and its edge conversions
    (signed-loose rows in, canonical rows out) against Python integers."""
    rng = random.Random(SEED)
    vals = [(0, 0), (1, Q - 1), (Q - 1, Q - 1)] + [(rng.randrange(Q), rng.randrange(Q)) for _ in range(29)]
    a = np.stack([_words(x) for x, _ in vals])
    b = np.stack([_words(y) for _, y in vals])
    out = np.zeros_like(a)
    host_g1.host_g1_fe_mul(_p(out), _p(a), _p(b), len(vals))
    rinv = pow(2, -384, Q)
    for i, (x, y) in enumerate(vals):
        assert int.from_bytes(out[i].tobytes(), "little") == x * y * rinv % Q
    # loose rows of the plain versions (negative limbs, values past q)
    rs = np.random.default_rng(SEED)
    prods = [G.mont_mul(torch.from_numpy(rs.integers(-(2**13), 2**13, size=(64, 30), dtype=np.int32)),
                        torch.from_numpy(rs.integers(-(2**13), 2**13, size=(64, 30), dtype=np.int32)))
             for _ in range(2)]
    loose = G.mul_small(G.msub(*prods), 12).numpy()
    assert (loose < 0).any()
    for plain in (0, 1):
        rows = np.ascontiguousarray(loose)
        back = np.zeros_like(rows)
        host_g1.host_g1_row_roundtrip(_p(rows), rows.shape[0], plain, _p(back))
        assert ((back >= 0) & (back < 2**13)).all()
        scale = G.R_MONT if plain else 1
        assert _mod_q(back) == [G.limbs_to_int(r) * scale % Q for r in rows]


@pytest.mark.parametrize("n,batch", [(1, 1), (2, 2), (171, 256)])
def test_host_aggregate_matches_plain_and_oracle(host_g1, n, batch):
    """B = 1, 2, 171 -> 256: the tree run level by level, forward and in
    reverse, equal mod q to the plain version's X, Y, Z and to the oracle."""
    pts = _pts(n)
    rows = _plain_rows(pts, batch)
    plain = _torch(G._aggregate_plain_impl, *rows)
    for reverse in (False, True):
        got = _host_aggregate(host_g1, rows, plain=True, reverse=reverse)
        assert ((got >= 0) & (got < 2**13)).all()
        assert _mod_q(got) == _mod_q(plain)
        assert G.projective_to_affine(*got) == G1Point.sum(pts)
    mont = _mont_rows(pts + [G1Point.identity()] * (batch - n))
    got = _host_aggregate(host_g1, mont, plain=False, reverse=False)
    assert _mod_q(got) == _mod_q(_torch(G._aggregate_impl, *mont))
    assert _mod_q(got) == _mod_q(_torch(G.aggregate_plain, *mont, plain=False))


def test_host_build_where_the_jax_columns_overflow(host_g1):
    """The kernel body's canonical field at the inputs of the test above:
    right, and equal mod q to the wide plain versions."""
    for n, batch, seed in ((171, 512, SEED), (1024, 1024, 1)):
        pts = _pts(n, seed=seed)
        rows = _plain_rows(pts, batch)
        got = _host_aggregate(host_g1, rows, plain=True, reverse=False)
        assert G.projective_to_affine(*got) == G1Point.sum(pts)
        assert _mod_q(got) == _mod_q(_torch(G.aggregate_plain, *rows))
    bits, xs, ys, zs, (p, k) = _ladder_lane_105()
    out = np.zeros((3, 1, G.NLIMBS), np.int32)
    bits, xs, ys, zs = (np.ascontiguousarray(a) for a in (bits[:13], xs, ys, zs))
    host_g1.host_g1_scalar_mult(_p(bits), 13, 1, _p(xs), _p(ys), _p(zs), _p(out[0]), _p(out[1]), _p(out[2]))
    assert G.projective_to_affine(out[0][0], out[1][0], out[2][0]) == p._mul_raw(k >> 115)
    wide = _torch(G.scalar_mult_plain, bits, xs, ys, zs)
    for c in range(3):
        assert _mod_q(out[c]) == _mod_q(wide[c])


@pytest.mark.parametrize("pair", ["equal", "opposite", "identity"])
def test_host_aggregate_complete_cases(host_g1, pair):
    p = _pts(1)[0]
    pts = {"equal": [p, p], "opposite": [p, -p], "identity": [G1Point.identity(), p]}[pair]
    got = _host_aggregate(host_g1, _mont_rows(pts), plain=False, reverse=False)
    assert G.projective_to_affine(*got) == pts[0] + pts[1]


def test_host_running_add_chain_of_512(host_g1):
    """A committee of 512 chains 512 adds: the kernel body's canonical
    field needs no renormalisation, so every step stays exact."""
    pts = _pts(512, seed=SEED + 3)
    acc = np.ascontiguousarray(_mont_rows([G1Point.identity()])[:, 0, :])
    plain = tuple(torch.from_numpy(c) for c in _mont_rows([G1Point.identity()]))
    for i, p in enumerate(pts):
        host_g1.host_g1_running_add(_p(acc), _p(_words(p.x)), _p(_words(p.y)))
        if i < 3:  # X, Y, Z equal the plain version's mod q step by step
            plain = G._running_add_impl(*plain, *(torch.from_numpy(c) for c in _plain_rows([p], 1)))
            assert _mod_q(acc) == _mod_q([c.numpy()[0] for c in plain])
    assert G.projective_to_affine(*acc) == G1Point.sum(pts)


def test_host_ladder_full_128_bits(host_g1):
    """The full 128-bit ladder (256 chained point additions a lane) with
    scalars 0, 1, 2^127 and random ones, against the oracle."""
    rng = random.Random(SEED)
    pts = _pts(8)
    ks = [0, 1, (1 << 127) | 1, (1 << 128) - 1] + [rng.randrange(1 << 128) for _ in range(4)]
    m = G.G1ScalarMul(nbits=128, device="cpu")
    bits, xs, ys, zs = m.stage(ks, pts)
    out = np.zeros((3,) + xs.shape, np.int32)
    host_g1.host_g1_scalar_mult(_p(bits), 128, xs.shape[0], _p(xs), _p(ys), _p(zs),
                                _p(out[0]), _p(out[1]), _p(out[2]))
    for i, (k, p) in enumerate(zip(ks, pts)):
        assert G.projective_to_affine(out[0][i], out[1][i], out[2][i]) == p._mul_raw(k)
    # a few bits: equal mod q to the plain ladder's X, Y, Z
    bits6, xs6, ys6, zs6 = G.G1ScalarMul(nbits=6, device="cpu").stage([k % 64 for k in ks], pts)
    out6 = np.zeros((3,) + xs6.shape, np.int32)
    host_g1.host_g1_scalar_mult(_p(bits6), 6, xs6.shape[0], _p(xs6), _p(ys6), _p(zs6),
                                _p(out6[0]), _p(out6[1]), _p(out6[2]))
    plain = _torch(G._scalar_mult_impl, bits6, xs6, ys6, zs6, nbits=6)
    for c in range(3):
        assert _mod_q(out6[c]) == _mod_q(plain[c])


# ---- wrappers, build and devices -----------------------------------------------------------


def test_wrappers_refuse_a_device_without_a_kernel():
    meta = torch.empty((2, 30), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        G.aggregate(meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        G.scalar_mult(torch.empty((4, 2), dtype=torch.int32, device="meta"), meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        G.running_add_(torch.empty((3, 30), dtype=torch.int32, device="meta"), 1, 2)


def test_cuda_host_classes_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (G.G1Aggregator, G.G1RunningSum, G.G1ScalarMul, G.StormOffload):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_g1_library_is_its_own_build_and_nothing_builds_at_import():
    assert "g1" not in _build._LIBS
    assert _build.library_path("g1").name.startswith("libhs_g1_")
    assert _build.library_path("g1").parent == _build.BUILD_DIR
    assert "g1_kernels.cu" in _build.KERNEL_SOURCES and "g1_field.cuh" in _build.HEADERS
    # the Ed25519 library's name (and hash inputs) did not move
    assert _build.library_path("dsm") == _build.library_path()


# ---- the CUDA kernels, on a card ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["aggregate", "running_add", "scalar_mult"])
def test_cuda_g1_kernels_match_plain(kernel):
    """Each G1 kernel against its plain version on the card: X, Y, Z equal
    mod q, the affine point equal to the oracle's, on repeated launches."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    dev = torch.device("cuda")
    pts = _pts(16)
    G.reset_launches()
    if kernel == "aggregate":
        rows = torch.from_numpy(_plain_rows(pts[:11], 16)).to(dev)
        plain = [c.cpu().numpy() for c in G._aggregate_plain_impl(*rows.unbind(0))]
        for _ in range(4):
            got = [c.cpu().numpy() for c in G.aggregate(*rows.unbind(0), plain=True)]
            assert _mod_q(got) == _mod_q(plain)
        assert G.projective_to_affine(*got) == G1Point.sum(pts[:11])
    elif kernel == "running_add":
        s = G.G1RunningSum(device=dev)
        for p in pts:
            s.add(p)
        assert s.snapshot() == G1Point.sum(pts)
    else:
        ks = [random.Random(i).randrange(1 << 128) for i in range(5)]
        m = G.G1ScalarMul(nbits=128, device=dev)
        assert m.mul(ks, pts[:5]) == [p._mul_raw(k) for p, k in zip(pts, ks)]
    assert G.launches["g1_" + kernel] > 0
