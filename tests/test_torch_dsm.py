"""The fused verifier's kernels (hotstuff_tpu_torch/gpu/dsm.py and
gpu/csrc/): the plain PyTorch versions against the Pallas kernels run in
interpret mode, the kernel body (ed25519_field.cuh, built for the host
with g++) against the plain versions and against Pallas limb for limb,
and the kernels themselves on a card where there is one.  Every value is
an integer limb or a boolean, so every tolerance is zero."""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hotstuff_tpu.tpu import pallas_dsm
from hotstuff_tpu.tpu.ed25519 import _bytes_to_windows_msb
from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.gpu import _build, curve, dsm, field as F

# The operands are small: intra-op threads would only contend with the
# other test workers.
torch.set_num_threads(1)

B = pallas_dsm.LANE_TILE  # 128
N_PAD = 4  # lanes 0..3 look like pad / invalid lanes: s = k = 0, A = 0
rng = random.Random(777)


def _windows(scalars):
    rows = np.stack([np.frombuffer(x.to_bytes(32, "little"), np.uint8) for x in scalars])
    return np.ascontiguousarray(_bytes_to_windows_msb(rows).T.astype(np.int32))


def _inputs():
    s = [0] * N_PAD + [rng.randrange(ref.L) for _ in range(B - N_PAD)]
    k = [0] * N_PAD + [rng.randrange(ref.L) for _ in range(B - N_PAD)]
    limbs = [curve.point_to_limbs(ref.point_neg(ref.point_mul(rng.randrange(1, ref.L), ref.B_POINT)))
             for _ in range(B)]
    a = [np.stack([lb[c] for lb in limbs]) for c in range(4)]
    for c in range(4):
        a[c][:N_PAD] = 0  # the verifier's zero dummy row
    return _windows(s), _windows(k), tuple(np.ascontiguousarray(c) for c in a)


S_WIN, K_WIN, A_PT = _inputs()


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _tp(coords):
    return tuple(_t(c) for c in coords)


@pytest.fixture(scope="module")
def plain_scan():
    return dsm.plain_dual_scalar_mult(_t(S_WIN), _t(K_WIN), _tp(A_PT))


@pytest.fixture(scope="module")
def encodings(plain_scan):
    """The true compressed encodings of the scan's points, then the sign
    bit flipped on some lanes and the y encoding on others."""
    zinv = F.pow_inv(plain_scan[2])
    r_y = F.canonical(F.mul(plain_scan[1], zinv)).numpy().copy()
    r_sign = F.is_odd(F.mul(plain_scan[0], zinv)).numpy().astype(np.int32).copy()
    expect = np.ones(B, bool)
    r_sign[N_PAD : N_PAD + 8] ^= 1
    r_y[N_PAD + 8 : N_PAD + 16, 0] ^= 1
    r_y[N_PAD + 16, 19] += 1 << 8  # y + 2^255: not reduced, never matches
    expect[N_PAD : N_PAD + 17] = False
    return r_y, r_sign, expect


@pytest.fixture(scope="module")
def pallas_scan():
    out = pallas_dsm.dual_scalar_mult(
        jnp.asarray(S_WIN), jnp.asarray(K_WIN), tuple(map(jnp.asarray, A_PT)), interpret=True
    )
    return tuple(np.asarray(c) for c in out)


def test_constants_match_pallas():
    btab = dsm.BTAB_T2D.astype(np.float32).reshape(256, 4 * F.NLIMBS).T
    assert (btab == pallas_dsm._BTAB_T).all()
    assert (curve.D2_LIMBS.reshape(F.NLIMBS, 1) == pallas_dsm._D2_COL).all()
    assert (F.SUB_PAD.reshape(F.NLIMBS, 1) == pallas_dsm._SUBPAD_COL).all()
    assert (dsm.MULS_SCAN, dsm.MULS_VERIFY) == (2688, 2955)
    assert (dsm.SQRS_SCAN, dsm.SQRS_VERIFY) == (1024, 1278)
    assert (dsm.MADS_SCAN, dsm.MADS_VERIFY) == (880640, 939180)


def test_plain_scan_matches_pallas_interpret(plain_scan, pallas_scan):
    for c in range(3):  # T is not part of the kernel's output
        assert (F.canonical(plain_scan[c]).numpy() == F.canonical(_t(pallas_scan[c])).numpy()).all()
    assert (plain_scan[3].numpy() == 0).all()


def test_plain_verify_matches_pallas_interpret(encodings):
    r_y, r_sign, expect = encodings
    port = dsm.plain_verify_compressed(_t(S_WIN), _t(K_WIN), _tp(A_PT), _t(r_y), _t(r_sign))
    want = pallas_dsm.verify_compressed(
        jnp.asarray(S_WIN), jnp.asarray(K_WIN), tuple(map(jnp.asarray, A_PT)),
        jnp.asarray(r_y), jnp.asarray(r_sign), interpret=True,
    )
    assert port.numpy().tolist() == np.asarray(want).tolist() == expect.tolist()


def test_cpu_wrappers_run_the_plain_versions(plain_scan, encodings):
    r_y, r_sign, expect = encodings
    dsm.reset_launches()
    ok = dsm.verify_compressed(_t(S_WIN), _t(K_WIN), _tp(A_PT), _t(r_y), _t(r_sign))
    pt = dsm.dual_scalar_mult(_t(S_WIN), _t(K_WIN), _tp(A_PT))
    assert ok.numpy().tolist() == expect.tolist()
    assert all((a == b).all() for a, b in zip(pt, plain_scan))
    assert dsm.launches == {"verify_compressed": 0, "dual_scalar_mult": 0}


def test_wrappers_refuse_a_device_without_a_kernel():
    meta = lambda x: torch.empty(x.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dsm.dual_scalar_mult(meta(S_WIN), meta(K_WIN), tuple(meta(c) for c in A_PT))


def test_nothing_built_at_import():
    assert _build._LIB is None
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.library_path().name.startswith("libhs_dsm_")


# ---- the kernel body, built for the host ------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel body cannot run")
    out = tmp_path_factory.mktemp("host_lanes") / "libhost_lanes.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(_build.CSRC),
         "-o", str(out), str(_build.CSRC / "host_lanes.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.host_dsm_scan.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2
    lib.host_dsm_verify.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
    lib.host_fe_mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.host_fe_sqr.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return lib


def _ptrs(arrays):
    return [a.ctypes.data_as(ctypes.c_void_p) for a in arrays]


_CONSTS = [np.ascontiguousarray(dsm.BTAB_T2D), curve.D2_LIMBS, F.SUB_PAD]


def _host_scan(lib, s_win, k_win, a_pt, reverse=False):
    """The scan kernel's team schedule on the host, each step's roles run
    in order 0..3 or, with ``reverse``, 3..0."""
    n = s_win.shape[1]
    out = [np.zeros((n, F.NLIMBS), np.int32) for _ in range(4)]
    lib.host_dsm_scan(*_ptrs(_CONSTS + list(a_pt) + [s_win, k_win] + out), n, int(reverse))
    return out


def _host_verify(lib, s_win, k_win, a_pt, r_y, r_sign, reverse=False):
    n = s_win.shape[1]
    ok = np.zeros(n, np.int32)
    arrays = _CONSTS + list(a_pt) + [s_win, k_win, np.ascontiguousarray(r_y),
                                     np.ascontiguousarray(r_sign, dtype=np.int32), ok]
    lib.host_dsm_verify(*_ptrs(arrays), n, int(reverse))
    return ok != 0


@pytest.mark.parametrize("lanes", [slice(0, 8), slice(0, B)], ids=["B8", "B128"])
def test_kernel_body_matches_plain(host_lib, plain_scan, encodings, lanes):
    """Per lane, the kernel body's scan gives the plain version's points
    and its epilogue the plain version's verdicts."""
    s_win = np.ascontiguousarray(S_WIN[:, lanes])
    k_win = np.ascontiguousarray(K_WIN[:, lanes])
    a_pt = [np.ascontiguousarray(c[lanes]) for c in A_PT]
    out = _host_scan(host_lib, s_win, k_win, a_pt)
    for c in range(3):
        got = F.canonical(_t(out[c])).numpy()
        assert (got == F.canonical(plain_scan[c][lanes]).numpy()).all()
    assert (out[3] == 0).all()
    r_y, r_sign, expect = encodings
    ok = _host_verify(host_lib, s_win, k_win, a_pt, r_y[lanes], r_sign[lanes])
    assert ok.tolist() == expect[lanes].tolist()


def test_kernel_body_matches_pallas_limb_for_limb(host_lib, pallas_scan):
    """The kernel body does the Pallas kernel's arithmetic (same waves,
    baked T*2d, need_t schedule), so its raw limbs equal Pallas's."""
    out = _host_scan(host_lib, S_WIN, K_WIN, A_PT)
    for c in range(4):
        assert (out[c] == pallas_scan[c]).all()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_team_schedule_in_either_role_order(host_lib, pallas_scan, plain_scan, encodings, reverse):
    """Within a step no role may read a slot that another role writes:
    on the card the four threads of a team run a step in no fixed order.
    Run with each step's roles forward and in reverse, the team schedule
    gives Pallas's raw limbs and the plain versions' verdicts."""
    out = _host_scan(host_lib, S_WIN, K_WIN, A_PT, reverse)
    for c in range(4):
        assert (out[c] == pallas_scan[c]).all()
    for c in range(3):
        assert (F.canonical(_t(out[c])).numpy() == F.canonical(plain_scan[c]).numpy()).all()
    r_y, r_sign, expect = encodings
    ok = _host_verify(host_lib, S_WIN, K_WIN, A_PT, r_y, r_sign, reverse)
    assert ok.tolist() == expect.tolist()


LOOSE_BOUND = (1 << 13) + 608  # largest limb of a loose-normalized element


@pytest.mark.parametrize("limbs", ["random", "bound"])
def test_fe_sqr_matches_fe_mul(host_lib, limbs):
    """The 210-product square gives fe_mul(a, a)'s limbs exactly, on
    seeded random loose limbs and on limbs at the loose bound."""
    gen = np.random.default_rng(2026)
    n = 512
    a = gen.integers(0, LOOSE_BOUND + 1, (n, F.NLIMBS), dtype=np.int32)
    if limbs == "bound":
        a = np.where(gen.random((n, F.NLIMBS)) < 0.75, LOOSE_BOUND, a).astype(np.int32)
        a[0] = LOOSE_BOUND
    sq = np.zeros_like(a)
    prod = np.zeros_like(a)
    host_lib.host_fe_sqr(*_ptrs([sq, a]), n)
    host_lib.host_fe_mul(*_ptrs([prod, a, a]), n)
    assert (sq == prod).all()
    assert (sq == F.mul(_t(a), _t(a)).numpy()).all()


# ---- the CUDA kernels, on a card ---------------------------------------------


@pytest.mark.cuda
def test_cuda_kernels_match_plain(encodings, pallas_scan):
    """Both kernels on the team schedule: the verdicts, the scan's raw
    limbs equal to Pallas's on every one of several launches, and its
    points equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    r_y, r_sign, expect = encodings
    dev = torch.device("cuda")
    s, k = _t(S_WIN).to(dev), _t(K_WIN).to(dev)
    a = tuple(c.to(dev) for c in _tp(A_PT))
    ry, rs = _t(r_y).to(dev), _t(r_sign).to(dev)
    dsm.reset_launches()
    ok = dsm.verify_compressed(s, k, a, ry, rs)
    pts = [dsm.dual_scalar_mult(s, k, a) for _ in range(4)]
    torch.cuda.synchronize()
    assert dsm.launches == {"verify_compressed": 1, "dual_scalar_mult": 4}
    assert ok.cpu().numpy().tolist() == expect.tolist()
    for pt in pts:
        for c in range(4):
            assert (pt[c].cpu().numpy() == pallas_scan[c]).all()
    plain = dsm.plain_dual_scalar_mult(s, k, a)
    for c in range(3):
        assert (F.canonical(pts[0][c]) == F.canonical(plain[c])).all()
