"""Build and load the CUDA kernels of the port.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface (no PyTorch headers, so a
build takes seconds) and loaded with ``ctypes``:

- ``dsm``: ``dsm_kernels.cu`` (``ed25519_field.cuh``), the Ed25519
  verify and scan kernels, as ``libhs_dsm_<hash>.so``;
- ``g1``: ``g1_kernels.cu`` (``g1_field.cuh``), the BLS12-381 G1
  kernels, as ``libhs_g1_<hash>.so``.

The libraries land in ``build/torch_kernels/`` at the root of the
checkout, named by a hash of their sources and flags: a changed source
builds anew, an unchanged one is loaded as it is.  The first load in a
process builds every library that is missing, one ``nvcc`` a source, all
started together; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# library name -> (its kernel source, the headers it includes)
LIBRARIES = {
    "dsm": ("dsm_kernels.cu", ("ed25519_field.cuh",)),
    "g1": ("g1_kernels.cu", ("g1_field.cuh",)),
}
KERNEL_SOURCES = tuple(src for src, _ in LIBRARIES.values())
HEADERS = tuple(h for _, hs in LIBRARIES.values() for h in hs)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}  # name -> the library, once loaded


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash(name: str = "dsm") -> str:
    source, headers = LIBRARIES[name]
    h = hashlib.sha256()
    for f in (source, *headers):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str = "dsm") -> Path:
    return BUILD_DIR / f"libhs_{name}_{source_hash(name)}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every library of ``names`` (all by default) that is
    missing, one ``nvcc`` process a source, all started together.  Each
    compiler's resource report (``-Xptxas -v``) is kept beside its
    library as ``<name>.ptxas.txt``.  Raises with the compiler's output
    if any build fails."""
    names = tuple(LIBRARIES) if names is None else tuple(names)
    outs = {name: library_path(name) for name in names}
    missing = [n for n in names if not outs[n].exists()]
    if not missing:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in missing:
        tmp = outs[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / LIBRARIES[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, tmp, proc))
    failures = []
    for name, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) building {name}:"
                            f"\n{stdout}\n{stderr}")
            continue
        outs[name].with_suffix(".ptxas.txt").write_text(stdout + stderr)
        os.replace(tmp, outs[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def build(name: str = "dsm") -> Path:
    """Library ``name``, compiled (with every other missing one) unless a
    library of the same sources exists."""
    return build_all()[name]


def _bind_dsm(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # btab, d2, subpad, ax, ay, az, at, s_win, k_win, then the outputs
    lib.dsm_verify_launch.argtypes = [vp] * 12 + [ci, ci, vp]
    lib.dsm_verify_launch.restype = ci
    lib.dsm_scan_launch.argtypes = [vp] * 13 + [ci, ci, vp]
    lib.dsm_scan_launch.restype = ci
    lib.dsm_smem_bytes.argtypes = []
    lib.dsm_smem_bytes.restype = ci
    lib.dsm_error_string.argtypes = [ci]
    lib.dsm_error_string.restype = ctypes.c_char_p
    return lib


class G1Affine(ctypes.Structure):
    """``g1::Affine`` of ``g1_field.cuh``: plain canonical x and y, 12
    little-endian 32-bit words each, passed to a launch by value."""

    _fields_ = [("x", ctypes.c_uint32 * 12), ("y", ctypes.c_uint32 * 12)]


def _bind_g1(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # xs, ys, zs, batch, plain, scratch, ox, oy, oz, device, stream
    lib.g1_aggregate_launch.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, vp, ci, vp]
    lib.g1_aggregate_launch.restype = ci
    lib.g1_running_add_launch.argtypes = [vp, G1Affine, ci, vp]
    lib.g1_running_add_launch.restype = ci
    # bits, nbits, batch, xs, ys, zs, ox, oy, oz, device, stream
    lib.g1_scalar_mult_launch.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, ci, vp]
    lib.g1_scalar_mult_launch.restype = ci
    lib.g1_error_string.argtypes = [ci]
    lib.g1_error_string.restype = ctypes.c_char_p
    return lib


_BIND = {"dsm": _bind_dsm, "g1": _bind_g1}


def load(name: str = "dsm") -> ctypes.CDLL:
    """Kernel library ``name``, built on first use (every missing library
    is built then, in parallel)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = _BIND[name](ctypes.CDLL(str(build(name))))
        return lib
