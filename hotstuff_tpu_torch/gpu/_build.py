"""Build and load the CUDA kernels of the port.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``.  The library lands in
``build/torch_kernels/`` at the root of the checkout, named by a hash
of its sources and flags: a changed source builds anew, an unchanged
one is loaded as it is.  The first call in a process builds; nothing is
built at import.
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
KERNEL_SOURCES = ("dsm_kernels.cu",)
HEADERS = ("ed25519_field.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in KERNEL_SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libhs_dsm_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists.
    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``<name>.ptxas.txt``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp)]
    cmd += [str(CSRC / s) for s in KERNEL_SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
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


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB
