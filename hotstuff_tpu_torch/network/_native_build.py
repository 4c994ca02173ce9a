"""Build and load the port's copy of the native transport library.

``native/transport.cpp`` (the epoll reactor, ``ht_*``) and
``native/wave_pack.cpp`` (the ingest arenas and the producer-v2 parser,
``wp_*``) are compiled by ``g++`` with the flags of ``native/Makefile``
into ONE shared library, as the Makefile's ``libhs_transport.so`` rule
does.  The library lands in ``build/torch_native/`` at the root of the
checkout, named by a hash of its sources and flags, so a changed source
builds anew and an unchanged one is loaded as it is.

The port never loads ``native/build/libhs_transport.so``: ``dlopen``
shares one mapping per path, so a process holding both packages would
share one set of the library's globals, and the JAX loader rebuilds
that file in place.  A build goes to a temporary name and is renamed
into place under a file lock, so concurrent processes (test workers,
co-located node processes) never load a half-written file.  The first
call in a process builds; nothing is built at import.  A failed build
or load raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "torch_native"
SOURCES = ("transport.cpp", "wave_pack.cpp")
# native/Makefile: CXXFLAGS, then the shared-library rule's own flags
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LINK_FLAGS = ("-lpthread",)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libhs_transport_{source_hash()}.so"


def build() -> Path:
    """Compile the library unless one of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cxx = os.environ.get("CXX", "g++")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp)]
        cmd += [str(NATIVE_DIR / s) for s in SOURCES]
        cmd += LINK_FLAGS
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(
                f"cannot build the native transport ({' '.join(cmd)}): {e}"
            ) from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} failed ({proc.returncode}) building the native "
                f"transport:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built on first use, with both ABIs bound."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    cp = ctypes.c_char_p
    u64p = ctypes.POINTER(ctypes.c_uint64)
    # the reactor (transport.cpp)
    lib.ht_start.restype = vp
    lib.ht_start.argtypes = []
    lib.ht_notify_fd.restype = ci
    lib.ht_notify_fd.argtypes = [vp]
    lib.ht_set_read_paused.restype = ci
    lib.ht_set_read_paused.argtypes = [vp, cl, ci]
    lib.ht_listen.restype = cl
    lib.ht_listen.argtypes = [vp, cp, ci]
    lib.ht_connect.restype = cl
    lib.ht_connect.argtypes = [vp, cp, ci]
    lib.ht_send.restype = ci
    lib.ht_send.argtypes = [vp, cl, cp, ci]
    lib.ht_reply.restype = ci
    lib.ht_reply.argtypes = [vp, cl, cp, ci]
    lib.ht_next.restype = ci
    lib.ht_next.argtypes = [
        vp, ctypes.POINTER(cl), ctypes.POINTER(ci), cp, ci,
    ]
    lib.ht_conn_listener.restype = cl
    lib.ht_conn_listener.argtypes = [vp, cl]
    lib.ht_close_listener.restype = ci
    lib.ht_close_listener.argtypes = [vp, cl]
    lib.ht_close_conn.restype = ci
    lib.ht_close_conn.argtypes = [vp, cl]
    lib.ht_counters.restype = None
    lib.ht_counters.argtypes = [vp, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.ht_stop.restype = None
    lib.ht_stop.argtypes = [vp]
    # the ingest arenas and the producer-v2 parser (wave_pack.cpp)
    lib.wp_create.restype = vp
    lib.wp_create.argtypes = [ci, ci]
    lib.wp_destroy.restype = None
    lib.wp_destroy.argtypes = [vp]
    lib.wp_set_pad.restype = ci
    lib.wp_set_pad.argtypes = [vp, cp, cp, cp]
    lib.wp_probe_vote.restype = ci
    lib.wp_probe_vote.argtypes = [cp, cl]
    lib.wp_pack_vote.restype = cl
    lib.wp_pack_vote.argtypes = [vp, cp, cl, cp]
    lib.wp_count.restype = cl
    lib.wp_count.argtypes = [vp]
    lib.wp_seal.restype = cl
    lib.wp_seal.argtypes = [vp, cl]
    lib.wp_arena_info.restype = ci
    lib.wp_arena_info.argtypes = [vp, cl, u64p]
    lib.wp_recycle.restype = ci
    lib.wp_recycle.argtypes = [vp, cl]
    lib.wp_discard.restype = ci
    lib.wp_discard.argtypes = [vp]
    lib.wp_counters.restype = ci
    lib.wp_counters.argtypes = [vp, u64p, ci]
    lib.wp_parse_producer.restype = cl
    lib.wp_parse_producer.argtypes = [cp, cl, cp, u64p]
    return lib
