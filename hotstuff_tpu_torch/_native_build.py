"""Build and load the port's copies of the native libraries.

Each library is compiled by the compiler ``CXX`` names (``g++`` when
unset) from sources of ``native/``, with the flags of
``native/Makefile``'s rule for it (``CXXFLAGS``, the rule's own flags,
``-shared``, then its link flags):

- ``transport``: ``transport.cpp`` (the epoll reactor, ``ht_*``) and
  ``wave_pack.cpp`` (the ingest arenas and the producer-v2 parser,
  ``wp_*``) in ONE library, as the Makefile's ``libhs_transport.so``;
- ``ed25519``: ``ed25519_batch.cpp``, the batch equation
  (``hs_ed25519_*``), with ``-O3``, as ``libhs_ed25519.so``;
- ``store``: ``store_engine.cpp``, the C++ WAL engine (``hs_*``), as
  ``libhs_store.so``, compiled through the port's
  ``store/csrc/store_batch.cpp``, which includes it unchanged and adds
  ``hs_put_many`` (many records, one write);
- ``bls``: ``bls_pairing.cpp`` (with its header ``bls_constants.h``), the
  BLS12-381 pairing verifier (``hs_bls_*``), with ``-O3``, as
  ``libhs_bls.so``.

A library lands in ``build/torch_native/`` at the root of the checkout,
named by a hash of its sources and flags (``libhs_ed25519_<hash>.so``),
so a changed source builds anew and an unchanged one is loaded as it is.

The port never loads ``native/build/*.so``: ``dlopen`` shares one
mapping per path, so a process holding both packages would share one set
of each library's globals (``hs_ed25519_precompute`` caches committee
keys in library globals), and the JAX loaders rebuild those files in
place.  A build goes to a temporary name and is renamed into place under
a file lock, so concurrent processes (test workers, co-located node
processes) never load a half-written file.  The first call in a process
builds; nothing is built at import.  A failed build or load raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = ROOT / "native"
PORT_DIR = ROOT / "hotstuff_tpu_torch"
BUILD_DIR = ROOT / "build" / "torch_native"
# native/Makefile's CXXFLAGS
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra")


class Library(NamedTuple):
    """One Makefile rule: its sources, its own compile flags, its link
    flags, the function that declares its ctypes signatures and the
    headers its sources include (hashed, not compiled), all of
    ``native/``; and the port's own sources (of ``hotstuff_tpu_torch/``,
    compiled with ``native/`` on the include path)."""

    sources: tuple[str, ...]
    flags: tuple[str, ...]
    link_flags: tuple[str, ...]
    bind: Callable[[ctypes.CDLL], ctypes.CDLL]
    headers: tuple[str, ...] = ()
    port_sources: tuple[str, ...] = ()


def _bind_transport(lib: ctypes.CDLL) -> ctypes.CDLL:
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


def _bind_ed25519(lib: ctypes.CDLL) -> ctypes.CDLL:
    cp, u32, ci = ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int
    lib.hs_ed25519_batch_verify.restype = ci
    lib.hs_ed25519_batch_verify.argtypes = [cp, u32, cp, cp, u32, ci]
    lib.hs_ed25519_precompute.restype = ci
    lib.hs_ed25519_precompute.argtypes = [cp, u32]
    lib.hs_ed25519_verify_one.restype = ci
    lib.hs_ed25519_verify_one.argtypes = [cp, u32, cp, cp]
    return lib


def _bind_store(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, cp, u32, ci = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    lib.hs_open.restype = vp
    lib.hs_open.argtypes = [cp, ci]
    lib.hs_put.restype = ci
    lib.hs_put.argtypes = [vp, cp, u32, cp, u32]
    lib.hs_get.restype = ci
    lib.hs_get.argtypes = [vp, cp, u32, u8pp, ctypes.POINTER(u32)]
    lib.hs_delete.restype = ci
    lib.hs_delete.argtypes = [vp, cp, u32]
    lib.hs_keys_blob.restype = ci
    lib.hs_keys_blob.argtypes = [vp, u8pp, ctypes.POINTER(ctypes.c_uint64)]
    lib.hs_count.restype = ctypes.c_uint64
    lib.hs_count.argtypes = [vp]
    lib.hs_wal_bytes.restype = ctypes.c_uint64
    lib.hs_wal_bytes.argtypes = [vp]
    lib.hs_compact.restype = ci
    lib.hs_compact.argtypes = [vp]
    lib.hs_free.restype = None
    lib.hs_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.hs_close.restype = None
    lib.hs_close.argtypes = [vp]
    lib.hs_put_many.restype = ci
    lib.hs_put_many.argtypes = [vp, cp, ctypes.c_uint64]
    return lib


def _bind_bls(lib: ctypes.CDLL) -> ctypes.CDLL:
    cp, sz, ci = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int
    lib.hs_bls_verify_one_ex.restype = ci
    lib.hs_bls_verify_one_ex.argtypes = [cp, sz, cp, cp, ci]
    lib.hs_bls_selftest.restype = ci
    lib.hs_bls_selftest.argtypes = []
    lib.hs_bls_aggregate_sigs.restype = ci
    lib.hs_bls_aggregate_sigs.argtypes = [cp, sz, cp]
    lib.hs_bls_verify_batch.restype = ci
    lib.hs_bls_verify_batch.argtypes = [cp, cp, cp, sz, cp, ci]
    for name in ("hs_bls_g1_decompress_many", "hs_bls_hash_base_many"):
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = [cp, sz, cp]
    lib.hs_bls_verify_batch_points.restype = ci
    lib.hs_bls_verify_batch_points.argtypes = [cp, cp, sz, cp, ci]
    return lib


LIBRARIES: dict[str, Library] = {
    "transport": Library(
        ("transport.cpp", "wave_pack.cpp"), (), ("-lpthread",), _bind_transport
    ),
    "ed25519": Library(("ed25519_batch.cpp",), ("-O3",), (), _bind_ed25519),
    # the port's translation unit includes native/store_engine.cpp whole
    "store": Library(
        (), (), (), _bind_store, ("store_engine.cpp",), ("store/csrc/store_batch.cpp",)
    ),
    "bls": Library(
        ("bls_pairing.cpp",), ("-O3",), (), _bind_bls, ("bls_constants.h",)
    ),
}

_LOCK = threading.Lock()
# name -> the loaded library of this process
_LIBS: dict[str, ctypes.CDLL] = {}


def _command_flags(lib: Library) -> tuple[str, ...]:
    return CXX_FLAGS + lib.flags + ("-shared",)


def source_hash(name: str) -> str:
    lib = LIBRARIES[name]
    h = hashlib.sha256()
    for source in lib.sources + lib.headers:
        h.update(source.encode())
        h.update((NATIVE_DIR / source).read_bytes())
    for source in lib.port_sources:
        h.update(source.encode())
        h.update((PORT_DIR / source).read_bytes())
    h.update(" ".join(_command_flags(lib) + lib.link_flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libhs_{name}_{source_hash(name)}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless one of the same sources exists."""
    lib = LIBRARIES[name]
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cxx = os.environ.get("CXX", "g++")
        cmd = [cxx, *_command_flags(lib), "-o", str(tmp)]
        if lib.port_sources:
            cmd += ["-I", str(NATIVE_DIR)]
        cmd += [str(NATIVE_DIR / s) for s in lib.sources]
        cmd += [str(PORT_DIR / s) for s in lib.port_sources]
        cmd += lib.link_flags
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"cannot build libhs_{name} ({' '.join(cmd)}): {e}"
            ) from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} failed ({proc.returncode}) building libhs_{name}:"
                f"\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Library ``name``, built on first use, with its ABI bound."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = LIBRARIES[name].bind(
                ctypes.CDLL(str(build(name)))
            )
        return lib
