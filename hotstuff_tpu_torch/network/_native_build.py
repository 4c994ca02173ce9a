"""The native libraries' build, at the path the transport first used.

A re-export of ``hotstuff_tpu_torch._native_build``, which builds every
native library of the port (``load("transport")`` is the reactor's and
the wave packer's).
"""

from .._native_build import (  # noqa: F401
    BUILD_DIR,
    LIBRARIES,
    NATIVE_DIR,
    build,
    library_path,
    load,
    source_hash,
)
