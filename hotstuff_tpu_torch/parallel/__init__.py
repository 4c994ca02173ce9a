"""Parallel layer: the crypto batch kernels sharded over a device mesh.

The JAX package's parallelism axes map to the port as: committee/batch
parallelism -> the signature-verification batch split over a 1-D mesh
of CUDA devices, driven from one process; the QC-validity decision is
the invalid counts summed onto the mesh's first device.  There is no
model/sequence dimension in a BFT framework — the scaling axes are
committee size and batch size.
"""

from .mesh import (
    DP_AXIS,
    Mesh,
    ShardedBatchVerifier,
    default_mesh,
    make_sharded_qc_check,
    make_sharded_verify,
    mesh_devices_from_env,
    shard_operands,
)

__all__ = [
    "DP_AXIS",
    "Mesh",
    "ShardedBatchVerifier",
    "default_mesh",
    "make_sharded_qc_check",
    "make_sharded_verify",
    "mesh_devices_from_env",
    "shard_operands",
]
