"""Device modules of the port (PyTorch + hand-written CUDA kernels).

- ``field`` / ``curve``: GF(2^255-19) and Edwards25519 in plain PyTorch,
  limb-identical to ``hotstuff_tpu/tpu/field.py`` / ``curve.py``;
- ``dsm``: the fused verify kernel and the scan kernel (CUDA C++ under
  ``csrc/``), their wrappers, launch counts and plain versions;
- ``ed25519``: ``BatchVerifier``, the host driver and verifier backend;
- ``bls``: the BLS12-381 G1 kernels (tree sum, running sum, ladder),
  their wrappers, launch counts and plain versions, and the host
  classes of the BLS device path;
- ``_build``: compiles ``csrc/`` with nvcc on first use into
  ``build/torch_kernels/``, one library a kernel source (there is no
  compile cache to prime: a library is keyed by a hash of its sources).
"""
