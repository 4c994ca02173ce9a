"""PyTorch/CUDA port of hotstuff_tpu, from the verifier up.

The port stands beside ``hotstuff_tpu`` (the JAX reference) and imports
nothing from it: what it needs is copied and trimmed.  Layers, top down:

- ``bench/storm.py``: the view-change-storm micro-benchmark;
- ``node/node.py``: the device-verifier host (``make_verifier``);
- ``consensus/``: the certificate layer — messages, wire, committee
  configuration, reconfiguration ops and the vote/timeout aggregators;
- ``crypto/async_service.py``: the wave service that coalesces claims
  from many cores into padded device waves; the rest of ``crypto/``,
  ``utils/`` and ``telemetry/`` are the host crypto and helpers;
- ``gpu/``: plain PyTorch versions of the field and curve layers, and
  hand-written CUDA kernels for the fused double-scalar-multiplication
  verifier, built with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise.
"""
