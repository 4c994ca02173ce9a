"""PyTorch/CUDA port of hotstuff_tpu, from the verifier up.

The port stands beside ``hotstuff_tpu`` (the JAX reference) and imports
nothing from it: what it needs is copied and trimmed.  Layers, top down:

- ``bench/storm.py``: the view-change-storm micro-benchmark;
  ``bench/committee.py``: ``run_committee``, a co-located committee;
- ``node/node.py``: the device-verifier host (``make_verifier``);
- ``consensus/``: the protocol engine — core, proposer, synchronizer,
  helper, leader election, timer and ``Consensus.spawn`` — over the
  certificate layer: messages, wire, committee configuration,
  reconfiguration ops and the vote/timeout aggregators;
- ``network/``, ``store/``, ``ingest/``: the asyncio and native
  (C++ reactor) transports, the write-ahead-log store and producer
  admission;
- ``crypto/async_service.py``: the wave service that coalesces claims
  from many cores into padded device waves, and the zero-copy ingest
  plane that verifies votes from the staging arenas the receivers
  packed (``crypto/native_ed25519.py``); the rest of ``crypto/`` and
  ``utils/`` are the host crypto and helpers;
- ``telemetry/``: the registry and ``/metrics`` endpoint, the per-round
  trace, the span recorder and the flight-recorder journal, off by
  default;
- ``gpu/``: plain PyTorch versions of the field and curve layers, and
  hand-written CUDA kernels for the fused double-scalar-multiplication
  verifier, built with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise.
"""
