"""Node layer of the port: the device-verifier host (``make_verifier``).
The composition root and the CLI come with the port of the consensus
core."""

from .node import LazyDeviceVerifier, make_verifier

__all__ = ["LazyDeviceVerifier", "make_verifier"]
