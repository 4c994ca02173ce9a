"""Node layer of the port: the device-verifier host (``make_verifier``).
The composition root and the CLI are not ported yet."""

from .node import LazyDeviceVerifier, make_verifier

__all__ = ["LazyDeviceVerifier", "make_verifier"]
