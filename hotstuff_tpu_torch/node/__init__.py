"""Node layer of the port: the composition root (``Node``), its JSON
config files, the CLI (``python -m hotstuff_tpu_torch.node``), the
producer client (``python -m hotstuff_tpu_torch.node.client``) and the
device-verifier host (``make_verifier``)."""

from .config import (
    ConfigError,
    Secret,
    read_committee,
    read_parameters,
    write_committee,
    write_parameters,
)
from .node import LazyDeviceVerifier, Node, make_verifier

__all__ = [
    "ConfigError",
    "Secret",
    "read_committee",
    "read_parameters",
    "write_committee",
    "write_parameters",
    "LazyDeviceVerifier",
    "Node",
    "make_verifier",
]
