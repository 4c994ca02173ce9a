"""Ingest plane: per-node admission control for the producer path.

The admission controller (admission.py) sits between the network
receiver's producer channel and the proposer: it derives a credit
window from proposer buffer occupancy and recent commit throughput,
piggybacks it on producer ACK frames (consensus/wire.py ingest ACK),
and sheds overload with a typed BUSY + retry-after instead of letting
the proposer silently drop the newest payload.  A copy of
``hotstuff_tpu.ingest``.
"""

from .admission import AdmissionController, Decision

__all__ = ["AdmissionController", "Decision"]
