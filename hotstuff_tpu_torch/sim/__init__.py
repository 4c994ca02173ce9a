"""Deterministic virtual-time simulation plane.

A copy of ``hotstuff_tpu.sim``, the explorer included (``shrink``,
``explore``, ``explore_guided``, ``fitness``; ``sim/explorer.py``),
plus :func:`normalised_journal_digest`.  Runs an entire N-node
committee — core, proposer, synchronizer, aggregator, state machine,
state-sync, reconfig — inside ONE process on a virtual-time event loop
(no real sleeps, no real sockets), with the chaos and adversary planes
threaded through an in-memory transport.  Every run is a pure function
of its schedule seed, and the same seed gives the reference's verdict.
The simulator verifies on the CPU (``CpuVerifier``), as the reference's
does: it touches no device.

``python -m hotstuff_tpu_torch.sim 1`` replays seed 1's schedule at 4
nodes and prints its verdict as one JSON line; ``guided:18``,
``explore:12`` and ``shrink:FILE`` run the explorer
(``sim/__main__.py``).
"""

from .explorer import (
    ExploreResult,
    GuidedResult,
    explore,
    explore_guided,
    fitness,
    shrink,
)
from .harness import SimCluster
from .loop import SIM_EPOCH, SimDeadlock, SimLoop, VirtualClock
from .runner import SimVerdict, normalised_journal_digest, run_schedule
from .schedule import (
    draw_schedule,
    mutate_schedule,
    profile_of_events,
    schedule_to_spec,
)
from .transport import SimNet, SimReceiver

__all__ = [
    "SIM_EPOCH",
    "ExploreResult",
    "GuidedResult",
    "SimCluster",
    "SimDeadlock",
    "SimLoop",
    "SimNet",
    "SimReceiver",
    "SimVerdict",
    "VirtualClock",
    "draw_schedule",
    "explore",
    "explore_guided",
    "fitness",
    "mutate_schedule",
    "normalised_journal_digest",
    "profile_of_events",
    "run_schedule",
    "schedule_to_spec",
    "shrink",
]
