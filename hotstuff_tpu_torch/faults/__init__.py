"""Seeded chaos plane: deterministic network fault injection.

A copy of ``hotstuff_tpu.faults``: the per-link fault views, the
scenario windows and the canned scenarios, and the adversary plane
with its adaptive policies.
"""

from .adaptive import (
    ADAPTIVE_POLICIES,
    ADAPTIVE_SHORT,
    ADAPTIVE_TRIGGERS,
    CountingRandom,
    StateView,
)
from .adversary import (
    POLICIES,
    AdversaryPlane,
    AdversaryRule,
    expand_adversary,
    run_adversary_clock,
    run_flood,
)
from .plane import (
    BARRIER_POLL_S,
    Decision,
    FaultPlane,
    FaultRule,
    LinkFaults,
    PASS,
    corrupt_frame,
    expand_rules,
    run_clock,
)
from .scenarios import SCENARIOS, build, last_heal

__all__ = [
    "ADAPTIVE_POLICIES",
    "ADAPTIVE_SHORT",
    "ADAPTIVE_TRIGGERS",
    "AdversaryPlane",
    "AdversaryRule",
    "BARRIER_POLL_S",
    "CountingRandom",
    "StateView",
    "Decision",
    "FaultPlane",
    "FaultRule",
    "LinkFaults",
    "PASS",
    "POLICIES",
    "SCENARIOS",
    "build",
    "corrupt_frame",
    "expand_adversary",
    "expand_rules",
    "last_heal",
    "run_adversary_clock",
    "run_clock",
    "run_flood",
]
