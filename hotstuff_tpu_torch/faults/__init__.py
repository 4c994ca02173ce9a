"""Seeded chaos plane: deterministic network fault injection.

A copy of the plane and scenario parts of ``hotstuff_tpu.faults``: the
per-link fault views, the scenario windows and the canned scenarios.
The adversary plane is not ported, so none of its names is here.
"""

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
    "BARRIER_POLL_S",
    "Decision",
    "FaultPlane",
    "FaultRule",
    "LinkFaults",
    "PASS",
    "SCENARIOS",
    "build",
    "corrupt_frame",
    "expand_rules",
    "last_heal",
    "run_clock",
]
