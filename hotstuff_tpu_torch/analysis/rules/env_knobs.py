"""env-knob-registry: every HOTSTUFF_* knob is documented or the gate
fails.

The check is a freshness diff: re-render the port's ``KNOBS.md`` from the
tree (``analysis/knobgen.py``) and compare against the committed file.
A new ``os.environ`` read — direct or through an ``_env_int``-style
helper — changes the rendered table, so an undocumented knob and a
stale table are the same single finding with the regeneration command
in the message.
"""

from __future__ import annotations

import os

from .. import knobgen
from ..framework import Finding

RULE = "env-knob-registry"


class EnvKnobRegistry:
    name = RULE
    # the rule diffs the whole tree itself; anchor the runner's file
    # iteration on a single always-present file so check() runs once
    targets = ("hotstuff_tpu_torch/__init__.py",)

    def check(self, sf, root) -> list[Finding]:
        if knobgen.is_fresh(root):
            return []
        exists = os.path.exists(
            os.path.join(root, *knobgen.KNOBS_REL.split("/"))
        )
        what = "stale" if exists else "missing"
        return [
            Finding(
                RULE,
                knobgen.KNOBS_REL,
                1,
                what,
                f"{knobgen.KNOBS_REL} is {what}: the HOTSTUFF_* knob "
                f"table no longer matches the tree — regenerate with "
                f"`python -m hotstuff_tpu_torch.analysis gen-knobs`",
            )
        ]
