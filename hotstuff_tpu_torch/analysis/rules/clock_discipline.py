"""clock-discipline: time and randomness must flow through the seam.

The deterministic simulator (hotstuff_tpu_torch/sim) replays a
whole committee in virtual time by swapping the ambient clock/rng seams
in ``hotstuff_tpu_torch.utils.clock``.  That only works if ``consensus/``,
``network/`` and ``faults/`` never reach around the seam: a direct
``time.time()`` leaks wall-clock into fault-window anchors, a direct
``asyncio.sleep()`` is pinned to whatever loop installed it instead of
the injected clock, and a module-level ``random.*`` draw consumes
global RNG state no seed controls — each one silently breaks the
"same seed ⇒ same run" contract that the explorer's repro bundles and
the shrinker depend on.

Flagged in the target trees:

- ``time.time()`` / ``time.monotonic()`` / ``time.monotonic_ns()``
  — use ``default_clock().time()`` (etc.) instead;
- ``asyncio.sleep()`` — use ``await default_clock().sleep()``;
- module-level ``random.<draw>()`` — use ``default_rng().<draw>()``;
  constructing a **seeded** generator (``random.Random(seed)``,
  ``random.SystemRandom()``) stays legal: a locally seeded stream is
  deterministic by construction and does not touch global state.

Boot/one-shot paths that genuinely want real time (process start
stamps, log rotation) carry ``# lint: allow(clock-discipline)`` with a
one-line justification.
"""

from __future__ import annotations

import ast

from ..framework import Finding, dotted_name

RULE = "clock-discipline"

#: direct wall/monotonic reads; the Clock protocol mirrors these names
_TIME_CALLS = {"time.time", "time.monotonic", "time.monotonic_ns"}

#: random.<attr> receivers that CONSTRUCT an independent generator (or
#: inspect the module) rather than draw from the shared global stream
_RNG_EXEMPT = {"Random", "SystemRandom", "getstate", "setstate", "seed"}


class ClockDiscipline:
    name = RULE
    targets = (
        "hotstuff_tpu_torch/consensus/**/*.py",
        "hotstuff_tpu_torch/network/**/*.py",
        "hotstuff_tpu_torch/faults/**/*.py",
    )

    def check(self, sf, root) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted is None:
                continue
            hit = self._classify(dotted)
            if hit is not None:
                code, fix = hit
                findings.append(
                    Finding(
                        RULE,
                        sf.rel,
                        node.lineno,
                        code,
                        f"{code}() bypasses the injected clock/rng seam "
                        f"— {fix}, or justify with # lint: allow({RULE})",
                    )
                )
        return findings

    @staticmethod
    def _classify(dotted: str):
        """(stable code, suggested fix) when ``dotted`` reaches around
        the seam, else None.  Receivers other than the bare ``time`` /
        ``asyncio`` / ``random`` modules (``self._clock.time``,
        ``rng.uniform``) are exactly the seam in use — never flagged."""
        if dotted in _TIME_CALLS:
            method = dotted.split(".", 1)[1]
            return dotted, f"use default_clock().{method}()"
        if dotted == "asyncio.sleep":
            return dotted, "use await default_clock().sleep()"
        if dotted.startswith("random."):
            attr = dotted.split(".", 1)[1]
            if "." not in attr and attr not in _RNG_EXEMPT:
                return dotted, f"use default_rng().{attr}()"
        return None
