"""HOTSTUFF_* knob inventory and the port's KNOBS.md generator.

A copy of ``hotstuff_tpu.analysis.knobgen`` that scans this package
alone (``benchmark/`` imports the JAX package) and writes its own table,
``hotstuff_tpu_torch/analysis/KNOBS.md``; ``docs/KNOBS.md`` stays the
JAX package's.  This module AST-scans ``hotstuff_tpu_torch/``
for every string constant matching ``HOTSTUFF_[A-Z0-9_]+`` — direct
``os.environ`` / ``os.getenv`` reads AND literals routed through
helpers like ``_env_int("HOTSTUFF_MAX_PENDING", 512)`` — and renders
one sorted markdown table: knob, observed default(s), owning modules.

``python -m hotstuff_tpu_torch.analysis gen-knobs`` writes the file; the
``env-knob-registry`` rule re-renders in memory and fails the gate when
the committed file is stale, so a new knob cannot merge undocumented.
"""

from __future__ import annotations

import ast
import os
import re

from .framework import iter_sources

KNOB_RE = re.compile(r"^HOTSTUFF_[A-Z0-9_]+$")

SCAN_PATTERNS = ("hotstuff_tpu_torch/**/*.py",)

KNOBS_REL = "hotstuff_tpu_torch/analysis/KNOBS.md"

HEADER = """\
# HOTSTUFF_* environment knobs

<!-- GENERATED FILE — do not edit by hand.
     Regenerate: python -m hotstuff_tpu_torch.analysis gen-knobs
     Freshness is enforced by the env-knob-registry lint rule
     (python -m hotstuff_tpu_torch.analysis check). -->

Every `HOTSTUFF_*` environment variable the code reads, discovered by
AST scan over `hotstuff_tpu_torch/`.  *Default* is the
fallback expression observed at the read site (`—` when the knob is a
bare presence/truthiness check); *read by* lists every module that
consults the knob.

| Knob | Default | Read by |
|------|---------|---------|
"""


def _default_from_call(call: ast.Call, index: int) -> str | None:
    """The fallback expression when the knob literal is argument
    ``index`` of a call with a following positional argument — covers
    ``os.environ.get(K, d)``, ``os.getenv(K, d)`` and project helpers
    (``_env_int(K, d)``, ``_env_flag(K, d)``, ...)."""
    if len(call.args) > index + 1:
        return ast.unparse(call.args[index + 1])
    return None


def scan(root: str) -> dict:
    """knob -> {"defaults": [unique expr strings], "modules": [rel]}"""
    knobs: dict = {}
    for sf in iter_sources(root, SCAN_PATTERNS):
        if isinstance(sf, str):
            continue  # unparseable: the lint runner reports it
        if sf.rel.startswith("hotstuff_tpu_torch/analysis/"):
            continue  # the scanner's own patterns are not reads
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            for i, arg in enumerate(node.args):
                if (
                    isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and KNOB_RE.match(arg.value)
                ):
                    entry = knobs.setdefault(
                        arg.value, {"defaults": [], "modules": []}
                    )
                    if sf.rel not in entry["modules"]:
                        entry["modules"].append(sf.rel)
                    default = _default_from_call(node, i)
                    if default and default not in entry["defaults"]:
                        entry["defaults"].append(default)
        # subscript / membership reads: os.environ["K"], "K" in environ
        for node in ast.walk(sf.tree):
            key = None
            if isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Constant
            ):
                key = node.slice.value
            elif isinstance(node, ast.Compare) and isinstance(
                node.left, ast.Constant
            ):
                key = node.left.value
            if (
                isinstance(key, str)
                and KNOB_RE.match(key)
            ):
                entry = knobs.setdefault(
                    key, {"defaults": [], "modules": []}
                )
                if sf.rel not in entry["modules"]:
                    entry["modules"].append(sf.rel)
    return knobs


def render(root: str) -> str:
    knobs = scan(root)
    lines = [HEADER]
    for knob in sorted(knobs):
        entry = knobs[knob]
        defaults = " / ".join(f"`{d}`" for d in entry["defaults"]) or "—"
        modules = ", ".join(f"`{m}`" for m in sorted(entry["modules"]))
        lines.append(f"| `{knob}` | {defaults} | {modules} |\n")
    lines.append(f"\n{len(knobs)} knobs registered.\n")
    return "".join(lines)


def write(root: str) -> str:
    path = os.path.join(root, *KNOBS_REL.split("/"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(render(root))
    return path


def is_fresh(root: str) -> bool:
    path = os.path.join(root, *KNOBS_REL.split("/"))
    if not os.path.exists(path):
        return False
    with open(path, encoding="utf-8") as f:
        return f.read() == render(root)
