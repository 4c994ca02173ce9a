"""wire-decoder-bounds: no length/count drives a decode without a bound.

The wire layer reads attacker-controlled frames.  Every ``dec.u8()`` /
``dec.u32()`` / ``dec.u64()`` that later sizes a slice (``dec.raw(n *
SIZE)``) or a decode loop (``for _ in range(n)``) must pass an ordering
comparison (``<``, ``<=``, ``>``, ``>=`` — equality checks don't bound)
between the read and the use; and every ``dec.var_bytes()`` must pass an
explicit cap.  ``utils/codec.py`` already refuses truncated input, so
the residual bug class is the *allocation bomb*: a 4-byte count of
2**32 driving a list comprehension of signature decodes.  The fuzz
corpus (tests/test_wire_fuzz.py) catches these dynamically after the
fact; this rule makes a new unbounded tag a lint error at review time.
"""

from __future__ import annotations

import ast

from ..framework import Finding, terminal_name

RULE = "wire-decoder-bounds"

_INT_READS = {"u8", "u16", "u32", "u64"}
_ORDERING = (ast.Lt, ast.LtE, ast.Gt, ast.GtE)


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class WireDecoderBounds:
    name = RULE
    targets = (
        "hotstuff_tpu_torch/consensus/wire.py",
        "hotstuff_tpu_torch/consensus/messages.py",
    )

    def check(self, sf, root) -> list[Finding]:
        findings: list[Finding] = []
        for func in ast.walk(sf.tree):
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_function(sf, func))
        return findings

    def _check_function(self, sf, func) -> list[Finding]:
        # length vars: name -> sorted list of assignment lines
        assigns: dict[str, list[int]] = {}
        # ordering comparisons touching each name: name -> compare lines
        compares: dict[str, list[int]] = {}
        # uses: (name, line, kind)
        uses: list[tuple[str, int, str]] = []
        findings: list[Finding] = []

        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                value = node.value
                if (
                    isinstance(target, ast.Name)
                    and isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Attribute)
                    and value.func.attr in _INT_READS
                ):
                    assigns.setdefault(target.id, []).append(node.lineno)
            elif isinstance(node, ast.Compare):
                if any(isinstance(op, _ORDERING) for op in node.ops):
                    for name in _names_in(node):
                        compares.setdefault(name, []).append(node.lineno)
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Name) and fn.id == "range":
                    for arg in node.args:
                        for name in _names_in(arg):
                            uses.append((name, node.lineno, "range"))
                elif isinstance(fn, ast.Attribute) and fn.attr == "raw":
                    for arg in node.args:
                        for name in _names_in(arg):
                            uses.append((name, node.lineno, "raw"))
                elif isinstance(fn, ast.Attribute) and fn.attr == "var_bytes":
                    if not node.args and not node.keywords:
                        recv = terminal_name(fn.value) or "dec"
                        findings.append(
                            Finding(
                                RULE,
                                sf.rel,
                                node.lineno,
                                f"{func.name}:var_bytes",
                                f"{recv}.var_bytes() without an explicit "
                                f"cap in {func.name}() — pass the tag's "
                                f"maximum payload size",
                            )
                        )

        flagged = set()
        for name, line, kind in uses:
            assign_lines = assigns.get(name)
            if not assign_lines:
                continue  # not a decoder-read length var
            # nearest decoder read lexically preceding this use
            prior = [a for a in assign_lines if a <= line]
            if not prior:
                continue
            assign_line = max(prior)
            bounded = any(
                assign_line <= c <= line for c in compares.get(name, ())
            )
            key = (name, assign_line)
            if not bounded and key not in flagged:
                flagged.add(key)
                what = (
                    "a decode loop" if kind == "range" else "a payload slice"
                )
                findings.append(
                    Finding(
                        RULE,
                        sf.rel,
                        line,
                        f"{func.name}:{name}",
                        f"wire-read count '{name}' (line {assign_line}) "
                        f"drives {what} in {func.name}() without an "
                        f"ordering bound check between read and use",
                    )
                )
        return findings
