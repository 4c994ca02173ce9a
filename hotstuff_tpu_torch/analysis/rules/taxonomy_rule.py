"""taxonomy-registry: edge and stage names come from one table.

``telemetry/traces.py`` routes journal records by edge name and span
records by stage name.  Before this rule the contract was implicit: a
misspelled ``journal.record("recv.propse", ...)`` produced a valid
JSONL stream and a silently-empty Perfetto track.  Now every literal
edge passed to a journal ``record()`` call and every literal stage
passed to ``span()`` / a recorder ``add()`` must be registered in
``hotstuff_tpu_torch/telemetry/taxonomy.py`` — the same module traces.py
renders from — and dynamic (f-string) edges must start with a
registered prefix (``fault.``, ``byz.``).

The registry is loaded from **source text** of the tree under analysis
(never imported), so the rule works in a bare CI venv and on fixture
trees.
"""

from __future__ import annotations

import ast
import os

from ..framework import Finding, terminal_name

RULE = "taxonomy-registry"

TAXONOMY_REL = "hotstuff_tpu_torch/telemetry/taxonomy.py"

#: receiver names that identify a journal handle at a record() call
_JOURNAL_RECEIVERS = {"journal", "_journal", "j"}

#: receiver names that identify a span recorder at an add() call
_RECORDER_RECEIVERS = {"rec", "recorder"}


_REGISTRY_CACHE: dict = {}


def load_registry(root: str):
    """(edges frozenset, prefixes tuple, stages frozenset) parsed from
    the tree's taxonomy module — literal-evaluated, not imported."""
    cached = _REGISTRY_CACHE.get(root)
    if cached is not None:
        return cached
    path = os.path.join(root, *TAXONOMY_REL.split("/"))
    if not os.path.exists(path):
        # fixture trees carry no registry: fall back to the one shipped
        # next to this rule (the real repo's)
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            ))),
            "telemetry",
            "taxonomy.py",
        )
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    consts: dict = {}
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                targets = [node.target.id]
            value = node.value
        else:
            continue
        for name in targets:
            try:
                consts[name] = _eval(value, consts)
            except ValueError:
                pass
    edges = frozenset(consts.get("JOURNAL_EDGES", ()))
    prefixes = tuple(consts.get("JOURNAL_EDGE_PREFIXES", ()))
    stages = frozenset(consts.get("SPAN_STAGES", ()))
    if not edges or not stages:
        raise RuntimeError(f"taxonomy registry unreadable: {path}")
    _REGISTRY_CACHE[root] = (edges, prefixes, stages)
    return edges, prefixes, stages


def _eval(node, consts):
    """Literal-eval extended with name lookup, tuple concat, and the
    frozenset(...) call the taxonomy module uses."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in consts:
            return consts[node.id]
        raise ValueError(node.id)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_eval(e, consts) for e in node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return tuple(_eval(node.left, consts)) + tuple(
            _eval(node.right, consts)
        )
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "frozenset"
        and len(node.args) == 1
    ):
        return frozenset(_eval(node.args[0], consts))
    raise ValueError(ast.dump(node))


class TaxonomyRegistry:
    name = RULE
    targets = ("hotstuff_tpu_torch/**/*.py",)

    def check(self, sf, root) -> list[Finding]:
        if sf.rel == TAXONOMY_REL:
            return []
        edges, prefixes, stages = load_registry(root)
        findings: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute) or not node.args:
                continue
            first = node.args[0]
            if fn.attr == "record" and (
                terminal_name(fn.value) in _JOURNAL_RECEIVERS
            ):
                findings.extend(
                    self._check_edge(sf, node, first, edges, prefixes)
                )
            elif fn.attr == "span" or (
                fn.attr == "add"
                and terminal_name(fn.value) in _RECORDER_RECEIVERS
                and len(node.args) == 3
            ):
                if isinstance(first, ast.Constant) and isinstance(
                    first.value, str
                ):
                    stage = first.value
                    if stage not in stages:
                        findings.append(
                            Finding(
                                RULE,
                                sf.rel,
                                node.lineno,
                                f"stage:{stage}",
                                f"span stage '{stage}' is not registered "
                                f"in {TAXONOMY_REL} (SPAN_STAGES) — "
                                f"traces.py and profile.py will drop it",
                            )
                        )
        return findings

    def _check_edge(self, sf, call, first, edges, prefixes):
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            edge = first.value
            if edge not in edges and not edge.startswith(tuple(prefixes)):
                yield Finding(
                    RULE,
                    sf.rel,
                    call.lineno,
                    f"edge:{edge}",
                    f"journal edge '{edge}' is not registered in "
                    f"{TAXONOMY_REL} (JOURNAL_EDGES) — traces.py will "
                    f"drop it as an unknown edge",
                )
        elif isinstance(first, ast.JoinedStr):
            values = first.values
            lead = (
                values[0].value
                if values
                and isinstance(values[0], ast.Constant)
                and isinstance(values[0].value, str)
                else ""
            )
            if not any(lead.startswith(p) for p in prefixes):
                yield Finding(
                    RULE,
                    sf.rel,
                    call.lineno,
                    "edge:<dynamic>",
                    f"dynamic journal edge f-string must start with a "
                    f"registered prefix {tuple(prefixes)} from "
                    f"{TAXONOMY_REL}",
                )
