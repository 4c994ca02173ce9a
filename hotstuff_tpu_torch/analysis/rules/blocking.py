"""no-blocking-in-async: the event loop must never block.

The consensus actors (pacemaker, proposer, synchronizer, receivers) are
one asyncio loop per node; a single synchronous ``time.sleep``,
``Future.result()``, ``block_until_ready`` or direct store/socket call
inside an ``async def`` stalls every timer and every in-flight round on
that node.  That is not a perf bug: the Byzantine plane's trusted-subset
verdicts assume honest nodes are *timely*, so a blocked loop
is indistinguishable from a withholding attacker.

Scope is **lexical**: code inside nested ``def``/``lambda`` bodies is
excluded (it runs on whatever schedule the nested callable gets, which
the guarded-by rule handles when it's a dispatch-loop thread).

Legitimate sites — ``t.result()`` on a task that ``asyncio.wait`` just
returned as done — carry ``# lint: allow(no-blocking-in-async)`` with a
one-line justification.
"""

from __future__ import annotations

import ast

from ..framework import Finding, dotted_name, terminal_name, walk_no_nested_functions

RULE = "no-blocking-in-async"

#: method names that block when invoked on a store engine (receiver
#: name containing "engine"): the sync Engine protocol of store/
_ENGINE_BLOCKING = {"put", "get", "delete", "keys", "compact"}

#: blocking socket methods (receiver name containing "sock")
_SOCKET_BLOCKING = {"recv", "recv_into", "accept", "connect", "listen", "sendall"}

#: module-level blocking calls, by dotted name
_BLOCKING_DOTTED = {
    "time.sleep",
    "os.system",
    "subprocess.run",
    "subprocess.check_output",
    "subprocess.check_call",
    "subprocess.call",
}


class NoBlockingInAsync:
    name = RULE
    targets = (
        "hotstuff_tpu_torch/consensus/**/*.py",
        "hotstuff_tpu_torch/network/**/*.py",
        "hotstuff_tpu_torch/node/**/*.py",
    )

    def check(self, sf, root) -> list[Finding]:
        findings: list[Finding] = []
        for func in ast.walk(sf.tree):
            if not isinstance(func, ast.AsyncFunctionDef):
                continue
            for node in walk_no_nested_functions(func):
                if isinstance(node, ast.Call):
                    hit = self._classify(node)
                    if hit is not None:
                        code, what = hit
                        findings.append(
                            Finding(
                                RULE,
                                sf.rel,
                                node.lineno,
                                code,
                                f"{what} blocks the event loop inside "
                                f"async def {func.name}() — await it, move "
                                f"it to an executor, or justify with "
                                f"# lint: allow({RULE})",
                            )
                        )
        return findings

    def _classify(self, call: ast.Call):
        """(stable code, human label) when ``call`` blocks, else None."""
        func = call.func
        dotted = dotted_name(func)
        if dotted in _BLOCKING_DOTTED:
            return dotted, f"{dotted}()"
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        recv = dotted_name(func.value) or terminal_name(func.value) or "<expr>"
        if attr == "result" and not call.args and not call.keywords:
            return f"{recv}.result", f"{recv}.result()"
        if attr == "block_until_ready":
            return f"{recv}.block_until_ready", f"{recv}.block_until_ready()"
        low = recv.lower()
        if attr in _ENGINE_BLOCKING and "engine" in low:
            return f"{recv}.{attr}", f"synchronous store call {recv}.{attr}()"
        if attr in _SOCKET_BLOCKING and "sock" in low:
            return f"{recv}.{attr}", f"blocking socket call {recv}.{attr}()"
        return None
