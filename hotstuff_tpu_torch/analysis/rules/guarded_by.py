"""guarded-by: cross-thread fields carry their synchronization story.

The node runs dispatch-loop *threads* under its asyncio loop: the
verify service's slot threads and completion callbacks run concurrently
with the event loop and share instance fields with it.  CPython's GIL
makes single-bytecode operations atomic, which is why most of these
fields legitimately carry no lock — but that discipline was tribal
knowledge.  This rule makes it explicit:

1. **Thread discovery.**  Inside each class, every callable handed to
   ``threading.Thread(target=...)``, ``<executor>.submit(...)``, or
   ``loop.run_in_executor(...)`` is a thread entry point — ``self.M``
   references, inline lambdas, and nested ``def`` callbacks alike —
   and the closure over ``self.M()`` calls from thread-side code is
   taken transitively.
2. **Shared fields.**  A ``self.<field>`` accessed from both thread-side
   and loop-side code, with at least one write outside ``__init__``,
   is shared state.
3. **Annotation.**  Some access line of a shared field must carry
   ``# guarded-by: <token>``.  When the token names a ``threading.Lock``
   / ``RLock`` attribute of the class, every non-``__init__`` write to
   the field must sit inside ``with self.<token>:`` — a lockset check,
   not just documentation.  Tokens like ``gil`` document a deliberate
   lock-free discipline and are accepted as-is.
4. **Lock-discipline drift** (lock-owning classes without visible
   thread creation, e.g. ``gpu/ed25519.py`` whose callers thread from
   outside): a field ever written under ``with self.<lock>`` must not
   also be written outside it without an annotation.
"""

from __future__ import annotations

import ast

from ..framework import Finding, dotted_name

RULE = "guarded-by"

_LOCK_CTORS = {"Lock", "RLock"}
_MUTATORS = {
    "append", "add", "pop", "clear", "update", "remove", "discard",
    "setdefault", "extend", "insert", "popleft", "appendleft",
    "put_nowait",
}


def _self_field(node) -> str | None:
    """``field`` for a ``self.field`` attribute node."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _Access:
    __slots__ = ("line", "write", "locks")

    def __init__(self, line, write, locks):
        self.line = line
        self.write = write
        self.locks = locks  # frozenset of held self.<lock> names


class GuardedBy:
    name = RULE
    targets = (
        "hotstuff_tpu_torch/crypto/async_service.py",
        "hotstuff_tpu_torch/telemetry/**/*.py",
        "hotstuff_tpu_torch/gpu/**/*.py",
    )

    def check(self, sf, root) -> list[Finding]:
        findings: list[Finding] = []
        for cls in ast.walk(sf.tree):
            if isinstance(cls, ast.ClassDef):
                findings.extend(self._check_class(sf, cls))
        return findings

    # ---- per-class analysis -------------------------------------------

    def _check_class(self, sf, cls) -> list[Finding]:
        methods = {
            m.name: m
            for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        locks = self._lock_attrs(methods.get("__init__"))
        entries, inline_thread_nodes = self._thread_entries(cls, methods)
        thread_methods = self._closure(entries, methods)

        # field -> side ("thread"/"loop"/"init") -> [_Access]
        accesses: dict = {}

        def collect(body_node, side):
            self._collect_accesses(body_node, side, accesses)

        for name, m in methods.items():
            if name == "__init__":
                collect(m, "init")
            elif name in thread_methods:
                collect(m, "thread")
            else:
                collect(m, "loop")
        for node in inline_thread_nodes:
            collect(node, "thread")

        findings: list[Finding] = []
        flagged = set()
        for field, sides in sorted(accesses.items()):
            thread = sides.get("thread", ())
            loop = sides.get("loop", ())
            init = sides.get("init", ())
            writes = [a for a in (*thread, *loop) if a.write]
            shared = bool(thread) and bool(loop) and bool(writes)
            all_lines = sorted(
                {a.line for a in (*thread, *loop, *init)}
            )
            token = None
            for line in all_lines:
                token = sf.guarded_by(line)
                if token:
                    break
            if shared and token is None:
                key = f"{cls.name}.{field}"
                if key not in flagged:
                    flagged.add(key)
                    line = min(a.line for a in writes)
                    findings.append(
                        Finding(
                            RULE,
                            sf.rel,
                            line,
                            key,
                            f"{cls.name}.{field} is written from a "
                            f"dispatch-loop thread and touched from "
                            f"the event loop with no "
                            f"# guarded-by: <lock> annotation on any "
                            f"access line",
                        )
                    )
                continue
            if token in locks:
                # annotated with a real lock: every non-init write must
                # hold it
                for a in writes:
                    if token not in a.locks:
                        key = f"{cls.name}.{field}:unlocked"
                        if key in flagged:
                            continue
                        flagged.add(key)
                        findings.append(
                            Finding(
                                RULE,
                                sf.rel,
                                a.line,
                                key,
                                f"{cls.name}.{field} is guarded-by "
                                f"{token} but written at line {a.line} "
                                f"without holding with self.{token}",
                            )
                        )
            elif token is None and locks:
                # drift check: written under a lock somewhere, written
                # outside it elsewhere, no annotation explaining why
                under = {
                    lk
                    for a in writes
                    for lk in a.locks
                    if lk in locks
                }
                if under:
                    for a in writes:
                        if not (under & a.locks):
                            key = f"{cls.name}.{field}:drift"
                            if key in flagged:
                                continue
                            flagged.add(key)
                            lock_name = sorted(under)[0]
                            findings.append(
                                Finding(
                                    RULE,
                                    sf.rel,
                                    a.line,
                                    key,
                                    f"{cls.name}.{field} is written "
                                    f"under with self.{lock_name} "
                                    f"elsewhere but written unlocked at "
                                    f"line {a.line} — annotate the "
                                    f"discipline with # guarded-by: or "
                                    f"take the lock",
                                )
                            )
        return findings

    # ---- discovery helpers --------------------------------------------

    def _lock_attrs(self, init) -> set:
        """self attrs assigned threading.Lock()/RLock() in __init__."""
        locks = set()
        if init is None:
            return locks
        for node in ast.walk(init):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                ctor = dotted_name(node.value.func) or ""
                if ctor.split(".")[-1] in _LOCK_CTORS:
                    for t in node.targets:
                        field = _self_field(t)
                        if field:
                            locks.add(field)
        return locks

    def _thread_entries(self, cls, methods):
        """(method names that are thread entry points, inline thread
        callables: Lambda / nested FunctionDef nodes)."""
        entries: set = set()
        inline: list = []
        for m in methods.values():
            nested = {
                n.name: n
                for n in ast.walk(m)
                if isinstance(n, ast.FunctionDef) and n is not m
            }
            for node in ast.walk(m):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                attr = fn.attr if isinstance(fn, ast.Attribute) else None
                cands = []
                if attr == "Thread" or (
                    isinstance(fn, ast.Name) and fn.id == "Thread"
                ):
                    cands = [
                        kw.value for kw in node.keywords
                        if kw.arg == "target"
                    ]
                elif attr == "submit":
                    cands = list(node.args)
                elif attr == "run_in_executor":
                    cands = list(node.args[1:])
                for cand in cands:
                    field = _self_field(cand)
                    if field and field in methods:
                        entries.add(field)
                    elif isinstance(cand, ast.Lambda):
                        inline.append(cand)
                        entries |= self._self_calls(cand, methods)
                    elif (
                        isinstance(cand, ast.Name) and cand.id in nested
                    ):
                        inline.append(nested[cand.id])
                        entries |= self._self_calls(
                            nested[cand.id], methods
                        )
        return entries, inline

    def _self_calls(self, node, methods) -> set:
        """Method names invoked as ``self.M(...)`` inside ``node``."""
        out = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                field = _self_field(n.func)
                if field and field in methods:
                    out.add(field)
        return out

    def _closure(self, entries, methods) -> set:
        """Transitive closure of thread-side methods over self-calls."""
        seen = set()
        frontier = list(entries)
        while frontier:
            name = frontier.pop()
            if name in seen or name not in methods:
                continue
            seen.add(name)
            frontier.extend(self._self_calls(methods[name], methods))
        return seen

    # ---- access collection --------------------------------------------

    def _collect_accesses(self, body, side, accesses) -> None:
        """Record every ``self.<field>`` read/write under ``body`` with
        the set of ``with self.<lock>`` contexts lexically held."""

        def visit(node, held):
            if isinstance(node, ast.With):
                extra = set()
                for item in node.items:
                    field = _self_field(item.context_expr)
                    if field:
                        extra.add(field)
                inner = held | frozenset(extra)
                for item in node.items:
                    visit(item.context_expr, held)
                for child in node.body:
                    visit(child, inner)
                return
            field = _self_field(node)
            if field is not None:
                write = isinstance(node.ctx, (ast.Store, ast.Del))
                accesses.setdefault(field, {}).setdefault(
                    side, []
                ).append(_Access(node.lineno, write, held))
            if isinstance(node, ast.Subscript):
                # self.f[k] = v: the Subscript has Store ctx but the
                # inner attribute reads — record the write on the field
                field = _self_field(node.value)
                if field is not None and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    accesses.setdefault(field, {}).setdefault(
                        side, []
                    ).append(_Access(node.lineno, True, held))
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                # self.f.pop(...) and friends mutate the container
                field = _self_field(node.func.value)
                if field is not None and node.func.attr in _MUTATORS:
                    accesses.setdefault(field, {}).setdefault(
                        side, []
                    ).append(_Access(node.lineno, True, held))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(body, frozenset())
