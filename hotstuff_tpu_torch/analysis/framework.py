"""Rule framework: source loading, inline allows, allowlist, runner.

Design choices that keep the plane dependable:

- **Stable finding keys.**  A finding's identity is ``rule:path:code``
  with NO line number — allowlist entries survive unrelated edits to
  the file.  ``code`` is a rule-chosen short token (e.g. the blocked
  call, ``Class.field``, ``function:var``).
- **Comments via tokenize.**  ``ast`` drops comments, but both escape
  hatches (``# lint: allow(rule)``) and the ``# guarded-by: <lock>``
  annotations live in comments, so every :class:`SourceFile` carries a
  ``{line: comment}`` map extracted with :mod:`tokenize`.
- **No package imports at lint time.**  The framework never imports
  the code under analysis — everything is read from source text, so
  the gate runs in a bare venv (CI lint job) where jax is absent.
"""

from __future__ import annotations

import ast
import glob
import io
import os
import re
import tokenize
from dataclasses import dataclass

#: ``# lint: allow(rule-a, rule-b)  -- optional justification``
_ALLOW_RE = re.compile(r"lint:\s*allow\(\s*([a-z0-9_\-, ]+?)\s*\)")

#: ``# guarded-by: <token>  -- optional justification``
GUARDED_BY_RE = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    code: str  # short stable token; line numbers never appear here
    message: str

    @property
    def key(self) -> str:
        """The allowlist identity: stable across unrelated edits."""
        return f"{self.rule}:{self.path}:{self.code}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed source file: text, AST, and the comment/allow maps."""

    def __init__(self, abspath: str, root: str):
        self.abspath = abspath
        self.rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        with open(abspath, encoding="utf-8") as f:
            self.text = f.read()
        self._lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.rel)
        #: line -> raw comment text (including the leading ``#``)
        self.comments: dict[int, str] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError):
            pass  # partial comment map beats no lint at all
        #: line -> frozenset of rule names allowed on that line
        self.allow: dict[int, frozenset] = {}
        for line, comment in self.comments.items():
            m = _ALLOW_RE.search(comment)
            if m:
                self.allow[line] = frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )

    def allows(self, rule: str, line: int) -> bool:
        """Is ``rule`` allowed at ``line``?  The allow marker may sit on
        the flagged line itself or anywhere in the contiguous comment
        block directly above it (so justifications can span lines)."""
        if rule in self.allow.get(line, ()):
            return True
        ln = line - 1
        while ln in self.comments:
            if rule in self.allow.get(ln, ()):
                return True
            if not self._is_comment_line(ln):
                break  # a trailing comment on code ends the block
            ln -= 1
        return False

    def _is_comment_line(self, line: int) -> bool:
        stripped = self._lines[line - 1].lstrip() if (
            0 < line <= len(self._lines)
        ) else ""
        return stripped.startswith("#")

    def guarded_by(self, line: int) -> str | None:
        """The ``# guarded-by:`` token at ``line``, or anywhere in the
        contiguous comment block directly above it."""
        comment = self.comments.get(line)
        if comment:
            m = GUARDED_BY_RE.search(comment)
            if m:
                return m.group(1)
        ln = line - 1
        while ln in self.comments:
            m = GUARDED_BY_RE.search(self.comments[ln])
            if m:
                return m.group(1)
            if not self._is_comment_line(ln):
                break
            ln -= 1
        return None


def iter_sources(root: str, patterns) -> list[SourceFile]:
    """Parsed sources under ``root`` matching any glob in ``patterns``
    (repo-relative, ``**`` supported), deduped, stable order."""
    paths: dict = {}
    for pattern in patterns:
        for path in glob.glob(os.path.join(root, pattern), recursive=True):
            if path.endswith(".py") and os.path.isfile(path):
                paths[os.path.abspath(path)] = True
    out = []
    for path in sorted(paths):
        try:
            out.append(SourceFile(path, root))
        except (SyntaxError, UnicodeDecodeError):
            # unparseable target files are their own finding, raised by
            # the runner below rather than silently skipped
            out.append(path)
    return out


def run_rules(rules, root: str) -> list[Finding]:
    """Run every rule over its targets; inline ``# lint: allow`` already
    applied.  Allowlist filtering is the caller's second stage."""
    findings: list[Finding] = []
    cache: dict[str, list] = {}
    for rule in rules:
        key = "\0".join(rule.targets)
        sources = cache.get(key)
        if sources is None:
            sources = cache[key] = iter_sources(root, rule.targets)
        for sf in sources:
            if isinstance(sf, str):  # failed to parse
                findings.append(
                    Finding(
                        rule.name,
                        os.path.relpath(sf, root).replace(os.sep, "/"),
                        1,
                        "syntax-error",
                        "target file does not parse",
                    )
                )
                continue
            for f in rule.check(sf, root):
                if not sf.allows(f.rule, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.code))
    return findings


def load_allowlist(path: str) -> set:
    """Committed grandfather list: one ``rule:path:code`` key per line;
    blank lines and ``#`` comments ignored."""
    keys = set()
    if not os.path.exists(path):
        return keys
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                keys.add(line)
    return keys


def apply_allowlist(findings, allow_keys):
    """(kept findings, used keys, stale keys) — stale entries are
    surfaced so the list cannot silently rot."""
    kept, used = [], set()
    for f in findings:
        if f.key in allow_keys:
            used.add(f.key)
        else:
            kept.append(f)
    return kept, used, set(allow_keys) - used


def repo_root() -> str:
    """The repo checkout this package was loaded from."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


# ---- shared AST helpers ----------------------------------------------------


def dotted_name(node) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node) -> str | None:
    """The last segment of a Name/Attribute receiver (``self._journal``
    -> ``_journal``), else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def walk_no_nested_functions(node):
    """Yield ``node``'s descendants without descending into nested
    function/lambda bodies (their code runs on a different schedule)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(child))
