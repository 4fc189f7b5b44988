"""The lint engine: module model, findings, fingerprints, baseline.

Stdlib-only by design (ast + tokenize-free line scanning) — the linter
must run in every environment the code does, including the bare CI
container, with zero pip installs.

The moving parts:

  * ``Module`` — one parsed source file plus the derived context every
    checker needs: parent links, enclosing-scope chains, and the raw
    source lines (for `lint: disable=` suppressions).
  * ``Finding`` — one violation; its ``fingerprint`` deliberately omits
    the line number (rule + path + enclosing scope + message + an
    occurrence counter), so unrelated edits above a finding don't churn
    the baseline.
  * baseline — a committed text file of fingerprints with `#`
    justification comments.  Findings whose fingerprint is listed are
    suppressed; NEW findings fail the run; stale entries are reported so
    the file shrinks as debt is paid.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Iterable, Iterator

_RULE_ID_RE = re.compile(r"MSK\d{3}")


class LintError(Exception):
    """Engine misuse (unknown rule, unreadable baseline...)."""


@dataclass
class Finding:
    rule: str          # "MSK001"
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    scope: str         # dotted enclosing def/class chain, "<module>" at top
    message: str
    # distinguishes repeated identical findings in one scope so each
    # needs its own baseline entry (set by the runner, not checkers)
    occurrence: int = 1

    @property
    def fingerprint(self) -> str:
        base = f"{self.rule} {self.path} {self.scope} :: {self.message}"
        return base if self.occurrence == 1 else f"{base} #{self.occurrence}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.scope}] {self.message}")


class Module:
    """One parsed file + the context checkers share."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def scope_of(self, node: ast.AST) -> str:
        """Dotted chain of enclosing defs/classes ("Cls.method"), or
        "<module>" for top-level code."""
        names: list[str] = []
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
            cur = self._parents.get(cur)
        return ".".join(reversed(names)) or "<module>"

    def enclosing_function(
        self, node: ast.AST
    ) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self._parents.get(cur)
        return None

    def enclosing_class(self, node: ast.AST) -> ast.ClassDef | None:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self._parents.get(cur)
        return None

    def suppressed(self, line: int, rule: str) -> bool:
        """True when the physical line carries `lint: disable=<rule>`
        (comma- or space-separated rules allowed).  The escape hatch for
        a finding that is wrong ON THIS LINE but right as a rule; prefer
        the baseline for pre-existing debt."""
        if not 1 <= line <= len(self.lines):
            return False
        text = self.lines[line - 1]
        marker = text.find("lint: disable=")
        if marker < 0 or "#" not in text[:marker]:
            return False
        # tolerate sloppy separators ("MSK001, MSK002") and an empty
        # list ("disable=" with the rule forgotten suppresses nothing)
        listed = _RULE_ID_RE.findall(text[marker + len("lint: disable="):])
        return rule in listed


@dataclass
class Checker:
    """Base: subclasses set `rule`/`summary` and implement check()."""

    rule: str = "MSK000"
    summary: str = ""

    def check(self, module: Module) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module: Module, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.rule,
            path=module.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            scope=module.scope_of(node),
            message=message,
        )


# --- small shared AST helpers (checkers import these) -----------------------


def call_name(node: ast.Call) -> str | None:
    """The terminal name a call targets: f() -> "f", a.b.f() -> "f"."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def dotted(node: ast.AST) -> str | None:
    """Render a Name/Attribute chain ("threading.Lock", "self._lock");
    None when the expression is not a plain chain."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def walk_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Pre-order, DOCUMENT-order walk that does not descend into nested
    function/class defs — the body of the scope itself (a nested def
    only runs when called; analyzing it as if inline produces false
    lock/drain findings).  Document order matters: the handler-drain
    latch is one-way over lexical statement order."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
            yield from walk_scope(child)


# --- the runner -------------------------------------------------------------

# Generated / vendored files no checker should parse opinions into.
EXCLUDE_SUFFIXES = ("_pb2.py",)


def iter_py_files(roots: Iterable[str], base: str) -> Iterator[tuple[str, str]]:
    """(abspath, relpath-to-base) for every lintable .py under roots;
    roots may be files or directories."""
    for root in roots:
        rootabs = os.path.join(base, root) if not os.path.isabs(root) else root
        if os.path.isfile(rootabs):
            if rootabs.endswith(".py"):
                yield rootabs, os.path.relpath(rootabs, base)
            continue
        for dirpath, dirnames, filenames in os.walk(rootabs):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if not fn.endswith(".py") or fn.endswith(EXCLUDE_SUFFIXES):
                    continue
                full = os.path.join(dirpath, fn)
                yield full, os.path.relpath(full, base)


def _number_occurrences(findings: list[Finding]) -> list[Finding]:
    seen: dict[str, int] = {}
    for f in findings:
        key = f"{f.rule} {f.path} {f.scope} :: {f.message}"
        seen[key] = seen.get(key, 0) + 1
        f.occurrence = seen[key]
    return findings


def run_source(source: str, checkers, relpath: str = "<snippet>.py"
               ) -> list[Finding]:
    """Lint one source string (the fixture-test entry point)."""
    module = Module(relpath, relpath, source)
    findings: list[Finding] = []
    for checker in checkers:
        for f in checker.check(module):
            if not module.suppressed(f.line, f.rule):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return _number_occurrences(findings)


def run_tree(roots, checkers, base: str) -> list[Finding]:
    """Lint every .py under roots; syntax errors are findings, not
    crashes (a half-written file must fail lint, loudly and located)."""
    findings: list[Finding] = []
    for path, rel in iter_py_files(roots, base):
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        try:
            module = Module(path, rel, source)
        except SyntaxError as e:
            findings.append(Finding(
                rule="MSK000", path=rel.replace(os.sep, "/"),
                line=e.lineno or 1, col=e.offset or 0,
                scope="<module>", message=f"syntax error: {e.msg}",
            ))
            continue
        for checker in checkers:
            for f in checker.check(module):
                if not module.suppressed(f.line, f.rule):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return _number_occurrences(findings)


# --- baseline ---------------------------------------------------------------


def load_baseline(path: str) -> set[str]:
    """Fingerprint set from a baseline file; missing file = empty
    baseline (a fresh checkout with no debt needs no file)."""
    if not os.path.exists(path):
        return set()
    out: set[str] = set()
    with open(path, encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


def save_baseline(path: str, findings: Iterable[Finding],
                  header: str = "") -> None:
    """Write every finding's fingerprint, sorted — `--update-baseline`.
    This OVERWRITES the file, dropping hand-written justification
    comments: restore them from the git diff afterward (the enforced
    workflow — tests/test_lint.py fails the tree while any entry lacks
    its comment, so a clobber cannot land silently)."""
    lines = sorted(f.fingerprint for f in findings)
    with open(path, "w", encoding="utf-8") as fh:
        if header:
            for h in header.splitlines():
                fh.write(f"# {h}\n")
        for line in lines:
            fh.write(line + "\n")


def apply_baseline(
    findings: list[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding], set[str]]:
    """Split into (new, suppressed, stale-baseline-entries)."""
    new: list[Finding] = []
    suppressed: list[Finding] = []
    hit: set[str] = set()
    for f in findings:
        if f.fingerprint in baseline:
            suppressed.append(f)
            hit.add(f.fingerprint)
        else:
            new.append(f)
    return new, suppressed, baseline - hit


def format_findings(findings: Iterable[Finding]) -> str:
    return "\n".join(f.render() for f in findings)
