"""The project checkers: one rule per recurring review finding.

Each checker is deliberately narrow — it encodes ONE defect shape this
repo has actually shipped and fixed (docs/STATIC_ANALYSIS.md cites the
incidents), erring toward precision over recall: a project linter that
cries wolf gets baselined into silence.  Fixture twins in
tests/test_lint.py pin that every rule still catches its seeded-bad
snippet and passes the corrected one; tests/test_torch_lint.py holds
these copies to the same findings.
"""

from __future__ import annotations

import ast
from typing import Iterator

from misaka_tpu_torch.lint.engine import (
    Checker,
    Finding,
    LintError,
    Module,
    call_name,
    dotted,
    walk_scope,
)

# Non-reentrant lock constructors: `with L:` inside `with L:` deadlocks.
# RLock is excluded by name — re-entry is its whole point.
_LOCK_CTORS = {"threading.Lock", "threading.Condition", "Lock", "Condition"}


def _is_lock_ctor(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (dotted(node.func) or "") in _LOCK_CTORS)


def _with_lock_names(stmt: ast.With) -> list[str]:
    """Dotted names of plain `with <chain>:` context items (lock usage
    shape); `with open(...)` and friends render no name."""
    out = []
    for item in stmt.items:
        name = dotted(item.context_expr)
        if name is not None:
            out.append(name)
    return out


class LockDiscipline(Checker):
    """MSK001 — a call to a function that acquires non-reentrant lock L,
    made lexically inside a `with L:` block of the same module/class.

    The self-deadlock shape fixed three times in review: the usage
    ledger's and the SLO windows' recursive "other" resolution under
    their module `_lock` (twice), and the admission governor's
    eviction path under its own `self._lock`.  The acquirer
    registry is DERIVED per file — module-level `X = threading.Lock()`
    plus `self.X = threading.Lock()` instance locks — so new modules are
    covered the day they grow a lock, and the known registries
    (metrics/usage/slo/edge/ServeBatcher) are pinned by tests.
    """

    def __init__(self):
        super().__init__(
            rule="MSK001",
            summary="call re-acquires a non-reentrant lock already held "
                    "by a lexically enclosing `with` (self-deadlock)",
        )

    # -- registry derivation --------------------------------------------

    def module_locks(self, module: Module) -> dict[str, set[str]]:
        """{lock_name: {module-level functions that acquire it}} for
        module-level `X = threading.Lock()/Condition()` locks."""
        locks = {
            t.id
            for stmt in module.tree.body if isinstance(stmt, ast.Assign)
            for t in stmt.targets
            if isinstance(t, ast.Name) and _is_lock_ctor(stmt.value)
        }
        acquirers: dict[str, set[str]] = {name: set() for name in locks}
        if not locks:
            return acquirers
        for stmt in module.tree.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for name in self._acquired(stmt, locks):
                acquirers[name].add(stmt.name)
        return acquirers

    def class_locks(self, cls: ast.ClassDef) -> dict[str, set[str]]:
        """{`self.X`: {methods that acquire it}} for instance locks
        assigned `self.X = threading.Lock()/Condition()` in any method."""
        locks: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    name = dotted(t)
                    if name and name.startswith("self."):
                        locks.add(name)
        acquirers: dict[str, set[str]] = {name: set() for name in locks}
        if not locks:
            return acquirers
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for name in self._acquired(stmt, locks):
                acquirers[name].add(stmt.name)
        return acquirers

    @staticmethod
    def _acquired(func: ast.AST, locks: set[str]) -> set[str]:
        """Which of `locks` this function acquires in its own body
        (`with L:` or `L.acquire()`), nested defs excluded."""
        out: set[str] = set()
        for node in walk_scope(func):
            if isinstance(node, ast.With):
                for name in _with_lock_names(node):
                    if name in locks:
                        out.add(name)
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr == "acquire"):
                    name = dotted(f.value)
                    if name in locks:
                        out.add(name)
        return out

    # -- the check ------------------------------------------------------

    def check(self, module: Module) -> Iterator[Finding]:
        mod_acq = self.module_locks(module)
        for stmt in module.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._scan(module, stmt, mod_acq, receiver=None)
            elif isinstance(stmt, ast.ClassDef):
                cls_acq = self.class_locks(stmt)
                for m in stmt.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        # module locks are visible inside methods too
                        yield from self._scan(module, m, mod_acq,
                                              receiver=None)
                        yield from self._scan(module, m, cls_acq,
                                              receiver="self")
        return

    def _scan(self, module: Module, func: ast.AST,
              acquirers: dict[str, set[str]],
              receiver: str | None) -> Iterator[Finding]:
        """Flag calls to acquirers of L inside `with L:`, lexically."""
        if not any(acquirers.values()):
            return

        def visit(node: ast.AST, held: frozenset):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                    continue  # a nested def runs later, not here
                child_held = held
                if isinstance(child, ast.With):
                    child_held = held | {
                        n for n in _with_lock_names(child) if n in acquirers
                    }
                if isinstance(child, ast.Call):
                    yield from self._check_call(module, child, held,
                                                acquirers, receiver)
                yield from visit(child, child_held)

        yield from visit(func, frozenset())

    def _check_call(self, module, call, held, acquirers, receiver):
        for lock in held:
            takers = acquirers.get(lock, ())
            f = call.func
            if receiver is None and isinstance(f, ast.Name) \
                    and f.id in takers:
                yield self.finding(
                    module, call,
                    f"{f.id}() acquires module lock `{lock}` but is "
                    f"called inside `with {lock}:` — non-reentrant "
                    f"self-deadlock",
                )
            elif receiver is not None and isinstance(f, ast.Attribute) \
                    and dotted(f) == f"self.{f.attr}" and f.attr in takers:
                yield self.finding(
                    module, call,
                    f"self.{f.attr}() acquires `{lock}` but is called "
                    f"inside `with {lock}:` — non-reentrant self-deadlock",
                )


class ExceptionBreadth(Checker):
    """MSK002 — HTTP-call try blocks whose handlers catch OSError-family
    types but not http.client.HTTPException, and bare `except:` anywhere.

    The fleet shipped this twice: a replica dying mid-response raises
    BadStatusLine (an HTTPException, NOT an OSError), so `except
    OSError` around post_form/getresponse turned a routine failover into
    an unhandled exception in the router.  conn.request() itself can
    raise CannotSendRequest (also HTTPException) on connection-state
    errors, so pooled-connection retry loops have the same hole.
    """

    # call names whose failure surface includes http.client.HTTPException
    RISKY = {"post_form", "_post_form", "getresponse", "urlopen", "request"}
    # TRANSPORT-level exception names that do NOT cover HTTPException on
    # their own.  urllib.error.HTTPError is deliberately absent: catching
    # it alone is status-code handling (read the error body), not the
    # failover shape this rule polices.
    NARROW = {"OSError", "ConnectionError", "IOError", "error",
              "URLError", "timeout", "TimeoutError"}
    COVERS = {"HTTPException", "Exception", "BaseException"}

    def __init__(self):
        super().__init__(
            rule="MSK002",
            summary="except clause around an HTTP call misses "
                    "http.client.HTTPException (or is a bare except)",
        )

    @staticmethod
    def _handler_names(handler: ast.ExceptHandler) -> list[str]:
        t = handler.type
        if t is None:
            return []
        nodes = t.elts if isinstance(t, ast.Tuple) else [t]
        out = []
        for n in nodes:
            name = dotted(n)
            if name:
                out.append(name.rsplit(".", 1)[-1])
        return out

    def check(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield self.finding(
                    module, node,
                    "bare `except:` swallows SystemExit/KeyboardInterrupt "
                    "— name the exceptions (at minimum `except Exception`)",
                )
            if not isinstance(node, ast.Try):
                continue
            risky = None
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and call_name(sub) in self.RISKY:
                    risky = call_name(sub)
                    break
            if risky is None:
                continue
            names: set[str] = set()
            for h in node.handlers:
                names.update(self._handler_names(h))
            if names and names & self.NARROW and not (names & self.COVERS):
                yield self.finding(
                    module, node,
                    f"try block calls {risky}() but handlers catch only "
                    f"{sorted(names & self.NARROW)} — http.client."
                    f"HTTPException (BadStatusLine, CannotSendRequest) "
                    f"escapes; catch (OSError, http.client.HTTPException)",
                )


class LabelCardinality(Checker):
    """MSK003 — tenant/program metric labels fed straight from a caller-
    supplied parameter without a cardinality launder.

    Client-chosen names minted unbounded metric series (and dict keys)
    until `metrics.capped_label` existed; a later review re-audited every
    edge-side dict for the same hole.  The rule: a `.labels(...)` call
    whose tenant-identifying keyword (tenant/program/account/key) is a
    bare parameter of the enclosing function must launder — the value
    itself a `capped_label(...)`-family call, the parameter reassigned
    from one earlier in the function, or the function itself one of the
    module's launder wrappers (a function whose body calls capped_label,
    derived per module — edge.tenant_metric_label's shape).
    """

    CLIENT_KEYWORDS = {"tenant", "program", "account", "key"}
    LAUNDER = {"capped_label"}

    def __init__(self):
        super().__init__(
            rule="MSK003",
            summary="client-derived metric label bypasses "
                    "metrics.capped_label (unbounded series cardinality)",
        )

    def _launder_fns(self, module: Module) -> set[str]:
        """Module functions whose body calls capped_label — calling THEM
        is laundering too (tenant_metric_label wraps capped_label)."""
        out = set(self.LAUNDER)
        for stmt in module.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in walk_scope(stmt):
                    if isinstance(node, ast.Call) \
                            and call_name(node) in self.LAUNDER:
                        out.add(stmt.name)
                        break
        return out

    @staticmethod
    def _params(func) -> set[str]:
        a = func.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return {n for n in names if n not in ("self", "cls")}

    def check(self, module: Module) -> Iterator[Finding]:
        launder = self._launder_fns(module)
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"):
                continue
            func = module.enclosing_function(node)
            if func is None or func.name in launder:
                continue
            params = self._params(func)
            laundered = self._laundered_names(func, launder)
            for kw in node.keywords:
                if kw.arg not in self.CLIENT_KEYWORDS:
                    continue
                v = kw.value
                if isinstance(v, ast.Call) and call_name(v) in launder:
                    continue
                if isinstance(v, ast.Name) and v.id in params \
                        and v.id not in laundered:
                    yield self.finding(
                        module, node,
                        f".labels({kw.arg}={v.id}) feeds parameter "
                        f"`{v.id}` straight into a metric label — launder "
                        f"through metrics.capped_label / "
                        f"tenant_label_budget first",
                    )

    @staticmethod
    def _laundered_names(func, launder: set[str]) -> set[str]:
        """Names (re)assigned from a launder call anywhere in the
        function — `label = capped_label(...)` clears `label`."""
        out: set[str] = set()
        for node in walk_scope(func):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and call_name(node.value) in launder:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
        return out


class ThreadLifecycle(Checker):
    """MSK004 — a threading.Thread that is neither daemonized nor
    reachable from any join path.

    The ComputePlane once leaked one accept thread per close: the
    thread was non-daemon and close() never joined it, so every
    open/close cycle in the full suite accumulated a blocked OS thread.
    Accepted shapes: `daemon=True` at construction; `X.daemon = True`
    before start; the Thread stored somewhere a lexically visible
    `.join(` reaches — same function for locals, any method of the class
    for `self.X` (close()/shutdown paths live there), and the list
    idiom: Threads collected into `ts = [...]` / `ts.append(...)` with a
    `for t in ts: t.join()` loop in the same scope.
    """

    def __init__(self):
        super().__init__(
            rule="MSK004",
            summary="threading.Thread neither daemonized nor joined "
                    "(leaks one OS thread per lifecycle)",
        )

    @staticmethod
    def _has_daemon_kwarg(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return True
        return False

    @staticmethod
    def _search(scope: ast.AST, target: str, attr: str) -> bool:
        """Does `target`.daemon = True or `target`.join( appear under
        scope?  target is a dotted chain ("t", "self._accept_thread")."""
        for node in ast.walk(scope):
            if attr == "join" and isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" \
                    and dotted(node.func.value) == target:
                return True
            if attr == "daemon" and isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "daemon" \
                            and dotted(t.value) == target \
                            and isinstance(node.value, ast.Constant) \
                            and node.value.value is True:
                        return True
        return False

    @staticmethod
    def _joined_via_loop(scope: ast.AST, container: str) -> bool:
        """`for v in <container>: ... v.join()` anywhere under scope."""
        for node in ast.walk(scope):
            if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
                it = node.iter
                names = {dotted(it)}
                if isinstance(it, ast.Call) and it.args:
                    names.add(dotted(it.args[0]))   # for t in list(ts):
                elif isinstance(it, ast.BinOp):
                    names.add(dotted(it.left))      # for t in ts + more:
                    names.add(dotted(it.right))
                if container not in names:
                    continue
                v = node.target.id
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "join" \
                            and dotted(sub.func.value) == v:
                        return True
        return False

    def _container_of(self, module: Module, node: ast.Call) -> str | None:
        """The list/collection name a Thread call lands in: a list
        literal or comprehension assigned to a Name, or `ts.append(...)`."""
        cur, parent = node, module.parent(node)
        while parent is not None:
            if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                    and isinstance(parent.targets[0], ast.Name):
                return parent.targets[0].id
            if isinstance(parent, ast.AugAssign) \
                    and isinstance(parent.target, ast.Name):
                return parent.target.id  # ts += [Thread(...), ...]
            if isinstance(parent, ast.Call) \
                    and isinstance(parent.func, ast.Attribute) \
                    and parent.func.attr == "append":
                return dotted(parent.func.value)
            if not isinstance(parent, (ast.List, ast.Tuple, ast.ListComp,
                                       ast.GeneratorExp, ast.comprehension,
                                       ast.IfExp)):
                return None
            cur, parent = parent, module.parent(parent)
        return None

    def check(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and (dotted(node.func) in ("threading.Thread", "Thread"))):
                continue
            if self._has_daemon_kwarg(node):
                continue
            parent = module.parent(node)
            target = None
            if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
                target = dotted(parent.targets[0])
            ok = False
            if target:
                if target.startswith("self."):
                    cls = module.enclosing_class(node)
                    scope = cls if cls is not None else module.tree
                else:
                    scope = module.enclosing_function(node) or module.tree
                ok = (self._search(scope, target, "join")
                      or self._search(scope, target, "daemon")
                      or self._joined_via_loop(scope, target))
            else:
                container = self._container_of(module, node)
                if container:
                    scope = module.enclosing_function(node) or module.tree
                    ok = self._joined_via_loop(scope, container)
            if not ok:
                where = f"`{target}`" if target else "an unnamed thread"
                yield self.finding(
                    module, node,
                    f"threading.Thread assigned to {where} is neither "
                    f"daemon=True nor reachable from a .join() — one OS "
                    f"thread leaks per lifecycle (the ComputePlane "
                    f"accept-thread class)",
                )


class ClockDiscipline(Checker):
    """MSK005 — time.time() in +/- arithmetic, i.e. used as a duration
    or deadline.  Wall clocks step (NTP, manual set); every elapsed/
    deadline computation must use time.monotonic().  time.time() stays
    legal as a timestamp VALUE (checkpoint metadata, trace start epochs).
    """

    def __init__(self):
        super().__init__(
            rule="MSK005",
            summary="time.time() arithmetic (duration/deadline math "
                    "must use time.monotonic())",
        )

    @staticmethod
    def _is_walltime_call(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and dotted(node.func) in ("time.time",))

    def check(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Sub, ast.Add)) \
                    and (self._is_walltime_call(node.left)
                         or self._is_walltime_call(node.right)):
                op = "-" if isinstance(node.op, ast.Sub) else "+"
                yield self.finding(
                    module, node,
                    f"time.time() used in `{op}` arithmetic — wall clocks "
                    f"step under NTP; durations and deadlines must use "
                    f"time.monotonic()",
                )


class HandlerDrain(Checker):
    """MSK006 — a POST handler answering an error status while the
    request body may still be unread, without the consume-or-close
    discipline.

    The keep-alive desync: an early `self._text(4xx, ...)` return
    that never read the POST body leaves those bytes in the socket, and
    the NEXT request on the connection parses them as its request line.
    The contract (a shared helper): before any early error
    response, either consume (`edge.drain_or_close`, `self._form()`,
    `self.rfile.read(...)`) or mark `self.close_connection = True`.
    Checked in POST-context methods (`do_POST`, `_handle_post*`,
    `_post*`) — GET paths carry no body.
    """

    POST_NAMES = ("do_POST", "_handle_post", "_post")
    CONSUMERS = {"drain_or_close", "_form", "_read_body"}

    def __init__(self):
        super().__init__(
            rule="MSK006",
            summary="POST handler answers an error before the body is "
                    "consumed or the connection marked to close "
                    "(keep-alive desync)",
        )

    @classmethod
    def _is_post_func(cls, func) -> bool:
        return any(func.name == n or func.name.startswith(n)
                   for n in cls.POST_NAMES)

    @staticmethod
    def _is_error_response(node: ast.AST) -> bool:
        """self._text(4xx/5xx-literal, ...) or send_error(4xx/5xx)."""
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("_text", "send_error")
                and node.args):
            return False
        status = node.args[0]
        return (isinstance(status, ast.Constant)
                and isinstance(status.value, int)
                and status.value >= 400)

    def _consumes(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in self.CONSUMERS:
                return True
            if name == "read" and isinstance(node.func, ast.Attribute) \
                    and dotted(node.func.value, ) in ("self.rfile", "rfile"):
                return True
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) \
                        and t.attr == "close_connection" \
                        and isinstance(node.value, ast.Constant) \
                        and node.value.value is True:
                    return True
        return False

    def check(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and self._is_post_func(node):
                yield from self._scan(module, node)

    def _scan(self, module: Module, func) -> Iterator[Finding]:
        # one-way latch in lexical statement order: conservative (a
        # consume in an earlier branch suppresses later findings) but
        # zero false positives on the repo's early-return shape, where
        # the consume always precedes the error response it licenses.
        consumed = False
        for node in walk_scope(func):
            if not consumed and self._consumes(node):
                consumed = True
            if not consumed and self._is_error_response(node):
                yield self.finding(
                    module, node,
                    "error response before the POST body is consumed — "
                    "call edge.drain_or_close(self) (or read the body / "
                    "set self.close_connection = True) first, or the "
                    "unread bytes desynchronize the next keep-alive "
                    "request",
                )


ALL_CHECKERS = (
    LockDiscipline(),
    ExceptionBreadth(),
    LabelCardinality(),
    ThreadLifecycle(),
    ClockDiscipline(),
    HandlerDrain(),
)


def checker_for(rule: str) -> Checker:
    for c in ALL_CHECKERS:
        if c.rule == rule:
            return c
    raise LintError(f"unknown rule {rule!r} (have "
                    f"{[c.rule for c in ALL_CHECKERS]})")
