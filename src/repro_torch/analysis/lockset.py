"""Static lockset inference over the concurrent hot-path classes (``LCK``).

THR002 guards exactly one hard-coded shape — ``_Gap`` field mutations under
``with ….lock``.  This pass generalizes it to *whole-module inference* in
the Eraser style: for every class in a configured module, discover its lock
attributes (anything used as ``with self.X:`` or assigned a
``threading.Lock/RLock/Condition`` in construction), infer which lock
guards each shared attribute from the lock contexts its *mutations* occur
under, and then flag accesses that break the inferred discipline:

* LCK001 — an attribute whose mutations happen under ``with self.X:`` is
  read or written somewhere without holding ``X``.  Construction
  (``__init__``/``__post_init__``) is exempt (single-threaded by
  convention), as are attributes never mutated under any lock (immutable
  after construction, or deliberately unsynchronized — no discipline to
  infer).  Methods named ``*_locked`` are treated as holding every class
  lock: that suffix is the repo's documented "caller holds the lock"
  convention (``WorkerPool._claim_locked`` et al.).
* LCK002 — inconsistent lock *acquisition order* across the module: lock B
  taken while holding A in one place and A while holding B in another is a
  deadlock waiting for the right interleaving.
* LCK003 — an attribute mutated from a ``spawn_daemon`` target body with an
  empty lockset: service threads run concurrently with everything, so an
  unlocked mutation there races by construction even if no other code path
  has been written yet.

Suppression: the shared ``# analysis: allow[LCK001] reason`` trailing
comment (``analysis/lint.py``) — every allow should name why the race is
benign (e.g. ``_Gap.size()``'s racy probe, re-validated under the lock at
take time).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .lint import Finding, _attr_chain

__all__ = ["lockset_findings"]


#: Factory leaves whose assignment marks an attribute as a lock.
_LOCK_FACTORY_LEAVES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

#: Leaf names treated as locks when acquired through a non-self chain
#: (mirrors the THR002 walker's heuristic).
_LOCK_LEAF_NAMES = {"lock", "_lock", "_cond"}

#: Construction methods: single-threaded by convention, exempt from LCK001.
_CONSTRUCTION_METHODS = {"__init__", "__post_init__", "__new__", "__del__"}

#: Method calls that mutate the receiver container in place.
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert",
    "add", "discard", "remove", "pop", "popleft", "popitem",
    "clear", "update", "setdefault",
}


@dataclasses.dataclass
class _Access:
    attr: str
    kind: str                 # "read" | "write"
    line: int
    held: frozenset
    method: str


def _is_self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _self_attr_base(node: ast.AST) -> Optional[str]:
    """First attribute above ``self`` in an attribute/subscript chain —
    the object a nested store (``self.x.y = v``, ``self.x[k] = v``)
    actually mutates."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        base = _is_self_attr(node)
        if base is not None:
            return base
        node = node.value
    return None


def _lock_attrs_of(cls: ast.ClassDef) -> Set[str]:
    """Lock attributes of a class: ``with self.X:`` targets, construction
    assignments of threading lock factories, and lock-typed dataclass
    fields."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                attr = _is_self_attr(item.context_expr)
                if attr is not None:
                    locks.add(attr)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                attr = _is_self_attr(t)
                if attr is None or not isinstance(node.value, ast.Call):
                    continue
                leaf = (_attr_chain(node.value.func) or "").split(".")[-1]
                if leaf in _LOCK_FACTORY_LEAVES:
                    locks.add(attr)
    # Dataclass fields annotated as a lock type (e.g. `lock: threading.Lock`).
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            leaf = (_attr_chain(stmt.annotation) or "").split(".")[-1]
            if leaf in _LOCK_FACTORY_LEAVES:
                locks.add(stmt.target.id)
    return locks


class _MethodWalker:
    """Collect self-attribute accesses with the lexically held lockset."""

    def __init__(self, lock_attrs: Set[str], all_locks_held: bool):
        self.lock_attrs = lock_attrs
        self.base_held = frozenset(lock_attrs) if all_locks_held else frozenset()
        self.accesses: Dict[Tuple[str, int], _Access] = {}

    def _record(self, attr: str, kind: str, line: int, held: frozenset,
                method: str) -> None:
        if attr in self.lock_attrs:
            return
        key = (attr, line)
        prev = self.accesses.get(key)
        if prev is None or (prev.kind == "read" and kind == "write"):
            self.accesses[key] = _Access(attr, kind, line, held, method)

    def walk(self, node: ast.AST, held: frozenset, method: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # A nested function's body runs later — not under the lexically
            # enclosing lock (unless it follows the *_locked convention).
            name = getattr(node, "name", "<lambda>")
            inner = (
                frozenset(self.lock_attrs)
                if name.endswith("_locked")
                else frozenset()
            )
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                self.walk(child, inner, method)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            taken = set()
            for item in node.items:
                attr = _is_self_attr(item.context_expr)
                if attr is not None and attr in self.lock_attrs:
                    taken.add(attr)
                else:
                    self.walk(item.context_expr, held, method)
            inner = held | frozenset(taken)
            for child in node.body:
                self.walk(child, inner, method)
            return

        attr = _is_self_attr(node)
        if attr is not None:
            kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
            self._record(attr, kind, node.lineno, held, method)
        if isinstance(node, (ast.Attribute, ast.Subscript)) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            base = _self_attr_base(node.value)
            if base is not None:
                self._record(base, "write", node.lineno, held, method)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATOR_METHODS:
                base = _self_attr_base(node.func.value)
                if base is not None:
                    self._record(base, "write", node.lineno, held, method)

        for child in ast.iter_child_nodes(node):
            self.walk(child, held, method)


def _class_accesses(
    cls: ast.ClassDef, lock_attrs: Set[str]
) -> List[_Access]:
    out: List[_Access] = []
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if stmt.name in _CONSTRUCTION_METHODS:
            continue
        walker = _MethodWalker(lock_attrs, stmt.name.endswith("_locked"))
        for child in stmt.body:
            walker.walk(child, walker.base_held, stmt.name)
        out.extend(walker.accesses.values())
    return out


def _lck001(cls: ast.ClassDef, rel: str) -> List[Finding]:
    lock_attrs = _lock_attrs_of(cls)
    if not lock_attrs:
        return []
    accesses = _class_accesses(cls, lock_attrs)
    by_attr: Dict[str, List[_Access]] = {}
    for a in accesses:
        by_attr.setdefault(a.attr, []).append(a)

    findings: List[Finding] = []
    for attr, accs in sorted(by_attr.items()):
        locked_writes = [a for a in accs if a.kind == "write" and a.held]
        if not locked_writes:
            continue  # no locking discipline to infer
        guard = frozenset.intersection(*[a.held for a in locked_writes])
        if not guard:
            w = min(locked_writes, key=lambda a: a.line)
            findings.append(Finding(
                "LCK001", rel, w.line,
                f"{cls.name}.{attr} is mutated under "
                f"{len(locked_writes)} different locks with no common "
                "guard — pick one lock for the attribute",
            ))
            continue
        pretty = " + ".join(f"self.{g}" for g in sorted(guard))
        for a in sorted(accs, key=lambda a: a.line):
            if guard <= a.held:
                continue
            findings.append(Finding(
                "LCK001", rel, a.line,
                f"{a.kind} of {cls.name}.{attr} in {a.method}() without "
                f"its inferred guard `with {pretty}` (inferred from "
                f"{len(locked_writes)} locked mutation(s))",
            ))
    return findings


# ---------------------------------------------------------------------------
# LCK002: lock acquisition order
# ---------------------------------------------------------------------------


def _lock_id(expr: ast.AST, cls_name: Optional[str]) -> Optional[str]:
    """Stable identifier for an acquired lock, or None if not lock-like."""
    attr = _is_self_attr(expr)
    if attr is not None:
        return f"{cls_name or '<module>'}.self.{attr}"
    chain = _attr_chain(expr)
    if chain is not None and chain.split(".")[-1] in _LOCK_LEAF_NAMES:
        return chain
    return None


def _collect_order_edges(
    node: ast.AST,
    held: Tuple[str, ...],
    cls_name: Optional[str],
    self_locks: Set[str],
    edges: Dict[Tuple[str, str], int],
) -> None:
    if isinstance(node, ast.ClassDef):
        inner_locks = _lock_attrs_of(node)
        for child in node.body:
            _collect_order_edges(child, held, node.name, inner_locks, edges)
        return
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        body = node.body if isinstance(node.body, list) else [node.body]
        for child in body:
            _collect_order_edges(child, (), cls_name, self_locks, edges)
        return
    if isinstance(node, (ast.With, ast.AsyncWith)):
        inner = held
        for item in node.items:
            lid = _lock_id(item.context_expr, cls_name)
            attr = _is_self_attr(item.context_expr)
            if lid is not None and (attr is None or attr in self_locks):
                for h in inner:
                    if h != lid:
                        edges.setdefault((h, lid), item.context_expr.lineno)
                inner = inner + (lid,)
        for child in node.body:
            _collect_order_edges(child, inner, cls_name, self_locks, edges)
        return
    for child in ast.iter_child_nodes(node):
        _collect_order_edges(child, held, cls_name, self_locks, edges)


def _lck002(tree: ast.Module, rel: str) -> List[Finding]:
    edges: Dict[Tuple[str, str], int] = {}
    # Module-level lock names: anything with-acquired through the leaf
    # heuristic.  Per-class self locks are resolved inside the collector.
    _collect_order_edges(tree, (), None, set(), edges)
    if not edges:
        return []
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)

    def reachable(src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(adj.get(cur, ()))
        return False

    findings: List[Finding] = []
    for (a, b), line in sorted(edges.items(), key=lambda kv: kv[1]):
        if reachable(b, a):
            findings.append(Finding(
                "LCK002", rel, line,
                f"inconsistent lock order: {b} acquired while holding {a}, "
                f"but elsewhere {a} is reachable while holding {b} — "
                "deadlock under the right interleaving",
            ))
    return findings


# ---------------------------------------------------------------------------
# LCK003: unlocked mutation from spawn_daemon bodies
# ---------------------------------------------------------------------------


def _daemon_targets(tree: ast.Module) -> List[ast.FunctionDef]:
    """Function defs handed to ``spawn_daemon`` (by name or ``self.method``)."""
    methods: Dict[Tuple[str, str], ast.FunctionDef] = {}
    module_fns: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, ast.FunctionDef):
                    methods[(node.name, stmt.name)] = stmt
    for stmt in tree.body:
        if isinstance(stmt, ast.FunctionDef):
            module_fns[stmt.name] = stmt

    targets: List[ast.FunctionDef] = []
    seen: Set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if (_attr_chain(node.func) or "").split(".")[-1] != "spawn_daemon":
            continue
        arg: Optional[ast.AST] = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "target":
                arg = kw.value
        fn: Optional[ast.FunctionDef] = None
        name = _is_self_attr(arg) if arg is not None else None
        if name is not None:
            # Any class defining the method counts (call sites say `self.X`).
            for (_, meth), fdef in methods.items():
                if meth == name:
                    fn = fdef
                    break
        elif isinstance(arg, ast.Name):
            fn = module_fns.get(arg.id)
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            targets.append(fn)
    return targets


def _enclosing_class(tree: ast.Module, fn: ast.FunctionDef) -> Optional[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and fn in node.body:
            return node
    return None


def _lck003(tree: ast.Module, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    for fn in _daemon_targets(tree):
        cls = _enclosing_class(tree, fn)
        lock_attrs = _lock_attrs_of(cls) if cls is not None else set()
        walker = _MethodWalker(lock_attrs, fn.name.endswith("_locked"))
        for child in fn.body:
            walker.walk(child, walker.base_held, fn.name)
        owner = f"{cls.name}.{fn.name}" if cls is not None else fn.name
        for a in sorted(walker.accesses.values(), key=lambda a: a.line):
            if a.kind == "write" and not a.held:
                findings.append(Finding(
                    "LCK003", rel, a.line,
                    f"self.{a.attr} mutated in spawn_daemon body {owner}() "
                    "with an empty lockset — service threads race with "
                    "everything; take the owning lock",
                ))
        # Module-level daemon bodies: writes to `global`-declared names.
        if cls is None:
            globals_declared: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Global):
                    globals_declared.update(node.names)
            if globals_declared:
                for node in ast.walk(fn):
                    if isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Store
                    ) and node.id in globals_declared:
                        findings.append(Finding(
                            "LCK003", rel, node.lineno,
                            f"global {node.id!r} mutated in spawn_daemon "
                            f"body {owner}() with an empty lockset",
                        ))
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lockset_findings(tree: ast.Module, rel: str) -> List[Finding]:
    """All LCK findings for one module's AST."""
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        findings += _lck001(cls, rel)
    findings += _lck002(tree, rel)
    findings += _lck003(tree, rel)
    return findings


def module_locksets(source: str) -> Dict[str, Dict[str, Sequence[str]]]:
    """Debug helper: {class: {attr: sorted inferred guard}} for a module
    (attributes with no inferable guard are omitted)."""
    tree = ast.parse(source)
    out: Dict[str, Dict[str, Sequence[str]]] = {}
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        lock_attrs = _lock_attrs_of(cls)
        if not lock_attrs:
            continue
        guards: Dict[str, Sequence[str]] = {}
        by_attr: Dict[str, List[_Access]] = {}
        for a in _class_accesses(cls, lock_attrs):
            by_attr.setdefault(a.attr, []).append(a)
        for attr, accs in by_attr.items():
            locked_writes = [a for a in accs if a.kind == "write" and a.held]
            if not locked_writes:
                continue
            guard = frozenset.intersection(*[a.held for a in locked_writes])
            if guard:
                guards[attr] = sorted(guard)
        if guards:
            out[cls.name] = guards
    return out
