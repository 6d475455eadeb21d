"""AST-based static invariant lint for the concurrent hot paths.

Port of ``repro/analysis/lint.py``.  Three passes over ``src/repro_torch``,
configured by :class:`LintConfig`'s defaults (``[tool.repro-analysis]`` in
``pyproject.toml`` configures the reference package's lint and is never read
here):

**Thread discipline** (``THR``)
    * THR001 — no raw ``threading.Thread`` / ``concurrent.futures``
      executor construction in hot-path modules.  The resident runtime owns
      all OS threads (``runtime/scheduler.py`` is the one sanctioned
      construction site; long-lived service threads go through
      ``scheduler.spawn_daemon``).  This promotes the old
      ``tests/test_scheduler.py`` source-grep pin into a real check.
    * THR002 — every ``_Gap`` field mutation (``lo``/``hi``/``taken_*``/
      ``border``) must be lexically inside a ``with <obj>.lock`` block.
    * THR003 — no bare ``except:`` anywhere in the tree.
    * THR004 — no swallowed blind exceptions (``except Exception``/
      ``BaseException`` whose handler neither re-raises nor records the
      error) in hot-path modules: a worker loop that eats an error strands
      its task group forever.

**Operator contract** (``OPC``) — the monoid/adapter contract every engine
backend silently assumes (Copik's thesis derives the operator requirements;
``engine/telemetry.py`` documents the adapter attributes):
    * OPC001 — anything advertising ``op_batchable`` must provide the
      batched form (a ``compose_batched`` method, or the attribute sits on
      the batched callable itself).
    * OPC002 — batchable (monoid) operators must declare their identity
      (``op_identity``): the engine's ``where=`` mask lifting and padding
      semantics assume one exists.
    * OPC003 — ``op_cost_estimate`` must be readable without arguments
      (attribute, property, or zero-arg method) — the dispatcher calls it
      blind (``telemetry.op_cost_from``).
    * OPC004 — ``element_cost_estimates`` must accept exactly the element
      count (``(self, n)`` method / 1-arg callable) or be a plain sequence
      — the two shapes ``telemetry.element_costs_from`` supports.

**Kernel purity** (``KRN``) — bodies handed to ``pallas_call`` in
``kernels/`` must be pure traced functions.  The port has no ``pallas_call``:
its kernels are CUDA C++ under ``kernels/csrc/``, which this Python lint does
not read, so over the port's tree these passes find no kernel body.  They are
kept so that the rules mean the same in both packages:
    * KRN001 — no Python side effects, host callbacks, or nondeterminism
      (``print``/``open``, ``jax.debug``/``io_callback``/``host_callback``,
      ``time``/``random``/``np.random`` …) inside a kernel body.
    * KRN002 — no ``global``/``nonlocal`` statements inside a kernel body.

**Lockset inference** (``LCK``) — whole-module guard inference over the
classes in ``lockset_modules`` (generalizes THR002 beyond ``_Gap``); see
``analysis/lockset.py`` for the rules (LCK001 unlocked access, LCK002
inconsistent acquisition order, LCK003 unlocked mutation from
``spawn_daemon`` bodies).

Suppression: a trailing ``# analysis: allow[RULE]`` comment on the flagged
line (use sparingly; every allow should carry a reason).
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "LintConfig", "load_config", "run_lint", "lint_source"]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LintConfig:
    """Lint scope and per-rule module lists: the reference's
    ``[tool.repro-analysis]`` lists cut to the modules the port has."""

    root: str = "src/repro_torch"
    #: Modules (paths relative to ``root``) under thread discipline.
    hot_path_modules: Tuple[str, ...] = (
        "core/work_stealing.py",
        "core/engine/hierarchical.py",
        "core/engine/sharded.py",
        "core/engine/cost.py",
        "core/simulator.py",
        "runtime/scheduler.py",
        "runtime/elastic.py",
        "runtime/fault.py",
        "runtime/straggler.py",
        "pipeline.py",
        "data/pipeline.py",
        "service.py",
        "serving/frontend.py",
        "serving/loadgen.py",
    )
    #: The sanctioned thread-construction sites (relative to ``root``).
    thread_construction_allowed: Tuple[str, ...] = ("runtime/scheduler.py",)
    #: Subtrees (relative to ``root``) under kernel-purity rules.
    kernel_paths: Tuple[str, ...] = ("kernels",)
    #: Extra paths (relative to the repo: directories, files or glob
    #: patterns) included in the operator-contract pass only — mock
    #: operators in the port's tests and smoke script must not drift from
    #: the adapter signatures the engine consumes.
    contract_extra_paths: Tuple[str, ...] = ("tests/test_torch_*.py",
                                             "chip_smoke.py")
    #: Modules (paths relative to ``root``) under lockset inference (LCK) —
    #: the classes whose lock discipline the Eraser-style pass infers and
    #: enforces.
    lockset_modules: Tuple[str, ...] = (
        "core/work_stealing.py",
        "core/engine/sharded.py",
        "core/engine/telemetry.py",
        "runtime/scheduler.py",
        "runtime/compile_cache.py",
        "runtime/elastic.py",
        "runtime/fault.py",
        "runtime/straggler.py",
        "serving/frontend.py",
        "serving/policies.py",
    )


def load_config(start: Optional[str] = None) -> Tuple[LintConfig, str]:
    """The port's lint configuration and the repository root (the nearest
    directory above ``start`` holding ``pyproject.toml``).

    Returns ``(config, repo_root)``.  The configuration is
    :class:`LintConfig`'s defaults: pyproject's ``[tool.repro-analysis]``
    configures the reference's lint and is not read here.
    """
    here = os.path.abspath(start or os.getcwd())
    repo = here
    while not os.path.exists(os.path.join(repo, "pyproject.toml")):
        parent = os.path.dirname(repo)
        if parent == repo:
            return LintConfig(), here
        repo = parent
    return LintConfig(), repo


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\[([A-Z0-9, ]+)\]")


def _allowed_lines(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of an attribute/name chain (``a.b.c``), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _decorators(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for d in getattr(fn, "decorator_list", ()):
        name = _attr_chain(d if not isinstance(d, ast.Call) else d.func)
        if name:
            out.add(name.split(".")[-1])
    return out


def _required_args(fn) -> List[str]:
    """Positional parameters without defaults (``self``/``cls`` dropped)."""
    a = fn.args
    pos = list(a.posonlyargs) + list(a.args)
    n_required = len(pos) - len(a.defaults)
    names = [p.arg for p in pos[:n_required]]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


class _ParentedVisit:
    """Depth-first walk that tracks ancestor ``with``-lock nesting."""

    def __init__(self):
        self.lock_depth = 0

    def walk(self, node: ast.AST, visit) -> None:
        is_lock_with = False
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                chain = _attr_chain(item.context_expr)
                if chain is not None and chain.split(".")[-1] in (
                    "lock", "_lock", "_cond",
                ):
                    is_lock_with = True
        if is_lock_with:
            self.lock_depth += 1
        visit(node, self.lock_depth > 0)
        for child in ast.iter_child_nodes(node):
            self.walk(child, visit)
        if is_lock_with:
            self.lock_depth -= 1


# ---------------------------------------------------------------------------
# pass 1: thread discipline
# ---------------------------------------------------------------------------

_EXECUTOR_NAMES = {"ThreadPoolExecutor", "ProcessPoolExecutor"}
_GAP_FIELDS = {"lo", "hi", "taken_left", "taken_right", "border"}
_BLIND_TYPES = {"Exception", "BaseException"}


def _thread_discipline(
    tree: ast.Module, rel: str, cfg: LintConfig
) -> List[Finding]:
    findings: List[Finding] = []
    hot = rel in cfg.hot_path_modules
    construction_ok = rel in cfg.thread_construction_allowed

    # THR001: raw thread / executor construction.
    if hot and not construction_ok:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func) or ""
            leaf = chain.split(".")[-1]
            if chain.endswith("threading.Thread") or chain == "Thread" or (
                leaf in _EXECUTOR_NAMES
            ):
                findings.append(Finding(
                    "THR001", rel, node.lineno,
                    f"raw thread construction ({chain}) in hot-path module — "
                    "route work through the injected WorkerPool "
                    "(or scheduler.spawn_daemon for service threads)",
                ))

    # THR002: _Gap field mutations must sit under a lock `with`.
    mentions_gap = any(
        isinstance(n, (ast.Name, ast.ClassDef))
        and (getattr(n, "id", None) == "_Gap" or getattr(n, "name", None) == "_Gap")
        for n in ast.walk(tree)
    ) or any(
        isinstance(n, ast.ImportFrom)
        and any(a.name == "_Gap" for a in n.names)
        for n in ast.walk(tree)
    )
    if mentions_gap:
        walker = _ParentedVisit()

        def visit(node: ast.AST, under_lock: bool) -> None:
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr in _GAP_FIELDS:
                    if not under_lock:
                        findings.append(Finding(
                            "THR002", rel, node.lineno,
                            f"gap field mutation (.{t.attr}) outside a "
                            "`with ….lock` block",
                        ))

        walker.walk(tree, visit)

    # THR003 / THR004: exception handling.
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            findings.append(Finding(
                "THR003", rel, node.lineno,
                "bare `except:` — name the exception types",
            ))
            continue
        if not hot:
            continue
        types = [node.type] if not isinstance(node.type, ast.Tuple) else (
            list(node.type.elts)
        )
        blind = any(
            (_attr_chain(t) or "").split(".")[-1] in _BLIND_TYPES for t in types
        )
        if blind and _swallows(node):
            findings.append(Finding(
                "THR004", rel, node.lineno,
                "blind exception swallowed in hot-path module — record, "
                "re-raise, or narrow the type",
            ))
    return findings


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does nothing with the error: only
    ``pass``/``continue``/``break``/bare-constant statements."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Return) and (
            stmt.value is None or isinstance(stmt.value, ast.Constant)
        ):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


# ---------------------------------------------------------------------------
# pass 2: operator contract
# ---------------------------------------------------------------------------


def _class_member_names(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[stmt.name] = stmt
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            out[stmt.target.id] = stmt
    return out


def _operator_contract(tree: ast.Module, rel: str) -> List[Finding]:
    findings: List[Finding] = []

    # --- classes advertising adapter attributes.
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        members = _class_member_names(cls)
        adv = members.get("op_batchable")
        advertises = False
        if isinstance(adv, ast.Assign) and isinstance(adv.value, ast.Constant):
            advertises = bool(adv.value.value)
        elif isinstance(adv, (ast.FunctionDef, ast.Assign, ast.AnnAssign)):
            advertises = True  # dynamic: assume it can say True
        if advertises:
            if "compose_batched" not in members:
                findings.append(Finding(
                    "OPC001", rel, cls.lineno,
                    f"class {cls.name} advertises op_batchable but defines "
                    "no compose_batched batched form",
                ))
            if "op_identity" not in members:
                findings.append(Finding(
                    "OPC002", rel, cls.lineno,
                    f"class {cls.name} advertises op_batchable (a monoid "
                    "contract) but declares no op_identity",
                ))

        cost = members.get("op_cost_estimate")
        if isinstance(cost, ast.FunctionDef) and _required_args(cost):
            findings.append(Finding(
                "OPC003", rel, cost.lineno,
                f"{cls.name}.op_cost_estimate takes required arguments "
                f"({', '.join(_required_args(cost))}) — the dispatcher reads "
                "it blind (attribute, property or zero-arg method)",
            ))
        elem = members.get("element_cost_estimates")
        if isinstance(elem, ast.FunctionDef):
            req = _required_args(elem)
            is_prop = "property" in _decorators(elem)
            if not is_prop and len(req) != 1:
                findings.append(Finding(
                    "OPC004", rel, elem.lineno,
                    f"{cls.name}.element_cost_estimates must take exactly "
                    f"the element count (got required args: {req or 'none'})",
                ))
        elif isinstance(elem, ast.Assign) and isinstance(elem.value, ast.Call):
            call = elem.value
            fn = call.args[0] if call.args else None
            if (
                (_attr_chain(call.func) or "").endswith("staticmethod")
                and isinstance(fn, ast.Lambda)
                and len(fn.args.args) != 1
            ):
                findings.append(Finding(
                    "OPC004", rel, elem.lineno,
                    f"{cls.name}.element_cost_estimates staticmethod must "
                    "take exactly the element count",
                ))

    # --- function-attribute advertising: `fn.op_batchable = True` means the
    # function itself is the batched form; it must also carry op_identity.
    batch_fns: Dict[str, int] = {}
    identity_fns: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
                if t.attr == "op_batchable":
                    truthy = not (
                        isinstance(node.value, ast.Constant)
                        and not node.value.value
                    )
                    if truthy:
                        batch_fns[t.value.id] = node.lineno
                elif t.attr == "op_identity":
                    identity_fns.add(t.value.id)
    for fn_name, line in batch_fns.items():
        if fn_name not in identity_fns:
            findings.append(Finding(
                "OPC002", rel, line,
                f"{fn_name}.op_batchable is set but {fn_name}.op_identity "
                "is not — monoid ops must declare their identity",
            ))
    return findings


# ---------------------------------------------------------------------------
# pass 3: kernel purity
# ---------------------------------------------------------------------------

_IMPURE_CALL_NAMES = {
    "print", "breakpoint", "open", "input", "eval", "exec",
    "io_callback", "pure_callback", "host_callback",
}
_IMPURE_CHAIN_PREFIXES = (
    "time.", "random.", "np.random.", "numpy.random.", "datetime.",
    "os.", "sys.", "jax.debug.", "debug.print", "debug.callback",
    "jax.experimental.io_callback", "jax.experimental.host_callback",
    "jax.pure_callback",
)


def _kernel_bodies(tree: ast.Module) -> List[ast.FunctionDef]:
    """Function defs passed (by name) as the first argument to pallas_call."""
    defs: Dict[str, List[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            defs.setdefault(node.name, []).append(node)
    bodies: List[ast.FunctionDef] = []
    seen: Set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func) or ""
        if chain.split(".")[-1] != "pallas_call":
            continue
        if node.args and isinstance(node.args[0], ast.Name):
            for fn in defs.get(node.args[0].id, ()):
                if id(fn) not in seen:
                    seen.add(id(fn))
                    bodies.append(fn)
    return bodies


def _kernel_purity(tree: ast.Module, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    for fn in _kernel_bodies(tree):
        for node in ast.walk(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                findings.append(Finding(
                    "KRN002", rel, node.lineno,
                    f"`{'global' if isinstance(node, ast.Global) else 'nonlocal'}`"
                    f" statement inside pallas kernel body {fn.name!r}",
                ))
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain is None:
                continue
            leaf = chain.split(".")[-1]
            impure = leaf in _IMPURE_CALL_NAMES or any(
                chain.startswith(p) or ("." + p) in ("." + chain)
                for p in _IMPURE_CHAIN_PREFIXES
            )
            if impure:
                findings.append(Finding(
                    "KRN001", rel, node.lineno,
                    f"impure/nondeterministic call `{chain}` inside pallas "
                    f"kernel body {fn.name!r}",
                ))
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_source(
    source: str,
    rel: str,
    cfg: Optional[LintConfig] = None,
    *,
    passes: Sequence[str] = ("threads", "contract", "kernels", "lockset"),
    in_kernel_scope: Optional[bool] = None,
    in_lockset_scope: Optional[bool] = None,
) -> List[Finding]:
    """Lint one module's source (``rel`` is its path relative to the scope
    root — rule applicability is path-based).  Used by :func:`run_lint` and
    directly by tests on synthetic snippets."""
    cfg = cfg or LintConfig()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("AST000", rel, e.lineno or 0, f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    if "threads" in passes:
        findings += _thread_discipline(tree, rel, cfg)
    if "contract" in passes:
        findings += _operator_contract(tree, rel)
    if "kernels" in passes:
        kernel_scope = in_kernel_scope
        if kernel_scope is None:
            kernel_scope = any(
                rel == k or rel.startswith(k.rstrip("/") + "/")
                for k in cfg.kernel_paths
            )
        if kernel_scope:
            findings += _kernel_purity(tree, rel)
    if "lockset" in passes:
        lockset_scope = in_lockset_scope
        if lockset_scope is None:
            lockset_scope = rel in cfg.lockset_modules
        if lockset_scope:
            from .lockset import lockset_findings  # local: lockset imports us

            findings += lockset_findings(tree, rel)
    allowed = _allowed_lines(source)
    findings = [
        f for f in findings
        if f.rule not in allowed.get(f.line, set())
    ]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def _iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def run_lint(
    repo: Optional[str] = None, cfg: Optional[LintConfig] = None
) -> List[Finding]:
    """Lint the configured tree; returns all findings (empty = clean)."""
    if cfg is None:
        cfg, found_repo = load_config(repo)
        repo = repo or found_repo
    repo = os.path.abspath(repo or os.getcwd())
    findings: List[Finding] = []
    root = os.path.join(repo, cfg.root)
    for path in _iter_py_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        findings += lint_source(source, rel, cfg)
    # Operator-contract pass only over the mock-bearing extra paths.
    for extra in cfg.contract_extra_paths:
        base = os.path.join(repo, extra)
        if os.path.isdir(base):
            paths: Iterable[str] = _iter_py_files(base)
        else:
            paths = sorted(glob.glob(base))
        for path in paths:
            rel = os.path.relpath(path, repo).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            findings += lint_source(source, rel, cfg, passes=("contract",))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
