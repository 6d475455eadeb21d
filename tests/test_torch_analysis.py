"""The port's correctness tooling (``repro_torch.analysis``): the cases of
``tests/test_analysis.py`` against the port — static lint rules (including
the LCK lockset-inference pass) with the port's own configuration, the
shared invariant module, the vector-clock happens-before sanitizer, and the
deterministic schedule explorer, including the mutation-seeding proof and
the anchoring tests that tie the explorer's sync-point labels to the port's
executors (its plain ``lookback_scan`` on the CPU)."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from repro_torch.analysis import invariants as inv
from repro_torch.analysis.invariants import (
    InvariantViolation,
    check_admission_bound,
    check_all_dispatched,
    check_board_published,
    check_dispatch_lane,
    check_group_settled,
    check_interval_partition,
    check_lookback_step,
    check_phase_order,
    check_session_exclusive,
    check_session_fifo,
    check_unique_claims,
    claim_once,
)
from repro_torch.analysis.lint import LintConfig, lint_source, load_config, run_lint
from repro_torch.analysis.race import RaceTracker
from repro_torch.analysis.schedule import (
    SERVING_LABELS,
    SUITE_LABELS,
    explore,
    frontend_model,
    gap_model,
    lookback_model,
    phase_model,
    standard_suite,
    verify_simulator_twin,
)
from repro_torch.analysis.sync import (
    get_race_tracker,
    invariants_enabled,
    observed_labels,
    reset_observed,
    reset_race_tracker,
    set_checking,
    sync_point,
)


def _rules(findings):
    return [f.rule for f in findings]


# ======================================================================
# static lint: thread discipline
# ======================================================================


THREAD_SNIPPET = (
    "import threading\n"
    "def serve(fn):\n"
    "    t = threading.Thread(target=fn)\n"
    "    t.start()\n"
)


def test_thr001_raw_thread_in_hot_module():
    assert _rules(lint_source(THREAD_SNIPPET, "pipeline.py")) == ["THR001"]


def test_thr001_executor_construction_flagged():
    src = (
        "from concurrent.futures import ThreadPoolExecutor\n"
        "ex = ThreadPoolExecutor(4)\n"
    )
    assert _rules(lint_source(src, "service.py")) == ["THR001"]


def test_thr001_sanctioned_site_and_cold_modules_pass():
    # The scheduler is the one allowed construction site...
    assert lint_source(THREAD_SNIPPET, "runtime/scheduler.py") == []
    # ...and modules off the hot-path list are out of scope.
    assert lint_source(THREAD_SNIPPET, "viz/plots.py") == []


def test_thr002_gap_mutation_outside_lock():
    src = (
        "from repro_torch.core.work_stealing import _Gap\n"
        "def bad(g):\n"
        "    g.lo += 1\n"
    )
    assert _rules(lint_source(src, "whatever.py")) == ["THR002"]


def test_thr002_mutation_under_lock_passes():
    src = (
        "from repro_torch.core.work_stealing import _Gap\n"
        "def good(g):\n"
        "    with g.lock:\n"
        "        g.lo += 1\n"
    )
    assert lint_source(src, "whatever.py") == []


def test_thr002_inapplicable_without_gap_mention():
    # `.lo` on unrelated objects in modules that never touch _Gap is fine.
    src = "def f(obj):\n    obj.lo = 3\n"
    assert lint_source(src, "whatever.py") == []


def test_thr003_bare_except_flagged_everywhere():
    src = "try:\n    f()\nexcept:\n    pass\n"
    assert _rules(lint_source(src, "viz/plots.py")) == ["THR003"]


def test_thr004_swallowed_blind_except_in_hot_module():
    src = "def loop():\n    try:\n        f()\n    except Exception:\n        pass\n"
    assert _rules(lint_source(src, "data/pipeline.py")) == ["THR004"]
    # Recording the error is not swallowing.
    src_ok = (
        "def loop(errs):\n"
        "    try:\n"
        "        f()\n"
        "    except Exception as e:\n"
        "        errs.append(e)\n"
    )
    assert lint_source(src_ok, "data/pipeline.py") == []
    # Cold modules are out of THR004 scope (ruff BLE001 covers them).
    assert lint_source(src, "viz/plots.py") == []


def test_allow_comment_suppresses_rule():
    src = "try:\n    f()\nexcept:  # analysis: allow[THR003] probe\n    pass\n"
    assert lint_source(src, "viz/plots.py") == []


def test_syntax_error_reported_not_raised():
    assert _rules(lint_source("def f(:\n", "x.py")) == ["AST000"]


# ======================================================================
# static lint: operator contract
# ======================================================================


def test_opc001_opc002_batchable_class_missing_parts():
    src = "class Op:\n    op_batchable = True\n"
    assert _rules(lint_source(src, "ops.py")) == ["OPC001", "OPC002"]


def test_batchable_class_with_full_contract_passes():
    src = (
        "class Op:\n"
        "    op_batchable = True\n"
        "    def compose_batched(self, a, b):\n"
        "        return a + b\n"
        "    def op_identity(self):\n"
        "        return 0\n"
    )
    assert lint_source(src, "ops.py") == []


def test_opc002_function_attribute_form():
    src = "def compose(a, b):\n    return a + b\ncompose.op_batchable = True\n"
    assert _rules(lint_source(src, "ops.py")) == ["OPC002"]
    src_ok = src + "compose.op_identity = make_identity\n"
    assert lint_source(src_ok, "ops.py") == []


def test_opc003_cost_estimate_with_required_args():
    src = (
        "class Op:\n"
        "    def op_cost_estimate(self, items):\n"
        "        return len(items)\n"
    )
    assert _rules(lint_source(src, "ops.py")) == ["OPC003"]
    src_ok = "class Op:\n    def op_cost_estimate(self):\n        return 1.0\n"
    assert lint_source(src_ok, "ops.py") == []


def test_opc004_element_costs_arity():
    src = (
        "class Op:\n"
        "    def element_cost_estimates(self):\n"
        "        return []\n"
    )
    assert _rules(lint_source(src, "ops.py")) == ["OPC004"]
    src_ok = (
        "class Op:\n"
        "    def element_cost_estimates(self, n):\n"
        "        return [1.0] * n\n"
    )
    assert lint_source(src_ok, "ops.py") == []


# ======================================================================
# static lint: kernel purity
# ======================================================================


def _kernel(body_line):
    return (
        "import jax.experimental.pallas as pl\n"
        "def k(x_ref, o_ref):\n"
        f"    {body_line}\n"
        "    o_ref[...] = x_ref[...]\n"
        "def scan(x):\n"
        "    return pl.pallas_call(k, out_shape=x)(x)\n"
    )


def test_krn001_impure_calls_in_kernel_body():
    for line in ("print(x_ref)", "jax.debug.print('x')", "time.sleep(1)"):
        findings = lint_source(_kernel(line), "kernels/foo.py")
        assert _rules(findings) == ["KRN001"], line


def test_krn002_global_in_kernel_body():
    src = (
        "import jax.experimental.pallas as pl\n"
        "def k(x_ref, o_ref):\n"
        "    global hits\n"
        "    o_ref[...] = x_ref[...]\n"
        "def scan(x):\n"
        "    return pl.pallas_call(k, out_shape=x)(x)\n"
    )
    assert _rules(lint_source(src, "kernels/foo.py")) == ["KRN002"]


def test_kernel_rules_scoped_to_kernel_paths():
    # Same impure body outside kernels/ (and not forced into scope): clean.
    assert lint_source(_kernel("print(x_ref)"), "viz/plots.py") == []
    # Non-kernel helpers in a kernels/ module are also untouched.
    src = "def host_helper():\n    print('fine')\n"
    assert lint_source(src, "kernels/foo.py") == []


# ======================================================================
# static lint: lockset inference (LCK)
# ======================================================================


COUNTER_SNIPPET = (
    "import threading\n"
    "class Pool:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self.count = 0\n"
    "    def bump(self):\n"
    "        with self._lock:\n"
    "            self.count += 1\n"
    "    def peek(self):\n"
    "        return self.count\n"
)


def test_lck001_read_outside_inferred_guard():
    findings = lint_source(COUNTER_SNIPPET, "x.py", in_lockset_scope=True)
    assert _rules(findings) == ["LCK001"]
    # The finding names the attribute, the offending method and the guard.
    msg = findings[0].message
    assert "Pool.count" in msg and "peek()" in msg and "_lock" in msg


def test_lck001_all_accesses_guarded_pass():
    src = COUNTER_SNIPPET.replace(
        "    def peek(self):\n        return self.count\n",
        "    def peek(self):\n"
        "        with self._lock:\n"
        "            return self.count\n",
    )
    assert lint_source(src, "x.py", in_lockset_scope=True) == []


def test_lck001_locked_suffix_convention_holds_all_locks():
    # `*_locked` helpers are called with the class locks already held —
    # the convention the scheduler/frontend hot paths rely on.
    src = (
        "import threading\n"
        "class Pool:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.count = 0\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self.count += 1\n"
        "    def _peek_locked(self):\n"
        "        return self.count\n"
    )
    assert lint_source(src, "x.py", in_lockset_scope=True) == []


def test_lck001_container_mutator_counts_as_write():
    src = (
        "import threading\n"
        "class Q:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.items = []\n"
        "    def put(self, v):\n"
        "        with self._lock:\n"
        "            self.items.append(v)\n"
        "    def drain(self):\n"
        "        return self.items.pop()\n"
    )
    findings = lint_source(src, "x.py", in_lockset_scope=True)
    assert _rules(findings) == ["LCK001"]
    assert "Q.items" in findings[0].message


def test_lck001_undisciplined_attr_is_skipped():
    # No locked mutation anywhere -> no inferred discipline to enforce
    # (flagging would drown real findings in single-threaded state noise).
    src = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0\n"
        "    def bump(self):\n"
        "        self.n += 1\n"
        "    def peek(self):\n"
        "        return self.n\n"
    )
    assert lint_source(src, "x.py", in_lockset_scope=True) == []


def test_lck001_allow_comment_suppresses():
    src = COUNTER_SNIPPET.replace(
        "        return self.count\n",
        "        return self.count  # analysis: allow[LCK001] racy probe\n",
    )
    assert lint_source(src, "x.py", in_lockset_scope=True) == []


def test_lck001_scoped_to_lockset_modules():
    # Out of scope by default for an arbitrary path...
    assert lint_source(COUNTER_SNIPPET, "viz/plots.py") == []
    # ...in scope for a configured hot module without forcing the flag.
    assert _rules(lint_source(COUNTER_SNIPPET, "serving/frontend.py")) == [
        "LCK001"
    ]


def test_lck002_inconsistent_acquisition_order():
    src = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cond = threading.Lock()\n"
        "    def f(self):\n"
        "        with self._lock:\n"
        "            with self._cond:\n"
        "                pass\n"
        "    def g(self):\n"
        "        with self._cond:\n"
        "            with self._lock:\n"
        "                pass\n"
    )
    findings = lint_source(src, "x.py", in_lockset_scope=True)
    assert _rules(findings) == ["LCK002", "LCK002"]  # one per cycle edge


def test_lck002_consistent_order_passes():
    src = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cond = threading.Lock()\n"
        "    def f(self):\n"
        "        with self._lock:\n"
        "            with self._cond:\n"
        "                pass\n"
        "    def g(self):\n"
        "        with self._lock:\n"
        "            with self._cond:\n"
        "                pass\n"
    )
    assert lint_source(src, "x.py", in_lockset_scope=True) == []


def test_lck003_daemon_body_mutates_unlocked():
    src = (
        "import threading\n"
        "from repro_torch.runtime.scheduler import spawn_daemon\n"
        "class Svc:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.beats = 0\n"
        "    def start(self):\n"
        "        spawn_daemon(self._loop, name='svc')\n"
        "    def _loop(self):\n"
        "        self.beats += 1\n"
    )
    findings = lint_source(src, "x.py", in_lockset_scope=True)
    assert _rules(findings) == ["LCK003"]
    assert "beats" in findings[0].message


def test_lck003_daemon_body_locked_passes():
    src = (
        "import threading\n"
        "from repro_torch.runtime.scheduler import spawn_daemon\n"
        "class Svc:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.beats = 0\n"
        "    def start(self):\n"
        "        spawn_daemon(self._loop, name='svc')\n"
        "    def _loop(self):\n"
        "        with self._lock:\n"
        "            self.beats += 1\n"
    )
    assert lint_source(src, "x.py", in_lockset_scope=True) == []


def test_module_locksets_debug_helper():
    from repro_torch.analysis.lockset import module_locksets

    sets = module_locksets(COUNTER_SNIPPET)
    assert "Pool" in sets
    assert any("_lock" in g for g in sets["Pool"].get("count", ()))


# ======================================================================
# lint entry points: config + the clean-tree gate
# ======================================================================


def test_load_config_gives_port_root():
    """The port's lint keeps its own configuration: the reference's
    ``[tool.repro-analysis]`` section (root ``src/repro``) is not read."""
    cfg, repo = load_config()
    assert cfg.root == "src/repro_torch"
    assert "core/work_stealing.py" in cfg.hot_path_modules
    assert cfg.thread_construction_allowed == ("runtime/scheduler.py",)
    assert "core/engine/sharded.py" in cfg.hot_path_modules
    assert "core/engine/sharded.py" in cfg.lockset_modules
    # As the reference's (src/repro/analysis/lint.py:81, :104).
    assert "runtime/elastic.py" in cfg.hot_path_modules
    assert "runtime/elastic.py" in cfg.lockset_modules
    assert isinstance(cfg, LintConfig)
    import os

    assert os.path.exists(os.path.join(repo, "pyproject.toml"))
    for rel in cfg.hot_path_modules + cfg.lockset_modules:
        assert os.path.exists(os.path.join(repo, cfg.root, rel)), rel


def test_load_config_finds_the_repo_from_below(tmp_path):
    (tmp_path / "pyproject.toml").write_text(
        '[tool.repro-analysis]\nroot = "src/repro"\n')
    (tmp_path / "a" / "b").mkdir(parents=True)
    cfg, repo = load_config(str(tmp_path / "a" / "b"))
    assert (cfg.root, repo) == ("src/repro_torch", str(tmp_path))


def test_tree_is_lint_clean():
    """The acceptance gate: zero findings across the whole configured tree
    (src/repro_torch plus the operator-contract extra paths: the port's
    tests and chip_smoke.py)."""
    findings = run_lint()
    assert findings == [], "\n".join(str(f) for f in findings)


# ======================================================================
# invariant checks (unit)
# ======================================================================


def test_flag_constants_pin_kernel_values():
    from repro_torch.kernels import lookback_scan as k

    assert (inv.FLAG_EMPTY, inv.FLAG_AGG, inv.FLAG_PREFIX) == (
        k.FLAG_EMPTY, k.FLAG_AGG, k.FLAG_PREFIX,
    )


def test_claims_invariants():
    claims = {}
    claim_once(claims, 0, "a")
    claim_once(claims, 1, "b")
    with pytest.raises(InvariantViolation, match="no-double-claim"):
        claim_once(claims, 0, "b")
    check_unique_claims(2, claims)
    with pytest.raises(InvariantViolation, match="no-lost-element"):
        check_unique_claims(3, claims)


def test_interval_partition_invariants():
    check_interval_partition(6, [(0, 2), (3, 3), (4, 5)])
    with pytest.raises(InvariantViolation, match="interval-contiguity"):
        check_interval_partition(6, [(0, 2), (4, 5)])
    with pytest.raises(InvariantViolation, match="interval-cover-hi"):
        check_interval_partition(6, [(0, 2), (3, 4)])
    with pytest.raises(InvariantViolation, match="interval-nonempty"):
        check_interval_partition(2, [(1, 0)])


def test_group_settled_invariants():
    check_group_settled(3, 3, 3)
    with pytest.raises(InvariantViolation, match="group-claims"):
        check_group_settled(3, 2, 3)
    with pytest.raises(InvariantViolation, match="group-completion"):
        check_group_settled(3, 3, 2)


def test_lookback_step_invariants():
    check_lookback_step(3, 2, inv.FLAG_AGG, stopped=False)
    check_lookback_step(3, 1, inv.FLAG_PREFIX, stopped=True)
    with pytest.raises(InvariantViolation, match="lookback-left-edge"):
        check_lookback_step(3, -1, inv.FLAG_AGG, stopped=False)
    with pytest.raises(InvariantViolation, match="lookback-no-empty-read"):
        check_lookback_step(3, 2, inv.FLAG_EMPTY, stopped=False)
    with pytest.raises(InvariantViolation, match="lookback-stop-at-prefix"):
        check_lookback_step(3, 2, inv.FLAG_PREFIX, stopped=False)
    with pytest.raises(InvariantViolation, match="board-terminal-prefix"):
        check_board_published([inv.FLAG_PREFIX, inv.FLAG_AGG])


def test_phase_order_invariants():
    check_phase_order(
        [("p1_done", 0), ("p1_done", 1), ("p2_done", -1),
         ("p3_start", 0), ("p3_start", 1)]
    )
    with pytest.raises(InvariantViolation, match="phase3-after-phase1"):
        check_phase_order([("p2_done", -1), ("p3_start", 0)])
    with pytest.raises(InvariantViolation, match="phase3-after-phase2"):
        check_phase_order([("p1_done", 0), ("p3_start", 0)])


def test_serving_admission_invariant():
    check_admission_bound("batch", 2, 2)
    with pytest.raises(InvariantViolation, match="admission-bound"):
        check_admission_bound("batch", 3, 2)


def test_serving_lane_invariant():
    check_dispatch_lane(1, 1)
    check_dispatch_lane(2, 1)  # above the top lane can't happen, but is safe
    with pytest.raises(InvariantViolation, match="lane-priority"):
        check_dispatch_lane(0, 1)


def test_serving_session_invariants():
    check_session_exclusive("s1", {"s2"})
    with pytest.raises(InvariantViolation, match="session-exclusive"):
        check_session_exclusive("s1", {"s1", "s2"})
    check_session_fifo("s1", 3, None)
    check_session_fifo("s1", 3, 2)
    with pytest.raises(InvariantViolation, match="session-fifo"):
        check_session_fifo("s1", 2, 3)


def test_serving_lost_wakeup_invariant():
    check_all_dispatched(4, 4)
    with pytest.raises(InvariantViolation, match="lost-wakeup"):
        check_all_dispatched(4, 3)


# ======================================================================
# schedule explorer: clean protocols are verified exhaustively
# ======================================================================


def test_gap_protocol_clean_and_exhaustive():
    res = explore(gap_model(5, 2, granularity="fine"))
    assert res.ok and res.exhausted
    assert res.schedules > 100  # a real interleaving space, not a single run
    assert {"gap.seat", "gap.observe", "gap.take"} <= set(res.labels)


def test_gap_protocol_cross_segment_seating_clean():
    res = explore(
        gap_model(8, 3, granularity="coarse", cross=(((0, 3), (4, 7)), (2, 1))),
        max_schedules=150000,
    )
    assert res.ok and res.exhausted


def test_phase_protocol_clean_and_exhaustive():
    res = explore(phase_model(2))
    assert res.ok and res.exhausted
    assert {"phase1.reduce", "phase2.scan", "phase3.apply"} <= set(res.labels)


def test_lookback_protocol_clean_and_exhaustive():
    res = explore(lookback_model(3, granularity="fine"))
    assert res.ok and res.exhausted
    assert {"lookback.read", "lookback.publish_prefix"} <= set(res.labels)


def test_serving_protocol_clean_and_exhaustive():
    res = explore(
        frontend_model([("batch", 0, 1, [None, None]), ("inter", 1, 1, [None])])
    )
    assert res.ok and res.exhausted
    assert res.schedules > 100
    assert set(SERVING_LABELS) <= set(res.labels)


def test_serving_sessions_clean_under_two_dispatchers():
    res = explore(frontend_model([("scope", 0, 2, ["s1", "s1"])], dispatchers=2))
    assert res.ok and res.exhausted


def test_explorer_reports_deadlock():
    class DeadlockModel:
        def __init__(self):
            self.a_done = False
            self.b_done = False

        def tasks(self):
            def ta():
                yield ("wait", lambda: self.b_done)
                self.a_done = True

            def tb():
                yield ("wait", lambda: self.a_done)
                self.b_done = True

            return [("a", ta()), ("b", tb())]

        def finalize(self):
            pass

    res = explore(DeadlockModel)
    assert not res.ok
    assert res.deadlocks > 0
    assert any(v.invariant == "deadlock" for v in res.violations)


def test_fast_suite_is_clean_and_covers_model_labels():
    entries = standard_suite(fast=True)
    assert entries, "fast suite must not be empty"
    seen = set()
    for name, res in entries:
        assert res.ok, f"{name}: {res.violations[:3]}"
        if "sample" not in name:
            assert res.exhausted, f"{name} did not exhaust its space"
        seen |= set(res.labels)
    assert set(SUITE_LABELS) <= seen


def test_simulator_twin_sweep_clean():
    assert verify_simulator_twin() == []


# ======================================================================
# schedule explorer: seeded protocol bugs must be detected
# ======================================================================

_SEEDED_BUGS = [
    # (bug name, model factory, schedule budget)
    ("drop_claim_cas",
     gap_model(5, 2, granularity="fine", bugs=frozenset({"drop_claim_cas"})),
     2000),
    ("early_phase3",
     phase_model(2, frozenset({"early_phase3"})),
     2000),
    ("unordered_publish",
     lookback_model(3, granularity="fine", bugs=frozenset({"unordered_publish"})),
     2000),
    ("ignore_prefix_stop",
     lookback_model(3, granularity="fine", bugs=frozenset({"ignore_prefix_stop"})),
     2000),
]


@pytest.mark.parametrize(
    "name,factory,budget", _SEEDED_BUGS, ids=[b[0] for b in _SEEDED_BUGS]
)
def test_explorer_detects_seeded_bug(name, factory, budget):
    """Mutation seeding: re-introducing each known protocol race must be
    caught within a bounded schedule budget — otherwise the explorer is
    security theater."""
    res = explore(factory, max_schedules=budget, stop_on_violation=True)
    assert res.violations, f"seeded bug {name!r} survived {res.schedules} schedules"
    assert res.schedules <= budget


def test_seeded_cas_bug_reports_double_claim():
    res = explore(
        gap_model(5, 2, granularity="fine", bugs=frozenset({"drop_claim_cas"})),
        max_schedules=2000,
    )
    assert any(
        v.invariant in ("no-double-claim", "fold-order", "interval-contiguity")
        for v in res.violations
    )


# Serving-twin mutations: each re-introduces one protocol bug the real
# front end's locking prevents, and names the invariant that must catch it.
_SERVING_BUGS = [
    # (bug name, model factory, schedule budget, expected invariant)
    ("dispatch_while_full",
     frontend_model([("batch", 0, 1, [None, None]), ("inter", 1, 1, [None])],
                    bugs=frozenset({"dispatch_while_full"})),
     2000, "admission-bound"),
    ("lane_inversion",
     frontend_model([("batch", 0, 1, [None, None]), ("inter", 1, 1, [None])],
                    bugs=frozenset({"lane_inversion"})),
     2000, "lane-priority"),
    ("lost_wakeup",
     frontend_model([("batch", 0, 1, [None, None]), ("inter", 1, 1, [None])],
                    bugs=frozenset({"lost_wakeup"})),
     2000, "lost-wakeup"),
    ("drop_busy_set",
     frontend_model([("scope", 0, 2, ["s1", "s1"])], dispatchers=2,
                    bugs=frozenset({"drop_busy_set"})),
     4000, "session-exclusive"),
    ("double_dispatch",
     frontend_model([("a", 0, 2, [None, None])], dispatchers=2,
                    bugs=frozenset({"double_dispatch"})),
     4000, "no-double-claim"),
]


@pytest.mark.parametrize(
    "name,factory,budget,invariant",
    _SERVING_BUGS, ids=[b[0] for b in _SERVING_BUGS],
)
def test_serving_twin_detects_seeded_bug(name, factory, budget, invariant):
    """Mutation seeding for the serving protocol: removing each piece of
    the front end's locking discipline must be caught by the named
    invariant within a bounded schedule budget."""
    res = explore(factory, max_schedules=budget)
    assert res.violations, f"seeded bug {name!r} survived {res.schedules} schedules"
    assert any(v.invariant == invariant for v in res.violations), (
        f"{name!r} caught, but not by {invariant!r}: "
        f"{[v.invariant for v in res.violations[:5]]}"
    )


# ======================================================================
# anchoring: the real executors hit the model's sync points
# ======================================================================


@pytest.fixture
def checking():
    set_checking(True)
    reset_observed()
    yield
    set_checking(False)
    reset_observed()


def test_sync_gate_defaults_off():
    assert not invariants_enabled()


def test_real_executors_hit_all_suite_labels(checking):
    """Every label the explorer's models branch on is hit by the shipped
    executors under REPRO_CHECK_INVARIANTS — so the verified model and the
    real protocol cannot silently drift apart."""
    import torch

    from repro_torch.core.work_stealing import stealing_reduce, work_stealing_scan
    from repro_torch.kernels.lookback_scan import lookback_resolve, lookback_scan

    op = lambda a, b: a + b
    xs = list(range(24))
    partials, _ = stealing_reduce(op, xs, 3)
    assert sum(partials) == sum(xs)

    ys, _ = work_stealing_scan(op, xs, 3)
    assert ys[-1] == sum(xs)

    x = torch.from_numpy(np.arange(32.0, dtype=np.float32).reshape(16, 2))
    y, status, aggs, prefs = lookback_scan(torch.add, x, 4)
    np.testing.assert_allclose(
        np.asarray(y), np.cumsum(np.asarray(x), axis=0), rtol=1e-6
    )
    # Replay the lookback walk over the published board (the host twin of
    # the kernel's read loop — the instrumented `lookback.read` path).
    excl, _ = lookback_resolve(
        np.add, 3, [int(s) for s in np.asarray(status)[:, 0]],
        list(np.asarray(aggs)), list(np.asarray(prefs)),
    )
    np.testing.assert_allclose(excl, np.asarray(x)[:12].sum(axis=0))

    observed = set(observed_labels())
    missing = set(SUITE_LABELS) - observed
    assert not missing, f"real executors never hit: {sorted(missing)}"
    # And the pool's claim path is instrumented too.
    assert "pool.claim" in observed


def test_runtime_invariants_pass_on_real_reduce(checking):
    """stealing_reduce's debug bookkeeping (unique claims + interval
    partition) holds on a real concurrent run."""
    from repro_torch.core.work_stealing import stealing_reduce

    op = lambda a, b: a + b
    for _ in range(5):
        partials, stats = stealing_reduce(op, list(range(40)), 4)
        assert sum(partials) == sum(range(40))


def test_lookback_resolve_checks_protocol_when_enabled(checking):
    from repro_torch.kernels.lookback_scan import lookback_resolve

    op = lambda a, b: a + b
    statuses = [inv.FLAG_PREFIX, inv.FLAG_AGG, inv.FLAG_AGG]
    aggs = [1, 2, 3]
    prefs = [1, None, None]
    excl, steps = lookback_resolve(op, 2, statuses, aggs, prefs)
    assert excl == 3 and steps == 2
    assert observed_labels().get("lookback.read", 0) >= 2


def test_real_frontend_hits_serving_labels(checking):
    """The serving twin's labels anchor to the shipped front end: one
    admit/reject/dispatch cycle hits every SERVING_LABELS point, and the
    instrumented lock discipline leaves the sanitizer clean."""
    from repro_torch.serving.frontend import (
        AdmissionError, FrontendConfig, RegistrationFrontend,
    )

    reset_race_tracker()
    fe = RegistrationFrontend(
        FrontendConfig(queue_depth=1), auto_dispatch=False
    )
    try:
        fe.add_tenant("a")
        t = fe.call("a", lambda: 42)
        with pytest.raises(AdmissionError):
            fe.call("a", lambda: 0)  # depth 1, queue full -> serve.reject
        assert fe.dispatch_one()
        assert t.result(timeout=2.0) == 42
    finally:
        fe.close()
    observed = set(observed_labels())
    missing = set(SERVING_LABELS) - observed
    assert not missing, f"front end never hit: {sorted(missing)}"
    # All four accesses sit inside `with self._cond` — the vector clocks
    # must order them even across the dispatcher/submitter thread split.
    assert get_race_tracker().races() == []
    reset_race_tracker()


def test_pool_priority_lane_claim_is_labeled(checking):
    """The priority-lane selection read in WorkerPool._claim_locked is a
    labeled sync point (the lane_inversion twin anchors to it)."""
    from repro_torch.runtime.scheduler import WorkerPool, _TaskGroup

    pool = WorkerPool(0)  # no workers: claim white-box, single-threaded
    group = _TaskGroup([lambda: 1], "g", 3)
    with pool._cond:
        pool._groups.append(group)
        claim = pool._claim_locked()
    assert claim is not None
    assert observed_labels().get("pool.lane.priority", 0) >= 1
    assert observed_labels().get("pool.claim", 0) >= 1


# ======================================================================
# happens-before sanitizer (vector clocks)
# ======================================================================


def test_race_tracker_flags_unordered_writes():
    t = RaceTracker()
    t.access(1, "x", "write", label="w1")
    t.access(2, "x", "write", label="w2")
    races = t.races()
    assert len(races) == 1
    r = races[0]
    assert r.var == "x" and "race on" in str(r)


def test_race_tracker_lock_orders_accesses():
    t = RaceTracker()
    t.access(1, "x", "write", lock="L")
    t.access(2, "x", "write", lock="L")
    t.access(3, "x", "read", lock="L")
    assert t.races() == []


def test_race_tracker_read_write_conflicts():
    t = RaceTracker()
    t.access(1, "x", "read")
    t.access(2, "x", "write")
    assert len(t.races()) == 1
    # Concurrent reads alone are not a race.
    t2 = RaceTracker()
    t2.access(1, "y", "read")
    t2.access(2, "y", "read")
    assert t2.races() == []


def test_race_tracker_different_locks_still_race():
    t = RaceTracker()
    t.access(1, "x", "write", lock="L1")
    t.access(2, "x", "write", lock="L2")
    assert len(t.races()) == 1


def test_race_tracker_explicit_acquire_release_and_reset():
    t = RaceTracker()
    t.acquire(1, "L")
    t.access(1, "x", "write")
    t.release(1, "L")
    t.acquire(2, "L")
    t.access(2, "x", "write")
    t.release(2, "L")
    assert t.races() == []
    t.access(3, "x", "write")  # no lock: unordered with thread 2's write
    assert len(t.races()) == 1
    t.reset()
    assert t.races() == []


def test_sync_point_kinds_feed_global_tracker(checking):
    """Threaded end-to-end: unlocked kinded sync points from two real
    threads produce a report; the same accesses under a lock name do not."""
    reset_race_tracker()
    # All four threads are alive at once, so none reuses another's thread
    # id (a reused id would read as one thread and hide the race).
    alive = threading.Barrier(4)

    def unlocked():
        alive.wait()
        sync_point("race.test", "write", var="racetest.dirty")
        alive.wait()

    def locked():
        alive.wait()
        sync_point("race.test", "write",
                   var="racetest.clean", lock="racetest.lock")
        alive.wait()

    threads = [threading.Thread(target=unlocked) for _ in range(2)]
    threads += [threading.Thread(target=locked) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    races = get_race_tracker().races()
    assert any(r.var == "racetest.dirty" for r in races)
    assert not any(r.var == "racetest.clean" for r in races)
    reset_race_tracker()  # deliberate seeded race: don't leak the report


def test_sync_point_kind_validation(checking):
    with pytest.raises(ValueError, match="requires var="):
        sync_point("bad.point", "write")
    with pytest.raises(ValueError, match="requires lock="):
        sync_point("bad.point", "acquire")
    with pytest.raises(ValueError, match="unknown sync_point kind"):
        sync_point("bad.point", "mumble", var="v")
    reset_observed()


def test_sync_point_off_switch_is_cheap():
    """The whole sanitizer rides behind one global bool: 200k kinded
    sync_point calls with checking off must be effectively free (tier-1
    runs with the gate off — this pins the zero-overhead claim)."""
    assert not invariants_enabled()
    t0 = time.perf_counter()
    for _ in range(200_000):
        sync_point("budget.probe", "write",
                   var="budget.var", lock="budget.lock")
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"off-switch sync_point cost {dt:.3f}s for 200k calls"
    assert "budget.probe" not in observed_labels()


# ======================================================================
# satellite regressions: sanctioned daemons + crash propagation
# ======================================================================


def test_spawn_daemon_captures_crash():
    from repro_torch.runtime.scheduler import spawn_daemon

    def boom():
        raise ValueError("daemon died")

    h = spawn_daemon(boom, name="test-daemon")
    h.join(timeout=2.0)
    assert not h.alive()
    assert isinstance(h.error(), ValueError)


def test_token_pipeline_producer_crash_raises_not_deadlocks():
    """Regression: a crashing producer used to leave the consumer blocked
    forever on an empty queue; now the error surfaces on the next batch."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    pipe = TokenPipeline(PipelineConfig(vocab_size=97, global_batch=4, seq_len=8))

    def explode(step):
        raise ValueError("producer exploded")

    pipe.batch_at = explode
    pipe.start()
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            next(pipe)
    finally:
        pipe.stop()


def test_token_pipeline_still_streams():
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    pipe = TokenPipeline(
        PipelineConfig(vocab_size=97, global_batch=4, seq_len=8)
    ).start()
    try:
        b0 = next(pipe)
        b1 = next(pipe)
        assert b0["tokens"].shape == (4, 8)
        assert not np.array_equal(b0["tokens"], b1["tokens"])
    finally:
        pipe.stop()


def test_prefetch_forwards_producer_error():
    from repro_torch.pipeline import _prefetched

    def gen():
        yield 1
        raise ValueError("stream died")

    it = _prefetched(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="stream died"):
        for _ in it:
            pass


# ======================================================================
# satellite regressions: the genuine LCK findings, fixed
# ======================================================================


def test_telemetry_summary_locked_and_consistent():
    """LCK001 fix: summary()/mean()/estimate()/imbalance() read the EMA
    state under the telemetry lock (summary snapshots all fields in ONE
    critical section via the _locked helpers — the lock is non-reentrant,
    so the old nested public calls would now deadlock, not race)."""
    from repro_torch.core.engine.telemetry import OpTelemetry

    tel = OpTelemetry("op")
    stop = threading.Event()
    bad = []

    def reader():
        while not stop.is_set():
            s = tel.summary()
            # calls and total move together under the lock: a nonzero call
            # count can never be observed with a zero mean service time.
            if s["calls"] and not s["mean_s"] > 0:
                bad.append(s)
            tel.mean(); tel.estimate(); tel.imbalance()

    th = threading.Thread(target=reader)
    th.start()
    try:
        for _ in range(2000):
            tel.record(0.001)
    finally:
        stop.set()
        th.join(timeout=5.0)
    assert not bad, bad[:3]
    assert tel.summary()["calls"] == 2000


@dataclasses.dataclass
class _FakePlan:  # module level: pickled by PlanStore round-trips
    payload: int
    scratch: dict = dataclasses.field(default_factory=dict)


def test_plan_store_counters_survive_concurrent_traffic(tmp_path):
    """LCK001 fix: PlanStore.loads/stores are bumped under a lock —
    concurrent store+load traffic must not lose counter increments
    (`n += 1` is not atomic)."""
    from repro_torch.runtime.compile_cache import PlanStore

    store = PlanStore(str(tmp_path))
    n_threads, n_ops = 8, 25

    def hammer(i):
        for j in range(n_ops):
            assert store.store(("k", i, j), _FakePlan(i * 100 + j))
            loaded = store.load(("k", i, j))
            assert loaded is not None and loaded.payload == i * 100 + j

    threads = [
        threading.Thread(target=hammer, args=(i,)) for i in range(n_threads)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert store.stores == n_threads * n_ops
    assert store.loads == n_threads * n_ops


def test_pool_occupancy_and_num_workers_locked():
    """LCK001 fix: occupancy() reads demand and _claimed under the pool
    condition; the zero-capacity branch reports inf only under real
    demand (and 0.0 when idle, not a division error)."""
    from repro_torch.runtime.scheduler import WorkerPool, _TaskGroup

    pool = WorkerPool(0)
    assert pool.num_workers == 0
    assert pool.occupancy() == 0.0
    with pool._cond:
        pool._groups.append(_TaskGroup([lambda: 1], "g", 0))
    assert pool.occupancy() == float("inf")


def test_frontend_concurrent_submits_keep_admission_consistent():
    """LCK001 fix: tenant lookups and counter updates share the frontend
    condition — a submit storm from many threads never loses an admitted
    request and never over-admits past the queue depth."""
    from repro_torch.serving.frontend import (
        AdmissionError, FrontendConfig, RegistrationFrontend,
    )

    depth = 64
    fe = RegistrationFrontend(
        FrontendConfig(queue_depth=depth), auto_dispatch=False
    )
    try:
        fe.add_tenant("a")
        outcomes = []
        out_lock = threading.Lock()

        def submit():
            for _ in range(16):
                try:
                    fe.call("a", lambda: None)
                    ok = True
                except AdmissionError:
                    ok = False
                with out_lock:
                    outcomes.append(ok)

        threads = [threading.Thread(target=submit) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        admitted = sum(outcomes)
        stats = fe.stats()["tenants"]["a"]
        assert stats["queued"] == admitted <= depth
        assert stats["admitted"] == admitted
        assert stats["rejected"] == len(outcomes) - admitted
        drained = 0
        while fe.dispatch_one():
            drained += 1
        assert drained == admitted
    finally:
        fe.close()


# ======================================================================
# CLI
# ======================================================================


def test_cli_lint_clean(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["lint"]) == 0
    out = capsys.readouterr().out
    assert "lint: 0 finding(s)" in out


# ======================================================================
# parity with the reference's tooling
# ======================================================================


def test_fast_suite_equals_reference():
    """The explorer is a copy: its fast suite walks the same schedules,
    with the same outcome, as the reference's."""
    from repro.analysis.schedule import standard_suite as ref_suite

    got = [(n, r.ok, r.exhausted, r.schedules, sorted(r.labels))
           for n, r in standard_suite(fast=True)]
    want = [(n, r.ok, r.exhausted, r.schedules, sorted(r.labels))
            for n, r in ref_suite(fast=True)]
    assert got == want


@pytest.mark.parametrize("snippet,rel", [
    (THREAD_SNIPPET, "pipeline.py"),
    (COUNTER_SNIPPET, "serving/frontend.py"),
    ("try:\n    f()\nexcept:\n    pass\n", "viz/plots.py"),
    ("class Op:\n    op_batchable = True\n", "ops.py"),
    (_kernel("print(x_ref)"), "kernels/foo.py"),
])
def test_lint_rules_equal_reference(snippet, rel):
    """The same source gives the same findings under both packages' rules."""
    from repro.analysis.lint import lint_source as ref_lint_source

    assert [(f.rule, f.line, f.message) for f in lint_source(snippet, rel)] == [
        (f.rule, f.line, f.message) for f in ref_lint_source(snippet, rel)
    ]
