"""Port parity: the prefix circuits (``repro_torch.core.circuits``) against
``repro.core.circuits``, the torch counterparts of ``tests/test_circuits.py``:
the paper's Table 1 on the port's circuits, each statistic equal to the
reference's, and the port's element executor on non-commutative operators."""

import math
import operator

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic fallback sampler
    from _hypothesis_shim import given, settings, strategies as st

from repro.core import circuits as ref
from repro.core.scan import python_exec as ref_python_exec
from repro_torch.core.circuits import (
    analyze,
    blelloch_circuit,
    get_circuit,
    ladner_fischer_circuit,
)
from repro_torch.core.scan import python_exec

ALL = ["sequential", "dissemination", "blelloch", "ladner_fischer",
       "brent_kung", "sklansky"]
POW2 = [2, 4, 8, 16, 64, 256, 1024]


def _stats(name, n):
    """The port's statistics of circuit (name, n), checked against the
    reference's."""
    st_ = analyze(get_circuit(name, n))
    want = ref.analyze(ref.get_circuit(name, n))
    assert (st_.work, st_.depth, st_.max_fanout) == (
        want.work, want.depth, want.max_fanout), (name, n)
    return st_


def test_sequential_table1():
    for n in POW2:
        st_ = _stats("sequential", n)
        assert st_.work == n - 1 and st_.depth == n - 1


def test_dissemination_table1():
    """Work = N log2 N - N + 1, depth = log2 N (paper Table 1 + Fig 2)."""
    for n in POW2:
        lg = int(math.log2(n))
        st_ = _stats("dissemination", n)
        assert st_.work == n * lg - n + 1, (n, st_.work)
        assert st_.depth == lg
    # The paper's Fig 2 example: N=8 needs exactly 17 operator applications.
    assert _stats("dissemination", 8).work == 17


def test_blelloch_table1():
    """Exclusive double sweep: work <= 2(N-1), depth <= 2 log2 N."""
    for n in POW2:
        lg = int(math.log2(n))
        st_ = _stats("blelloch", n)
        assert st_.work <= 2 * (n - 1)
        assert st_.work >= 2 * (n - 1) - 2 * lg  # identity moves are free
        assert st_.depth <= 2 * lg


def test_ladner_fischer_table1():
    """Depth exactly ceil(log2 N), work < 4N - 5 (Table 1, k=0)."""
    for n in POW2[1:]:
        lg = int(math.log2(n))
        st_ = _stats("ladner_fischer", n)
        assert st_.depth == lg, (n, st_.depth)
        assert st_.work < 4 * n - 5, (n, st_.work)


def test_ladner_fischer_k_tradeoff():
    """Higher k: +1 depth per level, less work (the paper's depth-work knob)."""
    n = 256
    prev_work = None
    for k in range(4):
        st_ = analyze(ladner_fischer_circuit(n, k))
        want = ref.analyze(ref.ladner_fischer_circuit(n, k))
        assert (st_.work, st_.depth) == (want.work, want.depth)
        assert st_.depth <= math.ceil(math.log2(n)) + k
        if prev_work is not None:
            assert st_.work <= prev_work
        prev_work = st_.work


def test_brent_kung_counts():
    for n in POW2:
        lg = int(math.log2(n))
        st_ = _stats("brent_kung", n)
        assert st_.work == 2 * n - 2 - lg
        assert st_.depth == (1 if n == 2 else 2 * lg - 2)


def test_sklansky_depth_optimal():
    for n in POW2:
        lg = int(math.log2(n))
        st_ = _stats("sklansky", n)
        assert st_.depth == lg
        assert st_.work == (n // 2) * lg


def test_multicast_only_in_lf_sklansky():
    """Point-to-point circuits must have fanout 1 (ppermute-lowerable)."""
    for name in ["sequential", "dissemination", "brent_kung"]:
        for n in POW2:
            assert _stats(name, n).max_fanout == 1, name
    # LF/Sklansky use broadcast rounds (MPI_Bcast / all_gather).
    assert _stats("ladner_fischer", 64).max_fanout > 1
    assert _stats("sklansky", 64).max_fanout > 1


def test_structural_validation():
    for name in ALL:
        for n in [2, 3, 5, 8, 13, 64, 100]:
            if name == "blelloch" and n & (n - 1):
                continue
            c = get_circuit(name, n)
            c.validate()
            assert c.rounds == ref.get_circuit(name, n).rounds


@settings(max_examples=40, deadline=None)
@given(
    n=st.integers(2, 80),
    name=st.sampled_from(["sequential", "dissemination", "ladner_fischer",
                          "brent_kung", "sklansky"]),
)
def test_circuit_correct_noncommutative(n, name):
    """Every circuit computes the inclusive scan of a *non-commutative* op,
    as the reference's executor does."""
    xs = [f"<{i}>" for i in range(n)]
    ys, _ = python_exec(operator.add, get_circuit(name, n), xs)
    assert ys == ["".join(xs[: i + 1]) for i in range(n)]
    assert ys == ref_python_exec(operator.add, ref.get_circuit(name, n), xs)[0]


@settings(max_examples=20, deadline=None)
@given(p=st.integers(1, 7))
def test_blelloch_exclusive_semantics(p):
    n = 2 ** p
    xs = [f"<{i}>" for i in range(n)]
    ys, total = python_exec(operator.add, blelloch_circuit(n), xs)
    assert total == "".join(xs)
    # Exclusive: position i holds the product of elements 0..i-1 (i >= 1).
    for i in range(1, n):
        assert ys[i] == "".join(xs[:i])
    assert (ys, total) == ref_python_exec(operator.add, ref.blelloch_circuit(n),
                                          xs)
