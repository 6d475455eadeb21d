"""Port parity: ``repro_torch.kernels._tiling`` against
``repro.kernels._tiling``, bit for bit, and the scan kernels' op table
(``repro_torch.kernels.op_table``).

Inputs are made with numpy from a seed and handed to both packages; every
comparison is exact (``array_equal``): packing, padding, flag lanes and the
one-hot round matrices are reshapes, concatenations and selections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.deformation as rdef
import repro.kernels._tiling as rt
import repro_torch.core.deformation as tdef
import repro_torch.kernels._tiling as tt
from repro.core.engine import get_plan as ref_get_plan
from repro_torch.core._tree import tree_flatten
from repro_torch.core.engine import get_plan
from repro_torch.kernels.op_table import (
    KernelOpError,
    check_kernel_row,
    kernel_op_for,
    kernel_op_of,
)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _trees(seed):
    """Numpy pytrees of one leading axis n=7: a deformation stack, a
    single leaf, a nested dict with a tuple, mixed dtypes."""
    rng = np.random.default_rng(seed)
    n = 7
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)
    return [
        {"shift": f(2), "angle": f()},           # unsorted keys: sorted packing
        f(3),
        f(),
        {"b": (f(2, 2), f()), "a": f(1)},
        {"i": rng.integers(-5, 5, (n, 2)).astype(np.int32), "x": f(2)},
    ]


def _to_j(tree):
    if isinstance(tree, dict):
        return {k: _to_j(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_j(v) for v in tree)
    return jnp.asarray(tree)


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_t(v) for v in tree)
    return torch.as_tensor(tree)


@pytest.mark.parametrize("n", list(range(0, 70)) + [255, 256, 4096, 10**6])
def test_default_num_tiles_matches_reference(n):
    assert tt.default_num_tiles(n) == rt.default_num_tiles(n)


@pytest.mark.parametrize("n", [1, 255, 4096, 4097, 2**20, 2**24 + 3])
def test_default_num_tiles_cuda_sizes_tiles_to_one_block(n):
    t = tt.default_num_tiles_cuda(n)
    k = -(-n // t)
    assert t >= 1 and k <= tt.CUDA_TILE_ROWS
    assert t == 1 or -(-n // (t - 1)) > tt.CUDA_TILE_ROWS


@pytest.mark.parametrize("n,t", [(10, 3), (12, 4), (7, 7), (5, 8), (1, 1)])
def test_pad_rows_matches_reference(n, t):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    got, gn = tt.pad_rows(torch.as_tensor(x), t)
    want, wn = rt.pad_rows(jnp.asarray(x), t)
    assert gn == wn == n
    _eq(got, want)


@pytest.mark.parametrize("which", range(5))
def test_pack_unpack_matches_reference(which):
    tree = _trees(which)[which]
    got, gspec = tt.pack_leaves(_to_t(tree))
    want, wspec = rt.pack_leaves(_to_j(tree))
    _eq(got, want)
    assert gspec.widths == wspec.widths and gspec.tails == wspec.tails
    assert gspec.dim == wspec.dim
    back = tt.unpack_leaves(got, gspec)
    wback = rt.unpack_leaves(want, wspec)
    for g, w in zip(tree_flatten(back)[0], jax.tree.leaves(wback)):
        _eq(g, w)


@pytest.mark.parametrize("which", range(5))
def test_pack_element_matches_reference(which):
    tree = _trees(which)[which]
    _, gspec = tt.pack_leaves(_to_t(tree))
    _, wspec = rt.pack_leaves(_to_j(tree))
    pick = lambda t: (
        {k: pick(v) for k, v in t.items()} if isinstance(t, dict)
        else tuple(pick(v) for v in t) if isinstance(t, tuple) else t[3]
    )
    _eq(tt.pack_element(_to_t(pick(tree)), gspec),
        rt.pack_element(_to_j(pick(tree)), wspec))


def test_deformation_packs_as_angle_then_shift():
    d = {"shift": np.array([[1.0, 2.0]], np.float32),
         "angle": np.array([0.5], np.float32)}
    got, spec = tt.pack_leaves(_to_t(d))
    _eq(got, np.array([[0.5, 1.0, 2.0]], np.float32))
    assert spec.widths == (1, 2)


def test_packed_op_matches_reference():
    rng = np.random.default_rng(3)
    a = {"angle": rng.normal(size=9).astype(np.float32) * 0.1,
         "shift": rng.normal(size=(9, 2)).astype(np.float32)}
    b = {"angle": rng.normal(size=9).astype(np.float32) * 0.1,
         "shift": rng.normal(size=(9, 2)).astype(np.float32)}
    ga, gspec = tt.pack_leaves(_to_t(a))
    gb, _ = tt.pack_leaves(_to_t(b))
    wa, wspec = rt.pack_leaves(_to_j(a))
    wb, _ = rt.pack_leaves(_to_j(b))
    got = tt.packed_op(tdef.compose_batched, gspec)(ga, gb)
    want = rt.packed_op(rdef.compose_batched, wspec)(wa, wb)
    # Same function, two libraries' cos/sin: equal to float32 rounding.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # Packing itself is exact: the packed op equals the unpacked op.
    direct = tdef.compose_batched(_to_t(a), _to_t(b))
    _eq(got[:, 0], direct["angle"].numpy())
    _eq(got[:, 1:], direct["shift"].numpy())


@pytest.mark.parametrize("mask", [None, [True, False, True, True, False],
                                  [False] * 5, [True] * 5])
def test_add_flag_lane_matches_reference(mask):
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    _eq(tt.add_flag_lane(torch.as_tensor(x), mask),
        rt.add_flag_lane(jnp.asarray(x), mask))
    if mask is not None:
        _eq(tt.add_flag_lane(torch.as_tensor(x), torch.tensor(mask)),
            rt.add_flag_lane(jnp.asarray(x), mask))


def test_lift_masked_matches_reference():
    rng = np.random.default_rng(4)
    a = rng.integers(-9, 10, (16, 3)).astype(np.float32)
    b = rng.integers(-9, 10, (16, 3)).astype(np.float32)
    a[:, -1] = np.tile([0.0, 1.0, 0.0, 1.0], 4)
    b[:, -1] = np.repeat([0.0, 1.0, 0.0, 1.0], 4)
    got = tt.lift_masked(torch.add)(torch.as_tensor(a), torch.as_tensor(b))
    want = rt.lift_masked(jnp.add)(jnp.asarray(a), jnp.asarray(b))
    _eq(got, want)


@pytest.mark.parametrize("alg", ["ladner_fischer", "sklansky", "blelloch"])
@pytest.mark.parametrize("n", [4, 8])
def test_build_round_matrices_matches_reference(alg, n):
    for rnd, wrnd in zip(get_plan(alg, n).rounds, ref_get_plan(alg, n).rounds):
        for g, w in zip(tt.build_round_matrices(rnd, n),
                        rt.build_round_matrices(wrnd, n)):
            assert (g is None) == (w is None)
            if g is not None:
                _eq(g, w)


# ------------------------------------------------------------- op table


def test_kernel_op_of_table():
    assert kernel_op_of(torch.add) == "add"
    import operator

    assert kernel_op_of(operator.add) == "add"
    assert kernel_op_of(tdef.compose_batched) == "rigid_compose"
    assert kernel_op_of(lambda a, b: a + b) is None
    tagged = lambda a, b: a + b
    tagged.kernel_op = "add"
    assert kernel_op_of(tagged) == "add"
    tagged.kernel_op = "nope"
    assert kernel_op_of(tagged) is None


def test_kernel_op_for_checks_the_data():
    f = lambda *s: torch.zeros(s)
    dfm = {"angle": f(5), "shift": f(5, 2)}
    assert kernel_op_for(tdef.compose_batched, dfm) == "rigid_compose"
    assert kernel_op_for(tdef.compose_batched, {"angle": f(5)}) is None
    assert kernel_op_for(torch.add, f(5)) == "add"
    assert kernel_op_for(torch.add, f(5, 4)) == "add"
    assert kernel_op_for(torch.add, f(5, 5)) is None          # too wide
    assert kernel_op_for(torch.add, f(5).double()) is None    # not f32
    assert kernel_op_for(lambda a, b: a + b, f(5)) is None


def test_packed_and_lifted_ops_keep_the_entry():
    _, spec = tt.pack_leaves({"angle": torch.zeros(3), "shift": torch.zeros(3, 2)})
    pop = tt.packed_op(tdef.compose_batched, spec)
    assert kernel_op_of(pop) == "rigid_compose"
    lifted = tt.lift_masked(pop)
    assert kernel_op_of(lifted) == "rigid_compose" and lifted.kernel_masked
    _, other = tt.pack_leaves({"angle": torch.zeros(3), "s": torch.zeros(3, 2)})
    assert kernel_op_of(tt.packed_op(tdef.compose_batched, other)) is None
    assert check_kernel_row(lifted, 4, masked=True) == "rigid_compose"


@pytest.mark.parametrize("op,d,masked", [
    (lambda a, b: a + b, 1, False),
    (torch.add, 5, False),
    (torch.add, 0, False),
    (tdef.compose_batched, 2, False),
])
def test_check_kernel_row_raises_naming_the_table(op, d, masked):
    with pytest.raises(KernelOpError, match="rigid_compose"):
        check_kernel_row(op, d, masked)
