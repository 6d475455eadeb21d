"""Port parity: ``warp_ncc_reference`` (the CUDA kernel's plain version)
against the reference's Pallas ``warp_ncc`` in interpret mode, with the
reference test's own parameters and tolerances (tests/test_kernels.py:
1e-4 on the warped image, atol=1e-5 on the ncc).  The kernel itself runs
only on a card: tests/test_torch_gpu.py."""

import jax
import numpy as np
import pytest
import torch

from repro.core.deformation import make_deformation, ncc as ncc_ref_fn, warp
from repro.data.images import lattice_image
from repro.kernels.warp_ncc import warp_ncc as warp_ncc_pallas
from repro_torch.kernels import launch_counts, warp_ncc as wn

CASES = [(0.0, (3.0, -2.0)), (0.07, (1.5, 0.7)), (-0.1, (-4.0, 2.5))]


@pytest.fixture(scope="module")
def images():
    img = np.array(lattice_image(64, key=jax.random.PRNGKey(0)))
    ref_img = np.array(lattice_image(64, key=jax.random.PRNGKey(1)))
    return img, ref_img


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("ang,shift", CASES)
def test_plain_matches_pallas_interpret(images, tile, ang, shift):
    img, ref_img = images
    w_j, ncc_j = warp_ncc_pallas(img, ref_img, ang, shift, tile=tile,
                                 interpret=True)
    w_t, ncc_t = wn.warp_ncc_reference(
        torch.from_numpy(img), torch.from_numpy(ref_img),
        torch.tensor(ang), torch.tensor(shift), tile=tile,
    )
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(ncc_t), float(ncc_j), atol=1e-5)
    # and the reference's own oracle (deformation.warp + ncc)
    w_ref = warp(img, make_deformation(ang, list(shift)))
    np.testing.assert_allclose(float(ncc_t), float(ncc_ref_fn(w_ref, ref_img)),
                               atol=1e-5)


@pytest.mark.parametrize("tile", [16, 32])
def test_heavy_clamp_matches_pallas(images, tile):
    """Most samples fall past the border: floor and clamp at the edge."""
    img, ref_img = images
    ang, shift = 0.6, (40.0, -55.0)
    w_j, ncc_j = warp_ncc_pallas(img, ref_img, ang, shift, tile=tile,
                                 interpret=True)
    w_t, ncc_t = wn.warp_ncc_reference(
        torch.from_numpy(img), torch.from_numpy(ref_img), ang, shift, tile=tile
    )
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(ncc_t), float(ncc_j), atol=1e-5)


@pytest.mark.parametrize("tile", [16, 32])
def test_sums_layout(images, tile):
    """(n_tiles, 8) row-major tile order: Σa, Σb, Σa², Σb², Σab, area, 0, 0."""
    img, ref_img = images
    w, sums = wn.warp_ncc_sums_reference(
        torch.from_numpy(img), torch.from_numpy(ref_img), 0.07, (1.5, 0.7),
        tile=tile,
    )
    nt = 64 // tile
    assert sums.shape == (nt * nt, 8)
    a, b = w.double(), torch.from_numpy(ref_img).double()
    blk = lambda x, i, j: x[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
    for i in range(nt):
        for j in range(nt):
            row = sums[i * nt + j].double()
            want = [blk(a, i, j).sum(), blk(b, i, j).sum(),
                    (blk(a, i, j) ** 2).sum(), (blk(b, i, j) ** 2).sum(),
                    (blk(a, i, j) * blk(b, i, j)).sum()]
            np.testing.assert_allclose(row[:5].numpy(), np.array(want), rtol=1e-5, atol=1e-4)
            assert float(row[5]) == tile * tile
            assert float(row[6]) == 0.0 and float(row[7]) == 0.0


def test_cpu_route_takes_plain_version_without_launching(images):
    img, ref_img = images
    before = launch_counts().get("warp_ncc", 0)
    w1, n1 = wn.warp_ncc(torch.from_numpy(img), torch.from_numpy(ref_img), 0.07, (1.5, 0.7))
    w2, n2 = wn.warp_ncc_reference(torch.from_numpy(img), torch.from_numpy(ref_img), 0.07, (1.5, 0.7))
    assert torch.equal(w1, w2) and torch.equal(n1, n2)
    assert launch_counts().get("warp_ncc", 0) == before


@pytest.mark.parametrize("shape,tile", [((64, 48), 32), ((64, 64), 8), ((40, 40), 16)])
def test_shape_and_tile_checks_raise(shape, tile):
    x = torch.zeros(shape)
    with pytest.raises(ValueError):
        wn.warp_ncc(x, x, 0.0, (0.0, 0.0), tile=tile)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA entry never falls back: CPU tensors raise there."""
    x = torch.zeros((32, 32))
    with pytest.raises(ValueError, match="is on cpu"):
        wn.warp_ncc_sums_cuda(x, x, 0.0, (0.0, 0.0), tile=32)


def test_fold_matches_reference_host_fold(images):
    img, ref_img = images
    _, sums = wn.warp_ncc_sums_reference(
        torch.from_numpy(img), torch.from_numpy(ref_img), -0.1, (-4.0, 2.5), tile=16
    )
    s = sums.double().sum(0)
    n = s[5]
    cov = s[4] - s[0] * s[1] / n
    va = s[2] - s[0] ** 2 / n
    vb = s[3] - s[1] ** 2 / n
    want = cov / (torch.sqrt(va * vb) + 1e-6)
    np.testing.assert_allclose(float(wn.fold(sums)), float(want), atol=1e-5)
