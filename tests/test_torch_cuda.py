"""The CUDA pair sweeps on the card, against the plain PyTorch sweep.

Marked ``cuda``: they skip without a CUDA device.  The GPU machine has no
JAX, so run them there without the JAX test harness's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rigid_body_light_tpu_torch.ops import rpy, rpy_cuda  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 5e-6   # float32 kernel vs float64 plain sweep, relative to max|U|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the pair-sweep kernels run only there")
    rpy_cuda.build()
    return torch.device("cuda", 0)


@pytest.fixture
def cloud(dev):
    """700 blobs (units of a) whose heights straddle the 0.75a floor."""
    rng = np.random.default_rng(1)
    r = rng.uniform([-10, -10, 0.3], [10, 10, 7], (700, 3))
    F = rng.standard_normal((2, 700, 3))
    return torch.from_numpy(r).to(dev), torch.from_numpy(F).to(dev)


def _rel(U, ref):
    return ((U.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("wall", [False, True])
def test_k1_matches_plain(cloud, wall):
    r, F = cloud
    ids = torch.arange(r.shape[0], device=r.device)
    ref = rpy.pair_sum(r, ids, r, ids, F[0], wall=wall)
    U = rpy_cuda.pair_sweep_sym(r.float().contiguous(),
                                F[0].float().contiguous(), wall, 0.75)
    torch.cuda.synchronize()
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_k2_slab_matches_plain(cloud, wall, k):
    """Rows 100..399 against all columns, with the global row offset."""
    r, F = cloud
    ids = torch.arange(r.shape[0], device=r.device)
    ref = rpy.pair_sum(r[100:400], ids[100:400], r, ids, F[:k], wall=wall)
    r32 = r.float().contiguous()
    U = rpy_cuda.pair_sweep_ordered(r32[100:400].contiguous(), 100, r32,
                                    F[:k].float().contiguous(), 0, wall, 0.75)
    torch.cuda.synchronize()
    assert U.shape == (k, 300, 3)
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("n", [1, 2, 31, 33, 129, 515])
def test_ragged_sizes_match_plain(dev, n):
    """Sizes off every tile edge (32-column sub-tiles, 128-row tiles,
    512-column chunks, 32-row and 256-column K2 tiles)."""
    rng = np.random.default_rng(n)
    r = torch.from_numpy(rng.uniform([-6, -6, 0.3], [6, 6, 5], (n, 3))).to(dev)
    F = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev)
    ids = torch.arange(n, device=dev)
    r32, F32 = r.float().contiguous(), F.float().contiguous()
    U1 = rpy_cuda.pair_sweep_sym(r32, F32[0], True, 0.75)
    U2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, True, 0.75)
    torch.cuda.synchronize()
    ref = rpy.pair_sum(r, ids, r, ids, F, wall=True)
    if n == 1:   # no pairs: exact zeros
        assert not U1.any() and not U2.any()
        return
    assert _rel(U1, ref[0]) < TOL
    assert _rel(U2, ref) < TOL


def test_k2_block_offsets_match_plain(cloud):
    """A row block × column block of the pair matrix with both global
    offsets (the 2-D sharded-slab contract), self pairs inside the
    overlap masked."""
    r, F = cloud
    ids = torch.arange(r.shape[0], device=r.device)
    rows, cols = slice(100, 400), slice(250, 650)
    ref = rpy.pair_sum(r[rows], ids[rows], r[cols], ids[cols], F[:, cols],
                       wall=True)
    r32 = r.float()
    U = rpy_cuda.pair_sweep_ordered(
        r32[rows].contiguous(), 100, r32[cols].contiguous(),
        F[:, cols].float().contiguous(), 250, True, 0.75)
    torch.cuda.synchronize()
    assert _rel(U, ref) < TOL


def test_k1_is_repeatable_and_counted(cloud):
    r, F = cloud
    r32, F32 = r.float().contiguous(), F[0].float().contiguous()
    before = rpy_cuda.sym_launches
    U1 = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75)
    U2 = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75)
    assert rpy_cuda.sym_launches == before + 2
    assert torch.equal(U1, U2)   # no atomics: bitwise repeatable


def test_kernel_refuses_float64(cloud):
    r, F = cloud
    with pytest.raises(TypeError, match="float32"):
        rpy_cuda.pair_sweep_sym(r, F[0], True, 0.75)
