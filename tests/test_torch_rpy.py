"""Port parity of the RPY mobility: the plain PyTorch sweep against the
numpy oracle in float64, and the pair-sweep wrappers (kernels K1/K2's
contract) against the Pallas kernels run in interpret mode in float32."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
from rigid_body_light_tpu.ops import rpy_pallas  # noqa: E402
from rigid_body_light_tpu_torch.ops import cuda_build, rpy, rpy_cuda  # noqa: E402

A, ETA = 0.9, 1.3
# float32 kernel vs its reference, relative to max|U| — the bound
# tests/test_pallas.py holds the TPU kernel to against a float64 oracle
KERNEL_TOL = 5e-6


@pytest.fixture
def cloud():
    """150 blobs whose heights straddle the wall floor h_floor = 0.75a
    (z/a from 0.33 to 7.8), so pairs of unequal, floored and unfloored
    heights all occur."""
    rng = np.random.default_rng(7)
    r = rng.uniform([-4, -4, 0.3], [4, 4, 7], (150, 3))
    F = rng.standard_normal((2, 150, 3))
    return r, F


def _rel(U, Uref):
    return np.abs(np.asarray(U) - Uref).max() / np.abs(Uref).max()


@pytest.mark.parametrize("wall", [False, True])
def test_plain_mobility_apply_matches_oracle(cloud, wall):
    r, F = cloud
    Uref = oracle.apply_M(F[0], r, A, ETA, wall).reshape(-1, 3)
    U = rpy.mobility_apply(torch.from_numpy(F[0]), torch.from_numpy(r), A,
                           ETA, wall, row_tile=64)
    assert _rel(U, Uref) < 1e-12


@pytest.mark.parametrize("wall", [False, True])
def test_plain_multi_matches_oracle(cloud, wall):
    r, F = cloud
    U = rpy.mobility_apply_multi(torch.from_numpy(F), torch.from_numpy(r), A,
                                 ETA, wall, row_tile=64)
    for k in range(2):
        Uref = oracle.apply_M(F[k], r, A, ETA, wall).reshape(-1, 3)
        assert _rel(U[k], Uref) < 1e-12


@pytest.mark.parametrize("wall", [False, True])
def test_plain_mobility_matrix_matches_oracle(cloud, wall):
    r, _ = cloud
    Mref = oracle.rpy_matrix(r[:60], A, ETA, wall)
    M = rpy.mobility_matrix(torch.from_numpy(r[:60]), A, ETA, wall)
    assert _rel(M, Mref) < 1e-12


def test_plain_pair_sum_slab_offsets(cloud):
    """An ordered row slab with global ids (K2's row/column-offset
    contract) equals the matching rows of the square sweep."""
    r, F = cloud
    r_t, F_t = torch.from_numpy(r / A), torch.from_numpy(F)
    ids = torch.arange(150)
    full = rpy.pair_sum(r_t, ids, r_t, ids, F_t, wall=True)
    lo, hi = 40, 110
    slab = rpy.pair_sum(r_t[lo:hi], ids[lo:hi], r_t, ids, F_t, wall=True)
    np.testing.assert_allclose(slab.numpy(), full[:, lo:hi].numpy(),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("wall", [False, True])
def test_k1_wrapper_matches_pallas_kernel(cloud, wall):
    """Single RHS: rpy_cuda.mobility_apply (K1's path) against
    rpy_pallas.mobility_apply → _kernel_sym, interpret mode, float32."""
    r, F = cloud
    r32, F32 = r.astype(np.float32), F[0].astype(np.float32)
    Uref = np.asarray(rpy_pallas.mobility_apply(
        jnp.asarray(F32), jnp.asarray(r32), A, ETA, wall, interpret=True))
    U = rpy_cuda.mobility_apply(torch.from_numpy(F32), torch.from_numpy(r32),
                                A, ETA, wall)
    assert U.dtype == torch.float32
    assert _rel(U, Uref.astype(np.float64)) < KERNEL_TOL


@pytest.mark.parametrize("wall", [False, True])
def test_k2_wrapper_matches_pallas_kernel(cloud, wall):
    """Two RHS: rpy_cuda.mobility_apply_multi (K2's path) against
    rpy_pallas.mobility_apply_multi → _kernel (150 blobs pad far below
    _SYM_K2_MIN_NPAD), interpret mode, float32."""
    r, F = cloud
    r32, F32 = r.astype(np.float32), F.astype(np.float32)
    Uref = np.asarray(rpy_pallas.mobility_apply_multi(
        jnp.asarray(F32), jnp.asarray(r32), A, ETA, wall, interpret=True))
    U = rpy_cuda.mobility_apply_multi(torch.from_numpy(F32),
                                      torch.from_numpy(r32), A, ETA, wall)
    assert U.shape == (2, 150, 3)
    assert _rel(U, Uref.astype(np.float64)) < KERNEL_TOL


@pytest.mark.parametrize("kwargs", [
    dict(box_over_a=(10.0, 10.0)),
    dict(box_over_a=(10.0, 10.0), image_shells=2),
    dict(box_over_a=(10.0, 10.0), image_shells=1, image_tail=False),
])
def test_wrapper_raises_on_unported_options(kwargs):
    """Per-blob radii with the pseudo-2D box, the options the wrapper
    refused before K1's and K2's POLY × box forms: on a CPU tensor, 1 and 2
    RHS, the float32 wrapper against the JAX package's float64 XLA sweep
    with the same radii, box and images, within the kernels' bound, with
    no kernel launch counted.  (The card's forms:
    tests/test_torch_cuda.py; the Pallas kernels in interpret mode:
    tests/test_torch_poly_film.py.)"""
    from rigid_body_light_tpu.ops import rpy as rpy_j

    rng = np.random.default_rng(3)
    r = rng.uniform([0.5, 0.5, 0.4], [9.5, 9.5, 4.0], (40, 3))
    ahat = rng.choice([0.6, 1.1], 40)
    F = rng.standard_normal((2, 40, 3))
    r32, a32, F32 = (x.astype(np.float32).astype(np.float64)
                     for x in (r, ahat, F))
    ids = jnp.arange(40)
    box = kwargs["box_over_a"]
    S = kwargs.get("image_shells", 0)
    before = rpy_cuda.launch_counts()
    for k in (1, 2):
        Fk = F32[:k] if k == 2 else F32[0]
        U = rpy_cuda.pair_sum(torch.from_numpy(r32), torch.from_numpy(Fk),
                              True, ahat=torch.from_numpy(a32), **kwargs)
        Uref = np.asarray(rpy_j.pair_sum(
            jnp.asarray(r32), ids, jnp.asarray(r32), ids,
            jnp.asarray(F32[:k]), wall=True, box=box, radii_rows=a32,
            radii_cols=a32, image_shells=S,
            image_tail=kwargs.get("image_tail", True)))
        assert U.dtype == torch.float32 and U.shape == Fk.shape
        assert _rel(U.reshape(k, 40, 3), Uref) < KERNEL_TOL
    assert rpy_cuda.launch_counts() == before


def test_wrapper_raises_on_three_rhs():
    r = torch.rand(8, 3) + 1.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rpy_cuda.pair_sum(r, torch.rand(3, 8, 3), True)


def test_wrapper_has_no_fallback_off_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, never
    routed to the plain sweep; the launch counters do not move."""
    r = torch.empty(8, 3, device="meta")
    before = rpy_cuda.launch_counts()
    with pytest.raises(ValueError, match="device"):
        rpy_cuda.pair_sum(r, torch.empty(8, 3, device="meta"), True)
    assert rpy_cuda.launch_counts() == before


def test_kernel_launchers_require_cuda_tensors():
    r = torch.rand(8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        rpy_cuda.pair_sweep_sym(r, torch.rand(8, 3), True, 0.75)
    with pytest.raises(ValueError, match="CUDA"):
        rpy_cuda.pair_sweep_ordered(r, 0, r, torch.rand(2, 8, 3), 0, True,
                                    0.75)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 512, 513, 65024, 65025, 65535, 65536,
                               65537, 102480])
def test_k_routing_follows_the_pallas_wrapper(k, n):
    """A square k-RHS sweep takes the symmetric kernel (K1) exactly where
    rpy_pallas.pair_sum sends it to _kernel_sym (rpy_pallas.py:623)."""
    n_pad = -(-n // rpy_pallas.TC) * rpy_pallas.TC
    want = rpy_pallas.USE_SYM and (k == 1
                                   or n_pad >= rpy_pallas._SYM_K2_MIN_NPAD)
    assert rpy_cuda.uses_sym(k, n) == want


def test_kernel_build_uses_ieee_math():
    """The kernels are built for sm_90a without fast math, and the sources
    use no approximate division (approximate reciprocals floor GMRES)."""
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for name in (*cuda_build.SOURCES.values(), *cuda_build.HEADERS):
        with open(os.path.join(cuda_build.CSRC, name)) as f:
            src = f.read()
        assert "__fdividef(" not in src and "__frcp" not in src, name
