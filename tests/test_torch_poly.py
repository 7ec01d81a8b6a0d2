"""Port parity of the polydisperse RPY mobility (per-blob radii) against the
JAX package on the CPU: the ``ops/rpy.py`` twin in float64 (the apply, the
dense matrix, the RAS coupling blocks and the pseudo-2D box's self-image
sum), the kernels' wrapper ``rpy_cuda`` (the contract of K1's and K2's POLY
forms) against the Pallas kernels run in interpret mode in float32, and
equal radii reducing to the monodisperse form.

The cloud draws its radii from {0.6, 1.1}·a (``tests/test_pallas.py``'s
choice) and holds a near-coincident pair of unequal radii (the deep branch
r < |aᵢ − aⱼ|) and an overlapping one, with heights straddling the
wall-height floor in units of either radius.  The JAX references are
compiled at XLA's cheapest CPU optimization (:func:`jax_fast`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu.ops import rpy as rpy_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy_pallas  # noqa: E402
from rigid_body_light_tpu_torch import SimulationConfig  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald, rpy, rpy_cuda, saddle  # noqa: E402

A, ETA = 0.4, 1.3
# float64 twin against the JAX package, relative to the largest entry
TWIN_TOL = 1e-12
# equal radii against the monodisperse form, relative: float64, and the
# float32 wrapper (the poly and mono fields round differently)
EQUAL_TOL = 1e-10
EQUAL_TOL_F32 = 2e-6
# float32 wrapper against the Pallas kernels in interpret mode: the bounds
# of tests/test_polydisperse.py::test_poly_pallas_interpret_matches_xla
RTOL, ATOL = 3e-5, 1e-6
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with :data:`FAST_COMPILE`: about half
    the compile time, results within roundoff of the default compile's."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def poly_cloud(n=48, seed=5):
    """n blobs in a 4a-wide box, heights from 0.3a, radii from {0.6, 1.1}·a;
    blob 1 sits 0.02a from blob 0 with the other radius (r < |aᵢ − aⱼ|)
    and blob 3 0.8a from blob 2 (the overlap branch)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform([-2, -2, 0.12], [2, 2, 2.4], (n, 3))
    radii = rng.choice([0.6 * A, 1.1 * A], n)
    radii[0], radii[1] = 0.6 * A, 1.1 * A
    radii[2], radii[3] = 1.1 * A, 0.6 * A
    r[1] = r[0] + [0.02 * A, 0.0, 0.0]
    r[3] = r[2] + [0.0, 0.8 * A, 0.0]
    F = rng.standard_normal((2, n, 3))
    return r, radii, F


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


def _branches(r, radii):
    """Counts of the cloud's pairs in the far / overlap / deep branches."""
    d = np.linalg.norm(r[:, None] - r[None], axis=-1)
    s = radii[:, None] + radii[None]
    df = np.abs(radii[:, None] - radii[None])
    off = ~np.eye(len(r), dtype=bool)
    return ((d >= s) & off).sum(), ((d < s) & (d >= df) & off).sum(), \
        ((d < df) & off).sum()


def test_cloud_takes_every_branch():
    far, overlap, deep = _branches(*poly_cloud()[:2])
    assert far > 0 and overlap > 0 and deep >= 2


@pytest.mark.parametrize("wall", [False, True])
def test_twin_apply_matches_jax(wall):
    r, radii, F = poly_cloud()
    U_j = jax_fast(lambda F_, r_, a_: rpy_j.mobility_apply_multi(
        F_, r_, a=A, eta=ETA, wall=wall, radii=a_, row_tile=16),
        jnp.asarray(F), jnp.asarray(r), jnp.asarray(radii))
    U_t = rpy.mobility_apply_multi(torch.from_numpy(F), torch.from_numpy(r),
                                   A, ETA, wall, row_tile=16,
                                   radii=torch.from_numpy(radii))
    assert _rel(U_t, U_j) < TWIN_TOL


@pytest.mark.parametrize("wall", [False, True])
def test_twin_matrix_matches_jax(wall):
    r, radii, _ = poly_cloud()
    M_j = jax_fast(lambda r_, a_: rpy_j.mobility_matrix(
        r_, A, ETA, wall, radii=a_), jnp.asarray(r), jnp.asarray(radii))
    M_t = rpy.mobility_matrix(torch.from_numpy(r), A, ETA, wall,
                              radii=torch.from_numpy(radii))
    assert _rel(M_t, M_j) < TWIN_TOL
    np.testing.assert_allclose(M_t.numpy(), M_t.numpy().T, atol=1e-13)


@pytest.mark.parametrize("wall", [False, True])
def test_twin_cross_blocks_match_jax(wall):
    """Batched (…, P, Q) blocks with per-pair radii, as the mixture RAS
    halos build them; the self and damping factors with radii beside."""
    r, radii, _ = poly_cloud()
    ri, rj = r[:24].reshape(3, 8, 3), r[24:].reshape(3, 8, 3)
    ai, aj = radii[:24].reshape(3, 8), radii[24:].reshape(3, 8)
    C_j = jax_fast(lambda ri_, rj_, ai_, aj_: rpy_j.cross_mobility_blocks(
        ri_, rj_, A, ETA, wall=wall, radii_i=ai_, radii_j=aj_),
        *(jnp.asarray(x) for x in (ri, rj, ai, aj)))
    C_t = rpy.cross_mobility_blocks(torch.from_numpy(ri), torch.from_numpy(rj),
                                    A, ETA, wall=wall,
                                    radii_i=torch.from_numpy(ai),
                                    radii_j=torch.from_numpy(aj))
    assert C_t.shape == (3, 8, 8, 3, 3)
    assert _rel(C_t, C_j) < TWIN_TOL
    S_j = rpy_j.self_mobility_blocks(jnp.asarray(r), A, ETA, wall,
                                     radii=jnp.asarray(radii))
    S_t = rpy.self_mobility_blocks(torch.from_numpy(r), A, ETA, wall,
                                   radii=torch.from_numpy(radii))
    assert _rel(S_t, S_j) < TWIN_TOL
    b_j = rpy_j.damping_factors(jnp.asarray(r), A, radii=jnp.asarray(radii))
    b_t = rpy.damping_factors(torch.from_numpy(r), A, torch.from_numpy(radii))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("wall", [False, True])
def test_twin_box_self_images_match_jax(wall):
    """Poly × the pseudo-2D box: every blob against its own images at
    S = 2 (the diagonal K1's box form leaves to the wrapper), which only
    the twin computes for radii."""
    r, radii, F = poly_cloud()
    box_n = (3.0 / A, 2.6 / A)
    S_j = jax_fast(lambda r_, F_, a_: rpy_j.self_image_sum(
        r_, F_, wall, box_n, 2, ahat=a_), jnp.asarray(r / A), jnp.asarray(F),
        jnp.asarray(radii / A))
    S_t = rpy.self_image_sum(torch.from_numpy(r / A), torch.from_numpy(F),
                             wall, box_n, 2, ahat=torch.from_numpy(radii / A))
    assert _rel(S_t, S_j) < TWIN_TOL


@pytest.mark.parametrize("wall", [False, True])
def test_equal_radii_reduce_to_mono(wall):
    """Radii all equal to a: the poly forms of the twin (apply, matrix,
    cross blocks) equal the monodisperse ones within 1e-10, the float32
    wrapper's within float32 rounding."""
    r, _, F = poly_cloud()
    r_t, F_t = torch.from_numpy(r), torch.from_numpy(F)
    eq = torch.full((r.shape[0],), A, dtype=torch.float64)
    for poly, mono in (
            (rpy.mobility_apply_multi(F_t, r_t, A, ETA, wall, radii=eq),
             rpy.mobility_apply_multi(F_t, r_t, A, ETA, wall)),
            (rpy.mobility_matrix(r_t, A, ETA, wall, radii=eq),
             rpy.mobility_matrix(r_t, A, ETA, wall)),
            (rpy.cross_mobility_blocks(r_t[:20], r_t[20:], A, ETA, wall,
                                       radii_i=eq[:20], radii_j=eq[20:]),
             rpy.cross_mobility_blocks(r_t[:20], r_t[20:], A, ETA, wall))):
        assert _rel(poly, mono) < EQUAL_TOL
    U1 = rpy_cuda.mobility_apply_multi(F_t.float(), r_t.float(), A, ETA, wall,
                                       radii=eq.float())
    U0 = rpy_cuda.mobility_apply_multi(F_t.float(), r_t.float(), A, ETA, wall)
    assert _rel(U1, U0) < EQUAL_TOL_F32


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_wrapper_matches_pallas_poly_kernels(wall, k):
    """rpy_cuda.mobility_apply(_multi) with radii (the POLY forms' contract:
    ahat = radii/a, damping min(z/aᵢ, 1), the self term at aᵢ) against
    rpy_pallas with radii in interpret mode, float32: k = 1 reaches
    _kernel_sym, k = 2 _kernel (48 blobs pad far below _SYM_K2_MIN_NPAD)."""
    r, radii, F = poly_cloud()
    r32, a32 = r.astype(np.float32), radii.astype(np.float32)
    F32 = F[:k].astype(np.float32)
    if k == 1:
        U_j = jax_fast(lambda F_, r_, a_: rpy_pallas.mobility_apply(
            F_, r_, A, ETA, wall, radii=a_, interpret=True),
            jnp.asarray(F32[0]), jnp.asarray(r32), jnp.asarray(a32))[None]
        U_t = rpy_cuda.mobility_apply(torch.from_numpy(F32[0]),
                                      torch.from_numpy(r32), A, ETA, wall,
                                      radii=torch.from_numpy(a32))[None]
    else:
        U_j = jax_fast(lambda F_, r_, a_: rpy_pallas.mobility_apply_multi(
            F_, r_, A, ETA, wall, radii=a_, interpret=True),
            jnp.asarray(F32), jnp.asarray(r32), jnp.asarray(a32))
        U_t = rpy_cuda.mobility_apply_multi(torch.from_numpy(F32),
                                            torch.from_numpy(r32), A, ETA,
                                            wall, radii=torch.from_numpy(a32))
    assert U_t.dtype == torch.float32
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=RTOL,
                               atol=ATOL)


def test_wrapper_poly_box_runs_the_twin_on_the_cpu():
    """Poly × box on a CPU tensor is the twin's (the kernels have no such
    form yet; off the CPU it raises, tests/test_torch_rpy.py)."""
    r, radii, F = poly_cloud()
    ahat = torch.from_numpy(radii / A).float()
    r_a = torch.from_numpy(r / A).float()
    F32 = torch.from_numpy(F).float()
    box = (3.0 / A, 2.6 / A)
    U = rpy_cuda.pair_sum(r_a, F32, True, box_over_a=box, ahat=ahat,
                          image_shells=1)
    ids = torch.arange(r.shape[0])
    ref = rpy.pair_sum(r_a, ids, r_a, ids, F32, wall=True, box=box,
                       image_shells=1, radii_rows=ahat, radii_cols=ahat)
    assert torch.equal(U, ref)


def test_apply_fns_close_over_radii_and_refuse_unported_operators():
    """saddle's apply-fns with radii: the plain and the kernels' wrapper
    (CPU) paths equal the twin's poly apply; radii with the far field
    compute the polydisperse operator (on a (2, 2, 2) grid every pair is a
    near pair, so it is the twin's to roundoff, in float64 and through
    K3's wrapper in float32; on (3, 3, 2) within p = 4's interpolation
    error at cells of 3.3a); radii with a 3-D box give the polydisperse
    Ewald operator."""
    r, radii, F = poly_cloud()
    r_t, F_t, rad = (torch.from_numpy(x) for x in (r, F[0], radii))
    cfg = SimulationConfig(a=A, eta=ETA, wall=True, dtype=torch.float64)
    U = saddle.mobility_apply_fn(cfg, radii=rad)(F_t, r_t)
    ref = rpy.mobility_apply(F_t, r_t, A, ETA, True, radii=rad)
    assert torch.equal(U, ref)
    U2 = saddle.mobility_apply_multi_fn(cfg, radii=rad)(
        torch.from_numpy(F), r_t)
    assert _rel(U2[0], ref.numpy()) < 1e-14
    cfg32 = cfg.replace(dtype=torch.float32)
    U3 = saddle.mobility_apply_fn(cfg32, radii=rad.float())(F_t.float(),
                                                            r_t.float())
    assert _rel(U3, ref.numpy()) < 1e-5
    for grid, dtype, tol in (((2, 2, 2), torch.float64, 1e-12),
                             ((2, 2, 2), torch.float32, 1e-5),
                             ((3, 3, 2), torch.float64, 2e-2)):
        cfg_ff = cfg.replace(farfield_grid=grid, farfield_p=4, gmres_tol=5e-3,
                             dtype=dtype)
        U_ff = saddle.mobility_apply_fn(cfg_ff, radii=rad.to(dtype))(
            F_t.to(dtype), r_t.to(dtype))
        assert _rel(U_ff, ref.numpy()) < tol, (grid, dtype)
    # radii with a 3-D box, once refused: the polydisperse Ewald operator
    cfg_3d = SimulationConfig(a=A, box=(20.0, 20.0, 20.0),
                              dtype=torch.float64)
    U_3d = saddle.mobility_apply_multi_fn(cfg_3d, radii=rad)(
        torch.from_numpy(F), r_t)
    ref_3d = ewald.mobility_apply_multi(
        torch.from_numpy(F), r_t, ewald.make_params((20.0, 20.0, 20.0), A),
        radii=rad)
    assert _rel(U_3d, ref_3d.numpy()) < 1e-14
