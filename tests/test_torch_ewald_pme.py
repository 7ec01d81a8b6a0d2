"""Port parity of the gridded Ewald wave part (``ops/ewald_pme.py``)
against the JAX package on the same numpy inputs, and the port's grid
against its own dense k-sum.

The cloud of ``tests/test_ewald_pme.py``: 300 blobs in an (8, 8.5, 9) box,
positions outside [0, L) (the apply folds them), a = 0.3, η = 1.3,
tol 1e-4, rc = 3.0; radii from {0.2, 0.3, 0.45} for the species-split
grid.

Tolerances: grid sizes and species indices exactly equal, the tables
within 1e-13, the wave part within 1e-10 of max|U| in float64 and, in
float32, within 2e-4 of max|U| — the bound ``tests/test_ewald_pme.py``
holds the float32 grid to against the dense sum.  The applies are held
against the JAX package's on a coarse grid (p = 3, no oversampling: ~20³
cells against ~40³ at p = 4, oversample 2) — parity holds on any grid, and
the coarse one keeps the JAX reference cheap.  The grid against the dense
sum: the JAX tests' interpolation bounds at each (p, oversample).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu.ops import ewald as ewald_j  # noqa: E402
from rigid_body_light_tpu.ops import ewald_pme as pme_j  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald as ewald_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_pme as pme_t  # noqa: E402

BOX = (8.0, 8.5, 9.0)
N = 300
F64_TOL = 1e-10
F32_TOL = 2e-4
TABLE_TOL = 1e-13
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's cheapest CPU optimization,
    as ``tests/test_torch_poly.py`` compiles its references."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(11)
    r = rng.uniform(-4, 12, (N, 3))
    F = rng.standard_normal((2, N, 3))
    radii = rng.choice([0.2, 0.3, 0.45], size=N)
    kw = dict(eta=1.3, tol=1e-4, rc=3.0)
    return (ewald_j.make_params(BOX, 0.3, **kw),
            ewald_t.make_params(BOX, 0.3, **kw), r, F, radii)


def _rel(U, ref):
    U, ref = np.asarray(U, np.float64), np.asarray(ref, np.float64)
    return np.abs(U - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
def test_make_grid_matches_jax(cloud, poly):
    """Grid sizes, species indices and every spectral table of the JAX
    package's make_grid."""
    pj, pt, _, _, radii = cloud
    rad = radii if poly else None
    gj = pme_j.make_grid(pj, p=4, radii=rad)
    gt = pme_t.make_grid(pt, p=4, radii=rad)
    assert gt.grid == gj.grid and gt.p == gj.p
    nmax = np.abs(pt.nvecs).max(axis=0)
    assert all(g >= 2 * m + 2 for g, m in zip(gt.grid, nmax))
    for name in ("wk_bin", "khat_bin", "phi_x", "phi_y", "phi_z",
                 "sinc_bin"):
        vj, vt = getattr(gj, name), getattr(gt, name)
        if vj is None:
            assert vt is None and not poly
            continue
        assert vt.shape == vj.shape, name
        assert np.abs(vt - vj).max() <= TABLE_TOL * max(np.abs(vj).max(),
                                                        1.0), name
    if poly:
        np.testing.assert_array_equal(gt.sidx, gj.sidx)
        assert gt.sinc_bin.shape[0] == 3
    else:
        assert gt.sidx is None
    assert pme_t._next_fast(97) == pme_j._next_fast(97) == 100


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wave_grid_matches_jax(cloud, dtype, poly):
    """wave_space_apply_grid at 1 and 2 RHS against the JAX package's, on
    the same (coarse) grid."""
    pj, pt, r, F, radii = cloud
    dj, dt = {"float64": (jnp.float64, torch.float64),
              "float32": (jnp.float32, torch.float32)}[dtype]
    tol = F64_TOL if dtype == "float64" else F32_TOL
    rad = radii if poly else None
    gj = pme_j.make_grid(pj, p=3, oversample=1.0, radii=rad)
    gt = pme_t.make_grid(pt, p=3, oversample=1.0, radii=rad)
    assert gt.grid == gj.grid
    r_t, F_t = torch.from_numpy(r).to(dt), torch.from_numpy(F).to(dt)
    U_j = np.asarray(jax_fast(
        lambda F_, r_: pme_j.wave_space_apply_grid(F_, r_, pj, gj),
        jnp.asarray(F, dj), jnp.asarray(r, dj)))
    U_t = pme_t.wave_space_apply_grid(F_t, r_t, pt, gt)
    assert U_t.dtype == dt and U_t.shape == F.shape
    assert _rel(U_t, U_j) < tol
    U1 = pme_t.wave_space_apply_grid(F_t[0], r_t, pt, gt)
    assert U1.shape == (N, 3) and _rel(U1, U_j[0]) < tol


@pytest.mark.parametrize("p,os,tol,poly", [
    (4, 1.5, 3e-4, False), (4, 2.0, 1e-4, False), (6, 2.0, 1e-6, False),
    (4, 2.0, 3e-4, True)])
def test_wave_grid_matches_dense(cloud, p, os, tol, poly):
    """The port's grid against its own dense k-sum (float64), within the
    plane waves' interpolation error: the JAX tests' bounds."""
    pt, r, F, radii = cloud[1:]
    rad = radii if poly else None
    g = pme_t.make_grid(pt, p=p, oversample=os, radii=rad)
    r_t, F_t = torch.from_numpy(r), torch.from_numpy(F[0])
    rad_t = None if rad is None else torch.from_numpy(rad)
    U_ref = ewald_t.wave_space_apply(F_t, r_t, pt, radii=rad_t)
    assert _rel(pme_t.wave_space_apply_grid(F_t, r_t, pt, g), U_ref) < tol


def test_wave_grid_f32_matches_dense(cloud):
    pt, r, F = cloud[1:4]
    g = pme_t.make_grid(pt, p=4)
    r_t, F_t = torch.from_numpy(r).float(), torch.from_numpy(F[0]).float()
    U = pme_t.wave_space_apply_grid(F_t, r_t, pt, g)
    assert U.dtype == torch.float32
    assert _rel(U, ewald_t.wave_space_apply(F_t.double(), r_t.double(),
                                            pt)) < F32_TOL


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
def test_wave_grid_exactly_symmetric(cloud, poly):
    """The spread and the readback share one basis: ⟨y, M x⟩ = ⟨x, M y⟩ to
    roundoff on a coarse grid (p = 3, no oversampling), and x·M x ≥ 0."""
    pt, r, _, radii = cloud[1], cloud[2], cloud[3], cloud[4]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((N, 3)))
    y = torch.from_numpy(rng.standard_normal((N, 3)))
    g = pme_t.make_grid(pt, p=3, oversample=1.0,
                        radii=radii if poly else None)
    r_t = torch.from_numpy(r)
    Mx = pme_t.wave_space_apply_grid(x, r_t, pt, g)
    My = pme_t.wave_space_apply_grid(y, r_t, pt, g)
    lhs, rhs = float(torch.sum(y * Mx)), float(torch.sum(x * My))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)
    assert float(torch.sum(x * Mx)) >= 0.0


def test_grid_radii_mismatch_raises(cloud):
    """A grid built without the apply's radii, or with radii the apply
    lacks, raises the JAX package's ValueError."""
    pt, r, F, radii = cloud[1:]
    r_t, F_t = torch.from_numpy(r), torch.from_numpy(F[0])
    g_mono = pme_t.make_grid(pt, p=4)
    g_poly = pme_t.make_grid(pt, p=4, radii=radii)
    for fn in (ewald_t.mobility_apply, ewald_t.mobility_apply_multi):
        Fk = F_t if fn is ewald_t.mobility_apply else F_t[None]
        with pytest.raises(ValueError, match="same radii"):
            fn(Fk, r_t, pt, radii=torch.from_numpy(radii), grid=g_mono)
        with pytest.raises(ValueError, match="same radii"):
            fn(Fk, r_t, pt, grid=g_poly)


def test_make_grid_validation(cloud):
    pt = cloud[1]
    with pytest.raises(ValueError, match="p >= 2"):
        pme_t.make_grid(pt, p=1)
    with pytest.raises(ValueError, match="oversample"):
        pme_t.make_grid(pt, p=4, oversample=0.5)
    with pytest.raises(ValueError, match="nvecs"):
        pme_t.make_grid(pt._replace(nvecs=None), p=4)
