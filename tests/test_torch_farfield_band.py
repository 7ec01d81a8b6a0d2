"""Port parity of the far field's band tier (``farfield_band_p``: the cell
offsets of ∞-norm 2..3 at a higher Chebyshev order as a direct block
convolution, the FFT lattices masked beyond) against the JAX package, on
the CPU.

The same numpy inputs go through both packages: the band offsets integer
for integer; the free and wall band blocks, mono and with radii, in
float64 to 1e-12 of their largest entry; the band convolutions on random
blocks and moments; the whole operator with a hoisted ctx in float64 to
1e-10, free, wall and wall with radii, one and two RHS; and the JAX
package's own band tests (``tests/test_farfield.py``'s validation,
tightening, symmetry and exact-sweep checks) on the port.  The JAX
references are compiled at XLA's cheapest CPU optimization
(:func:`jax_fast`).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig  # noqa: E402
from rigid_body_light_tpu.ops import farfield as ff_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.config import SimulationConfig as CfgT  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield as ff_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy as rpy_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402

N = 400
A = 1.1
# 5 × 5 × 2 cells of ~3.5a over a 16a square: offsets 2 and 3 in x and y
KW = dict(a=A, eta=0.9, grid=(5, 5, 2), p=3, band_p=4)
CASES = {"free": dict(KW, wall=False), "wall": dict(KW, wall=True),
         "poly": dict(KW, wall=True)}
# float64 blocks against the JAX package, relative to the largest entry;
# the operator, relative to max|U|
BLOCK_TOL = 1e-12
OPERATOR_TOL = 1e-10
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _wall_blocks_j(Kw):
    """The JAX package's (nk, n_oxy, gz_t, gz_s, B6, B6) wall band in the
    port's (nk, n_oxy, gz_t·B6, gz_s·B6) layout."""
    Kw = np.asarray(Kw)
    nk, m, gz, _, b6, _ = Kw.shape
    return Kw.transpose(0, 1, 2, 4, 3, 5).reshape(nk, m, gz * b6, gz * b6)


@pytest.fixture(scope="module")
def cloud():
    """N blobs over 16a × 16a at heights 0.6a–8a (straddling the wall
    floor), radii {0.6, 1.1}·a for the poly case, two RHS."""
    rng = np.random.default_rng(21)
    r = rng.uniform([0, 0, 0.6], [16, 16, 8], (N, 3))
    radii = rng.choice([0.6 * A, 1.1 * A], N)
    F = rng.standard_normal((2, N, 3))
    return r, radii, F


def test_band_offsets_match_jax():
    np.testing.assert_array_equal(ff_t._band_offsets_free(),
                                  np.asarray(ff_j._band_offsets_free()))
    np.testing.assert_array_equal(ff_t._band_offsets_xy(),
                                  np.asarray(ff_j._band_offsets_xy()))
    assert ff_t._band_offsets_free().shape == (316, 3)
    assert ff_t._band_offsets_xy().shape == (49, 2)
    # at gz = 3 no offset with |oz| = 3 reaches a target cell: the plan
    # drops those 98, and keeps every x/y offset
    (off_f, idx_f, ok_f), (off_w, _, _) = ff_t._band_plan((5, 5, 3),
                                                          torch.device("cpu"))
    assert len(off_f) == 316 - 98 and np.abs(off_f[:, 2]).max() == 2
    assert len(off_w) == 49
    assert bool(ok_f.any(dim=1).all()) and idx_f.shape == (218, 75)


@pytest.mark.parametrize("poly", [False, True])
def test_band_blocks_match_jax(poly):
    h = np.array([1.3, 1.1, 0.9])
    bp = 3
    Kb_j = ff_j._band_blocks_free(jnp.asarray(h), bp, jnp.float64, poly=poly)
    Kb_t = ff_t._band_blocks_free(torch.from_numpy(h), bp, poly=poly)
    assert Kb_t.shape == Kb_j.shape
    assert _rel(Kb_t.numpy(), Kb_j) < BLOCK_TOL
    grid = (5, 5, 3)
    lo_z = 0.35          # node heights below and above the 0.75 floor
    Kw_j = ff_j._band_blocks_wall(jnp.asarray(lo_z), jnp.asarray(h), grid,
                                  bp, jnp.float64, 0.75, poly=poly)
    Kw_t = ff_t._band_blocks_wall(torch.tensor(lo_z, dtype=torch.float64),
                                  torch.from_numpy(h), grid, bp, 0.75,
                                  poly=poly)
    ref = _wall_blocks_j(Kw_j)
    assert Kw_t.shape == ref.shape
    assert _rel(Kw_t.numpy(), ref) < BLOCK_TOL
    # the band mask: every block with |oxy|∞ ≤ 1 and |Δcz| ≤ 1 is zero
    b6 = 3 * bp ** 3
    W = Kw_t.reshape(Kw_t.shape[0], 49, 3, b6, 3, b6)
    near_xy = np.abs(ff_t._band_offsets_xy()).max(axis=1) <= 1
    for ct in range(3):
        for cs in range(3):
            blk = W[:, near_xy, ct, :, cs]
            assert (blk.abs().max() == 0) == (abs(ct - cs) <= 1)


@pytest.mark.parametrize("nm", [1, 2, 3])
def test_band_applies_match_jax(nm):
    """The two band convolutions on random blocks and moments: nm = 1
    mono, 2 (free, poly) and 3 (wall, poly)."""
    rng = np.random.default_rng(nm)
    grid = (4, 5, 3)
    ncell, b6, k = 60, 12, 2
    Q = rng.standard_normal((nm, k, ncell, b6))
    if nm < 3:
        Kb = rng.standard_normal((nm, 316, b6, b6))
        U_j = ff_j._band_apply_free(jnp.asarray(Kb), jnp.asarray(Q), grid)
        U_t = ff_t._band_apply_free(torch.from_numpy(Kb), torch.from_numpy(Q),
                                    grid)
        assert U_t.shape == U_j.shape
        assert _rel(U_t.numpy(), U_j) < 1e-13
    if nm != 2:
        Kw = rng.standard_normal((nm, 49, 3, 3, b6, b6))
        U_j = ff_j._band_apply_wall(jnp.asarray(Kw), jnp.asarray(Q), grid)
        U_t = ff_t._band_apply_wall(torch.from_numpy(_wall_blocks_j(Kw)),
                                    torch.from_numpy(Q), grid)
        assert U_t.shape == U_j.shape
        assert _rel(U_t.numpy(), U_j) < 1e-13


@pytest.mark.parametrize("case", list(CASES))
def test_band_operator_matches_jax(cloud, case):
    """The whole operator, a hoisted ctx, 1 and 2 RHS, float64."""
    r, radii, F = cloud
    kw = CASES[case]
    rad_j = jnp.asarray(radii) if case == "poly" else None
    U_j = np.asarray(jax_fast(
        lambda F_, r_: ff_j.mobility_apply(F_, r_, radii=rad_j, **kw),
        jnp.asarray(F), jnp.asarray(r)))
    rt = torch.from_numpy(r)
    rad_t = torch.from_numpy(radii) if case == "poly" else None
    ctx = ff_t.prepare(rt, radii=rad_t, **kw)
    assert ctx.band_free is not None and ctx.W6.shape == (N, 64)
    assert (ctx.band_wall is not None) == kw["wall"]
    U2 = ff_t.mobility_apply(torch.from_numpy(F), rt, ctx=ctx, radii=rad_t,
                             **kw).numpy()
    U1 = ff_t.mobility_apply(torch.from_numpy(F[0]), rt, ctx=ctx,
                             radii=rad_t, **kw).numpy()
    assert _rel(U2, U_j) < OPERATOR_TOL
    assert _rel(U1, U_j[0]) < OPERATOR_TOL
    # the band changes the operator: it is not the p = 3 one
    U_p = ff_t.mobility_apply(torch.from_numpy(F[0]), rt, radii=rad_t,
                              **dict(kw, band_p=0)).numpy()
    assert _rel(U_p, U1) > 1e-4


def test_config_and_apply_fn_take_the_band(cloud):
    """``cfg.farfield_band_p`` through ``saddle.mobility_apply_fn`` is the
    direct band call, bitwise, and the geometry tier carries the blocks."""
    r, _, F = cloud
    cfg_j = SimulationConfig(a=A, eta=0.9, wall=True, dtype=jnp.float64,
                             farfield_grid=KW["grid"], farfield_p=3,
                             farfield_band_p=3, gmres_tol=2e-2,
                             max_step_residual=0.1)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg_t.farfield_band_p == 3
    rt, Ft = torch.from_numpy(r), torch.from_numpy(F[0])
    mob = saddle_t.mobility_apply_fn(cfg_t)
    U = mob(Ft, rt)
    U_direct = ff_t.mobility_apply(Ft, rt, wall=True, **dict(KW, band_p=3))
    assert torch.equal(U, U_direct)
    pinned = saddle_t.pin_geometry(mob, rt)
    geo = pinned.prepare_geometry(rt)
    assert geo.band_free is not None and geo.band_wall is not None
    assert torch.equal(pinned(Ft, rt), U)


def test_band_validation():
    """The JAX package's ``test_band_validation`` on both packages: band_p
    2 and a 2-D box raise the same ValueErrors; the two-tier estimate feeds
    the tolerance warning alike."""
    for ff, arr in ((ff_j, jnp.asarray), (ff_t, torch.from_numpy)):
        with pytest.raises(ValueError, match="band_p"):
            ff.mobility_apply(arr(np.zeros((8, 3))), arr(np.zeros((8, 3))),
                              grid=4, p=3, band_p=2)
        with pytest.raises(ValueError, match="pseudo-2D"):
            ff.prepare(arr(np.ones((8, 3))), wall=True, grid=(4, 4, 2), p=3,
                       band_p=4, box=(10.0, 10.0), image_shells=1)
    for Cfg, dt in ((SimulationConfig, jnp.float64),
                    (CfgT, torch.float64)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            Cfg(farfield_grid=4, farfield_p=4, farfield_band_p=6,
                gmres_tol=1e-3, dtype=dt)
        with pytest.warns(UserWarning, match="operator error"):
            Cfg(farfield_grid=4, farfield_p=4, farfield_band_p=6,
                gmres_tol=1e-5, dtype=dt)


def _exact(r, F, wall):
    return rpy_t.mobility_apply(F, r, a=0.9, eta=1.3, wall=wall)


def test_band_tier_tightens_free():
    """``tests/test_farfield.py::test_band_tier_tightens_free`` on the port:
    band_p 5 over p = 3 cuts the free operator's error at least 4-fold."""
    rng = np.random.default_rng(7)
    r = torch.from_numpy(rng.uniform(0, 20, (1500, 3)))
    F = torch.from_numpy(rng.standard_normal((2, 1500, 3))[0])
    U_ref = _exact(r, F, False)
    kw = dict(a=0.9, eta=1.3, grid=5, p=3)
    scale = U_ref.abs().max()
    e_base = float((ff_t.mobility_apply(F, r, **kw) - U_ref).abs().max()
                   / scale)
    e_band = float((ff_t.mobility_apply(F, r, band_p=5, **kw)
                    - U_ref).abs().max() / scale)
    assert e_band < e_base / 4
    assert e_band < 3e-3


def test_band_symmetry_multi_rhs_and_ctx():
    """``tests/test_farfield.py::test_band_symmetry_multi_rhs_and_ctx`` on
    the port: symmetric to roundoff, the 2-RHS apply its two 1-RHS ones,
    a prepared ctx the same computation."""
    rng = np.random.default_rng(7)
    r = torch.from_numpy(rng.uniform(0, 20, (1500, 3)))
    F = torch.from_numpy(rng.standard_normal((2, 1500, 3)))
    kw = dict(a=0.9, eta=1.3, grid=5, p=3, band_p=4)
    U1 = ff_t.mobility_apply(F[0], r, **kw)
    U2 = ff_t.mobility_apply(F[1], r, **kw)
    s1, s2 = float(torch.sum(F[1] * U1)), float(torch.sum(F[0] * U2))
    assert abs(s1 - s2) / abs(s1) < 1e-12
    Um = ff_t.mobility_apply(F, r, **kw)
    assert float((Um[0] - U1).abs().max()) < 1e-13
    assert float((Um[1] - U2).abs().max()) < 1e-13
    ctx = ff_t.prepare(r, **kw)
    assert torch.equal(ff_t.mobility_apply(F[0], r, ctx=ctx, **kw), U1)


@pytest.mark.medium
def test_band_wall_matches_exact_sweep():
    """``tests/test_farfield.py::test_band_wall_matches_exact_sweep`` on the
    port: p = 4 + band 6 against the exact wall sweep, below 8e-4."""
    rng = np.random.default_rng(11)
    n = 1200
    r = torch.from_numpy(np.column_stack([
        rng.uniform(0, 30, n), rng.uniform(0, 30, n),
        rng.uniform(0.9, 12.0, n)]))
    F = torch.from_numpy(rng.standard_normal((n, 3)))
    U_ref = _exact(r, F, True)
    U = ff_t.mobility_apply(F, r, a=0.9, eta=1.3, wall=True, grid=(5, 5, 2),
                            p=4, band_p=6)
    assert float((U - U_ref).abs().max() / U_ref.abs().max()) < 8e-4
