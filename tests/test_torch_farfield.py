"""Port parity of the proxy-grid far field (``ops/farfield.py``) and its
near sweep K3 against the JAX package, on the CPU.

The same numpy inputs go through both packages: the tile order, the
neighbor lists and the grid rules must give identical integers; the plain
near sweep matches the JAX ``_near_sweep`` in float64 and the Pallas
``near_sweep`` (interpret mode) in float32; the whole operator matches in
float64, wall and free, one and two RHS.  Rows of pad blobs are left out of
the near-sweep comparisons: both packages write garbage there that every
caller drops.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig  # noqa: E402
from rigid_body_light_tpu.ops import farfield as ff_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy_pallas  # noqa: E402
from rigid_body_light_tpu.ops import tiles as tiles_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.config import SimulationConfig as CfgT  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield as ff_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import tiles as tiles_t  # noqa: E402

N = 900
# a = 1.1: heights 0.6-8 straddle the 0.75a wall floor
KW = dict(a=1.1, eta=0.9, grid=(3, 3, 2), p=4)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(5)
    r = rng.uniform([0, 0, 0.6], [16, 16, 8], (N, 3))
    F = rng.standard_normal((2, N, 3))
    return r, F


@pytest.fixture(scope="module")
def ctx_j(cloud):
    """The JAX package's FarCtx for the cloud, wall and free."""
    r, _ = cloud
    return {wall: ff_j.prepare(jnp.asarray(r), wall=wall, **KW)
            for wall in (False, True)}


@pytest.fixture(scope="module")
def U_j(cloud, ctx_j):
    """The JAX operator on both RHS, wall and free (float64).  It is
    linear, so row 0 is also its single-RHS reference."""
    r, F = cloud
    return {wall: np.asarray(ff_j.mobility_apply(
        jnp.asarray(F), jnp.asarray(r), wall=wall, ctx=ctx_j[wall], **KW))
        for wall in (False, True)}


def _sorted_forces(ctx, F):
    pad = ctx.x_s.shape[0] - N
    return np.concatenate([F[:, np.asarray(ctx.order)],
                           np.zeros((F.shape[0], pad, 3))], axis=1)


def _rel_live(U, U_ref, live):
    U, U_ref = np.asarray(U)[:, live], np.asarray(U_ref)[:, live]
    return np.abs(U - U_ref).max() / np.abs(U_ref).max()


def test_cell_snake_order_matches_jax():
    """Many blobs per cell (ties) on an anisotropic grid: the stable sort
    gives the identical permutation."""
    rng = np.random.default_rng(2)
    grid = (5, 4, 3)
    ci = rng.integers(0, grid, (3000, 3)).astype(np.int32)
    o_j = np.asarray(tiles_j.cell_snake_order(jnp.asarray(ci), grid))
    o_t = tiles_t.cell_snake_order(torch.from_numpy(ci), grid).numpy()
    assert np.array_equal(o_t, o_j)


@pytest.mark.parametrize("wall", [False, True])
def test_prepare_matches_jax(cloud, ctx_j, wall):
    """Order, cells, padding, neighbor lists bit for bit; the spreading
    weights and self terms to float64 roundoff."""
    r, _ = cloud
    cj = ctx_j[wall]
    ct = ff_t.prepare(torch.from_numpy(r), wall=wall, **KW)
    for name in ("order", "cid", "ci_s", "id_s", "nbr"):
        assert np.array_equal(getattr(ct, name).numpy(),
                              np.asarray(getattr(cj, name))), name
    assert bool(ct.overflow) is bool(cj.overflow) is False
    for name in ("lo", "h", "x_s", "W3", "self_diag"):
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)), rtol=0,
                                   atol=1e-13, err_msg=name)


def test_neighbor_list_overflow_matches_jax(ctx_j):
    ci_s = ctx_j[True].ci_s
    t = ci_s.shape[0] // ff_j.TILE
    for max_nbr in (2, t):
        nbr_j, ov_j = ff_j._near_neighbor_lists(ci_s, t, max_nbr)
        nbr_t, ov_t = ff_t._near_neighbor_lists(
            torch.from_numpy(np.array(ci_s)), t, max_nbr)
        assert np.array_equal(nbr_t.numpy(), np.asarray(nbr_j))
        assert bool(ov_t) == bool(ov_j) == (max_nbr == 2)


@pytest.mark.parametrize("n,p,wall", [
    (900, 4, False), (25_620, 4, True), (102_480, 4, True),
    (102_480, 6, True), (1_000_000, 4, False), (1_000_000, 4, True),
])
def test_grid_rules_match_jax(n, p, wall):
    g_j = ff_j.auto_grid(n, p, wall)
    assert ff_t.auto_grid(n, p, wall) == g_j
    for grid in ((g_j,) * 3, (12, 12, 3)):
        assert (ff_t.default_max_nbr(n, grid, p)
                == ff_j.default_max_nbr(n, grid, p))
    assert ff_t._chunk_rows(801, 130, 2) == ff_j._chunk_rows(801, 130, 2)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("wall", [False, True])
def test_near_sweep_matches_jax(cloud, ctx_j, wall, k):
    _, F = cloud
    cj = ctx_j[wall]
    t = cj.nbr.shape[0]
    F_s = _sorted_forces(cj, F[:k])
    U_j = ff_j._near_sweep(cj.x_s, cj.ci_s, cj.id_s, jnp.asarray(F_s), None,
                           cj.nbr, cj.nbr.shape[1], wall, 0.75, 0, t)
    U_t = ff_t._near_sweep(
        torch.from_numpy(np.array(cj.x_s)),
        torch.from_numpy(np.array(cj.ci_s)),
        torch.from_numpy(np.array(cj.id_s)), torch.from_numpy(F_s),
        torch.from_numpy(np.array(cj.nbr)), wall, 0.75)
    assert U_t.shape == (k, t * ff_t.TILE, 3)
    assert _rel_live(U_t, U_j, np.array(cj.id_s) >= 0) < 1e-12


@pytest.mark.parametrize("wall,k", [(False, 1), (True, 2)])
def test_near_sweep_wrapper_matches_pallas(cloud, ctx_j, wall, k):
    """K3's wrapper on a CPU tensor (its plain version, float32) against
    the Pallas kernel in interpret mode."""
    _, F = cloud
    cj = ctx_j[wall]
    live = np.array(cj.id_s) >= 0
    F_s = _sorted_forces(cj, F[:k]).astype(np.float32)
    x32 = jnp.array(cj.x_s, jnp.float32)
    U_p = rpy_pallas.near_sweep(x32, cj.ci_s, jnp.asarray(live),
                                jnp.asarray(F_s), cj.nbr, wall, 0.75,
                                interpret=True)
    U_t = farfield_cuda.near_sweep(
        torch.from_numpy(np.array(x32)),
        torch.from_numpy(np.array(cj.ci_s)), torch.from_numpy(live),
        torch.from_numpy(F_s), torch.from_numpy(np.array(cj.nbr)), wall,
        0.75)
    assert U_t.dtype == torch.float32
    assert _rel_live(U_t, U_p, live) < 1e-5


def test_near_sweep_wrapper_refuses_three_rhs(ctx_j):
    cj = ctx_j[True]
    n_pad = cj.x_s.shape[0]
    with pytest.raises(ValueError, match="at most 2 RHS"):
        farfield_cuda.near_sweep(
            torch.from_numpy(np.array(cj.x_s)),
            torch.from_numpy(np.array(cj.ci_s)),
            torch.ones(n_pad, dtype=torch.bool), torch.zeros(3, n_pad, 3),
            torch.from_numpy(np.array(cj.nbr)), True, 0.75)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("wall", [False, True])
def test_mobility_apply_matches_jax(cloud, U_j, wall, k):
    """The whole operator in float64: (N, 3) for one RHS, (2, N, 3) for
    two."""
    r, F = cloud
    Fk, ref = (F[0], U_j[wall][0]) if k == 1 else (F, U_j[wall])
    U_t = ff_t.mobility_apply(torch.from_numpy(Fk), torch.from_numpy(r),
                              wall=wall, **KW).numpy()
    assert U_t.shape == ref.shape
    assert np.abs(U_t - ref).max() / np.abs(ref).max() < 1e-10


@pytest.fixture(scope="module")
def reuse_j(cloud):
    """Positions moved well inside a cell, and the JAX operator there on
    the geometry tier built at the original positions (wall, 2 RHS)."""
    r, F = cloud
    kw = dict(wall=True, **KW)
    r2 = r + 0.05 * np.random.default_rng(9).standard_normal(r.shape)
    geo = ff_j.prepare_geometry(jnp.asarray(r), **kw)
    U = ff_j.mobility_apply(jnp.asarray(F), jnp.asarray(r2),
                            ctx=ff_j.prepare(jnp.asarray(r2), geo=geo, **kw),
                            **kw)
    return r2, np.asarray(U)


def test_geometry_reuse_and_poison(cloud, reuse_j):
    """prepare(geo=...) at moved positions matches the JAX package;
    positions past half a cell out of the reused box poison the apply with
    NaN, as does a neighbor-list overflow (as in the JAX package)."""
    r, F = cloud
    r2, U_j = reuse_j
    kw = dict(wall=True, **KW)
    geo = ff_t.prepare_geometry(torch.from_numpy(r), **kw)
    U_t = ff_t.mobility_apply(
        torch.from_numpy(F), torch.from_numpy(r2),
        ctx=ff_t.prepare(torch.from_numpy(r2), geo=geo, **kw), **kw)
    assert np.abs(U_t.numpy() - U_j).max() / np.abs(U_j).max() < 1e-10
    far = r.copy()
    far[0, 0] += 12.0                      # 2+ cells (h ≈ 4.8a) out
    ctx = ff_t.prepare(torch.from_numpy(far), geo=geo, **kw)
    assert bool(ctx.overflow)
    assert torch.isnan(ff_t.mobility_apply(
        torch.from_numpy(F[0]), torch.from_numpy(far), ctx=ctx, **kw)).all()
    U_ov = ff_t.mobility_apply(torch.from_numpy(F[0]), torch.from_numpy(r),
                               max_nbr=2, **kw)
    assert torch.isnan(U_ov).all()


def test_pin_geometry_and_hoist_match_jax(cloud, reuse_j):
    """The saddle-level far-field apply-fn: hoisting reproduces the direct
    apply, and the operator pinned at r, applied at moved positions,
    matches the JAX package's (same grid, same lattices)."""
    r, F = cloud
    r2, U_j = reuse_j
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_j = SimulationConfig(a=KW["a"], eta=KW["eta"], wall=True,
                                 farfield_grid=KW["grid"], farfield_p=4,
                                 dtype=jnp.float64)
        cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    mob = saddle_t.mobility_apply_fn(cfg_t)
    assert saddle_t.mobility_apply_multi_fn(cfg_t).prepare is not None
    rt, Ft = torch.from_numpy(r), torch.from_numpy(F)
    assert torch.equal(mob(Ft[0], rt),
                       saddle_t.hoist_positions(mob, rt)(Ft[0], rt))
    pinned = saddle_t.pin_geometry(mob, rt)
    U_t = pinned(Ft, torch.from_numpy(r2)).numpy()
    assert U_t.shape == (2, N, 3)
    assert np.abs(U_t - U_j).max() / np.abs(U_j).max() < 1e-10
    # the pinned lattices are reused, not rebuilt
    assert pinned.prepare_geometry(rt).khat_free is pinned.prepare(
        torch.from_numpy(r2)).khat_free


def test_config_checks_match_jax():
    for cls in (SimulationConfig, CfgT):
        with pytest.raises(ValueError, match="open"):
            cls(box=(10.0, 10.0, 10.0), farfield_grid=4)
        with pytest.raises(ValueError, match="triple"):
            cls(farfield_grid=(4, 4))
        with pytest.raises(ValueError, match="'auto'"):
            cls(farfield_grid="automatic")
    cfg = CfgT(farfield_grid=[4, 4, 2], gmres_tol=1e-2,
               max_step_residual=1e-1)
    assert cfg.farfield_grid == (4, 4, 2)
    hash(cfg)
    # the band tier's order and its refusal of the film, as the JAX
    # package's tests/test_farfield.py::test_band_validation checks them
    r8 = np.zeros((8, 3))
    with pytest.raises(ValueError, match="band_p"):
        ff_j.mobility_apply(jnp.asarray(r8), jnp.asarray(r8), grid=4, p=3,
                            band_p=2)
    with pytest.raises(ValueError, match="band_p"):
        ff_t.mobility_apply(torch.from_numpy(r8), torch.from_numpy(r8),
                            grid=4, p=3, band_p=2)
    for ff, arr in ((ff_j, jnp.asarray), (ff_t, torch.from_numpy)):
        with pytest.raises(ValueError, match="does not compose"):
            ff.prepare(arr(np.ones((8, 3))), wall=True, grid=(4, 4, 2), p=3,
                       band_p=4, box=(10.0, 10.0), image_shells=1)
    with pytest.raises(ValueError, match="pseudo-2D"):
        CfgT(farfield_grid=4, farfield_band_p=4, box=(10.0, 10.0),
             wall=True, image_shells=1, gmres_tol=1e-2,
             max_step_residual=1e-1)


def test_tolerance_mismatch_warns():
    with pytest.warns(UserWarning, match="operator error"):
        CfgT(farfield_grid=4, farfield_p=4, gmres_tol=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        CfgT(farfield_grid=4, farfield_p=4, gmres_tol=1e-2,
             max_step_residual=1e-1)
        CfgT(farfield_grid=4, farfield_p=6, gmres_tol=1e-3)
