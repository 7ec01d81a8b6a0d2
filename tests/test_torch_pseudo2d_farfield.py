"""Port parity of the pseudo-2D far field (a doubly periodic (Lx, Ly) box
above the wall, ``ops/farfield.py`` with ``box``) and K3's box form against
the JAX package, on the CPU.

The same numpy inputs go through both packages: the combined image-summed
kernel lattice in float64 to 1e-12 of max|K̂|; the wrapped positions, cells
and cyclic neighbor lists bit for bit; the plain near sweep with the box in
float64 to 1e-12 and K3's wrapper (its plain version here) against the
Pallas kernel in interpret mode in float32 to 5e-6·max|U|; the whole
operator in float64 to 1e-10, one and two RHS.  Then the port's operator
against its own exact image sweep, the geometry-reuse guard (z only: x/y
wrap) and the configuration rules of both packages.  Rows of pad blobs are
left out of the near-sweep comparisons: both packages write garbage there.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig  # noqa: E402
from rigid_body_light_tpu.ops import farfield as ff_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy_pallas  # noqa: E402
from rigid_body_light_tpu_torch.config import SimulationConfig as CfgT  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield as ff_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy as rpy_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import tiles as tiles_t  # noqa: E402

N = 300
BOX = (16.0, 16.0)
# a = 1.1: heights 0.6-5 straddle the 0.75a wall floor; the box is 4 cells
# of 3.6a, the fewest the JAX package allows
KW = dict(a=1.1, eta=0.9, wall=True, grid=(4, 4, 2), p=3, box=BOX,
          image_shells=6)
BOX_N = tuple(b / KW["a"] for b in BOX)
WRAP = KW["grid"][:2]
# K3's wrapper (float32) against the Pallas kernel (float32), max|ΔU| /
# max|U| over live rows: the kernels' bound against float64
KERNEL_TOL = 5e-6


@pytest.fixture(scope="module")
def cloud():
    """Blobs spread over 1.6 periods in x and y (the wrap moves most of
    them) at heights 0.6-5."""
    rng = np.random.default_rng(5)
    r = rng.uniform([-0.3 * BOX[0], -0.3 * BOX[1], 0.6],
                    [1.3 * BOX[0], 1.3 * BOX[1], 5.0], (N, 3))
    F = rng.standard_normal((2, N, 3))
    return r, F


@pytest.fixture(scope="module")
def ctx_j(cloud):
    return ff_j.prepare(jnp.asarray(cloud[0]), **KW)


@pytest.fixture(scope="module")
def ctx_t(cloud):
    return ff_t.prepare(torch.from_numpy(cloud[0]), **KW)


def _complex_lattice_j(Kp, gz):
    """The JAX package's packed (2, gz_t, gz_s, f, B, B) lattice in the
    port's (f, gz_t·B, gz_s·B) complex layout."""
    K = np.asarray(Kp[0]) + 1j * np.asarray(Kp[1])
    f, B = K.shape[2], K.shape[3]
    return K.transpose(2, 0, 3, 1, 4).reshape(f, gz * B, gz * B)


def _sorted_forces(ctx, F):
    pad = ctx.x_s.shape[0] - N
    return np.concatenate([F[:, np.asarray(ctx.order)],
                           np.zeros((F.shape[0], pad, 3))], axis=1)


def _rel_live(U, U_ref, live):
    U, U_ref = np.asarray(U)[:, live], np.asarray(U_ref)[:, live]
    return np.abs(U - U_ref).max() / np.abs(U_ref).max()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_film_lattice_matches_jax(ctx_j, ctx_t):
    """The combined lattice of the cloud's geometry (S = 6, 169 shifts)."""
    assert ctx_t.khat_free is None and ctx_j.khat_free is None
    K_j = _complex_lattice_j(ctx_j.khat_wall, KW["grid"][2])
    K_t = ctx_t.khat_wall.numpy()
    assert K_t.shape == K_j.shape == (4 * 3, 2 * 81, 2 * 81)
    assert np.abs(K_t - K_j).max() < 1e-12 * np.abs(K_j).max()


@pytest.mark.parametrize("shells", [1, 2])
def test_kernel_hat_2p_matches_jax(shells):
    """Another grid (odd counts: the cyclic offsets' halves differ),
    anisotropic cells, node heights below the wall floor; S = 1 (the
    one-term tail) and 2."""
    h = np.array([4.0, 3.0, 1.5])
    grid = (5, 4, 2)
    K_j = _complex_lattice_j(ff_j._kernel_hat_2p(
        jnp.asarray(0.5), jnp.asarray(h), grid, 3, jnp.float64, 0.75,
        shells), 2)
    K_t = ff_t._kernel_hat_2p(torch.tensor(0.5, dtype=torch.float64),
                              torch.from_numpy(h), grid, 3, 0.75,
                              shells).numpy()
    assert K_t.shape == K_j.shape
    assert np.abs(K_t - K_j).max() < 1e-12 * np.abs(K_j).max()


def test_prepare_matches_jax(ctx_j, ctx_t):
    """Wrapped positions, cells, order, padding and the cyclic neighbor
    lists bit for bit; weights and self terms to roundoff."""
    for name in ("order", "cid", "ci_s", "id_s", "nbr"):
        assert np.array_equal(getattr(ctx_t, name).numpy(),
                              np.asarray(getattr(ctx_j, name))), name
    assert bool(ctx_t.overflow) is bool(ctx_j.overflow) is False
    for name in ("lo", "h", "x_s", "W3", "self_diag"):
        np.testing.assert_allclose(getattr(ctx_t, name).numpy(),
                                   np.asarray(getattr(ctx_j, name)), rtol=0,
                                   atol=1e-13, err_msg=name)
    x = ctx_t.x_s[:, :2].numpy()
    assert (x >= 0).all() and (x < np.array(BOX_N)).all()


def test_wrapped_neighbor_lists_match_jax(ctx_j):
    """The cyclic tile adjacency at a narrow list width (overflow) and a
    full one, and the open adjacency of the same cells, against JAX."""
    ci_s = ctx_j.ci_s
    t = ci_s.shape[0] // ff_j.TILE
    for max_nbr, wrap in ((1, WRAP), (t, WRAP), (t, None)):
        nbr_j, ov_j = ff_j._near_neighbor_lists(ci_s, t, max_nbr,
                                                wrap_xy=wrap)
        nbr_t, ov_t = ff_t._near_neighbor_lists(_t(ci_s), t, max_nbr,
                                                wrap_xy=wrap)
        assert np.array_equal(nbr_t.numpy(), np.asarray(nbr_j))
        assert bool(ov_t) == bool(ov_j) == (max_nbr == 1)


def _check_tile_pairs(nbr):
    """K3's work list covers each unordered adjacent tile pair once, its
    slots point back at each other."""
    pairs, n_pairs = tiles_t.tile_pairs(nbr)
    rows = pairs[:int(n_pairs)].numpy()
    nb = nbr.numpy()
    adj = {(a, int(b)) for a in range(nb.shape[0]) for b in nb[a] if b >= 0}
    assert all((b, a) in adj for a, b in adj)              # symmetric
    want = {(a, b) for a, b in adj if b >= a}
    got = [(a, b) for a, b, _, _ in rows]
    assert len(got) == len(set(got)) and set(got) == want
    for a, b, sa, sb in rows:
        assert nb[a, sa] == b and nb[b, sb] == a
    return want


def test_tile_pairs_on_wrapped_lists(ctx_t):
    """On the cloud's cyclic lists, and on tiles made to meet across a
    seam: a tile spanning every x cell lists itself once, its pair with a
    tile adjacent to it both directly and across the seam is listed once,
    and two tiles three cells apart in x are neighbors across the seam
    only."""
    _check_tile_pairs(ctx_t.nbr)
    g = 4
    ci = np.zeros((4, ff_t.TILE, 3), np.int32)
    ci[0, :, 0] = np.arange(ff_t.TILE) % g                # spans x, y = 0
    ci[1, :, 0] = 3                                        # x = 3, y = 0
    ci[2, :, 1] = 2                                        # x = 0, y = 2
    ci[3, :, :2] = (3, 2)                                  # x = 3, y = 2
    ci_s = torch.from_numpy(ci.reshape(-1, 3))
    nbr, _ = ff_t._near_neighbor_lists(ci_s, 4, 3, wrap_xy=(g, g))
    assert nbr.tolist() == [[0, 1, -1], [0, 1, -1], [2, 3, -1], [2, 3, -1]]
    assert _check_tile_pairs(nbr) == {(0, 0), (0, 1), (1, 1), (2, 2),
                                      (2, 3), (3, 3)}
    open_nbr, _ = ff_t._near_neighbor_lists(ci_s, 4, 3)
    assert open_nbr[2].tolist() == [2, -1, -1]


@pytest.mark.parametrize("k", [1, 2])
def test_near_sweep_matches_jax(cloud, ctx_j, k):
    _, F = cloud
    cj = ctx_j
    t = cj.nbr.shape[0]
    F_s = _sorted_forces(cj, F[:k])
    U_j = ff_j._near_sweep(cj.x_s, cj.ci_s, cj.id_s, jnp.asarray(F_s), None,
                           cj.nbr, cj.nbr.shape[1], True, 0.75, 0, t,
                           box_n=BOX_N, wrap_xy=WRAP)
    U_t = ff_t._near_sweep(_t(cj.x_s), _t(cj.ci_s), _t(cj.id_s),
                           torch.from_numpy(F_s), _t(cj.nbr), True, 0.75,
                           box_n=BOX_N, wrap_xy=WRAP)
    assert U_t.shape == (k, t * ff_t.TILE, 3)
    assert _rel_live(U_t, U_j, np.array(cj.id_s) >= 0) < 1e-12


@pytest.mark.parametrize("k", [1, 2])
def test_near_sweep_wrapper_matches_pallas(cloud, ctx_j, k):
    """K3's wrapper on a CPU tensor (its plain version, float32) against
    the Pallas kernel's box form in interpret mode."""
    _, F = cloud
    cj = ctx_j
    live = np.array(cj.id_s) >= 0
    F_s = _sorted_forces(cj, F[:k]).astype(np.float32)
    x32 = jnp.array(cj.x_s, jnp.float32)
    U_p = rpy_pallas.near_sweep(x32, cj.ci_s, jnp.asarray(live),
                                jnp.asarray(F_s), cj.nbr, True, 0.75,
                                box_over_a=BOX_N, wrap_cells=WRAP,
                                interpret=True)
    U_t = farfield_cuda.near_sweep(
        _t(x32), _t(cj.ci_s), torch.from_numpy(live), torch.from_numpy(F_s),
        _t(cj.nbr), True, 0.75, box_over_a=BOX_N, wrap_cells=WRAP)
    assert U_t.dtype == torch.float32
    assert _rel_live(U_t, U_p, live) < KERNEL_TOL


@pytest.mark.parametrize("k", [1, 2])
def test_mobility_apply_matches_jax(cloud, ctx_j, ctx_t, k):
    """The whole film operator in float64: (N, 3) for one RHS, (2, N, 3)
    for two."""
    r, F = cloud
    Fk = F[0] if k == 1 else F
    U_j = np.asarray(ff_j.mobility_apply(jnp.asarray(Fk), jnp.asarray(r),
                                         ctx=ctx_j, **KW))
    U_t = ff_t.mobility_apply(torch.from_numpy(Fk), torch.from_numpy(r),
                              ctx=ctx_t, **KW).numpy()
    assert U_t.shape == U_j.shape
    assert np.abs(U_t - U_j).max() / np.abs(U_j).max() < 1e-10


def test_operator_matches_exact_image_sweep():
    """The port's far-field film at p = 4, S = 6 against its own exact image
    sweep, tail-extrapolated at S = 16: within the JAX package's bound for
    its own operator (tests/test_pseudo2d_farfield.py, 2e-3)."""
    rng = np.random.default_rng(9)
    n, box = 150, (14.0, 14.0)
    r = torch.from_numpy(np.stack([rng.uniform(0, box[0], n),
                                   rng.uniform(0, box[1], n),
                                   rng.uniform(1.0, 4.0, n)], axis=1))
    F = torch.from_numpy(rng.standard_normal((n, 3)))
    U = ff_t.mobility_apply(F, r, wall=True, grid=(4, 4, 1), p=4, box=box,
                            image_shells=6)
    U_ref = rpy_t.mobility_apply(F, r, wall=True, box=box, image_shells=16)
    assert (U - U_ref).abs().max() / U_ref.abs().max() < 2e-3


def test_geometry_reuse_guards_z_only(cloud, ctx_j):
    """A reused geometry tier at positions moved by whole periods and half
    the box in x/y stays valid (they wrap, as in the JAX package), and
    matches the JAX operator there; a move of 2+ cells in z poisons the
    apply with NaN in both packages."""
    r, F = cloud
    geo_j = ff_j.prepare_geometry(jnp.asarray(r), **KW)
    geo_t = ff_t.prepare_geometry(torch.from_numpy(r), **KW)
    moved = r.copy()
    moved[:100, 0] += 3 * BOX[0] + 0.5 * BOX[0]
    moved[100:200, 1] -= 2 * BOX[1] + 0.3 * BOX[1]
    up = r.copy()
    up[0, 2] += 9.0                       # h_z ≈ 2a: 4 cells out
    for r2, bad in ((moved, False), (up, True)):
        c_j = ff_j.prepare(jnp.asarray(r2), geo=geo_j, **KW)
        c_t = ff_t.prepare(torch.from_numpy(r2), geo=geo_t, **KW)
        assert bool(c_t.overflow) is bool(c_j.overflow) is bad
        U_t = ff_t.mobility_apply(torch.from_numpy(F), torch.from_numpy(r2),
                                  ctx=c_t, **KW).numpy()
        if bad:
            assert np.isnan(U_t).all()
            continue
        U_j = np.asarray(ff_j.mobility_apply(jnp.asarray(F), jnp.asarray(r2),
                                             ctx=c_j, **KW))
        assert np.abs(U_t - U_j).max() / np.abs(U_j).max() < 1e-10
    assert c_t.khat_wall is geo_t.khat_wall


def test_config_rules_match_jax(cloud):
    """The JAX package's rules for the film's far field raise alike in both
    packages: image_shells ≥ 1 and the wall (configuration and operator),
    ≥ 4 cells on x and y (operator), no band tier; the valid configuration
    is accepted."""
    r, F = cloud
    base = dict(box=BOX, farfield_grid=(4, 4, 2), gmres_tol=1e-2,
                max_step_residual=1e-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for cls in (SimulationConfig, CfgT):
            with pytest.raises(ValueError, match="image_shells"):
                cls(wall=True, **base)
            with pytest.raises(ValueError, match="wall"):
                cls(image_shells=6, **base)
            cfg = cls(wall=True, image_shells=6, **base)
            assert cfg.box == BOX and cfg.farfield_grid == (4, 4, 2)
            hash(cfg)
        with pytest.raises(ValueError, match="compose"):
            CfgT(wall=True, image_shells=6, farfield_band_p=4, **base)
    with pytest.raises(ValueError, match="compose"):
        ff_j.prepare_geometry(jnp.asarray(r), band_p=4, **KW)
    rj, Fj = jnp.asarray(r), jnp.asarray(F[0])
    rt, Ft = torch.from_numpy(r), torch.from_numpy(F[0])
    bad = {"cells": dict(KW, grid=(3, 4, 2)),
           "image_shells": dict(KW, image_shells=0),
           "wall": dict(KW, wall=False)}
    for what, kw in bad.items():
        with pytest.raises(ValueError, match=what):
            ff_j.mobility_apply(Fj, rj, **kw)
        with pytest.raises(ValueError, match=what):
            ff_t.mobility_apply(Ft, rt, **kw)
