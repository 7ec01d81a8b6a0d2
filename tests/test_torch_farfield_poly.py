"""Port parity of the polydisperse far field (per-blob radii with
``farfield_grid``: the radius-split kernel lattices and K3's POLY form)
against the JAX package, on the CPU.

The same numpy inputs go through both packages: the split coefficients and
the free, wall and film lattices in float64 to 1e-12 of their largest
entry; the sorted radii, damping and self terms; the plain near sweep with
radii in float64 to 1e-12 and K3's wrapper (its plain version here)
against the Pallas kernel in interpret mode in float32 to 1e-5 of max|U|
(open, wall and box); the whole operator in float64 to 1e-10, open free,
open wall and film, one and two RHS; radii equal to a everywhere against
the monodisperse operator; ``auto_grid``'s poly rule; and the saddle-level
apply-fns with radii.

The cloud draws its radii from {0.6, 1.1}·a (``tests/test_pallas.py``'s
choice), holds pairs of unequal radii closer than |aᵢ − aⱼ| (the deep
branch) and closer than aᵢ + aⱼ (the overlap branch), and its heights
straddle the wall-height floor in units of either radius.  Cells are wider
than the largest contact distance, as the JAX package requires.  Rows of
pad blobs are left out of the near-sweep comparisons.  The JAX references
are compiled at XLA's cheapest CPU optimization (:func:`jax_fast`).
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
from rigid_body_light_tpu.ops import rpy_pallas  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield as ff_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402

N = 400
A = 1.1
# the open domain: 3 × 3 × 2 cells of ~5a over a 16a square; the film: the
# same heights in a (16, 16) box of 4 × 4 cells, image_shells 2
OPEN = dict(a=A, eta=0.9, grid=(3, 3, 2), p=4)
BOX = (16.0, 16.0)
FILM = dict(a=A, eta=0.9, wall=True, grid=(4, 4, 2), p=3, box=BOX,
            image_shells=2)
CASES = {"free": dict(OPEN, wall=False), "wall": dict(OPEN, wall=True),
         "film": FILM}
# float64 lattices and near sweep against the JAX package, relative to the
# largest entry; the operator, relative to max|U|
LATTICE_TOL = 1e-12
OPERATOR_TOL = 1e-10
# K3's wrapper (float32) against the Pallas kernel in interpret mode (the
# bound of tests/test_farfield_pallas.py)
WRAPPER_TOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE` (an eighth
    of the eager far field's time here, within roundoff of it)."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def cloud():
    """N blobs over 16a × 16a at heights 0.3a–6a with radii {0.6, 1.1}·a;
    blob 1 sits 0.02a from blob 0 (deep branch), blob 3 0.8a from blob 2
    (overlap branch), both pairs of unequal radii."""
    rng = np.random.default_rng(17)
    r = rng.uniform([0, 0, 0.3 * A], [16, 16, 6 * A], (N, 3))
    radii = rng.choice([0.6 * A, 1.1 * A], N)
    radii[:4] = [0.6 * A, 1.1 * A, 1.1 * A, 0.6 * A]
    r[1] = r[0] + [0.02 * A, 0, 0]
    r[3] = r[2] + [0, 0.8 * A, 0]
    F = rng.standard_normal((2, N, 3))
    return r, radii, F


@pytest.fixture(scope="module")
def ctx(cloud):
    """Both packages' FarCtx with radii, per case."""
    r, radii, _ = cloud
    return {case: (jax_fast(lambda r_, a_, kw=kw: ff_j.prepare(
                       r_, radii=a_, **kw), jnp.asarray(r),
                       jnp.asarray(radii)),
                   ff_t.prepare(torch.from_numpy(r),
                                radii=torch.from_numpy(radii), **kw))
            for case, kw in CASES.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _rel_live(U, U_ref, live):
    return _rel(np.asarray(U)[:, live], np.asarray(U_ref)[:, live])


def _free_lattices_j(Kp):
    """The JAX package's packed (nk, 2, nf, B, B) lattices as complex."""
    Kp = np.asarray(Kp)
    return Kp[:, 0] + 1j * Kp[:, 1]


def _z_lattices_j(Kp, gz):
    """The JAX package's packed (nk, 2, gz_t, gz_s, f, B, B) wall or film
    lattices in the port's (nk, f, gz_t·B, gz_s·B) complex layout."""
    K = _free_lattices_j(Kp)
    nk, f, B = K.shape[0], K.shape[3], K.shape[4]
    return K.transpose(0, 3, 1, 4, 2, 5).reshape(nk, f, gz * B, gz * B)


def test_free_split_coeffs_matches_jax():
    """Distances below the 1e-2 floor, near it and far."""
    r2 = np.concatenate([[0.0, 1e-3, 1e-2], np.geomspace(0.02, 400.0, 50)])
    out_j = ff_j._free_split_coeffs(jnp.asarray(r2), jnp.float64)
    out_t = ff_t._free_split_coeffs(torch.from_numpy(r2))
    for pair_t, pair_j in zip(out_t, out_j):
        for x_t, x_j in zip(pair_t, pair_j):
            np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j),
                                       rtol=1e-15, atol=0)


H = np.array([2.3, 1.9, 1.4])
GRID = (3, 4, 2)


def test_far_kernel_hat_poly_matches_jax():
    """[K₀, K₂] on an anisotropic grid (odd and even counts)."""
    K_j = _free_lattices_j(ff_j._far_kernel_hat(jnp.asarray(H), GRID, 3,
                                                jnp.float64, poly=True))
    K_t = ff_t._far_kernel_hat(torch.from_numpy(H), GRID, 3,
                               poly=True).numpy()
    assert K_t.shape == K_j.shape == (2, 6 * 8 * 3, 81, 81)
    assert _rel(K_t, K_j) < LATTICE_TOL


def test_wall_kernel_hat_poly_matches_jax():
    """[G₀, G₁, G₂], node heights below the wall floor; their sum is the
    monodisperse lattice."""
    args = (GRID, 3)
    K_j = _z_lattices_j(ff_j._wall_kernel_hat(
        jnp.asarray(0.5), jnp.asarray(H), *args, jnp.float64, 0.75,
        poly=True), GRID[2])
    K_t = ff_t._wall_kernel_hat(torch.tensor(0.5, dtype=torch.float64),
                                torch.from_numpy(H), *args, 0.75,
                                poly=True).numpy()
    assert K_t.shape == K_j.shape == (3, 6 * 5, 2 * 81, 2 * 81)
    assert _rel(K_t, K_j) < LATTICE_TOL
    mono = ff_t._wall_kernel_hat(torch.tensor(0.5, dtype=torch.float64),
                                 torch.from_numpy(H), *args, 0.75).numpy()
    assert _rel(K_t.sum(0), mono) < LATTICE_TOL


def test_kernel_hat_2p_poly_matches_jax():
    """The four film lattices [K₀ + G₀, G₁, G₂, K₂] at S = 2, an odd grid."""
    h = np.array([4.0, 3.0, 1.5])
    grid = (5, 4, 2)
    K_j = _z_lattices_j(ff_j._kernel_hat_2p(
        jnp.asarray(0.5), jnp.asarray(h), grid, 3, jnp.float64, 0.75, 2,
        poly=True), 2)
    K_t = ff_t._kernel_hat_2p(torch.tensor(0.5, dtype=torch.float64),
                              torch.from_numpy(h), grid, 3, 0.75, 2,
                              poly=True).numpy()
    assert K_t.shape == K_j.shape == (4, 5 * 3, 2 * 81, 2 * 81)
    assert _rel(K_t, K_j) < LATTICE_TOL


@pytest.mark.parametrize("n,p,wall", [
    (900, 4, True), (25_620, 4, False), (108_960, 4, True),
    (108_960, 6, True), (1_000_000, 4, False), (1_000_000, 4, True),
])
def test_auto_grid_poly_matches_jax(n, p, wall):
    assert ff_t.auto_grid(n, p, wall, poly=True) == ff_j.auto_grid(
        n, p, wall, poly=True)


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_poly_matches_jax(ctx, case):
    """Order and lists bit for bit; the radii (sorted, pads 1), damping at
    z/aᵢ and the self terms (4/3)·a/aᵢ plus the wall's at aᵢ to roundoff."""
    cj, ct = ctx[case]
    for name in ("order", "id_s", "nbr"):
        assert np.array_equal(getattr(ct, name).numpy(),
                              np.asarray(getattr(cj, name))), name
    names = ["ahat", "ah_s", "self_diag", "W3"] + (
        ["b"] if CASES[case]["wall"] else [])
    for name in names:
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)), rtol=1e-14,
                                   atol=1e-14, err_msg=name)
    pad = ct.ah_s.shape[0] - N
    assert pad > 0 and bool((ct.ah_s[N:] == 1.0).all())


def _sorted_forces(ctx, F):
    pad = ctx.x_s.shape[0] - N
    return np.concatenate([F[:, np.asarray(ctx.order)],
                           np.zeros((F.shape[0], pad, 3))], axis=1)


def _box_args(case):
    if case != "film":
        return None, None
    return tuple(b / A for b in BOX), FILM["grid"][:2]


@pytest.mark.parametrize("case", list(CASES))
def test_near_sweep_poly_matches_jax(cloud, ctx, case):
    """The plain near sweep with radii, float64, 2 RHS."""
    _, _, F = cloud
    cj, _ = ctx[case]
    t = cj.nbr.shape[0]
    box_n, wrap = _box_args(case)
    wall = CASES[case]["wall"]
    F_s = _sorted_forces(cj, F)
    U_j = ff_j._near_sweep(cj.x_s, cj.ci_s, cj.id_s, jnp.asarray(F_s),
                           cj.ah_s, cj.nbr, cj.nbr.shape[1], wall, 0.75, 0,
                           t, box_n=box_n, wrap_xy=wrap)
    U_t = ff_t._near_sweep(_t(cj.x_s), _t(cj.ci_s), _t(cj.id_s),
                           torch.from_numpy(F_s), _t(cj.nbr), wall, 0.75,
                           box_n=box_n, wrap_xy=wrap, ah_s=_t(cj.ah_s))
    assert _rel_live(U_t, U_j, np.asarray(cj.id_s) >= 0) < LATTICE_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_near_sweep_wrapper_poly_matches_pallas(cloud, ctx, case):
    """K3's wrapper with ahat_s on a CPU tensor (its plain version, float32)
    against the Pallas kernel's poly form in interpret mode, 2 RHS."""
    _, _, F = cloud
    cj, _ = ctx[case]
    box_n, wrap = _box_args(case)
    wall = CASES[case]["wall"]
    live = np.asarray(cj.id_s) >= 0
    F_s = _sorted_forces(cj, F).astype(np.float32)
    x32 = jnp.asarray(cj.x_s, jnp.float32)
    a32 = jnp.asarray(cj.ah_s, jnp.float32)
    U_p = rpy_pallas.near_sweep(x32, cj.ci_s, jnp.asarray(live),
                                jnp.asarray(F_s), cj.nbr, wall, 0.75,
                                box_over_a=box_n, wrap_cells=wrap,
                                ahat_s=a32, interpret=True)
    before = farfield_cuda.launch_counts()
    U_t = farfield_cuda.near_sweep(
        _t(x32), _t(cj.ci_s), torch.from_numpy(live), torch.from_numpy(F_s),
        _t(cj.nbr), wall, 0.75, box_over_a=box_n, wrap_cells=wrap,
        ahat_s=_t(a32))
    assert U_t.dtype == torch.float32
    assert farfield_cuda.launch_counts() == before   # no kernel on the CPU
    assert _rel_live(U_t, U_p, live) < WRAPPER_TOL


@pytest.fixture(scope="module")
def U_j(cloud, ctx):
    """The JAX operator with radii on both RHS, per case (float64)."""
    r, radii, F = cloud
    return {case: np.asarray(jax_fast(
        lambda F_, r_, a_, c_, kw=kw: ff_j.mobility_apply(
            F_, r_, radii=a_, ctx=c_, **kw), jnp.asarray(F), jnp.asarray(r),
        jnp.asarray(radii), ctx[case][0])) for case, kw in CASES.items()}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_mobility_apply_poly_matches_jax(cloud, U_j, case, k):
    """The whole polydisperse operator in float64: (N, 3) for one RHS,
    (2, N, 3) for two."""
    r, radii, F = cloud
    Fk, ref = (F[0], U_j[case][0]) if k == 1 else (F, U_j[case])
    U_t = ff_t.mobility_apply(torch.from_numpy(Fk), torch.from_numpy(r),
                              radii=torch.from_numpy(radii),
                              **CASES[case]).numpy()
    assert U_t.shape == ref.shape
    assert _rel(U_t, ref) < OPERATOR_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_equal_radii_reduce_to_mono(cloud, case):
    """radii = a everywhere: the split lattices and the POLY near fields
    give the monodisperse operator (tests/test_farfield.py:299-309)."""
    r, _, F = cloud
    rt, Ft = torch.from_numpy(r), torch.from_numpy(F)
    U_m = ff_t.mobility_apply(Ft, rt, **CASES[case])
    U_p = ff_t.mobility_apply(Ft, rt, radii=torch.full((N,), A,
                                                       dtype=torch.float64),
                              **CASES[case])
    assert _rel(U_p, U_m) < OPERATOR_TOL


def _cfgs(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_j = SimulationConfig(dtype=jnp.float64, **kw)
        cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    return cfg_j, cfg_t


@pytest.mark.parametrize("case", ["wall", "film"])
def test_apply_fns_with_radii_match_jax(cloud, case):
    """saddle.mobility_apply_fn / mobility_apply_multi_fn with radii and
    farfield_grid compute (tests/test_farfield.py:313-330) and match the
    JAX package's; the hoisted and pinned forms carry the radii into the
    position setup and the lattice build (one build, shared)."""
    r, radii, F = cloud
    kw = dict(a=A, eta=1.3, wall=True, farfield_p=CASES[case]["p"],
              farfield_grid=CASES[case]["grid"])
    if case == "film":
        kw.update(box=BOX, image_shells=2)
    cfg_j, cfg_t = _cfgs(**kw)
    U_j = np.asarray(jax_fast(lambda F_, r_, a_: saddle_j.mobility_apply_fn(
        cfg_j, radii=a_)(F_, r_), jnp.asarray(F[0]), jnp.asarray(r),
        jnp.asarray(radii)))
    rt, Ft, rad = (torch.from_numpy(x) for x in (r, F, radii))
    mob = saddle_t.mobility_apply_fn(cfg_t, radii=rad)
    U_t = mob(Ft[0], rt)
    assert _rel(U_t, U_j) < OPERATOR_TOL
    assert torch.equal(saddle_t.hoist_positions(mob, rt)(Ft[0], rt), U_t)
    U2 = saddle_t.mobility_apply_multi_fn(cfg_t, radii=rad)(Ft, rt)
    assert _rel(U2[0], U_j) < OPERATOR_TOL
    pinned = saddle_t.pin_geometry(mob, rt)
    assert torch.equal(pinned(Ft[0], rt), U_t)
    geo = pinned.prepare_geometry(rt)
    assert geo.khat_wall.shape[0] == (4 if case == "film" else 3)
    assert pinned.prepare(rt).khat_wall is geo.khat_wall
    # the radii reach the operator: other radii, another product
    U_o = saddle_t.mobility_apply_fn(cfg_t, radii=rad * 0.9)(Ft[0], rt)
    assert _rel(U_o, U_t.numpy()) > 1e-3
