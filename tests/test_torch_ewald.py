"""Port parity of the triply-periodic Ewald operator
(``rigid_body_light_tpu_torch/ops/ewald.py`` and ``ewald_cuda.py``) against
the JAX package on the same numpy inputs.

Two boxes: (9, 11, 10) with a = 0.45 at the default tolerance (K = 3862
wavevectors: the per-axis phase-table branch, Chebyshev degree 58) and
the periodic slice's (14, 14, 14) with shell_N_642's blob radius a =
0.0675 at ``tol = 1e-4`` (K = 846: the direct cos/sin branch; the long
segment starts at 2a = 0.135, so the fit escalates twice, to degree 81).
Each box's host fit runs once per package (module-scoped fixture).  The CUDA sweep K4 cannot run
here; its plain version, which the wrapper takes on a CPU tensor, is held
against the Pallas kernel in interpret mode, as the JAX package's own test
runs that kernel on the CPU.

Tolerances: float64 results agree to 1e-10 (roundoff of sums ordered
differently); float32 results to 5e-6·max|U|, the bound the TPU kernel is
held to against the streamed sweep.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig as ConfigJ  # noqa: E402
from rigid_body_light_tpu.ops import ewald as ewald_j  # noqa: E402
from rigid_body_light_tpu.ops import ewald_pallas as pallas_j  # noqa: E402
import rigid_body_light_tpu_torch as rt  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import run_bd  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald as ewald_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_pme  # noqa: E402
from rigid_body_light_tpu_torch.ops import kinematics as kin_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402

N = 700          # not a multiple of any tile edge
F64_TOL = 1e-10
F32_TOL = 5e-6   # of max|U|
BOXES = {
    "aniso": dict(box=(9.0, 11.0, 10.0), a=0.45, tol=1e-6),
    "slice": dict(box=(14.0, 14.0, 14.0), a=0.06752767533299997, tol=1e-4),
}
DTYPES = {"float64": (jnp.float64, torch.float64, F64_TOL),
          "float32": (jnp.float32, torch.float32, F32_TOL)}


@pytest.fixture(scope="module", params=list(BOXES))
def case(request):
    """(JAX params, the port's own params, the JAX params carried across,
    positions (N, 3), forces (2, N, 3)) for one box."""
    kw = BOXES[request.param]
    pj = ewald_j.make_params(kw["box"], kw["a"], tol=kw["tol"])
    pt = ewald_t.make_params(kw["box"], kw["a"], tol=kw["tol"])
    carried = interop.ewald_params_from_numpy(**pj._asdict())
    rng = np.random.default_rng(11)
    r = rng.uniform(0, kw["box"][0], (N, 3))
    F = rng.standard_normal((2, N, 3))
    return pj, pt, carried, r, F


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


def test_make_params_equal(case):
    pj, pt, carried, _, _ = case
    assert pt.box == pj.box and pt.rc is None
    for p in (pt, carried):
        for f in ("a", "eta", "xi"):
            assert getattr(p, f) == getattr(pj, f)
        for f in ("kvecs", "wk", "wk_raw", "cheb_bounds", "cheb_A", "cheb_B"):
            vj, vt = getattr(pj, f), getattr(p, f)
            assert vt.shape == vj.shape and vt.dtype == np.float64
            assert np.abs(vt - vj).max() <= 1e-14 * max(1.0, np.abs(vj).max())
        assert np.array_equal(p.nvecs, pj.nvecs)
    assert carried.cheb_A is not pj.cheb_A   # a copy, not the JAX array


def test_branches_covered(case):
    """The two boxes sit on the two sides of the phase-table switch."""
    _, pt, _, _, _ = case
    K = len(pt.kvecs)
    assert K == (846 if pt.box[0] == 14.0 else 3862)
    assert pt.cheb_A.shape == ((3, 82) if pt.box[0] == 14.0 else (3, 59))


def test_closed_form_scalars_float64(case):
    pj, pt, _, _, _ = case
    rr = np.random.default_rng(5).uniform(0.01, 0.5 * np.linalg.norm(pt.box),
                                          1000)
    Aj, Bj = ewald_j.real_space_ab(jnp.asarray(rr), pj.a, pj.xi, pj.eta)
    At, Bt = ewald_t.real_space_ab(torch.from_numpy(rr), pt.a, pt.xi, pt.eta)
    assert np.abs(At.numpy() - np.asarray(Aj)).max() < F64_TOL
    assert np.abs(Bt.numpy() - np.asarray(Bj)).max() < F64_TOL
    assert abs(ewald_t.self_coeff(pt.a, pt.xi, pt.eta)
               - float(ewald_j.self_coeff(pj.a, pj.xi, pj.eta))) < F64_TOL


def test_chebyshev_scalars_float32(case):
    """Clenshaw on the fit, float32, every segment (r from below the clamp
    radius to the half diagonal), to 1e-6 of the scalars' scale; and the
    float64 Clenshaw within the fit's 3e-6 of the closed forms."""
    pj, pt, _, _, _ = case
    rr = np.random.default_rng(6).uniform(0.0, 0.5 * np.linalg.norm(pt.box),
                                          4000).astype(np.float32)
    rr[:8] = [0.0, 1e-4, pt.cheb_bounds[0], pt.cheb_bounds[1],
              pt.cheb_bounds[2], 1.99 * pt.a, 2.01 * pt.a, pt.cheb_bounds[3]]
    Aj, Bj = ewald_j._cheb_ab(jnp.asarray(rr), pj.cheb_bounds, pj.cheb_A,
                              pj.cheb_B)
    At, Bt = ewald_t._cheb_ab(torch.from_numpy(rr), pt.cheb_bounds,
                              pt.cheb_A, pt.cheb_B)
    scale = 1.0 / (6.0 * np.pi * pt.eta * pt.a)
    assert At.dtype == torch.float32
    assert np.abs(At.numpy() - np.asarray(Aj)).max() < 1e-6 * scale
    assert np.abs(Bt.numpy() - np.asarray(Bj)).max() < 1e-6 * scale
    r64 = torch.from_numpy(rr[8:].astype(np.float64)).clamp(min=0.05 * pt.a)
    Ac, Bc = ewald_t._cheb_ab(r64, pt.cheb_bounds, pt.cheb_A, pt.cheb_B)
    Ax, Bx = ewald_t.real_space_ab(r64, pt.a, pt.xi, pt.eta)
    # the short overlap segment (r < 2a) is S''-sample-noise limited at
    # ~1e-5 of scale, as the fit's own escalation loop says
    assert (Ac - Ax).abs().max().item() < 2e-5 * scale
    assert (Bc - Bx).abs().max().item() < 2e-5 * scale


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["real_space_apply", "wave_space_apply",
                                "mobility_apply_multi"])
def test_operator_parts_match(case, fn, dtype):
    """(2, N, 3) forces through each part and the whole operator."""
    pj, _, carried, r, F = case
    dj, dt, tol = DTYPES[dtype]
    Uj = getattr(ewald_j, fn)(jnp.asarray(F, dj), jnp.asarray(r, dj), pj)
    Ut = getattr(ewald_t, fn)(torch.from_numpy(F).to(dt),
                              torch.from_numpy(r).to(dt), carried)
    assert Ut.shape == (2, N, 3) and Ut.dtype == dt
    assert _rel(Ut, Uj) < tol


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mobility_apply_single_rhs(case, dtype):
    """(N, 3) forces: the numbers of the multi-RHS product, which shares
    the pair fields and is held to the JAX package above."""
    _, pt, _, r, F = case
    _, dt, _ = DTYPES[dtype]
    rt_, Ft = torch.from_numpy(r).to(dt), torch.from_numpy(F).to(dt)
    Ut = ewald_t.mobility_apply(Ft[0], rt_, pt)
    Um = ewald_t.mobility_apply_multi(Ft, rt_, pt)
    assert Ut.shape == (N, 3) and Ut.dtype == dt
    assert _rel(Ut, Um[0]) < (1e-13 if dtype == "float64" else 1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wave_space_chunked_matches_dense(case, dtype):
    """The K-chunked wave sum called directly (its switch needs K·N > 2²⁷),
    with a chunk that does not divide K, with and without the lattice
    indices, against the JAX dense sum."""
    pj, _, carried, r, F = case
    dj, dt, tol = DTYPES[dtype]
    Uj = ewald_j._wave_space_dense(jnp.asarray(F, dj), jnp.asarray(r, dj), pj)
    rt_, Ft = torch.from_numpy(r).to(dt), torch.from_numpy(F).to(dt)
    for p in (carried, carried._replace(nvecs=None)):
        Ut = ewald_t._wave_space_chunked(Ft, rt_, p, kc=500)
        assert _rel(Ut, Uj) < tol
    U1 = ewald_t._wave_space_chunked(Ft[0], rt_, carried, kc=500)
    assert U1.shape == (N, 3) and _rel(U1, Uj[0]) < tol


@pytest.mark.parametrize("case", ["aniso"], indirect=True)
@pytest.mark.parametrize("nrhs", [1, 2])
def test_plain_sweep_matches_pallas_interpret(case, nrhs):
    """K4's wrapper on CPU tensors (the plain float32 sweep) against the
    Pallas kernel in interpret mode."""
    pj, _, carried, r, F = case
    U = pallas_j.real_pair_sum(jnp.asarray(F[:nrhs], jnp.float32),
                               jnp.asarray(r, jnp.float32), pj,
                               interpret=True)
    before = ewald_cuda.sweep_launches
    Ut = ewald_cuda.real_pair_sum(torch.from_numpy(F[:nrhs]).float(),
                                  torch.from_numpy(r).float(), carried)
    assert ewald_cuda.sweep_launches == before   # no kernel on the CPU
    assert Ut.shape == (nrhs, N, 3) and Ut.dtype == torch.float32
    assert _rel(Ut, U) < F32_TOL
    # and against the float64 Clenshaw the kernel is held to on the card
    U64 = ewald_t.real_space_apply(torch.from_numpy(F[:nrhs]),
                                   torch.from_numpy(r), carried, cheb=True)
    assert _rel(Ut, U64) < F32_TOL


@pytest.mark.parametrize("case", ["slice"], indirect=True)
def test_wrapper_operator_matches_pallas_interpret(case):
    pj, pt, _, r, F = case
    Uj = pallas_j.mobility_apply_multi(jnp.asarray(F, jnp.float32),
                                       jnp.asarray(r, jnp.float32), pj,
                                       interpret=True)
    Ft, rt_ = torch.from_numpy(F), torch.from_numpy(r)   # cast by the wrapper
    Ut = ewald_cuda.mobility_apply_multi(Ft, rt_, pt)
    assert Ut.dtype == torch.float32 and _rel(Ut, Uj) < F32_TOL
    assert _rel(ewald_cuda.mobility_apply(Ft[0], rt_, pt), Uj[0]) < F32_TOL


def test_table_and_constants_of_the_sweep(case):
    """What the wrapper hands the kernel: the table [j][segment] = (A_j,
    B_j) and the 14 scalars, float32 from the float64 fit."""
    _, pt, _, _, _ = case
    table = ewald_cuda.coefficient_table(pt)
    D = pt.cheb_A.shape[1] - 1
    assert table.shape == (D + 1, 4, 2) and table.dtype == np.float32
    np.testing.assert_array_equal(table[:, :3, 0],
                                  pt.cheb_A.T.astype(np.float32))
    np.testing.assert_array_equal(table[:, :3, 1],
                                  pt.cheb_B.T.astype(np.float32))
    assert not table[:, 3].any()
    c = ewald_cuda.sweep_constants(pt)
    assert c.shape == (14,) and c.dtype == np.float32
    assert np.isfinite(c).all()
    np.testing.assert_allclose(c[:3] * c[3:6], 1.0, rtol=1e-6)
    b = pt.cheb_bounds
    np.testing.assert_allclose(c[6:8], b[1:3], rtol=1e-6)
    np.testing.assert_allclose(c[8:11], b[:3], rtol=1e-6)
    np.testing.assert_allclose(c[12:14], 2.0 / np.diff(b)[1:], rtol=1e-6)


def test_hasimoto_self_mobility():
    """A single sphere in a cubic box: 1 − 2.837297·a/L + 4π/3·(a/L)³."""
    a, eta = 0.25, 1.3
    for L in (20.0, 40.0):
        p = ewald_t.make_params((L, L, L), a, eta, tol=1e-9)
        U = ewald_t.mobility_apply(
            torch.tensor([[0.0, 0, 1.0]], dtype=torch.float64),
            torch.tensor([[1.2, 3.4, 5.6]], dtype=torch.float64), p)
        mu0 = 1 / (6 * np.pi * eta * a)
        pred = mu0 * (1 - 2.837297 * a / L + 4 * np.pi / 3 * (a / L) ** 3)
        assert abs(U[0, 2].item() - pred) / pred < 1e-6


def test_dense_matrix_symmetric_spd():
    rng = np.random.default_rng(1)
    r = rng.uniform(0, 10.0, (12, 3))
    pj = ewald_j.make_params((10.0, 10.0, 10.0), 0.25, 1.3, tol=1e-8)
    pt = interop.ewald_params_from_numpy(**pj._asdict())
    M = ewald_t.mobility_matrix(torch.from_numpy(r), pt).numpy()
    np.testing.assert_allclose(M, M.T, atol=1e-14)
    assert np.linalg.eigvalsh((M + M.T) / 2).min() > 0
    F = rng.standard_normal((12, 3))
    Uj = ewald_j.mobility_apply(jnp.asarray(F), jnp.asarray(r), pj)
    np.testing.assert_allclose(M @ F.reshape(-1), np.asarray(Uj).reshape(-1),
                               atol=1e-12)


def test_float32_refuses_closed_forms(case):
    _, pt, _, r, F = case
    with pytest.raises(ValueError, match="float32"):
        ewald_t.real_space_apply(torch.from_numpy(F[0]).float(),
                                 torch.from_numpy(r).float(), pt, cheb=False)


def test_config_dispatch_and_guards():
    box = (10.0, 10.0, 10.0)
    with pytest.raises(ValueError, match="incompatible with"):
        rt.SimulationConfig(box=box, wall=True)
    # a 2-D box with farfield_grid is the film's far field, not Ewald
    film = rt.SimulationConfig(box=(10.0, 10.0), wall=True, image_shells=1,
                               farfield_grid=(4, 4, 2), gmres_tol=5e-3)
    assert film.box == (10.0, 10.0) and film.farfield_grid == (4, 4, 2)
    # the balanced split and its grid, once refused, are configurations
    assert rt.SimulationConfig(box=box, ewald_rc=3.0).ewald_rc == 3.0
    assert rt.SimulationConfig(box=box, ewald_rc=3.0,
                               ewald_grid_p=4).ewald_grid_p == 4
    # the JAX configuration carries across, box and all
    cfg_j = ConfigJ(a=0.25, eta=1.3, box=box, dtype=jnp.float64,
                    ewald_tol=1e-8)
    cfg = interop.config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg.box == box and cfg.dtype == torch.float64
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.uniform(0, 10.0, (8, 3)))
    F = torch.from_numpy(rng.standard_normal((2, 8, 3)))
    p = ewald_t.make_params(box, 0.25, 1.3, tol=1e-8)
    ref = ewald_t.mobility_apply_multi(F, r, p)
    mob, multi = (saddle_t.mobility_apply_fn(cfg),
                  saddle_t.mobility_apply_multi_fn(cfg))
    np.testing.assert_allclose(mob(F[0], r).numpy(), ref[0].numpy(),
                               atol=1e-14)
    np.testing.assert_allclose(multi(F, r).numpy(), ref.numpy(), atol=1e-14)
    # the fit runs once per configuration, not once per closure
    assert saddle_t._ewald_params.cache_info().misses >= 1
    misses = saddle_t._ewald_params.cache_info().misses
    saddle_t.mobility_apply_fn(cfg)
    assert saddle_t._ewald_params.cache_info().misses == misses
    # the Ewald operator has no position setup to hoist
    assert saddle_t.hoist_positions(mob, r) is mob
    assert saddle_t.pin_geometry(mob, r) is mob
    # float32 goes to K4's wrapper (the plain sweep on CPU tensors)
    mob32 = saddle_t.mobility_apply_fn(cfg.replace(dtype=torch.float32))
    U32 = mob32(F[0].float(), r.float())
    assert U32.dtype == torch.float32
    assert _rel(U32, ref[0]) < 1e-4   # ewald_tol 1e-8, fit 3e-6, float32
    # the balanced split, radii and the grid, once refused, are dispatched:
    # rc to the tile sweep (K4's wrapper keeps the classic split only),
    # radii to the polydisperse sweeps, a grid to the gridded wave part
    p_rc = ewald_t.make_params(box, 0.25, 1.3, rc=3.0)
    U_rc = ewald_t.mobility_apply(F[0], r, p_rc)
    assert _rel(U_rc, ref[0]) < 5e-5   # both splits truncate by 1e-6
    with pytest.raises(ValueError, match="classic split"):
        ewald_cuda.mobility_apply(F[0], r, p_rc)
    U_one = ewald_t.mobility_apply(F[0], r, p, radii=torch.full((8,), 0.25,
                                                                 dtype=torch.float64))
    assert _rel(U_one, ref[0]) < 1e-12   # equal radii: the mono operator
    g = ewald_pme.make_grid(p_rc, p=4)
    assert _rel(ewald_t.mobility_apply(F[0], r, p_rc, grid=g), U_rc) < 1e-3
    with pytest.raises(ValueError, match="same radii"):
        ewald_t.mobility_apply(F[0], r, p_rc, radii=torch.full(
            (8,), 0.25, dtype=torch.float64), grid=g)
    with pytest.raises(NotImplementedError, match="RHS"):
        ewald_cuda.real_pair_sum(torch.cat([F, F[:1]]), r, p)


def test_run_bd_refuses_a_box_too_small_for_the_body():
    params, ref = rt.load_structure("shell_N_42")
    a = params["sep"] / 2
    diam = 2 * a + np.sqrt(((ref[:, None] - ref[None]) ** 2).sum(-1)).max()
    geom = kin_t.make_ref_geometry(ref, dtype=torch.float64, device="cpu")
    state = rt.make_state(np.full((1, 3), 2.0), np.array([[1.0, 0, 0, 0]]),
                          dtype=torch.float64, device="cpu")
    L = 2.0 * diam * 0.99       # body diameter ≥ min(L)/2
    cfg = rt.SimulationConfig(a=a, dt=0.01, kBT=1.0, box=(3 * L, L, 3 * L),
                              dtype=torch.float64, lanczos_iters=4)
    with pytest.raises(ValueError, match="too small for this body"):
        run_bd(geom, cfg, state, 1,
               generator=torch.Generator().manual_seed(0))
