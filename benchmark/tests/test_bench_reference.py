"""The plain reference against itself in float64, against the repository's
loop-based numpy oracle, and against the port at a tiny size on the CPU
through the port's public entry points."""

import os
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import ewald, rpy, solve, step
from benchmark.reference.arith import F64, TF32, round_tf32
from benchmark.spec import ROOT

sys.path.insert(0, os.path.join(ROOT, "tests"))
import oracle  # noqa: E402  (numpy only)

SHELL = os.path.join(ROOT, "rigid_body_light_tpu", "structures",
                     "shell_N_42.csv")


def _cloud(n=40, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 3, size=(n, 3))
    r[:, 2] = rng.uniform(0.1, 2.0, n)
    return r, rng.standard_normal((n, 3))


@pytest.mark.parametrize("wall", [False, True])
def test_rows_match_the_oracle(wall):
    r, F = _cloud()
    want = oracle.apply_M(F, r, a=0.3, eta=1.3, wall=wall).reshape(-1, 3)
    rows = torch.tensor([0, 5, 17, 39, 3])
    got = rpy.mobility_rows(rows, torch.tensor(r), torch.tensor(F), 0.3, 1.3,
                            wall, 0.75, F64, row_block=2)
    assert np.abs(got.numpy() - want[rows.numpy()]).max() \
        <= 1e-13 * np.abs(want).max()
    two = rpy.mobility_rows(torch.arange(40), torch.tensor(r),
                            torch.tensor(np.stack([F, -2 * F])), 0.3, 1.3,
                            wall, 0.75, F64)
    assert np.abs(two[1].numpy() + 2 * want).max() \
        <= 1e-13 * np.abs(want).max()


def test_periodic_rows_do_not_depend_on_the_split():
    rng = np.random.default_rng(1)
    box = (6.0, 7.0, 6.5)
    r = torch.tensor(rng.uniform(0, 1, (30, 3)) * np.array(box))
    F = torch.tensor(rng.standard_normal((30, 3)))
    rows = torch.arange(30)
    a = ewald.PeriodicRPY(box, 0.25, 1.0, F64, "cpu").rows(rows, r, F)
    old = ewald.TAIL
    try:
        ewald.TAIL = 6.5
        b = ewald.PeriodicRPY(box, 0.25, 1.0, F64, "cpu").rows(rows, r, F)
    finally:
        ewald.TAIL = old
    assert (a - b).abs().max() <= 1e-10 * a.abs().max()


def test_periodic_rows_match_the_ports_ewald_in_float64():
    from rigid_body_light_tpu_torch import SimulationConfig
    from rigid_body_light_tpu_torch.ops import saddle

    rng = np.random.default_rng(2)
    box = (6.0, 7.0, 6.5)
    r = torch.tensor(rng.uniform(0, 1, (50, 3)) * np.array(box))
    r[1] = r[0] + torch.tensor([0.3, 0.1, 0.0], dtype=torch.float64)
    F = torch.tensor(rng.standard_normal((50, 3)))
    cfg = SimulationConfig(a=0.25, box=box, dtype=torch.float64,
                           ewald_tol=1e-11)
    port = saddle.mobility_apply_fn(cfg)(F, r)
    ref = ewald.PeriodicRPY(box, 0.25, 1.0, F64, "cpu").rows(
        torch.arange(50), r, F)
    assert (port - ref).abs().max() <= 1e-9 * ref.abs().max()


def test_wall_rows_match_the_ports_plain_sweep_in_float64():
    from rigid_body_light_tpu_torch import SimulationConfig
    from rigid_body_light_tpu_torch.ops import saddle

    r, F = _cloud(60, seed=4)
    r, F = torch.tensor(r), torch.tensor(F)
    cfg = SimulationConfig(a=0.3, wall=True, dtype=torch.float64)
    port = saddle.mobility_apply_fn(cfg)(F, r)
    ref = rpy.mobility_rows(torch.arange(60), r, F, 0.3, 1.0, True, 0.75, F64)
    assert (port - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_commit_matches_the_ports_update():
    from rigid_body_light_tpu_torch.ops import kinematics

    g = torch.Generator().manual_seed(5)
    X = torch.rand((6, 3), generator=g, dtype=torch.float64) * 5 + 3
    Q = torch.randn((6, 4), generator=g, dtype=torch.float64)
    Q = Q / Q.norm(dim=1, keepdim=True)
    U = torch.randn((6, 6), generator=g, dtype=torch.float64)
    a, ref = rpy.load_shell(SHELL)
    sim = {"dt": 0.01, "a": a, "wall": True, "max_move": 5.0,
           "max_rotation": 0.5, "max_step_residual": 1e-2,
           "reject_below_wall": True}
    Xr, Qr = step.commit(X, Q, U, 1e-5, ref, sim, F64)
    Xp, Qp = kinematics.update_X_Q(X, Q, U * 0.01)
    assert (Xr - Xp).abs().max() < 1e-14 and (Qr - Qp).abs().max() < 1e-14
    Xf, Qf = step.commit(X, Q, U, 0.5, ref, sim, F64)
    assert torch.equal(Xf, X) and torch.equal(Qf, Q)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, -3.0 - 2.0**-10])
    assert round_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, -3.0 - 2.0**-9]
    assert TF32.op(torch.tensor([1.0 + 2.0**-13])).item() == 1.0


def _bodies(wall):
    """Three shell_N_42 bodies apart (above the wall with ``wall``), a
    seeded rigid-plus-strain slip and seeded forces."""
    from benchmark import check

    a, ref = rpy.load_shell(SHELL)
    g = torch.Generator().manual_seed(7)
    X = torch.tensor([[0.0, 0.0, 2.5], [3.1, 0.4, 2.8], [0.5, 3.3, 3.0]],
                     dtype=torch.float64)
    Q = torch.randn((3, 4), generator=g, dtype=torch.float64)
    Q = Q / Q.norm(dim=1, keepdim=True)
    slip, force = check.solve_inputs(X, Q, (a, ref), 1.0, g)
    r = rpy.blob_positions(X, Q, ref, F64)
    off = r.reshape(3, -1, 3) - X[:, None]
    every = torch.arange(r.shape[0])

    def mob(lam, ar=F64):
        return rpy.mobility_rows(every, r, lam, a, 1.0, wall, 0.75, ar)
    pc = solve.BodyBlockPC(ref, a, 1.0, torch.float64, "cpu")
    R = rpy.rotation(Q)
    return mob, off, R, slip, force, pc


@pytest.mark.parametrize("wall", [False, True])
def test_reference_solve_meets_its_equations(wall):
    mob, off, R, slip, force, pc = _bodies(wall)
    lam, U, res, its = solve.solve(mob, off, R, slip, force, pc, 1e-10, 30,
                                   100)
    assert res <= 1e-10 and its < 60
    rows = torch.arange(0, off.shape[0] * off.shape[1], 5)
    gap = solve.residual_gap(mob(lam.reshape(-1, 3))[rows], rows, lam, U,
                             slip, force, off)
    assert gap <= 1e-8
    # a solution a hundredth off misses the equations by about that much
    off_gap = solve.residual_gap(mob(lam.reshape(-1, 3))[rows], rows, lam,
                                 1.01 * U, slip, force, off)
    assert off_gap >= 1e-3


def test_body_block_pc_solves_one_free_body_exactly():
    """Alone in free space, a body's saddle problem is its own block: one
    application of the preconditioner solves it."""
    a, ref = rpy.load_shell(SHELL)
    mob, off, R, slip, force, pc = _bodies(False)
    one = slice(0, 1)
    lam, U = pc.apply(slip.reshape(3, -1, 3)[one], force[one], R[one])
    r = off[0] + torch.tensor([0.0, 0.0, 2.5], dtype=torch.float64)
    rows = torch.arange(r.shape[0])
    Mlam = rpy.mobility_rows(rows, r, lam.reshape(-1, 3), a, 1.0, False,
                             0.75, F64)
    assert solve.residual_gap(Mlam, rows, lam, U, slip.reshape(3, -1, 3)[0],
                              force[one], off[one]) <= 1e-10


def test_reference_solve_matches_the_ports_solve_in_float64():
    from rigid_body_light_tpu_torch import SimulationConfig
    from rigid_body_light_tpu_torch.ops import kinematics, saddle, solvers
    from rigid_body_light_tpu_torch.state import make_state

    mob, off, R, slip, force, pc = _bodies(True)
    lam, U, _, _ = solve.solve(mob, off, R, slip, force, pc, 1e-11, 30, 100)
    a, ref = rpy.load_shell(SHELL)
    geom = kinematics.make_ref_geometry(torch.tensor(ref),
                                        dtype=torch.float64, device="cpu")
    X = torch.tensor([[0.0, 0.0, 2.5], [3.1, 0.4, 2.8], [0.5, 3.3, 3.0]],
                     dtype=torch.float64)
    g = torch.Generator().manual_seed(7)
    Q = torch.randn((3, 4), generator=g, dtype=torch.float64)
    state = make_state(X, Q / Q.norm(dim=1, keepdim=True),
                       dtype=torch.float64, device="cpu")
    cfg = SimulationConfig(a=a, wall=True, dtype=torch.float64,
                           gmres_tol=1e-11, gmres_maxiter=100,
                           gmres_restart=50)
    res = solvers.solve_saddle(saddle.geometry_ops(geom, state), cfg, slip,
                               force)
    assert (res.U - U).abs().max() <= 1e-8 * U.abs().max()
    assert (res.lam - lam.reshape(-1, 3)).abs().max() \
        <= 1e-8 * lam.abs().max()
