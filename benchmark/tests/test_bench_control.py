"""The check against its control and its faults, at a size a test run
holds, on the CPU (the port's plain PyTorch twins stand for its kernels):
the control (the reference in TF32 in the program's place) and a run with
the timed path broken underneath must come out as not correct, a sound run
as correct.  The harness's look for a chip is skipped: ``run_cell`` is
called with the CPU."""

import time

import pytest
import torch

from benchmark import check, control, harness, spec

CELLS = {
    "wall_sediment_642.exact_41k": dict(lattice=[2, 1, 1], chunk=2),
    "periodic_suspension_642.balanced_116k": dict(
        lattice=[2, 1, 1], spacing=[4.0, 4.0, 4.0], chunk=2,
        simulation={"box": [8.0, 8.0, 8.0]}),
}
SEED = 2**31 + 12345
BLOBS = 642   # blobs a body in both configurations


def small(name):
    cell = spec.cell(name)
    cell["traffic"] = {**cell["traffic"], **CELLS[name]}
    cell["limits"] = {**cell["limits"], "sample_bodies": 1}
    return cell


def run(cell):
    return harness.run_cell(cell, SEED, 0.0, False, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_and_the_program_passes(name):
    cell = small(name)
    row = next(control.readings(cell, [SEED], {SEED}, 2, torch.device("cpu")))
    limits = cell["limits"]["limits"]
    assert check.verdict(row["program"], limits)[0], row
    assert not check.verdict(row["control"], limits)[0], row


def _frozen(monkeypatch):
    from rigid_body_light_tpu_torch.dynamics import stepper

    real = stepper.stochastic_step

    def step(geom, cfg, state, *a, **k):
        return state, real(geom, cfg, state, *a, **k)[1]
    monkeypatch.setattr(stepper, "stochastic_step", step)


def _broken_operator(monkeypatch, fault):
    from rigid_body_light_tpu_torch.ops import saddle

    def wrap(make):
        def make_broken(cfg, radii=None):
            op = make(cfg, radii)

            def apply(F, r, *a, **k):
                if fault == "half_batch":
                    keep = torch.ones(F.shape[-2], 1, dtype=F.dtype)
                    keep[F.shape[-2] // 2:] = 0.0
                    return op(2.0 * F * keep, r, *a, **k)
                U = op(F, r, *a, **k).clone()
                U[..., ::BLOBS, :] += 0.01 * U.abs().max()   # every body
                return U
            return apply
        return make_broken
    for fn in ("mobility_apply_fn", "mobility_apply_multi_fn"):
        monkeypatch.setattr(saddle, fn, wrap(getattr(saddle, fn)))


def _altered_solve(monkeypatch):
    """The saddle solve's body velocities altered by 10% where it returns
    them, in the window and in the check alike (sound solves at
    ``gmres_tol`` read up to 1.5e-2 of ``solve_gap``, so a 1% error
    hides under the limit)."""
    from rigid_body_light_tpu_torch.ops import solvers

    real = solvers.solve_saddle

    def solve_saddle(*a, **k):
        res = real(*a, **k)
        return res._replace(U=1.1 * res.U)
    monkeypatch.setattr(solvers, "solve_saddle", solve_saddle)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault", [None, "frozen", "half_batch", "altered",
                                   "altered_solve"])
def test_faults_come_out_not_correct(monkeypatch, name, fault):
    if fault == "frozen":
        _frozen(monkeypatch)
    elif fault == "altered_solve":
        _altered_solve(monkeypatch)
    elif fault is not None:
        _broken_operator(monkeypatch, fault)
    result = run(small(name))
    assert result["correct"] is (fault is None), result["checks"]
