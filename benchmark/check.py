"""The comparison that decides ``correct``.

After the window, at its final state, the program's outputs
(:func:`benchmark.system.program_outputs`) are judged against the plain
reference of ``benchmark/reference/`` in float64:

  mob_gap    the one-RHS mobility product (the GMRES matvec: K1, or K4
             tiles with the gridded wave part) on a seeded force, at the
             blobs of bodies drawn from the seed:
             max |U − U_ref| / max |U_ref|
  mob2_gap   the same of the two-RHS product (the fused Lanczos draws: K2,
             or K1 at 2 RHS past 65,025 blobs, the Ewald operator), both
             right-hand sides
  step_gap   one fluctuating step of the window's entry from seeded draws:
             the bodies it commits against the reference's commit of the
             step's own velocities, relative to the step's move (∞ where
             the step's solve failed)
  solve_gap  the window's saddle solve of a seeded slip and force: its
             (λ, U) in M·λ − K·U = slip at the sampled blobs (over
             max |M·λ|) and Kᵀ·λ = F at every body

The control (``arith=TF32``) puts the reference, computed in TF32, in
the program's place; it has to come out as not correct.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import solve as ref_solve, step as ref_step
from benchmark.reference.arith import F64, Arith
from benchmark.reference.ewald import PeriodicRPY
from benchmark.reference.rpy import blob_positions, mobility_rows, rotation

NUMBERS = ("mob_gap", "mob2_gap", "step_gap", "solve_gap")
CONTROL_MAXITER = 300     # the control's GMRES iterations at most


def solve_inputs(X, Q, shell, eta, generator):
    """The solve's right-hand side, drawn from ``generator`` (on the
    bodies' device): a slip that is a random rigid-plus-strain field on
    each body, s = g + G·(r − X), and random body forces and torques
    scaled to move a body of the shell's radius R at speeds of order 1
    (6πηR, 8πηR³).  Returns float64 (N, 3) and (B, 6)."""
    a, ref = shell
    off = (blob_positions(X.double(), Q.double(), ref, F64).reshape(
        X.shape[0], -1, 3) - X.double()[:, None, :])
    kw = dict(generator=generator, dtype=torch.float64, device=X.device)
    B = X.shape[0]
    g, G = torch.randn((B, 3), **kw), torch.randn((B, 3, 3), **kw)
    slip = g[:, None, :] + torch.einsum("bij,bkj->bki", G, off)
    R = float(torch.linalg.norm(torch.as_tensor(ref), dim=-1).max())
    F = torch.randn((B, 6), **kw)
    F[:, :3] *= 6 * math.pi * eta * R
    F[:, 3:] *= 8 * math.pi * eta * R**3
    return slip.reshape(-1, 3), F


def sample_rows(n_bodies, n_blobs, k, generator):
    """Blob indices of ``k`` bodies drawn from ``generator`` (CPU)."""
    bodies = torch.randperm(n_bodies, generator=generator)[:k]
    return (bodies[:, None] * n_blobs
            + torch.arange(n_blobs)[None, :]).reshape(-1).sort().values


class Reference:
    """The configuration's operator and commit, in arithmetic ``ar``."""

    def __init__(self, sim, shell, ar: Arith, device):
        self.sim, self.ar, self.device = sim, ar, device
        self.a, self.ref = shell
        box = sim["box"]
        self.periodic = box is not None and len(box) == 3
        if box is not None and not self.periodic:
            raise NotImplementedError("the pseudo-2D film has no reference "
                                      "here yet")
        self._ewald = {}

    def ewald(self, ar):
        if ar.name not in self._ewald:
            self._ewald[ar.name] = PeriodicRPY(self.sim["box"], self.a,
                                               self.sim["eta"], ar,
                                               self.device)
        return self._ewald[ar.name]

    def positions(self, X, Q, ar=None):
        return blob_positions(X.to(self.device), Q.to(self.device), self.ref,
                              ar or self.ar)

    def mobility(self, rows, r, F, ar=None):
        ar = ar or self.ar
        rows, F = rows.to(self.device), F.to(self.device)
        if self.periodic:
            return self.ewald(ar).rows(rows, r, F)
        return mobility_rows(rows, r, F, self.a, self.sim["eta"],
                             self.sim["wall"], self.sim["h_floor"], ar)

    def offsets(self, X, r, ar=None):
        """(B, n, 3) blob offsets r − X in ``ar``."""
        ar = ar or self.ar
        return r.reshape(X.shape[0], -1, 3) - ar.op(X.to(self.device))[:, None]

    def solve(self, X, Q, slip, force, ar):
        """(λ, U) of the reference's own GMRES solve in ``ar``."""
        r = self.positions(X, Q, ar)
        off = self.offsets(X, r, ar)
        R = rotation(ar.op(Q.to(self.device)))
        pc = ref_solve.BodyBlockPC(self.ref, self.a, self.sim["eta"],
                                   ar.dtype, self.device)
        every = torch.arange(r.shape[0], device=self.device)
        lam, U, _, _ = ref_solve.solve(
            lambda lam: self.mobility(every, r, lam, ar), off, R,
            slip.to(self.device, ar.dtype), force.to(self.device, ar.dtype),
            pc, self.sim["gmres_tol"], self.sim["gmres_restart"],
            CONTROL_MAXITER)
        return lam.reshape(-1, 3), U

    def commit(self, X, Q, U, residual, ar=None):
        return ref_step.commit(X.to(self.device), Q.to(self.device),
                               U.to(self.device), residual, self.ref,
                               self.sim, ar or self.ar)


def _gap(value, ref):
    ref = ref.double().cpu()
    return ((value.double().cpu() - ref).abs().max()
            / ref.abs().max()).item()


def _moved_gap(value, ref, start):
    """max |value − ref| over the reference's largest move from start."""
    return ((value.double().cpu() - ref).abs().max()
            / (ref - start.double()).abs().max()).item()


def judge(out, sim, shell, rows, device, control: Arith = None):
    """The compared numbers of the program's outputs ``out`` (or, with
    ``control``, of the reference in that arithmetic in its place)."""
    ref = Reference(sim, shell, F64, device)
    r64 = ref.positions(out["X"], out["Q"])
    U1 = ref.mobility(rows, r64, out["F1"])
    U2 = ref.mobility(rows, r64, out["F2"])
    X1, Q1 = ref.commit(out["X"], out["Q"], out["U_step"], out["residual"])
    if control is None:
        got1, got2 = out["U1"][rows], out["U2"][:, rows]
        Xg, Qg = out["X_new"], out["Q_new"]
        lam, U = out["lam"], out["U_solve"]
    else:
        rc = ref.positions(out["X"], out["Q"], control)
        got1 = ref.mobility(rows, rc, out["F1"], control)
        got2 = ref.mobility(rows, rc, out["F2"], control)
        Xg, Qg = ref.commit(out["X"], out["Q"], out["U_step"],
                            out["residual"], control)
        lam, U = ref.solve(out["X"], out["Q"], out["slip"], out["force"],
                           control)
    if not float(out["residual"]) < sim["max_step_residual"]:
        step = math.inf
    else:
        X1, Q1 = X1.double().cpu(), Q1.double().cpu()
        step = max(_moved_gap(Xg, X1, out["X"]), _moved_gap(Qg, Q1, out["Q"]))
    lam = lam.to(device, torch.float64)
    solve = ref_solve.residual_gap(
        ref.mobility(rows, r64, lam), rows.to(device), lam,
        U.to(device, torch.float64), out["slip"].to(device),
        out["force"].to(device), ref.offsets(out["X"], r64))
    return {"mob_gap": _gap(got1, U1), "mob2_gap": _gap(got2, U2),
            "step_gap": step, "solve_gap": solve}


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]) over the numbers that ``limits``
    names: every one at or below its limit; a NaN or a missing number
    misses it."""
    rows = [(k, numbers.get(k, math.nan), limits[k]) for k in NUMBERS
            if k in limits]
    ok = all(v <= lim for _, v, lim in rows)    # NaN compares False
    return ok, rows
