"""Drop-in ``RigidBody`` API matching the reference's ``Rigid.RigidBody`` —
the port of ``rigid_body_light_tpu/api.py``.

Same constructor signature, same methods, same validation error contract
(reference ``src/Rigid.py:5-135``): numpy arrays go in, numpy arrays come
out, and every operator runs on tensors on the instance's device through
the port's plain functions (the mobility products through the CUDA kernels
in float32 on the card).

Extensions over the reference (keywords after the reference's positional
surface): ``kBT``, ``dtype`` (runtime precision instead of a build flag),
``config``, ``device`` (the card unless the caller names the CPU), and the
stepping entry points ``deterministic_step`` / ``stochastic_step`` /
``run``.  The noise comes from explicit ``torch.Generator``s or given
draws (``dynamics.make_draws``); without either, a per-instance counter
seeds a fresh generator on the instance's device, so two fresh instances
repeat each other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.dynamics import stepper
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import saddle as saddle_mod
from rigid_body_light_tpu_torch.ops import solvers
from rigid_body_light_tpu_torch.state import BodyState, make_state, resolve_device
from rigid_body_light_tpu_torch.utils import validation


def _to_numpy(t):
    """A host copy of ``t``: never a view of a CPU tensor the instance
    keeps."""
    t = t.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


class RigidBody:
    """N rigid bodies sharing one blob reference configuration.

    Parity: reference ``RigidBody`` (``src/Rigid.py:5``).
    """

    X_shape = None
    Q_shape = None

    def __init__(
        self,
        rigid_config,
        X,
        Q,
        a,
        eta,
        dt,
        wall_PC: bool = False,
        block_PC: bool = False,
        *,
        kBT: float = 1.0,
        dtype=torch.float32,
        config: Optional[SimulationConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        rigid_config = np.asarray(rigid_config)
        if rigid_config.size % 3 != 0:
            raise RuntimeError(
                f"Rigid config must have length 3N. Rigid config shape: {rigid_config.shape}"
            )
        self.blobs_per_body = rigid_config.size // 3

        if config is None:
            config = SimulationConfig(
                a=float(a),
                eta=float(eta),
                dt=float(dt),
                kBT=float(kBT),
                wall=bool(wall_PC),
                block_diag_pc=bool(block_PC),
                dtype=dtype,
            )
        else:
            # explicit config: the required positional scalars a/eta/dt win;
            # everything else must live in the config — mixing the two would
            # silently produce wrong physics, so it is rejected outright
            if wall_PC or block_PC or kBT != 1.0 or dtype is not torch.float32:
                raise ValueError(
                    "when config= is given, pass wall/block_diag_pc/kBT/dtype "
                    "inside the SimulationConfig, not as constructor kwargs"
                )
            config = config.replace(a=float(a), eta=float(eta), dt=float(dt))
        self.config = config
        self.precision = "double" if config.dtype == torch.float64 else "single"
        self._geom = kin.make_ref_geometry(rigid_config, dtype=config.dtype,
                                           device=self.device)
        validation.check_box_geometry(
            config.box, self._geom.ref_cfg.cpu().numpy(), config.a)
        # the closed-form (KᵀK)⁻¹ needs a nonsingular rotational moment block
        # D = Σ|ref|²·I − MOI; its spectrum is rotation-invariant, so check
        # once at construction (the reference kills the process instead —
        # ``block_KTKinv``, ``c_rigid_obj.cpp:313-316``)
        D = (self._geom.sum_r2 * torch.eye(3, dtype=config.dtype,
                                           device=self.device)
             - self._geom.moi).cpu().numpy()
        # "singular" = no digits left at working precision
        cond_limit = 0.01 / np.finfo(D.dtype).eps
        if self.blobs_per_body >= 2 and (
            not np.isfinite(np.linalg.cond(D)) or np.linalg.cond(D) > cond_limit
        ):
            raise RuntimeError(
                "The rotational block of K^T K is singular — the blobs are "
                "collinear (is your rigid body a dimer?). Rotation about the "
                "blob axis is unconstrained; add off-axis blobs."
            )
        self._pc_cache = None
        self._ops_cache = None
        self._key_counter = 0
        self.set_config(X, Q)

    # ---------------------------------------------------------------- state

    def set_config(self, X, Q):
        """Set body positions/quaternions; quaternions normalized on set."""
        self.__check_and_set_configs(X, Q)
        self.state = make_state(self._tensor(X), self._tensor(Q),
                                dtype=self.config.dtype, device=self.device)
        self.total_blobs = self.N_bodies * self.blobs_per_body
        self._invalidate()
        self._check_overlap(self._ops.flat_positions)

    def get_config(self):
        X = _to_numpy(self.state.X).reshape(self.X_shape)
        Q = _to_numpy(self.state.Q).reshape(self.Q_shape)
        return X, Q

    def _invalidate(self):
        self._pc_cache = None
        self._ops_cache = None

    @property
    def _ops(self) -> saddle_mod.GeometryOps:
        if self._ops_cache is None:
            self._ops_cache = saddle_mod.geometry_ops(self._geom, self.state)
        return self._ops_cache

    @property
    def _pc(self) -> saddle_mod.PCData:
        if self._pc_cache is None:
            self._pc_cache = saddle_mod.build_pc(self._ops, self.config)
        return self._pc_cache

    def _tensor(self, x):
        """A copy of caller data in the config's dtype on the instance's
        device (``torch.as_tensor`` of a numpy array on the CPU would share
        the caller's memory)."""
        return torch.tensor(np.asarray(x), dtype=self.config.dtype,
                            device=self.device)

    def _out_shape(self):
        return (-1, 3) if len(self.X_shape) == 2 else (-1,)

    # ------------------------------------------------------------ operators

    def get_blob_positions(self):
        return _to_numpy(self._ops.positions).reshape(self._out_shape())

    def K_dot(self, U):
        self.__check_input_size(U_vec=U)
        U = self._tensor(U).reshape(-1, 6)
        result = kin.K_dot(U, self._ops.offsets)
        return _to_numpy(result).reshape(self._out_shape())

    def KT_dot(self, lambda_vec):
        self.__check_input_size(lambda_vec=lambda_vec)
        lam = self._tensor(lambda_vec).reshape(
            self.N_bodies, self.blobs_per_body, 3)
        result = kin.KT_dot(lam, self._ops.offsets)
        return _to_numpy(result).reshape(self._out_shape())

    def apply_PC(self, b):
        self.__check_input_size(system_input=b)
        self._check_above_wall(self._ops.flat_positions)
        b = self._tensor(b).reshape(-1)
        slip = b[: 3 * self.total_blobs].reshape(-1, 3)
        F = b[3 * self.total_blobs :].reshape(-1, 6)
        lam, U = saddle_mod.apply_pc(self._pc, slip, F, self._ops, self.config)
        return _to_numpy(torch.cat([lam.reshape(-1), U.reshape(-1)]))

    def apply_M(self, forces, positions):
        """U = B·M·B·F (damping iff wall) at caller-supplied positions.

        Supports extra free blobs beyond the rigid ones (reference
        ``tests/test_interface.py:171-177``).
        """
        if np.size(positions) != np.size(forces):
            raise RuntimeError("Positions and forces must be of the same size")
        if np.size(positions) % 3 != 0 or np.size(forces) % 3 != 0:
            raise RuntimeError(
                "Positions and forces must have total length 3N, where N is the number of blobs"
            )
        r = self._tensor(positions).reshape(-1, 3)
        self._check_above_wall(r)
        self._check_overlap(r)
        F = self._tensor(forces).reshape(-1, 3)
        out = saddle_mod.mobility_apply_fn(self.config)(F, r)
        return _to_numpy(out).ravel()

    def apply_saddle(self, x):
        self.__check_input_size(system_input=x)
        self._check_above_wall(self._ops.flat_positions)
        x = self._tensor(x).reshape(-1)
        lam = x[: 3 * self.total_blobs].reshape(-1, 3)
        U = x[3 * self.total_blobs :].reshape(-1, 6)
        slip, F = saddle_mod.apply_saddle(lam, U, self._ops, self.config)
        return _to_numpy(torch.cat([slip.reshape(-1), F.reshape(-1)]))

    def solve_mobility(self, forces, slip=None, x0=None):
        """Solve the saddle system for body velocities U given applied
        force/torque (B,6) and optional prescribed blob slip (N,3).

        The reference delegates this to an external scipy GMRES; here it is
        one preconditioned GMRES solve on the instance's device.  x0:
        optional (λ, U) warm start.  Returns (U (B,6), λ (N,3), residual)
        as numpy.
        """
        force = self._tensor(forces).reshape(-1, 6)
        if slip is None:
            slip = torch.zeros((self.total_blobs, 3), dtype=self.config.dtype,
                               device=self.device)
        else:
            slip = self._tensor(slip).reshape(-1, 3)
        self._check_above_wall(self._ops.flat_positions)
        if x0 is not None:
            x0 = (self._tensor(x0[0]).reshape(-1, 3),
                  self._tensor(x0[1]).reshape(-1, 6))
        res = solvers.solve_saddle(self._ops, self.config, slip, force,
                                   pc=self._pc, x0=x0)
        return _to_numpy(res.U), _to_numpy(res.lam), float(res.residual)

    # ---------------------------------------------------------------- matrices

    def get_K(self):
        """Sparse K (3·B·n × 6·B) as scipy CSR (parity: ``get_K``,
        ``c_rigid_obj.cpp:978``)."""
        import scipy.sparse as sp

        Kb = _to_numpy(saddle_mod.body_K_blocks(self._ops.offsets))  # (B,n,3,6)
        B, n = Kb.shape[0], Kb.shape[1]
        blocks = [sp.csr_matrix(Kb[b].reshape(3 * n, 6)) for b in range(B)]
        return sp.block_diag(blocks, format="csr")

    def get_Kinv(self):
        """Sparse K⁺ = (KᵀK)⁻¹Kᵀ (6·B × 3·B·n) as scipy CSR."""
        import scipy.sparse as sp

        Kb = _to_numpy(saddle_mod.body_K_blocks(self._ops.offsets))
        ktki = _to_numpy(self._ops.ktkinv)  # (B,6,6)
        B, n = Kb.shape[0], Kb.shape[1]
        blocks = [
            sp.csr_matrix(ktki[b] @ Kb[b].reshape(3 * n, 6).T) for b in range(B)
        ]
        return sp.block_diag(blocks, format="csr")

    # ---------------------------------------------------------------- stepping

    def evolve_rigid_bodies(self, U):
        """Commit one timestep X += U·dt, Q ← exp(ω·dt)∘Q.

        Parity: ``evolve_X_Q`` (``c_rigid_obj.cpp:865-878``) — without
        mutating the caller's U buffer (the reference scales it in place).
        """
        self.__check_input_size(U_vec=U)
        U = self._tensor(U).reshape(-1, 6)
        dU = U * self.config.dt
        X, Q = kin.update_X_Q(self.state.X, self.state.Q, dU)
        self.state = BodyState(X=X, Q=Q)
        self._invalidate()

    def deterministic_step(self, forces, slip=None):
        """Solve the mobility problem and advance this body system by dt.

        Returns the (B, 6) body velocities used (numpy).
        """
        self._check_above_wall(self._ops.flat_positions)
        force = self._tensor(forces).reshape(-1, 6)
        slip_t = None if slip is None else self._tensor(slip).reshape(-1, 3)
        new_state, aux = stepper.deterministic_step(
            self._geom, self.config, self.state, force, slip=slip_t)
        self.state = new_state
        self._invalidate()
        return _to_numpy(aux.U)

    def _next_generator(self) -> torch.Generator:
        """A fresh generator on the instance's device seeded by the
        instance's step counter (reproducible per instance)."""
        self._key_counter += 1
        return torch.Generator(device=self.device).manual_seed(
            self._key_counter)

    def stochastic_step(self, forces, generator=None, slip=None, draws=None):
        """One fluctuating BD step (midpoint slip scheme by default).

        generator: optional ``torch.Generator`` on the instance's device;
        draws: optional (W1, W2, W_rfd) in the shapes of
        ``dynamics.make_draws``.  With neither, a generator seeded by a
        per-instance counter (reproducible per instance).  Returns the
        (B, 6) body velocities.
        """
        self._check_above_wall(self._ops.flat_positions)
        if generator is None and draws is None:
            generator = self._next_generator()
        force = self._tensor(forces).reshape(-1, 6)
        slip_t = None if slip is None else self._tensor(slip).reshape(-1, 3)
        new_state, aux = stepper.stochastic_step(
            self._geom, self.config, self.state, force, slip=slip_t,
            draws=draws, generator=generator)
        self.state = new_state
        self._invalidate()
        return _to_numpy(aux.U)

    def run(self, n_steps, generator=None, force_fn=None, slip_fn=None,
            save_every=1, draws_fn=None):
        """Run a whole trajectory from the current configuration.

        Thin wrapper over :func:`rigid_body_light_tpu_torch.dynamics.run_bd`
        (force_fn / slip_fn: (BodyState, step) → (B, 6) / (N, 3), numpy or
        tensors; draws_fn: step → (W1, W2, W_rfd)); without a generator or
        draws_fn, a generator seeded by the per-instance counter.  Updates
        this instance's state and returns the trajectory dict (numpy
        arrays).
        """
        if generator is None and draws_fn is None:
            generator = self._next_generator()
        dtype, dev = self.config.dtype, self.device

        def as_device(fn):
            if fn is None:
                return None
            return lambda s, i: torch.as_tensor(fn(s, i), dtype=dtype,
                                                device=dev)

        final, traj = stepper.run_bd(
            self._geom, self.config, self.state, n_steps, generator=generator,
            force_fn=as_device(force_fn), slip_fn=as_device(slip_fn),
            save_every=save_every, draws_fn=draws_fn)
        self.state = final
        self._invalidate()
        return {k: _to_numpy(v) for k, v in traj.items()}

    # ---------------------------------------------------------------- checks

    def _check_above_wall(self, positions):
        """Reference error contract (``c_rigid_obj.cpp:95-97``).  Costs a
        host sync per operator call — deliberate at this numpy-in/numpy-out
        boundary; hot loops should use ``dynamics.run_bd`` /
        ``stochastic_step``, which guard below-wall configurations with move
        rejection instead."""
        if self.config.wall:
            if bool(torch.any(positions[:, 2] < 0.0)):
                raise RuntimeError(
                    "A blob has its center below the wall (z<0). Cannot compute "
                    "mobility- check your configuration."
                )

    def _check_overlap(self, positions):
        """Raise on exactly-coincident blobs (the RPY pair mobility is
        undefined at r=0; the reference exits the process there,
        ``mobilityUFRPY``, ``c_rigid_obj.cpp:53-58``).  Gated on
        ``config.validate_config`` — this is an O(N²) sweep + host sync and
        only guards the user-facing numpy entry points."""
        if not self.config.validate_config or positions.shape[0] < 2:
            return
        # separations measured through the same minimum-image wrap the
        # mobility uses (blobs coincident modulo the box are the r=0 case);
        # diagnose works in raw position units, so the box passes unscaled
        Q_unit = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=positions.dtype,
                              device=positions.device)
        diag = validation.diagnose(positions, Q_unit, a=self.config.a,
                                   box=self.config.box).min_separation
        if float(diag) < 1e-8:
            raise RuntimeError(
                f"TWO BLOBS ARE OVERLAPPING OR TOO CLOSELY POSITIONED "
                f"(min separation {float(diag):.3e} a)"
            )

    def __check_and_set_configs(self, X, Q):
        x_size = int(np.prod(np.shape(X)))
        q_size = int(np.prod(np.shape(Q)))
        if x_size % 3 != 0:
            raise RuntimeError("X must have total length 3N")
        if q_size % 4 != 0:
            raise RuntimeError("Q must have total length 4N")
        nx = x_size // 3
        nq = q_size // 4
        if nx != nq:
            raise RuntimeError("X and Q must have the same number of bodies")
        self.N_bodies = nx
        self.X_shape = np.shape(X)
        self.Q_shape = np.shape(Q)

    def __check_input_size(self, lambda_vec=None, U_vec=None, system_input=None):
        if lambda_vec is not None:
            if np.size(lambda_vec) != 3 * self.total_blobs:
                raise RuntimeError(
                    f"lambda must have total size 3*N_blobs = {3 * self.total_blobs}. "
                    f"lambda_vec shape: {np.shape(lambda_vec)}"
                )
        if U_vec is not None:
            if np.size(U_vec) != 6 * self.N_bodies:
                raise RuntimeError(
                    f"U must have total size 6*N_bodies = {6 * self.N_bodies}. "
                    f"U shape: {np.shape(U_vec)}"
                )
        if system_input is not None:
            expected_size = 3 * self.total_blobs + 6 * self.N_bodies
            if np.size(system_input) != expected_size:
                raise RuntimeError(
                    f"Rigid system input vector must have total size 3*N_blobs + "
                    f"6*N_bodies = {expected_size}. system_input shape: "
                    f"{np.shape(system_input)}"
                )
