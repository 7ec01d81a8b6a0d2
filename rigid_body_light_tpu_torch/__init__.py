"""rigid_body_light_tpu_torch — the PyTorch + CUDA port of rigid_body_light_tpu.

A second package beside the JAX one, mirroring its module layout
(``ops/``, ``dynamics/``) so each module's counterpart is easy to find.  It
imports ``torch`` and never ``jax``; the JAX package stays the reference the
port is tested against (``tests/test_torch_*.py``).

The slices ported so far are the fluctuating Brownian-dynamics main path
(:func:`rigid_body_light_tpu_torch.dynamics.run_bd`): rigid multiblob
bodies with one blob radius, the ``block_free`` preconditioner,
preconditioned fused two-draw Lanczos noise, the midpoint-slip RFD drift
and a GMRES saddle solve, with three mobility operators: the dense O(N²)
pair sweep above a wall or in an open domain, the O(N) proxy-grid far
field (``farfield_grid``), and the triply-periodic positively-split Ewald
operator (a 3-D ``box``); the settled-suspension configuration
(the RAS preconditioner, adaptive Lanczos, :mod:`.forces`, the checkpoint
reader of :mod:`.utils.checkpoint`); and the pseudo-2D film (a 2-D
``box`` above the wall: the minimum-image pair sweep, or with
``image_shells`` the exact doubly-periodic image sum); and mixtures of
body species (:mod:`.multi`, ``multi.run_bd_multi``), a species with its
own blob radius making the coupled product polydisperse, on the dense
sweeps or the far field (open or in the film); the ``em_exact`` drift and
the unpreconditioned noise in both steppers; the run driver
(``python -m rigid_body_light_tpu_torch.run``, :mod:`.run`) with its
trajectory writer (:mod:`.runtime`) and checkpoints; and the
reference-compatible :class:`RigidBody` API (:mod:`.api`, numpy in and
out) with the state diagnostics of :mod:`.utils.validation`, the
resistance solve, the ambient flows of :mod:`.flows` and the trajectory
observables of :mod:`.analysis`.  Their pair sweeps are hand-written CUDA
kernels for sm_90a (``csrc/``, wrapped by :mod:`.ops.rpy_cuda`,
:mod:`.ops.farfield_cuda` and :mod:`.ops.ewald_cuda`), as is the FP32 peak
probe of :mod:`.utils.roofline`; everything else is eager PyTorch on
whatever device the input tensors live on.

Float32 matmuls are pinned to full precision (TF32 off), mirroring the JAX
package's ``jax_default_matmul_precision="highest"`` pin: reduced-precision
matmuls biased the sampled equilibrium of the preconditioned noise
(VALIDATION.md).  The pin is process-global.
"""

import torch as _torch

_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from rigid_body_light_tpu_torch.config import SimulationConfig  # noqa: E402
from rigid_body_light_tpu_torch.state import BodyState, make_state  # noqa: E402
from rigid_body_light_tpu_torch.structures import (  # noqa: E402
    load_structure, structure_path)
from rigid_body_light_tpu_torch import analysis, flows, forces, multi  # noqa: E402
from rigid_body_light_tpu_torch.api import RigidBody  # noqa: E402

__all__ = ["RigidBody", "SimulationConfig", "BodyState", "make_state",
           "load_structure", "structure_path", "analysis", "flows", "forces",
           "multi"]
