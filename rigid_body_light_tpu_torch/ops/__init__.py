"""Operator library of the port: quaternions, rigid kinematics, RPY
mobility (plain sweep and CUDA kernels), saddle preconditioner and solver,
Lanczos noise and RFD drift."""

from rigid_body_light_tpu_torch.ops import gmres
from rigid_body_light_tpu_torch.ops import quaternion
from rigid_body_light_tpu_torch.ops import kinematics
from rigid_body_light_tpu_torch.ops import rpy
from rigid_body_light_tpu_torch.ops import rpy_cuda
from rigid_body_light_tpu_torch.ops import saddle
from rigid_body_light_tpu_torch.ops import solvers
from rigid_body_light_tpu_torch.ops import lanczos
from rigid_body_light_tpu_torch.ops import rfd

__all__ = ["gmres", "quaternion", "kinematics", "rpy", "rpy_cuda", "saddle",
           "solvers", "lanczos", "rfd"]
