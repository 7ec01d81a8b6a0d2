"""Operator library of the port: quaternions, rigid kinematics, RPY
mobility (plain sweep and CUDA kernels), the proxy-grid far field (plain
and CUDA near sweep), the triply-periodic Ewald operator (plain and CUDA
real-space sweep), saddle preconditioner and solver, Lanczos noise and
RFD drift."""

from rigid_body_light_tpu_torch.ops import cuda_build
from rigid_body_light_tpu_torch.ops import gmres
from rigid_body_light_tpu_torch.ops import quaternion
from rigid_body_light_tpu_torch.ops import kinematics
from rigid_body_light_tpu_torch.ops import rpy
from rigid_body_light_tpu_torch.ops import rpy_cuda
from rigid_body_light_tpu_torch.ops import tiles
from rigid_body_light_tpu_torch.ops import farfield_cuda
from rigid_body_light_tpu_torch.ops import farfield
from rigid_body_light_tpu_torch.ops import ewald
from rigid_body_light_tpu_torch.ops import ewald_cuda
from rigid_body_light_tpu_torch.ops import saddle
from rigid_body_light_tpu_torch.ops import solvers
from rigid_body_light_tpu_torch.ops import lanczos
from rigid_body_light_tpu_torch.ops import rfd

__all__ = ["cuda_build", "gmres", "quaternion", "kinematics", "rpy", "rpy_cuda",
           "tiles", "farfield_cuda", "farfield", "ewald", "ewald_cuda",
           "saddle", "solvers", "lanczos", "rfd"]
