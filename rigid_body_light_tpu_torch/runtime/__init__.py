"""Run-time I/O of the port: the asynchronous trajectory writer (its own
C++ writer thread, bound with ctypes) and the trajectory reader."""

from rigid_body_light_tpu_torch.runtime.trajectory import (
    TrajectoryWriter,
    native_available,
    read_trajectory,
)

__all__ = ["TrajectoryWriter", "read_trajectory", "native_available"]
