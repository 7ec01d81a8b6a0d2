"""Own ms a step of the body kinematics and the RFD drift (spans
``kinematics`` and ``rfd``)."""
from benchmark.readers import ms_per_step


def read(t):
    return ms_per_step(t, "kinematics", "rfd")
