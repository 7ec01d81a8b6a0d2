"""Own ms a step of the mobility products outside the spans nested in them
(span ``mobility``): the wrappers' work around the kernels."""
from benchmark.readers import ms_per_step


def read(t):
    return ms_per_step(t, "mobility")
