"""Own ms a step of the saddle preconditioner's applies (span ``pc_apply``)."""
from benchmark.readers import ms_per_step


def read(t):
    return ms_per_step(t, "pc_apply")
