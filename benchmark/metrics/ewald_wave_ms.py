"""ms a step of the balanced split's gridded wave part (span ``ewald_pme``)."""
from benchmark.readers import ms_per_step


def read(t):
    return ms_per_step(t, "ewald_pme", own=False)
