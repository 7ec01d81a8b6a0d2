"""ms a step of the balanced split's sorted tiles and pair lists (span
``ewald_tiles``)."""
from benchmark.readers import ms_per_step


def read(t):
    return ms_per_step(t, "ewald_tiles", own=False)
