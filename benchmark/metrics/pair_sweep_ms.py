"""ms a step inside the wall pair sweeps' launches (spans
``pair_sweep_sym`` and ``pair_sweep_ordered``: K1 and K2)."""
from benchmark.readers import ms_per_step


def read(t):
    return ms_per_step(t, "pair_sweep_sym", "pair_sweep_ordered", own=False)
