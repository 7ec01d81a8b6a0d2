"""K2's share of its roofline: the bound time of its launches' work (an
all-pairs product of the window's blobs at the launch's RHS count) over
their device time, its chunk sum counted with it."""
from benchmark import readers
from benchmark.work import pair_sweep


def read(t):
    n = t.positions.shape[0]
    return readers.roofline_pct(
        t, ("pair_sweep_ordered_kernel",), helpers=("sum_chunks_kernel",),
        work=lambda k: (pair_sweep.flops(n, k), pair_sweep.n_bytes(n, k)))
