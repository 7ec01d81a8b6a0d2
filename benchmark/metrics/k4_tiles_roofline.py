"""K4 tiles' share of its roofline: the bound time of its launches' work
(the blob pairs within the cut at the window's final positions, at the
launch's RHS count) over their device time, its slot sum counted with it."""
from benchmark import readers
from benchmark.work import ewald_tiles


def read(t):
    if not any(readers.base(k) == "ewald_tile_kernel"
               for k in t.device.kernels):
        return None
    r = t.positions.double()
    pairs = ewald_tiles.pairs_within(r, t.sim["box"], t.sim["ewald_rc"])
    n = r.shape[0]
    return readers.roofline_pct(
        t, ("ewald_tile_kernel",), helpers=("tile_sum_slots_kernel",),
        work=lambda k: (ewald_tiles.flops(pairs, k),
                              ewald_tiles.n_bytes(n, k)))
