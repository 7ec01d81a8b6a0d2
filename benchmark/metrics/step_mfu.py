"""The counted work's share of the card's FP32 peak over the traced
window: the work of every launch of the kernels the benchmark counts (the
pair sweeps K1 and K2 at all-pairs work, K4 tiles at the pairs within the
cut, each counted from the positions as in their rooflines) over the
traced window's length.  The FFTs and complex GEMMs of the wave part are
not counted, so where they do the work (the balanced cell) this is a floor
of the whole step's share, not the share."""
from benchmark import peaks, readers
from benchmark.work import ewald_tiles, pair_sweep


def read(t):
    n = t.positions.shape[0]
    flops, pairs = 0.0, None
    for name, count in t.device.launches.items():
        b = readers.base(name)
        if b not in readers.NRHS_ARG:
            continue
        k = readers.nrhs(name)
        if b == "ewald_tile_kernel":
            if pairs is None:
                pairs = ewald_tiles.pairs_within(
                    t.positions.double(), t.sim["box"], t.sim["ewald_rc"])
            flops += count * ewald_tiles.flops(pairs, k)
        else:
            flops += count * pair_sweep.flops(n, k)
    if flops == 0.0 or t.device.window_s <= 0:
        return None
    return 100.0 * flops / (t.device.window_s * peaks.FP32_FLOPS)
