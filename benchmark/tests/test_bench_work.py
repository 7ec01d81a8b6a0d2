"""The flop and pair counts of the rooflines against hand counts."""

import itertools
import math

import pytest
import torch

from benchmark import peaks, readers, spec, trace
from benchmark.harness import TraceView
from benchmark.work import ewald_tiles, pair_sweep


def test_pair_sweep_counts():
    # 4 blobs, 1 RHS: 16/2 pairs × (60 + 60)
    assert pair_sweep.flops(4, 1) == 960
    assert pair_sweep.flops(10272, 2) == pytest.approx(9.50e9, rel=1e-3)
    assert pair_sweep.n_bytes(4, 2) == 4 * 60


def test_pairs_within_matches_double_loop():
    g = torch.Generator().manual_seed(3)
    box = (4.0, 5.0, 3.0)
    r = torch.rand((57, 3), generator=g, dtype=torch.float64) \
        * torch.tensor(box)
    hand = 0
    for i, j in itertools.combinations(range(57), 2):
        d = [r[i, c] - r[j, c] for c in range(3)]
        d = [x - L * round(float(x) / L) for x, L in zip(d, box)]
        hand += math.sqrt(sum(float(x) ** 2 for x in d)) < 1.2
    assert ewald_tiles.pairs_within(r, box, 1.2, block=7) == hand
    assert ewald_tiles.flops(10, 2) == 10 * (36 + 6 * 47 + 72)


def _view(kernels, launches, n=100):
    dt = trace.DeviceTrace(kernels, launches, 1.0, 2.0, [], [])
    return TraceView(1, 3, [3.0], {}, dt, torch.zeros((n, 3)), {})


def test_roofline_share_by_template_argument():
    k1 = "pair_sweep_sym_kernel<true, 2, false, false>"
    t = _view({k1: 1e-3, "tile_items::sum_items_kernel": 1e-3},
              {k1: 4, "tile_items::sum_items_kernel": 4}, n=1000)
    bound = 4 * peaks.bound_s(pair_sweep.flops(1000, 2),
                              pair_sweep.n_bytes(1000, 2))
    got = readers.roofline_pct(
        t, ("pair_sweep_sym_kernel",), helpers=("sum_items_kernel",),
        work=lambda k: (pair_sweep.flops(1000, k),
                              pair_sweep.n_bytes(1000, k)))
    assert got == pytest.approx(100 * bound / 2e-3)
    assert readers.roofline_pct(t, ("ewald_tile_kernel",),
                                work=lambda k: (1, 1)) is None


def test_gmres_drift_reads_last_chunk_less_first():
    t = _view({}, {})._replace(chunk_iters=[9.0, 14.5, 20.0])
    assert spec.reader("gmres_iters_drift")(t) == pytest.approx(11.0)
    assert spec.reader("gmres_iters_drift")(t._replace(
        chunk_iters=[9.0])) is None


def test_short_kernel_name():
    assert trace.short_name(
        "void pair_sweep_ordered_kernel<true, 2, false, false>"
        "(float const*, int)") == \
        "pair_sweep_ordered_kernel<true, 2, false, false>"
