"""The work of one balanced-split real-space product, as kernel K4 tiles
(``ewald_tile_kernel``) computes it: 36 + 6·D + 36·k flop per unordered
blob pair within the cut rc (minimum image), with the Chebyshev degree
D = 47 of the real-space scalars at rc 3.5 and ewald_tol 1e-4 (PERF.md §6
"Bounds", frozen here); positions, ids and forces read once, velocities
written once.  The pairs are counted from the positions and rc alone, not
from any tile list."""

import torch

DEGREE = 47


def pairs_within(r: torch.Tensor, box, rc: float, block: int = 2048) -> int:
    """Unordered pairs i < j of blobs r (N, 3) closer than rc under minimum
    image in the (Lx, Ly, Lz) box."""
    L = torch.as_tensor(box, dtype=r.dtype, device=r.device)
    n, count = r.shape[0], 0
    cols = torch.arange(n, device=r.device)
    for s in range(0, n, block):
        d = r[s:s + block, None, :] - r[None, :, :]
        d = d - L * torch.round(d / L)
        close = torch.sum(d * d, dim=-1) < rc * rc
        upper = cols[None, :] > torch.arange(s, min(s + block, n),
                                             device=r.device)[:, None]
        count += int((close & upper).sum())
    return count


def flops(pairs: int, k: int) -> float:
    return pairs * (36 + 6 * DEGREE + 36 * k)


def n_bytes(n: int, k: int) -> float:
    return n * (16 + 24 * k)
