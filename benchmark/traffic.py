"""The one traffic generator: a traffic mix's parameters and a seed → the
bodies' initial positions and orientations.

A mix (``traffic/<name>.json``) places its bodies on a lattice:

  lattice       [nx, ny, nz] bodies along each axis; body i sits at
                (i mod nx, ⌊i/nx⌋ mod ny, ⌊i/(nx·ny)⌋)
  spacing       the lattice's steps along x, y, z
  origin        the first body's position
  height_cycle  added to z of body i by i mod its length (default [0])
  jitter        each coordinate moved by a uniform draw in ±jitter
  chunk         steps of each ``run_bd`` call of the window, each from
                the previous chunk's end
  simulation    settings of the cell on top of its configuration's

Orientations are uniform random unit quaternions.  Every seed gives the
same lattice, sizes and chunks; the seed moves the jitter, the
orientations and the Brownian draws.
"""

from __future__ import annotations

import torch

# the streams one seed feeds (placements, the window's draws, the check's
# inputs, the warm-up's draws)
PLACE, DRAWS, CHECK, WARM = range(4)


def stream(seed: int, k: int) -> int:
    """A generator seed for stream ``k`` of ``seed``."""
    return (int(seed) * 1_000_003 + k) % 2**63


def n_bodies(traffic) -> int:
    nx, ny, nz = traffic["lattice"]
    return nx * ny * nz


def placements(traffic, seed, device):
    """(X (B, 3), Q (B, 4)) float64 on ``device`` from ``seed``."""
    nx, ny, nz = traffic["lattice"]
    B = nx * ny * nz
    i = torch.arange(B, device=device)
    lat = torch.stack([i % nx, (i // nx) % ny, i // (nx * ny)], dim=1)
    step = torch.as_tensor(traffic["spacing"], dtype=torch.float64,
                           device=device)
    X = torch.as_tensor(traffic["origin"], dtype=torch.float64,
                        device=device) + lat.double() * step
    cyc = torch.as_tensor(traffic.get("height_cycle", [0.0]),
                          dtype=torch.float64, device=device)
    X[:, 2] += cyc[i % cyc.numel()]
    g = torch.Generator(device=device).manual_seed(stream(seed, PLACE))
    kw = dict(generator=g, dtype=torch.float64, device=device)
    X += (2.0 * torch.rand((B, 3), **kw) - 1.0) * traffic["jitter"]
    Q = torch.randn((B, 4), **kw)
    return X, Q / torch.linalg.norm(Q, dim=1, keepdim=True)
