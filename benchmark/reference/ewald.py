"""Plain triply-periodic RPY mobility rows.

The periodic RPY operator of a (Lx, Ly, Lz) box is the lattice sum of the
RPY tensor with the k = 0 mode left out (zero mean velocity).  It is
split here with the positively split screen H(k) = (1 + k²/4ξ²)e^{−k²/4ξ²}
(Fiore, Balboa Usabiaga, Donev & Swan, J. Chem. Phys. 146, 124116, 2017),
whose total does not depend on ξ, at a ξ of this module's own:

  wave part   (1/V) Σ_{k≠0} sinc²(ka) H(k)/(ηk²) (I − k̂k̂) e^{ik·r}, summed
              directly over every wavevector up to where H is below 1e-13;
  real part   the RPY tensor (closed form, with its overlap branch) less
              the wave kernel's inverse transform, under minimum image
              within L/2, where it is below 1e-13.

The wave kernel's inverse transform is the radial integral

  M_w(r) = (1/2π²η) ∫₀^∞ sinc²(ka) H(k) [(j₀ − j₁/x) I + j₂ r̂r̂] dk,
  x = kr,

taken by Gauss–Legendre quadrature onto a table of r and read back by
cubic Lagrange interpolation.  Nothing here reads the program or its
splitting: ξ, the wavevectors and the cut are worked out again.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.arith import Arith

TAIL = 5.8          # ξ·rcut and √(k²/4ξ²) at the cut: e^{−33.6}
TABLE_H = 5e-4      # the table's spacing in r
QUAD_NODES = 600


def _sph_bessel(x):
    """(j₀, j₁/x, j₂) of x ≥ 0, series below x = 0.1."""
    small = x < 0.1
    xs = torch.where(small, torch.ones_like(x), x)
    s, c = torch.sin(xs), torch.cos(xs)
    j0 = s / xs
    j1x = s / xs**3 - c / xs**2
    j2 = (3.0 / xs**2 - 1.0) * s / xs - 3.0 * c / xs**2
    x2 = x * x
    j0s = 1 - x2 / 6 + x2**2 / 120 - x2**3 / 5040 + x2**4 / 362880
    j1s = 1 / 3 - x2 / 30 + x2**2 / 840 - x2**3 / 45360 + x2**4 / 3991680
    j2s = x2 / 15 - x2**2 / 210 + x2**3 / 7560 - x2**4 / 498960
    return (torch.where(small, j0s, j0), torch.where(small, j1s, j1x),
            torch.where(small, j2s, j2))


def _rpy_ab(r, a, eta):
    """Free-space RPY as A(r)·I + B(r)·r̂r̂ for r > 0."""
    far = r >= 2 * a
    safe = torch.where(r > 0, r, torch.ones_like(r))
    oseen = 8 * math.pi * eta * safe
    A = torch.where(far, (1 + 2 * a * a / (3 * safe * safe)) / oseen,
                    (1 - 9 * safe / (32 * a)) / (6 * math.pi * eta * a))
    B = torch.where(far, (1 - 2 * a * a / (safe * safe)) / oseen,
                    (3 * safe / (32 * a)) / (6 * math.pi * eta * a))
    return A, B


class PeriodicRPY:
    """The periodic RPY operator of ``box`` for blobs of radius ``a``,
    evaluated at rows against every column (float64 tables; sums in the
    arithmetic ``ar``)."""

    def __init__(self, box, a, eta, ar: Arith, device):
        self.box = tuple(float(b) for b in box)
        self.a, self.eta = float(a), float(eta)
        self.ar, self.device = ar, device
        self.rcut = min(self.box) / 2.0
        self.xi = TAIL / self.rcut
        kmax = 2.0 * self.xi * TAIL
        nmax = [int(math.ceil(kmax * L / (2 * math.pi))) for L in self.box]
        g = np.meshgrid(*[np.arange(-n, n + 1) for n in nmax], indexing="ij")
        nv = np.stack([x.ravel() for x in g], axis=1)
        half = (nv[:, 2] > 0) | ((nv[:, 2] == 0) & (nv[:, 1] > 0)) | \
            ((nv[:, 2] == 0) & (nv[:, 1] == 0) & (nv[:, 0] > 0))
        kv = 2 * np.pi * nv / np.asarray(self.box)
        k2 = np.sum(kv**2, axis=1)
        keep = half & (k2 <= kmax**2)
        self.nmax = nmax
        self.nvecs = torch.as_tensor(nv[keep], device=device)
        kv, k2 = kv[keep], k2[keep]
        k = np.sqrt(k2)
        u = k2 / (4 * self.xi**2)
        sinc = np.sin(k * a) / (k * a)
        V = float(np.prod(self.box))
        # ±k pairs: twice the real part of the half space's terms
        w = 2.0 * sinc**2 * (1 + u) * np.exp(-u) / (eta * V * k2)
        self.khat = torch.as_tensor(kv / k[:, None], device=device)
        self.wk = torch.as_tensor(w, device=device)
        self._table()

    def _table(self):
        kq = 2.0 * self.xi * math.sqrt(40.0)
        t, wq = np.polynomial.legendre.leggauss(QUAD_NODES)
        k = torch.as_tensor(0.5 * kq * (t + 1), device=self.device)
        wq = torch.as_tensor(0.5 * kq * wq, device=self.device)
        ka = k * self.a
        u = k * k / (4 * self.xi**2)
        f = (torch.sin(ka) / ka) ** 2 * (1 + u) * torch.exp(-u) * wq \
            / (2 * math.pi**2 * self.eta)
        m = int(math.ceil(self.rcut / TABLE_H)) + 6
        r = (torch.arange(m, device=self.device, dtype=torch.float64)
             - 2.0) * TABLE_H
        A, B = [], []
        for s in range(0, m, 2048):
            x = r[s:s + 2048].abs()[:, None] * k[None, :]
            j0, j1x, j2 = _sph_bessel(x)
            A.append(((j0 - j1x) * f).sum(-1))
            B.append((j2 * f).sum(-1))
        self.tab_A, self.tab_B = torch.cat(A), torch.cat(B)
        A0 = self.tab_A[2].item()
        self.self_real = 1.0 / (6 * math.pi * self.eta * self.a) - A0

    def _interp(self, r):
        """(A_w, B_w) at r by 4-point Lagrange on the table."""
        u = r / TABLE_H + 2.0
        i = torch.floor(u).long()
        f = u - i
        w = (-f * (f - 1) * (f - 2) / 6, (f + 1) * (f - 1) * (f - 2) / 2,
             -(f + 1) * f * (f - 2) / 2, (f + 1) * f * (f - 1) / 6)
        A = sum(wj * self.tab_A[i - 1 + j] for j, wj in enumerate(w))
        B = sum(wj * self.tab_B[i - 1 + j] for j, wj in enumerate(w))
        return A, B

    def rows(self, rows, r, F, row_block=64, k_block=512):
        """U at blobs ``rows`` of the operator applied to F (N, 3) or
        (k, N, 3) at positions r (N, 3)."""
        ar = self.ar
        multi = F.dim() == 3
        Fs = ar.op(F if multi else F[None])
        r = ar.op(r)
        box = torch.as_tensor(self.box, dtype=torch.float64, device=r.device)
        N = r.shape[0]
        cols = torch.arange(N, device=r.device)
        real = []
        for s in range(0, rows.numel(), row_block):
            idx = rows[s:s + row_block]
            d = (r[idx][:, None, :] - r[None, :, :]).double()
            d = d - box * torch.round(d / box)
            rr = torch.sqrt(torch.sum(d * d, dim=-1))
            live = (rr < self.rcut) & (idx[:, None] != cols[None, :])
            rs = torch.where(live, rr, torch.full_like(rr, 1.0))
            Ar, Br = _rpy_ab(rs, self.a, self.eta)
            Aw, Bw = self._interp(rs)
            A = ar.op(torch.where(live, Ar - Aw, torch.zeros_like(rs)))
            B = ar.op(torch.where(live, Br - Bw, torch.zeros_like(rs)))
            e = ar.op(d / rs[..., None])
            blk = []
            for Fk in Fs:
                eF = torch.sum(e * Fk[None], -1, keepdim=True)
                u = (A[..., None] * Fk[None] + B[..., None] * e * eF).sum(1)
                blk.append(u + self.self_real * Fk[idx])
            real.append(torch.stack(blk))
        U = torch.cat(real, dim=1) + self._wave_rows(rows, r, Fs, k_block)
        return U if multi else U[0]

    def _phases(self, r):
        """Per-axis e^{−i·2πn·x/L} tables, (N, 2n+1) each."""
        out = []
        for ax in range(3):
            n = torch.arange(-self.nmax[ax], self.nmax[ax] + 1,
                             device=r.device, dtype=torch.float64)
            ph = -2 * math.pi * r[:, ax].double()[:, None] * n[None, :] \
                / self.box[ax]
            out.append(torch.polar(torch.ones_like(ph), ph))
        return out

    def _wave_rows(self, rows, r, Fs, k_block):
        ar = self.ar
        ex, ey, ez = self._phases(r)
        nx, ny, nz = (self.nvecs[:, ax] + self.nmax[ax] for ax in range(3))
        Fc = ar.op(Fs.to(ar.cdtype))                      # (k, N, 3)
        U = torch.zeros((Fs.shape[0], rows.numel(), 3), dtype=ar.dtype,
                        device=r.device)
        for s in range(0, nx.numel(), k_block):
            sl = slice(s, s + k_block)
            P = ar.op(ex[:, nx[sl]] * ey[:, ny[sl]] * ez[:, nz[sl]])  # (N, Kb)
            # S(k) = Σ_j e^{−ik·r_j} F_j
            S = torch.einsum("nk,rnc->rkc", P, Fc)
            kh = self.khat[sl].to(ar.dtype)
            kS = torch.einsum("rkc,kc->rk", S, kh.to(ar.cdtype))
            G = (S - kh.to(ar.cdtype)[None] * kS[..., None]) \
                * self.wk[sl].to(ar.dtype)[None, :, None]
            Prow = ar.op(torch.conj(P[rows]))             # e^{+ik·r_i}
            U = U + torch.einsum("ik,rkc->ric", Prow, ar.op(G)).real
        return U
