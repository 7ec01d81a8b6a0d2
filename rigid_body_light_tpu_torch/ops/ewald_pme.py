"""Gridded (PME-style) Ewald wave part — the port of
``rigid_body_light_tpu/ops/ewald_pme.py``: the k-sum of the balanced split
as cell-spectral FFTs, at O(N·p³ + G³·p³·log G) instead of the dense
O(N·K) sum (:func:`.ewald.wave_space_apply`), so that

    M_per·F = real_cells(rc) + A_self·F + wave_grid(F)

is the at-scale periodic operator.

1. Fold positions into the box and anterpolate F onto p³ Chebyshev nodes
   per cell of a (Gx, Gy, Gz) grid that tiles the box exactly (the far
   field's :func:`.farfield._p2m`, summed per cell in blob order).
2. 3-D real FFT of the node moments over the cell axes (``torch.fft``).
   With node x = (c + s_u)·h and k = 2πn/L the plane-wave phase factorizes,
   e^{ik·x} = e^{2πi n·c/G}·e^{2πi n·s_u/G}: the cell factor is the DFT at
   frequency n mod G, the node factor a per-axis p-vector.
3. With the grid oversampled past Nyquist (G_d ≥ 2·nmax_d + 2) every
   spectral bin holds at most one wavevector, so the kernel is diagonal
   over bins and rank-3 inside each:
   û(m) = wk·φ_u(k)·(I − k̂k̂)·Σ_{u'} φ̄_{u'}(k)·Q̂(m)_{u'},
   the node contractions taken one axis at a time.
4. Inverse FFT, interpolate the node velocities back to the blobs with
   the spreading basis (:func:`.farfield._l2p`).

The one approximation is the Chebyshev interpolation of the plane waves
inside a cell; because the spread and the readback share one basis, the
gridded wave operator is exactly symmetric positive semi-definite.

Polydisperse (``make_grid(..., radii=)``): the symbol sinc(kaᵢ)·sinc(kaⱼ)
factorizes per blob, so each species spreads onto its own moment field,
each species' spectrum is weighted by its per-bin sinc(|k|a_s) before the
fields are summed into one amplitude, and each blob reads back its own
species' sinc-weighted synthesis.

The JAX package runs its FFTs through TPU workarounds (``fftsafe``,
lane-padded selector tensors); here the node axis B = 3p³ leads the cell
axes, so each FFT is a batch of contiguous 3-D transforms, and the O(G³)
tables are device tensors built once per grid (:func:`.ewald.per_operator`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rigid_body_light_tpu_torch.ops import ewald, farfield


class EwaldGrid(NamedTuple):
    """Spectral-bin tables of one grid (numpy, float64 / complex128)."""

    grid: tuple           # (Gx, Gy, Gz) cells — tiles the box exactly
    p: int                # Chebyshev nodes per axis per cell
    wk_bin: np.ndarray    # (Gx, Gy, Gz//2+1) wave weight × ΠG (the inverse
    #                       FFT's 1/ΠG); 0 on bins holding no wavevector
    khat_bin: np.ndarray  # (Gx, Gy, Gz//2+1, 3) unit k̂ (0 where wk_bin=0)
    phi_x: np.ndarray     # (Gx, p) complex e^{2πi·n(m)·s_u/Gx} node phases
    phi_y: np.ndarray     # (Gy, p)
    phi_z: np.ndarray     # (Gz//2+1, p)
    sidx: np.ndarray = None      # polydisperse: (N,) int32 species per blob
    sinc_bin: np.ndarray = None  # (S, Gx, Gy, Gz//2+1) sinc(|k|·a_s);
    #                              wk_bin then carries wk_raw (no sinc²)


def _next_fast(n: int) -> int:
    """Smallest 2^a·3^b·5^c ≥ n (FFT-friendly grid sizes)."""
    m = n
    while True:
        k = m
        for f in (2, 3, 5):
            while k % f == 0:
                k //= f
        if k == 1:
            return m
        m += 1


def _signed_freq(g: int) -> np.ndarray:
    o = np.arange(g)
    return np.where(o <= g // 2, o, o - g).astype(np.int64)


def make_grid(params: ewald.EwaldParams, p: int = 4,
              oversample: float = 2.0, radii=None) -> EwaldGrid:
    """The spectral-bin tables for ``params``' wavevector set.

    The grid size per axis is the FFT-friendly round-up of
    ``oversample · (2·nmax_d + 1)`` (≥ 2·nmax_d + 2, so each bin holds at
    most one k).  radii: (N,) per-blob radii (numpy or a tensor) — builds
    the species-split tables (``sidx`` / ``sinc_bin``) and the sinc-free
    ``wk_bin``.
    """
    if params.nvecs is None:
        raise ValueError("make_grid needs params.nvecs (ewald.make_params)")
    if p < 2:
        raise ValueError(f"ewald grid needs p >= 2 nodes per dim, got {p}")
    if oversample < 1.0:
        raise ValueError(f"oversample must be >= 1, got {oversample}")
    box = params.box
    nmax = np.abs(params.nvecs).max(axis=0).astype(int)      # (3,)
    grid = tuple(
        _next_fast(max(int(np.ceil(oversample * (2 * nm + 1))), 2 * nm + 2, 4))
        for nm in nmax)
    gx, gy, gz = grid
    gzh = gz // 2 + 1
    # the exact keep-predicate of make_params: k ≠ 0 and |k| ≤ kmax
    kmax2 = float((params.kvecs ** 2).sum(axis=1).max()) * (1 + 1e-12)
    NX, NY, NZ = np.meshgrid(_signed_freq(gx), _signed_freq(gy),
                             np.arange(gzh), indexing="ij")
    n_bin = np.stack([NX, NY, NZ], axis=-1)                  # (gx,gy,gzh,3)
    kvec = 2 * np.pi * n_bin / np.asarray(box)
    k2 = np.sum(kvec**2, axis=-1)
    keep = (k2 > 0) & (k2 <= kmax2) & np.all(np.abs(n_bin) <= nmax, axis=-1)
    wk_raw, wk = ewald.wave_weights(kvec, params.a, params.eta, box,
                                    params.xi)
    sidx = sinc_bin = None
    if radii is not None:
        if torch.is_tensor(radii):
            radii = radii.detach().cpu().numpy()
        rad = np.asarray(radii, np.float64)
        uniq, sidx = np.unique(rad, return_inverse=True)
        sidx = sidx.astype(np.int32)
        kk = np.sqrt(np.maximum(k2, 1e-300))
        ka = kk[None] * uniq[:, None, None, None]    # (S, gx, gy, gzh)
        sinc_bin = np.where(keep[None], np.sinc(ka / np.pi), 0.0)
        wk = wk_raw                                  # sinc² moves per species
    wk_bin = np.where(keep, wk, 0.0) * float(gx * gy * gz)
    khat = np.where(keep[..., None],
                    kvec / np.sqrt(np.maximum(k2, 1e-300))[..., None], 0.0)
    nodes = farfield._cheb_nodes(p)                          # (p,) in (0,1)

    def phases(g, freqs):
        return np.exp(2j * np.pi * np.outer(freqs, nodes) / g)

    return EwaldGrid(
        grid=grid, p=int(p), wk_bin=wk_bin, khat_bin=khat,
        phi_x=phases(gx, _signed_freq(gx)),
        phi_y=phases(gy, _signed_freq(gy)),
        phi_z=phases(gz, np.arange(gzh)),
        sidx=sidx, sinc_bin=sinc_bin,
    )


def _device_tables(g: EwaldGrid, dtype, dev):
    """(wk_bin, k̂ (3, Gx, Gy, Gz//2+1), φx, φy, φz, sinc_bin, species
    one-hot (S, N)) on ``dev`` in ``dtype`` and its complex type; the last
    two None for a monodisperse grid."""
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128

    def real(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                               device=dev)

    def cplx(v):
        return torch.as_tensor(v, dtype=cdtype, device=dev)

    sinc = onehot = None
    if g.sidx is not None:
        sinc = real(g.sinc_bin)
        onehot = real(np.arange(g.sinc_bin.shape[0])[:, None]
                      == g.sidx[None, :])
    return (real(g.wk_bin), real(np.moveaxis(g.khat_bin, -1, 0)),
            cplx(g.phi_x), cplx(g.phi_y), cplx(g.phi_z), sinc, onehot)


def wave_space_apply_grid(F, r, params: ewald.EwaldParams, g: EwaldGrid):
    """U_wave = Σ_{k≠0} wk(I − k̂k̂) e^{ik·(rᵢ−rⱼ)} F_j on the cell grid.

    Drop-in for :func:`.ewald.wave_space_apply` (the i = j wave self term
    included, symmetric PSD).  F (N, 3) or (k, N, 3), sharing the spread
    weights and the spectral batch.  A grid built with ``radii=`` runs the
    species-split path (S spread/readback fields in the RHS batch axis,
    one shared spectral kernel).
    """
    r = r.reshape(-1, 3)
    dtype, dev = r.dtype, r.device
    single = F.dim() == 2
    Fs = F.to(dtype).reshape(-1, r.shape[0], 3)
    gx, gy, gz = g.grid
    gzh = gz // 2 + 1
    p = g.p
    k = Fs.shape[0]
    wkb, kh, px, py, pz, sinc, onehot = ewald.per_operator(
        g, ("grid tables", dtype, dev), lambda: _device_tables(g, dtype, dev))
    S = 1 if sinc is None else sinc.shape[0]
    box = torch.as_tensor(params.box, dtype=dtype, device=dev)
    h = box / torch.as_tensor(g.grid, dtype=dtype, device=dev)
    xf = r - box * torch.floor(r / box)                      # fold into box
    ci, cid = farfield._cell_indices(xf, torch.zeros(3, dtype=dtype,
                                                     device=dev), h, g.grid)
    t3 = torch.clamp(xf / h - ci.to(dtype), 0.0, 1.0)        # intra-cell
    W3 = farfield._blob_weights(t3, farfield._cheb_nodes(p))  # (N, p³)
    if onehot is not None:
        # species-split spread fields, folded into the RHS batch axis
        Fs = (Fs[:, None] * onehot[None, :, :, None]).reshape(k * S, -1, 3)
    Q = farfield._p2m(W3, cid, Fs, gx * gy * gz)              # (kS, G³, 3p³)
    # node axis (a, b, c, t) ahead of the cell axes: each FFT is a batch of
    # contiguous 3-D transforms
    Q = Q.reshape(k * S, gx, gy, gz, p, p, p, 3).permute(
        0, 4, 5, 6, 7, 1, 2, 3)
    Qh = torch.fft.rfftn(Q, dim=(-3, -2, -1))           # (kS,p,p,p,3,x,y,zh)
    # analysis, one node axis at a time: Â_t = Σ_abc φ̄x_a φ̄y_b φ̄z_c Q̂_abct
    A = torch.einsum("kabctxyz,zc->kabtxyz", Qh, pz.conj())
    A = torch.einsum("kabtxyz,yb->katxyz", A, py.conj())
    A = torch.einsum("katxyz,xa->ktxyz", A, px.conj())       # (kS,3,x,y,zh)
    if sinc is not None:
        # Σ_s sinc_s·Â_s: one plane-wave amplitude per bin
        A = torch.sum(A.reshape(k, S, 3, gx, gy, gzh) * sinc[None, :, None],
                      dim=1)
    A = wkb * (A - kh * torch.sum(kh * A, dim=1, keepdim=True))
    if sinc is not None:
        # fan the kernelled amplitude back out with the species' weights
        A = (A[:, None] * sinc[None, :, None]).reshape(k * S, 3, gx, gy,
                                                       gzh)
    # synthesis: V̂_abct = φx_a φy_b φz_c Â_t
    V = torch.einsum("ktxyz,xa->katxyz", A, px)
    V = torch.einsum("katxyz,yb->kabtxyz", V, py)
    V = torch.einsum("kabtxyz,zc->kabctxyz", V, pz)
    Un = torch.fft.irfftn(V, s=(gx, gy, gz), dim=(-3, -2, -1))
    Un = Un.permute(0, 5, 6, 7, 1, 2, 3, 4).reshape(k * S, gx * gy * gz,
                                                    3 * p ** 3)
    U = farfield._l2p(W3, cid, Un)                           # (kS, N, 3)
    if onehot is not None:
        # each blob reads its own species' sinc-weighted synthesis field
        U = torch.einsum("ksnx,sn->knx", U.reshape(k, S, -1, 3), onehot)
    return U[0] if single else U
