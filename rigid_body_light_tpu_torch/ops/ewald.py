"""Triply-periodic RPY mobility via positively-split Ewald — the port of
the single-device part of ``rigid_body_light_tpu/ops/ewald.py``.

The exact periodic RPY operator, split with the positively-split screen

    H(k) = (1 + k²/4ξ²) e^{−k²/4ξ²}          (Fiore, Balboa Usabiaga,
                                               Donev & Swan, JCP 2017)

into a short-ranged real-space part and a smooth wave-space part, both SPD
for every ξ:

    M_per = M_real(pairs) + A_self·I(self) + M_wave(everything).

The real-space part is A(r)·I + B(r)·r̂r̂ under 3-D minimum image, with

    A = S₀ + S'/r,   B = S'' − S'/r
    S₀(r) = [2J₃(r) − J₃(r+2a) − J₃(r−2a)] / (8π²ηa²r)
    S(r)  = [2J₅(r) − J₅(r+2a) − J₅(r−2a)] / (8π²ηa²r)
    J₃(α) = (√πα/4ξ)e^{−α²ξ²} − (πα²/4)erfc(αξ)
    J₅(α) = (πα⁴/48)erfc(αξ) − (√πα³/48ξ)e^{−α²ξ²}
            + (√πα/96ξ³)e^{−α²ξ²} + (π/64ξ⁴)erf(αξ)

(J_n odd in α), S', S'' by forward-mode differentiation of the closed
form.  Per-blob radii (polydisperse) shift the same J-cascade to
r ± (aᵢ − aⱼ), r ± (aᵢ + aⱼ), and the wave symbol becomes
sinc(kaᵢ)·sinc(kaⱼ)/(ηk²).  **float32 never evaluates these closed
forms**: their J-combination differences cancel catastrophically in
float32 (~1e-2 operator errors that diverge GMRES and break the M^{1/2}
sampling).  float32 evaluates the host-fitted float64 piecewise-Chebyshev
representation of A and B (``EwaldParams.cheb_*``) by Clenshaw instead;
float64 evaluates the closed forms.

The wave part is dense matmuls against the (N, K) phase matrices cos/sin
of r·k: ``torch.matmul`` / ``einsum`` at full float32 precision (the
package pins TF32 off).

:func:`real_space_apply` is the plain version of the CUDA real-space
sweep (:mod:`.ewald_cuda`, ``csrc/ewald_real_sweep.cu``) and the CPU
path.  The host fits (:func:`make_params`, numpy + scipy) are copied from
the JAX package so that both build identical arrays.

The balanced split (``make_params(rc=)``) cuts the real part at rc < L/2:
:func:`mobility_apply` then sweeps it over sorted tiles
(:mod:`.ewald_cells`; float32 through the kernel K4 tiles unless
``use_kernel=False``), and with a ``grid`` evaluates the wave part on the
cell-spectral grid (:mod:`.ewald_pme`).  float32 with per-blob radii
evaluates per-species-pair Chebyshev fits (:class:`PolyTables`).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from rigid_body_light_tpu_torch.utils import collectives, profiling
from rigid_body_light_tpu_torch.utils.collectives import psum

_SQPI = math.sqrt(math.pi)


# ------------------------------------------------------ float64 closed forms
def _erfc(x):
    return 1.0 - torch.special.erf(x)


def _j3(al, xi):
    """J₃(α) for α ≥ 0 (the odd extension is the caller's job)."""
    e = torch.exp(-(al * xi) ** 2)
    return _SQPI * al / (4.0 * xi) * e - math.pi * al**2 / 4.0 * _erfc(al * xi)


def _j5(al, xi):
    e = torch.exp(-(al * xi) ** 2)
    return (math.pi * al**4 / 48.0 * _erfc(al * xi)
            - _SQPI * al**3 / (48.0 * xi) * e
            + _SQPI * al / (96.0 * xi**3) * e
            + math.pi / (64.0 * xi**4) * torch.special.erf(al * xi))


def _j_odd(j_fn, al, xi):
    return torch.sign(al) * j_fn(torch.abs(al), xi)


def _s0(r, a, xi, eta, ai=None, aj=None):
    if ai is None:
        c = 1.0 / (8.0 * math.pi**2 * eta * a**2)
        return c / r * (2.0 * _j3(r, xi) - _j3(r + 2 * a, xi)
                        - _j_odd(_j3, r - 2 * a, xi))
    # polydisperse: sin(kaᵢ)sin(kaⱼ)sin(kr) product-to-sum — the same
    # J-cascade with shifts r ± (aᵢ − aⱼ), r ± (aᵢ + aⱼ)
    c = 1.0 / (8.0 * math.pi**2 * eta * ai * aj)
    d, sm = ai - aj, ai + aj
    return c / r * (_j_odd(_j3, r + d, xi) + _j_odd(_j3, r - d, xi)
                    - _j3(r + sm, xi) - _j_odd(_j3, r - sm, xi))


def _s(r, a, xi, eta, ai=None, aj=None):
    if ai is None:
        c = 1.0 / (8.0 * math.pi**2 * eta * a**2)
        return c / r * (2.0 * _j5(r, xi) - _j5(r + 2 * a, xi)
                        - _j_odd(_j5, r - 2 * a, xi))
    c = 1.0 / (8.0 * math.pi**2 * eta * ai * aj)
    d, sm = ai - aj, ai + aj
    return c / r * (_j_odd(_j5, r + d, xi) + _j_odd(_j5, r - d, xi)
                    - _j5(r + sm, xi) - _j_odd(_j5, r - sm, xi))


def real_space_ab(r, a, xi, eta=1.0, ai=None, aj=None):
    """Real-space Ewald scalars (A, B) with M_real = A·I + B·r̂r̂, from the
    closed forms; elementwise over any-shape ``r`` (physical units).  S'
    and S'' by forward-mode differentiation of the closed-form S, as the
    JAX package takes them.  ai, aj: per-pair radii broadcast against
    ``r`` (polydisperse, exact).  float64 only in practice (see module
    doc)."""
    def s_fn(rr):
        return _s(rr, a, xi, eta, ai=ai, aj=aj)

    def sp_fn(rr):
        return torch.func.jvp(s_fn, (rr,), (torch.ones_like(rr),))[1]

    sp, spp = torch.func.jvp(sp_fn, (r,), (torch.ones_like(r),))
    A = _s0(r, a, xi, eta, ai=ai, aj=aj) + sp / r
    B = spp - sp / r
    return A, B


def self_coeff(a, xi, eta=1.0):
    """A_self = lim_{r→0} A(r): the real-space part of the screened
    periodic self mobility — a Python float for a float ``a``, elementwise
    for a tensor of per-blob radii."""
    if not torch.is_tensor(a):
        return ((1.0 - math.erf(2.0 * a * xi)) / (6.0 * math.pi * eta * a)
                + (1.0 - math.exp(-4.0 * a**2 * xi**2))
                / (24.0 * math.pi**1.5 * a**2 * eta * xi))
    return ((1.0 - torch.special.erf(2.0 * a * xi)) / (6.0 * math.pi * eta * a)
            + (1.0 - torch.exp(-4.0 * a**2 * xi**2))
            / (24.0 * math.pi**1.5 * a**2 * eta * xi))


# ------------------------------------------------------------- host set-up
class EwaldParams(NamedTuple):
    """Static Ewald configuration (Python floats and numpy arrays).

    kvecs: (K, 3) wavevectors (k ≠ 0, |k| ≤ kmax).
    wk: (K,) positive wave weights H(k)·sinc²(ka)/(η V k²).
    wk_raw: (K,) the same without the sinc² factor.
    cheb_bounds/cheb_A/cheb_B: host-fitted float64 piecewise-Chebyshev
      representation of the monodisperse real-space scalars: (4,) segment
      edges and (3, D+1) coefficients per segment.  The float32 path must
      evaluate these instead of the closed forms (see module doc).
    rc: balanced-splitting real-space cutoff, or None for the classic
      split (the real part spans min(L)/2).
    nvecs: (K, 3) integer lattice indices n with k = 2πn/L.
    """

    box: tuple
    a: float
    eta: float
    xi: float
    kvecs: np.ndarray
    wk: np.ndarray
    wk_raw: np.ndarray = None
    cheb_bounds: np.ndarray = None
    cheb_A: np.ndarray = None
    cheb_B: np.ndarray = None
    rc: float = None
    nvecs: np.ndarray = None


_KEPT = 64
_kept = OrderedDict()


def per_operator(params: EwaldParams, key, make):
    """``make()`` once per operator ``params`` (or grid, or species-pair
    table set) and ``key``, then kept: the device copies of an operator's
    tables, so an apply neither rebuilds nor uploads them (a blocking
    upload from pageable memory also waits for the stream).  The last
    ``_KEPT`` entries are kept; an entry holds its params, so that id
    cannot be reused while the entry lives, and a hit checks identity —
    operators with equal contents keep their own."""
    k = (id(params), key)
    hit = _kept.get(k)
    if hit is not None and hit[0] is params:
        _kept.move_to_end(k)
        return hit[1]
    value = make()
    _kept[k] = (params, value)
    if len(_kept) > _KEPT:
        _kept.popitem(last=False)
    return value


def _np_j3(al, xi):
    from scipy.special import erfc

    e = np.exp(-(al * xi) ** 2)
    return (np.sqrt(np.pi) * al / (4.0 * xi) * e
            - np.pi * al**2 / 4.0 * erfc(al * xi))


def _np_j5(al, xi):
    from scipy.special import erf, erfc

    e = np.exp(-(al * xi) ** 2)
    return (np.pi * al**4 / 48.0 * erfc(al * xi)
            - np.sqrt(np.pi) * al**3 / (48.0 * xi) * e
            + np.sqrt(np.pi) * al / (96.0 * xi**3) * e
            + np.pi / (64.0 * xi**4) * erf(al * xi))


def _np_j_odd(j_fn, al, xi):
    return np.sign(al) * j_fn(np.abs(al), xi)


_CHEB_DEG = 48     # fit degree per segment (long-segment fit ≈ 4e-9 abs)
_CHEB_DEG_S = 96   # degree of the intermediate S-series (derivative source)


def _fit_pair_cheb(eta, xi, rmax, ai, aj, deg=_CHEB_DEG, deg_s=_CHEB_DEG_S):
    """Host float64 piecewise-Chebyshev fit of A(r), B(r) for one radius
    pair.

    Segments split at the kink radii r = |aᵢ−aⱼ| and r = aᵢ+aⱼ (the
    α|α|-type terms of the odd J-extension make the scalars non-smooth
    exactly there).  S', S'' come from differentiating a degree-``deg_s``
    Chebyshev series of S analytically (``chebder``).

    The required degree grows with ξ·(segment length), so each fit is
    validated against a deg+16 refit at off-node points and escalated
    until they agree to 3e-6 of the scalar's scale.

    Returns bounds (4,), coefA (3, D+1), coefB (3, D+1).
    """
    cheb = np.polynomial.chebyshev
    c = 1.0 / (8.0 * np.pi**2 * eta * ai * aj)
    d, sm = ai - aj, ai + aj

    def g(r, j_fn):
        return (_np_j_odd(j_fn, r + d, xi) + _np_j_odd(j_fn, r - d, xi)
                - j_fn(r + sm, xi) - _np_j_odd(j_fn, r - sm, xi))

    def fit_seg(lo, hi, deg, deg_s):
        ks = np.arange(deg_s + 1)
        xs = np.cos(np.pi * (ks + 0.5) / (deg_s + 1))
        rs = lo + (hi - lo) * (xs + 1) / 2
        cS = cheb.chebfit(xs, c / rs * g(rs, _np_j5), deg_s)
        scale = 2.0 / (hi - lo)
        cSp = cheb.chebder(cS) * scale
        cSpp = cheb.chebder(cSp) * scale
        kf = np.arange(deg + 1)
        xf = np.cos(np.pi * (kf + 0.5) / (deg + 1))
        rf = lo + (hi - lo) * (xf + 1) / 2
        sp = cheb.chebval(xf, cSp)
        spp = cheb.chebval(xf, cSpp)
        s0 = c / rf * g(rf, _np_j3)
        return (cheb.chebfit(xf, s0 + sp / rf, deg),
                cheb.chebfit(xf, spp - sp / rf, deg))

    rlo = 0.05 * min(ai, aj)   # below: clamp (A, B smooth and ~flat at 0)
    edges = [rlo, max(abs(d), rlo * (1 + 1e-9)), sm, rmax]
    edges = list(np.maximum.accumulate(edges))
    a_scale = 1.0 / (6.0 * np.pi * eta * max(ai, aj))
    coefA, coefB = [None] * 3, [None] * 3
    deg_out = deg
    for seg in (2, 1, 0):      # reverse: degenerate segs copy their right
        lo, hi = edges[seg], edges[seg + 1]
        if hi <= lo * (1 + 1e-8):
            # zero-width (equal radii): constant = next segment's left edge
            # (chosen only for r below the clamp radius)
            coefA[seg] = np.asarray([cheb.chebval(-1.0, coefA[seg + 1])])
            coefB[seg] = np.asarray([cheb.chebval(-1.0, coefB[seg + 1])])
            continue
        # initial degree tracks the segment's screened length (the
        # Gaussian-decay bandwidth); cubic boxes land at the default
        dcur = max(deg, int(10 + 7.5 * xi * (hi - lo)))
        dscur = 2 * dcur
        prev_err = np.inf
        for _ in range(4):
            cA, cB = fit_seg(lo, hi, dcur, dscur)
            cA2, cB2 = fit_seg(lo, hi, dcur + 16, dscur + 32)
            xv = np.linspace(-1, 1, 257)
            err = max(np.abs(cheb.chebval(xv, cA) -
                             cheb.chebval(xv, cA2)).max(),
                      np.abs(cheb.chebval(xv, cB) -
                             cheb.chebval(xv, cB2)).max())
            # stop on convergence or plateau (short overlap segments are
            # S''-sample-noise limited at ~1e-5·scale: more degree only
            # fits noise)
            if err <= 3e-6 * a_scale or err > 0.5 * prev_err:
                break
            prev_err = err
            dcur, dscur = dcur + 16, dscur + 32
        coefA[seg] = cA
        coefB[seg] = cB
        deg_out = max(deg_out, len(cA) - 1)
    # pad all segments to the common escalated degree
    coefA = [np.pad(ca, (0, deg_out + 1 - len(ca))) for ca in coefA]
    coefB = [np.pad(cb, (0, deg_out + 1 - len(cb))) for cb in coefB]
    return (np.asarray(edges), np.stack(coefA), np.stack(coefB))


def wave_weights(kvecs, a, eta, box, xi):
    """(wk_raw, wk) positively-split wave weights for k ≠ 0 (numpy).

    wk_raw = H(k)/(ηVk²) with H = (1 + k²/4ξ²)·exp(−k²/4ξ²); wk adds the
    monodisperse sinc²(ka) shape factor.
    """
    k2 = np.sum(np.asarray(kvecs) ** 2, axis=-1)
    k = np.sqrt(np.maximum(k2, 1e-300))
    V = box[0] * box[1] * box[2]
    ka = k * a
    sinc = np.sin(ka) / np.maximum(ka, 1e-300)
    H = (1 + k2 / (4 * xi**2)) * np.exp(-k2 / (4 * xi**2))
    wk_raw = np.where(k2 > 0, H / (eta * V * np.maximum(k2, 1e-300)), 0.0)
    return wk_raw, wk_raw * sinc**2


def make_params(box, a, eta=1.0, xi=None, tol=1e-6, rc=None) -> EwaldParams:
    """Choose ξ and build the wavevector lattice for a (Lx, Ly, Lz) box.

    The default ξ puts the real-space truncation error at ``tol`` for the
    minimum-image radius min(L)/2 (so the real sweep needs no image loop),
    and kmax puts the wave truncation at the same ``tol``.

    rc: balanced-splitting real-space cutoff (2a < rc ≤ min(L)/2): ξ = s/rc,
    pairs beyond rc excluded, and the real part swept over sorted tiles
    (:mod:`.ewald_cells`).  Explicit ``xi`` is incompatible with ``rc``.
    """
    box = tuple(float(b) for b in box)
    if len(box) != 3:
        raise ValueError(f"Ewald needs a 3-D box, got {box!r}")
    s = float(np.sqrt(-np.log(tol)))
    rcut = min(box) / 2.0
    if rc is not None:
        if xi is not None:
            raise ValueError("pass either rc= (balanced split) or xi=, not both")
        rc = float(rc)
        if not 2.0 * a < rc <= rcut:
            raise ValueError(
                f"ewald rc must satisfy 2a = {2 * a:.4g} < rc <= min(L)/2 = "
                f"{rcut:.4g}, got {rc:.4g}")
        xi = s / rc
    if xi is None:
        xi = s / rcut
    xi = float(xi)
    kmax = 2.0 * xi * s
    nmax = [int(np.ceil(kmax * L / (2 * np.pi))) for L in box]
    grids = np.meshgrid(*[np.arange(-n, n + 1) for n in nmax], indexing="ij")
    n_all = np.stack([g.ravel() for g in grids], axis=1)
    kvecs = 2 * np.pi * n_all / np.asarray(box)
    k2 = np.sum(kvecs**2, axis=1)
    keep = (k2 > 0) & (k2 <= kmax**2)
    kvecs = kvecs[keep]
    wk_raw, wk = wave_weights(kvecs, a, eta, box, xi)
    # the fit covers every distance the sweep can see: rc with cells, else
    # half the box diagonal (minimum image); a short-range (rc) fit starts
    # at a low degree, escalated until it validates as the long one does
    rmax = (rc if rc is not None
            else 0.5 * float(np.linalg.norm(box))) * 1.001
    deg0 = 12 if rc is not None else _CHEB_DEG
    b, cA, cB = _fit_pair_cheb(float(eta), xi, rmax, float(a), float(a),
                               deg=deg0)
    return EwaldParams(box=box, a=float(a), eta=float(eta), xi=xi,
                       kvecs=kvecs.astype(np.float64),
                       wk=wk.astype(np.float64),
                       wk_raw=wk_raw.astype(np.float64),
                       cheb_bounds=b, cheb_A=cA, cheb_B=cB, rc=rc,
                       nvecs=n_all[keep].astype(np.int32))


class PolyTables(NamedTuple):
    """Species-pair Chebyshev fits for the float32 polydisperse path.

    The float32 closed forms cancel as badly with radii as without, so each
    unique unordered (aᵢ, aⱼ) radius pair gets its own host-fitted
    piecewise Chebyshev; blobs carry a species index and ``pair_map``
    assigns each (sᵢ, sⱼ) its fit, applied by masked Clenshaw sweeps.
    """

    sidx: np.ndarray       # (N,) int32 species index per blob
    n_species: int
    pair_map: np.ndarray   # (S, S) int32 → pair-fit index (symmetric)
    bounds: np.ndarray     # (P, 4)
    coefA: np.ndarray      # (P, 3, D+1)
    coefB: np.ndarray


def make_poly_tables(params: EwaldParams, radii) -> PolyTables:
    """Per-species-pair Chebyshev fits for per-blob radii (host float64;
    a tensor is read back to the host)."""
    if torch.is_tensor(radii):
        radii = radii.detach().cpu().numpy()
    rad = np.asarray(radii, np.float64)
    uniq, sidx = np.unique(rad, return_inverse=True)
    S = len(uniq)
    rmax = 0.5 * float(np.linalg.norm(params.box)) * 1.001
    pair_map = np.zeros((S, S), np.int32)
    bounds, coefA, coefB = [], [], []
    p = 0
    for i in range(S):
        for j in range(i, S):
            b, cA, cB = _fit_pair_cheb(params.eta, params.xi, rmax,
                                       float(uniq[i]), float(uniq[j]))
            bounds.append(b)
            coefA.append(cA)
            coefB.append(cB)
            pair_map[i, j] = pair_map[j, i] = p
            p += 1
    # degree escalation is per pair: pad to the common maximum
    dmax = max(c.shape[1] for c in coefA)
    coefA = [np.pad(c, ((0, 0), (0, dmax - c.shape[1]))) for c in coefA]
    coefB = [np.pad(c, ((0, 0), (0, dmax - c.shape[1]))) for c in coefB]
    return PolyTables(sidx=sidx.astype(np.int32), n_species=S,
                      pair_map=pair_map, bounds=np.stack(bounds),
                      coefA=np.stack(coefA), coefB=np.stack(coefB))


# ------------------------------------------------------------- real space
def _cheb_ab(rr, bounds, coefA, coefB):
    """Evaluate the piecewise fit elementwise in ``rr``'s dtype: the segment
    is chosen once per element, the coefficients are read per Clenshaw step
    by that index, and the two recurrences are the JAX package's
    (``c_j + 2x·b₁ − b₂``).  Below ``bounds[0]`` the fit is held constant
    (x clipped to −1).  The tables may be numpy arrays or tensors on
    ``rr``'s device (:func:`cheb_tables`)."""
    dtype, dev = rr.dtype, rr.device
    b = torch.as_tensor(bounds, dtype=dtype, device=dev)
    seg = (rr >= b[1]).long() + (rr >= b[2]).long()
    lo, hi = b[:3][seg], b[1:][seg]
    x = torch.clamp(2.0 * (rr - lo) / (hi - lo) - 1.0, -1.0, 1.0)
    two_x = 2.0 * x

    def clenshaw(coef):
        c = torch.as_tensor(coef, dtype=dtype, device=dev)
        bk1 = torch.zeros_like(x)
        bk2 = torch.zeros_like(x)
        for j in range(c.shape[1] - 1, 0, -1):
            bk1, bk2 = c[:, j][seg] + two_x * bk1 - bk2, bk1
        return c[:, 0][seg] + x * bk1 - bk2

    return clenshaw(coefA), clenshaw(coefB)


def cheb_tables(params: EwaldParams, dtype, dev):
    """params' monodisperse fit (bounds (4,), coefA, coefB (3, D+1)) as
    tensors on ``dev``, kept per operator (:func:`per_operator`)."""
    return per_operator(params, ("cheb tables", dtype, dev), lambda: tuple(
        torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=dev)
        for v in (params.cheb_bounds, params.cheb_A, params.cheb_B)))


def poly_device_tables(pt: PolyTables, dtype, dev):
    """(sidx (N,), pair_map (S, S), bounds (P, 4), coefA, coefB (P, 3,
    D+1)) of ``pt`` as tensors on ``dev``, kept per table set."""
    def make():
        return (torch.as_tensor(pt.sidx.astype(np.int64), device=dev),
                torch.as_tensor(pt.pair_map.astype(np.int64), device=dev),
                *(torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                  device=dev)
                  for v in (pt.bounds, pt.coefA, pt.coefB)))
    return per_operator(pt, ("poly tables", dtype, dev), make)


def pair_scalars(rr, params: EwaldParams, cheb, ai=None, aj=None, si=None,
                 sj=None, pt: PolyTables = None):
    """(A, B) at distances ``rr``, as the JAX package's sweeps pick them:
    with ``pt`` (float32 polydisperse) the species-pair fits selected per
    pair by the species indices si, sj; with radii ai, aj (float64
    polydisperse) the shifted closed forms; else the monodisperse fit
    (``cheb``) or closed forms.  The index and radius arguments broadcast
    against ``rr``."""
    if pt is not None:
        # each species pair's fit on its own pairs only (the JAX package
        # evaluates every fit on every pair and selects: the same values)
        _, pmap, bnd, cA, cB = poly_device_tables(pt, rr.dtype, rr.device)
        pair = torch.broadcast_to(pmap[si, sj], rr.shape)
        A = torch.zeros_like(rr)
        B = torch.zeros_like(rr)
        for p in range(bnd.shape[0]):
            m = (pair == p).nonzero(as_tuple=True)
            A[m], B[m] = _cheb_ab(rr[m], bnd[p], cA[p], cB[p])
        return A, B
    if ai is not None:
        return real_space_ab(rr, params.a, params.xi, params.eta, ai=ai,
                             aj=aj)
    if cheb:
        return _cheb_ab(rr, *cheb_tables(params, rr.dtype, rr.device))
    return real_space_ab(rr, params.a, params.xi, params.eta)


def _wrap3(d, box):
    """3-D minimum image of displacements d (..., 3); halves round to
    even, as ``jnp.round`` does."""
    L = torch.as_tensor(box, dtype=d.dtype, device=d.device)
    return d - L * torch.round(d / L)


def _sweep(r_rows, row_ids, r_cols, col_ids, Fk, params: EwaldParams,
           row_tile, scalars):
    """Σ_j [A·I + B·r̂r̂]·F_j over row tiles of ``row_tile`` rows, 3-D
    minimum image, the self pair (equal ids) and, with ``params.rc``, the
    pairs beyond rc set to an exact 0.  scalars(rr, rows) → (A, B) for the
    row slice ``rows``.  Fk (k, N_c, 3) → (k, N_r, 3)."""
    outs = []
    for s in range(0, r_rows.shape[0], row_tile):
        ri, rid = r_rows[s:s + row_tile], row_ids[s:s + row_tile]
        d = _wrap3(ri[:, None, :] - r_cols[None, :, :], params.box)
        r2 = torch.sum(d * d, dim=-1)
        self_mask = rid[:, None] == col_ids[None, :]
        rr = torch.sqrt(torch.where(self_mask, torch.ones_like(r2),
                                    torch.clamp(r2, min=1e-24)))
        A, B = scalars(rr, slice(s, s + row_tile))
        # balanced split: pairs beyond rc are excluded by contract (the
        # tile sweep's pair set)
        drop = self_mask if params.rc is None else self_mask | ~(
            rr <= params.rc)
        zero = torch.zeros_like(A)
        A = torch.where(drop, zero, A)
        B = torch.where(drop, zero, B)
        e = d / rr[..., None]
        eF = torch.einsum("tnx,knx->ktn", e, Fk)
        outs.append(torch.einsum("tn,knx->ktx", A, Fk)
                    + torch.einsum("ktn,tn,tnx->ktx", eF, B, e))
    return torch.cat(outs, dim=1)


def real_space_block(r_rows, row_ids, r_cols, col_ids, F_cols,
                     params: EwaldParams, row_tile=512, cheb=None):
    """Screened real-space pair terms of a (rows × column-block) slab,
    Σ_j [A·I + B·r̂r̂]·F_j with 3-D minimum image; global ids mask the self
    pair, and with ``params.rc`` pairs beyond rc are excluded.  F_cols
    (N_c, 3) or (k, N_c, 3) sharing the pair fields.  Monodisperse.

    cheb: evaluate A, B from the Chebyshev fit (True) or the closed forms
    (False); None → the fit in float32, the closed forms in float64.
    ``cheb=True`` in float64 is the float64 Clenshaw that the CUDA sweep is
    held against.
    """
    multi = F_cols.dim() == 3
    Fk = F_cols if multi else F_cols[None]
    dtype = r_rows.dtype
    if cheb is None:
        cheb = dtype == torch.float32
    if not cheb and dtype == torch.float32:
        raise ValueError("the closed-form Ewald scalars cancel "
                         "catastrophically in float32: use the Chebyshev "
                         "fit (cheb=True) or float64")
    U = _sweep(r_rows, row_ids, r_cols, col_ids, Fk, params, row_tile,
               lambda rr, rows: pair_scalars(rr, params, cheb))
    return U if multi else U[0]


def real_space_apply(F, r, params: EwaldParams, row_tile=512, radii=None,
                     poly_tables: PolyTables = None, cheb=None):
    """Streamed U_real = Σ_{j≠i} [A·I + B·r̂r̂]·F_j with 3-D minimum image,
    (N, 3) or (k, N, 3) forces.  Classic split: no cutoff mask, A, B ≤ tol
    beyond min(L)/2 by the choice of ξ; balanced split (``params.rc``):
    pairs beyond rc excluded, the tile sweep's pair set.  The plain version
    of the CUDA sweep.

    radii: (N,) per-blob radii (polydisperse, exact): float32 evaluates the
    species-pair fits of ``poly_tables`` (built here from the radii when
    not given), float64 the shifted closed forms.
    """
    ids = torch.arange(r.shape[0], device=r.device)
    if radii is None:
        return real_space_block(r, ids, r, ids, F, params, row_tile=row_tile,
                                cheb=cheb)
    multi = F.dim() == 3
    Fk = F if multi else F[None]
    rad = torch.as_tensor(radii, dtype=r.dtype, device=r.device)
    if r.dtype == torch.float32:
        pt = (poly_tables if poly_tables is not None
              else make_poly_tables(params, rad))
        sidx = poly_device_tables(pt, r.dtype, r.device)[0]

        def scalars(rr, rows):
            return pair_scalars(rr, params, True, si=sidx[rows, None],
                                sj=sidx[None, :], pt=pt)
    else:
        def scalars(rr, rows):
            return pair_scalars(rr, params, False, ai=rad[rows, None],
                                aj=rad[None, :])
    U = _sweep(r, ids, r, ids, Fk, params, row_tile, scalars)
    return U if multi else U[0]


# ------------------------------------------------------------- wave space
def wave_space_apply(F, r, params: EwaldParams, radii=None, group=None):
    """U_wave = Σ_{k≠0} w(k)(I − k̂k̂) e^{ik·(r_i−r_j)} F_j as matmuls
    against the (N, K) phase matrices C/S = cos/sin(r·kᵀ).  The k-sum
    includes the i = j term (the wave part of the self mobility).  Above a
    memory threshold the k-sum runs in K-chunks so the phase matrices never
    exist whole.  radii: per-blob sinc(|k|aᵢ) weights on the spread and
    the readback (the weights then carry no sinc²).

    group: None (one device), or a process group: F, r and radii are this
    rank's blobs, the (K, 3) k-space moments are summed over the group
    (one all-reduce each of their real and imaginary parts) and the
    phases stay local."""
    K = len(params.kvecs)
    if K * r.shape[0] > 2**27 and K > 4096:
        return _wave_space_chunked(F, r, params, radii=radii, group=group)
    return _wave_space_dense(F, r, params, radii=radii, group=group)


def _nmax3(nvecs):
    return tuple(int(m) for m in np.abs(nvecs).max(axis=0))


def _phase_tables(r, box, nmax3):
    """Per-dimension phase tables cos/sin(xᵢ·2πm/L) for m ∈ [−nmax, nmax].

    Lattice wavevectors factorize, e^{ik·r} = Ex(n₁)·Ey(n₂)·Ez(n₃), so the
    (N, K) phase matrices need only N·ΣW base transcendentals plus
    gathers and complex multiplies instead of N·K."""
    out = []
    for d2 in range(3):
        m = torch.arange(-nmax3[d2], nmax3[d2] + 1, dtype=r.dtype,
                         device=r.device)
        th = r[:, d2, None] * (2.0 * np.pi / box[d2]) * m[None, :]
        out.append((torch.cos(th), torch.sin(th)))
    return out


def _phases_from_tables(tables, nvecs, nmax3):
    """(N, K) C, S = Re/Im of Ex·Ey·Ez, the per-axis tables gathered at the
    wavevectors' lattice indices (``index_select``; the JAX package uses
    one-hot matmuls here because gathers are slow on a TPU)."""
    dev = tables[0][0].device
    g = []
    for d2, (c, s) in enumerate(tables):
        idx = torch.as_tensor(nvecs[:, d2].astype(np.int64) + nmax3[d2],
                              device=dev)
        g.append((c.index_select(1, idx), s.index_select(1, idx)))
    (cxg, sxg), (cyg, syg), (czg, szg) = g
    cxy = cxg * cyg - sxg * syg
    sxy = cxg * syg + sxg * cyg
    return cxy * czg - sxy * szg, cxy * szg + sxy * czg


def _wave_space_chunked(F, r, params: EwaldParams, radii=None, kc=4096,
                        group=None):
    """The k-sum in chunks of ``kc`` wavevectors, sharing the per-axis
    phase tables."""
    K = len(params.kvecs)
    tables = nmax3 = None
    if params.nvecs is not None:
        nmax3 = _nmax3(params.nvecs)
        tables = _phase_tables(r, params.box, nmax3)
    U = torch.zeros_like(F)
    for k0 in range(0, K, kc):
        sl = slice(k0, k0 + kc)
        sub = params._replace(kvecs=params.kvecs[sl], wk=params.wk[sl],
                              wk_raw=params.wk_raw[sl], nvecs=None)
        phases = (_phases_from_tables(tables, params.nvecs[sl], nmax3)
                  if tables is not None else None)
        U = U + _wave_space_dense(F, r, sub, radii=radii, phases=phases,
                                  keep=False, group=group)
    return U


def _wave_tables(params: EwaldParams, dtype, dev):
    """(K, 3) wavevectors, (K,) weights with and without the sinc², and
    (K, 3) unit wavevectors."""
    kv = torch.as_tensor(params.kvecs, dtype=dtype, device=dev)
    wk = torch.as_tensor(params.wk, dtype=dtype, device=dev)
    wk_raw = torch.as_tensor(params.wk_raw, dtype=dtype, device=dev)
    return kv, wk, wk_raw, kv / torch.linalg.norm(kv, dim=1, keepdim=True)


def _wave_space_dense(F, r, params: EwaldParams, radii=None, phases=None,
                      keep=True, group=None):
    """keep: the wave tables are kept per operator (:func:`per_operator`);
    the chunked sum's per-chunk operators are temporaries, not kept.
    group: the moments' all-reduce (:func:`wave_space_apply`)."""
    dtype, dev = r.dtype, r.device
    if keep:
        kv, wk, wk_raw, khat = per_operator(
            params, ("wave tables", dtype, dev),
            lambda: _wave_tables(params, dtype, dev))
    else:
        kv, wk, wk_raw, khat = _wave_tables(params, dtype, dev)
    if phases is None and params.nvecs is not None and len(kv) >= 1024:
        nmax3 = _nmax3(params.nvecs)
        phases = _phases_from_tables(_phase_tables(r, params.box, nmax3),
                                     params.nvecs, nmax3)
    if phases is not None:
        C, S = phases
    else:
        theta = r @ kv.T                                           # (N, K)
        C = torch.cos(theta)
        S = torch.sin(theta)
    if radii is not None:
        # per-blob sinc(|k|aᵢ) on the spread and the readback
        wk = wk_raw
        ka = torch.linalg.norm(kv, dim=1)[None, :] * torch.as_tensor(
            radii, dtype=dtype, device=dev)[:, None]               # (N, K)
        sinc = torch.sin(ka) / ka
        C = C * sinc
        S = S * sinc

    def project(X):
        # transverse projection + weight, X (..., K, 3)
        return wk[:, None] * (X - khat * torch.sum(khat * X, dim=-1,
                                                   keepdim=True))

    if F.dim() == 3:                           # (k, N, 3): shared phases
        ReF = psum(torch.einsum("nK,qnx->qKx", C, F), group)
        ImF = psum(-torch.einsum("nK,qnx->qKx", S, F), group)
        ReP, ImP = project(ReF), project(ImF)
        return (torch.einsum("nK,qKx->qnx", C, ReP)
                - torch.einsum("nK,qKx->qnx", S, ImP))
    ReF = psum(C.T @ F, group)                 # (K, 3) = Re Σ e^{-ikr} F
    ImF = psum(-(S.T @ F), group)
    ReP, ImP = project(ReF), project(ImF)
    return C @ ReP - S @ ImP


# --------------------------------------------------------------- operator
def _operator(Fs, r, params: EwaldParams, row_tile, radii, poly_tables,
              max_nbr, grid, cheb, use_kernel):
    """M_per·Fs for (N, 3) or (k, N, 3) forces: the real part (all pairs,
    or the tile sweep under ``params.rc``, float32 through K4 tiles with
    ``use_kernel``), the self term and the wave part (dense, or on
    ``grid``)."""
    if grid is not None and (radii is None) != (grid.sidx is None):
        raise ValueError("gridded wave part: build the grid with the "
                         "same radii= as the apply (polydisperse needs "
                         "species sinc tables)")
    if radii is not None:
        radii = torch.as_tensor(radii, dtype=r.dtype, device=r.device)
    if params.rc is not None:
        from rigid_body_light_tpu_torch.ops import ewald_cells

        with profiling.span("ewald_cells"):
            U = ewald_cells.real_space_apply_cells(
                Fs, r, params, max_nbr=max_nbr, radii=radii,
                poly_tables=poly_tables, use_kernel=use_kernel)
    else:
        U = real_space_apply(Fs, r, params, row_tile=row_tile, radii=radii,
                             poly_tables=poly_tables, cheb=cheb)
    a_self = params.a if radii is None else radii[:, None]
    U = U + self_coeff(a_self, params.xi, params.eta) * Fs
    if grid is not None:
        from rigid_body_light_tpu_torch.ops import ewald_pme

        with profiling.span("ewald_pme"):
            return U + ewald_pme.wave_space_apply_grid(Fs, r, params, grid)
    return U + wave_space_apply(Fs, r, params, radii=radii)


def mobility_apply(F, r, params: EwaldParams, row_tile=512, radii=None,
                   poly_tables: PolyTables = None, max_nbr=None, grid=None,
                   cheb=None, use_kernel=True):
    """Full periodic RPY product U = M_per(r)·F, SPD by construction;
    (N, 3) → (N, 3) in ``r``'s dtype.

    radii: (N,) per-blob radii (polydisperse; float32 through
    ``poly_tables``, built from the radii when not given).  With
    ``params.rc`` the real part is the tile sweep (:mod:`.ewald_cells`,
    ``max_nbr`` its neighbor-list width; float32 through the kernel K4
    tiles unless ``use_kernel`` is False); ``grid``: the gridded wave part
    (:mod:`.ewald_pme`), built with the same ``radii=`` as the apply.
    """
    r = r.reshape(-1, 3)
    F = F.to(r.dtype).reshape(-1, 3)
    return _operator(F, r, params, row_tile, radii, poly_tables, max_nbr,
                     grid, cheb, use_kernel)


def mobility_apply_multi(Fs, r, params: EwaldParams, row_tile=512,
                         radii=None, poly_tables: PolyTables = None,
                         max_nbr=None, grid=None, cheb=None,
                         use_kernel=True):
    """Multi-RHS periodic product (k, N, 3) → (k, N, 3) sharing the pair
    fields: the real-space (A, B) sweep and the wave-space phase matrices
    (or the grid's spread weights) are computed once for all RHS."""
    r = r.reshape(-1, 3)
    return _operator(Fs.to(r.dtype), r, params, row_tile, radii,
                     poly_tables, max_nbr, grid, cheb, use_kernel)


def mobility_matrix(r, params: EwaldParams, radii=None):
    """Dense (3N, 3N) periodic mobility, column c the product with the
    c-th unit force: tests and preconditioner blocks only."""
    r = r.reshape(-1, 3)
    n = r.shape[0]
    eye = torch.eye(3 * n, dtype=r.dtype, device=r.device)
    cols = mobility_apply_multi(eye.reshape(3 * n, n, 3), r, params,
                                radii=radii)
    return cols.reshape(3 * n, 3 * n).T


# ------------------------------------------------------------ distributed
def ring_slab(Fs, r_rows, row0, r_cols, col0, params: EwaldParams,
              row_tile=512, use_kernel=False, diagonal=False):
    """One slab of the classic split's ring: Σ_j [A·I + B·r̂r̂]·F_j for the
    rows ``r_rows`` (global ids row0, …) against the columns ``r_cols``
    (col0, …), the pair of equal ids left out.  The plain
    :func:`real_space_block`, or with ``use_kernel`` (float32, Fs (k, N_c,
    3)) K4's symmetric sweep for the ``diagonal`` block (the rank's own
    rows against themselves) and K4's slab form for the others
    (:mod:`.ewald_cuda`)."""
    if use_kernel:
        from rigid_body_light_tpu_torch.ops import ewald_cuda

        if diagonal:
            return ewald_cuda.real_pair_sum(Fs, r_rows, params)
        return ewald_cuda.real_pair_sum_slab(Fs, r_rows, row0, r_cols, col0,
                                             params)
    dev = r_rows.device
    return real_space_block(
        r_rows, row0 + torch.arange(r_rows.shape[0], device=dev), r_cols,
        col0 + torch.arange(r_cols.shape[0], device=dev), Fs, params,
        row_tile=row_tile)


def _ring_real(Fs, r_l, params: EwaldParams, group, row_tile, use_kernel):
    """The classic split's real part of this rank's rows on a ring of
    slabs (:func:`ring_slab`): over D steps the (positions, forces) blocks
    rotate around the group, the next block's send and receive posted
    before the current slab's sweep, step s sweeping the block from rank
    (idx − s) mod D and the steps summed in order, as the JAX package's
    ring; step 0 is the diagonal block."""
    d, idx = collectives.size(group), collectives.rank(group)
    n_l = r_l.shape[0]
    acc = None
    blk = [r_l, Fs]
    for s in range(d):
        wait = None
        if s < d - 1:
            nxt, wait = collectives.ring_shift(blk, group)
        part = ring_slab(blk[1], r_l, idx * n_l, blk[0],
                         ((idx - s) % d) * n_l, params, row_tile,
                         use_kernel, diagonal=s == 0)
        acc = part if acc is None else acc + part
        if wait is not None:
            wait()
            blk = nxt
    return acc


def mobility_apply_local(F_l, r_l, params: EwaldParams, group, row_tile=512,
                         max_nbr=None, radii_l=None,
                         poly_tables: PolyTables = None, use_kernel=False):
    """The periodic RPY product of this rank's rows over a process group
    (the JAX package's ``mobility_apply_local``): F_l (N_l, 3) or (k, N_l,
    3) and r_l (N_l, 3) this rank's blobs, every rank holding as many, in
    rank order; ``group`` None is one device.

    The classic split's real part rides the ring of slabs
    (:func:`_ring_real`; ``use_kernel``, float32 monodisperse: K4 and its
    slab form, the layout of :func:`.ewald_cuda.mobility_apply_multi`);
    the balanced split's (``params.rc``) is this rank's slice of the tile
    sweep (:func:`.ewald_cells.real_space_apply_cells` with the group,
    ``max_nbr`` its list width; ``use_kernel``, float32: K4 tiles on the
    slice).  The wave part's k-space moments are
    summed over the group (:func:`wave_space_apply`), the self term is
    per blob.  At one rank it is the single-device operator, bit for bit.

    radii_l: this rank's per-blob radii (balanced split only, as in the
    JAX package); float32 needs ``poly_tables`` built from the global
    radii.
    """
    r_l = r_l.reshape(-1, 3)
    multi = F_l.dim() == 3
    Fs = F_l.to(r_l.dtype)
    Fs = Fs if multi else Fs.reshape(-1, 3)
    if radii_l is not None and params.rc is None:
        raise NotImplementedError(
            "distributed polydisperse Ewald needs balanced splitting "
            "(ewald_rc > 0) — the classic-split ring sweep is monodisperse")
    ring_kernel = use_kernel and params.rc is None
    if ring_kernel and not multi:
        Fs = Fs[None]
    if radii_l is not None:
        radii_l = torch.as_tensor(radii_l, dtype=r_l.dtype,
                                  device=r_l.device)
    if params.rc is not None:
        from rigid_body_light_tpu_torch.ops import ewald_cells

        with profiling.span("ewald_cells"):
            U = ewald_cells.real_space_apply_cells(
                Fs, r_l, params, max_nbr=max_nbr, radii=radii_l,
                poly_tables=poly_tables, group=group, use_kernel=use_kernel)
    else:
        U = _ring_real(Fs, r_l, params, group, row_tile, use_kernel)
    a_self = params.a if radii_l is None else radii_l[:, None]
    U = U + self_coeff(a_self, params.xi, params.eta) * Fs
    U = U + wave_space_apply(Fs, r_l, params, radii=radii_l, group=group)
    return U[0] if ring_kernel and not multi else U
