"""Trajectory analysis: the standard observables of confined-suspension BD
— the port of ``rigid_body_light_tpu/analysis.py``.

Post-processing utilities over (T, B, ...) trajectory arrays (as returned by
:func:`rigid_body_light_tpu_torch.runtime.read_trajectory`,
:func:`rigid_body_light_tpu_torch.dynamics.run_bd` (``.cpu().numpy()``) or
``RigidBody.run``).  numpy-based — analysis is host-side, not a device hot
path.
"""

from __future__ import annotations

import numpy as np
import torch

from rigid_body_light_tpu_torch.ops import quaternion as quat


def msd(X, max_lag=None):
    """Time-averaged mean-square displacement per lag.

    X: (T, B, 3).  Returns (lags (L,), msd (L, 3)) with per-axis MSD
    averaged over bodies and time origins.
    """
    X = np.asarray(X)
    T = X.shape[0]
    if max_lag is None:
        max_lag = T // 2
    max_lag = min(max_lag, T - 1)
    lags = np.arange(1, max_lag + 1)
    out = np.empty((max_lag, 3))
    for i, lag in enumerate(lags):
        d = X[lag:] - X[:-lag]
        out[i] = np.mean(d * d, axis=(0, 1))
    return lags, out


def orientation_correlation(Q, max_lag=None):
    """⟨cos θ(τ)⟩ where θ is the FULL rotation angle between orientations τ
    apart: C(τ) = ⟨2·(q(t)·q(t+τ))² − 1⟩ (quaternion double-cover safe).

    Note: for free rotational diffusion this decays as (3·e^{−2·D_r·τ} − 1)/2
    (trace of the l=1 Wigner matrix), limiting to −1/2 at uniform
    orientations — NOT a pure exponential.  For the textbook
    ⟨u(τ)·u(0)⟩ = e^{−2·D_r·τ} observable use :func:`axis_correlation`.

    Q: (T, B, 4).  Returns (lags, C (L,)).
    """
    Q = np.asarray(Q)
    T = Q.shape[0]
    if max_lag is None:
        max_lag = T // 2
    max_lag = min(max_lag, T - 1)
    lags = np.arange(1, max_lag + 1)
    out = np.empty(max_lag)
    for i, lag in enumerate(lags):
        dot = np.sum(Q[lag:] * Q[:-lag], axis=-1)
        out[i] = np.mean(2.0 * dot * dot - 1.0)
    return lags, out


def axis_correlation(Q, axis=(0.0, 0.0, 1.0), max_lag=None):
    """Body-axis autocorrelation ⟨u(t+τ)·u(t)⟩ with u = R(q)·axis.

    Decays as exp(−2·D_r·τ) for free rotational diffusion — the standard
    rotational-diffusion observable.  Q: (T, B, 4).  Returns (lags, C).
    """
    Q = np.asarray(Q)
    axis = np.asarray(axis, dtype=np.float64)
    T, B, _ = Q.shape
    R = quat.to_rotation_matrix(torch.as_tensor(Q.reshape(-1, 4))).numpy()
    u = (R @ axis).reshape(T, B, 3)
    if max_lag is None:
        max_lag = T // 2
    max_lag = min(max_lag, T - 1)
    lags = np.arange(1, max_lag + 1)
    out = np.empty(max_lag)
    for i, lag in enumerate(lags):
        out[i] = np.mean(np.sum(u[lag:] * u[:-lag], axis=-1))
    return lags, out


def height_histogram(X, bins=50, z_range=None):
    """Number density vs height z — equilibrium profile near the wall.

    Returns (bin_centers, density) normalized to ∫ρ dz = 1.
    """
    z = np.asarray(X)[..., 2].ravel()
    if z_range is None:
        z_range = (z.min(), z.max())
    hist, edges = np.histogram(z, bins=bins, range=z_range, density=True)
    return 0.5 * (edges[:-1] + edges[1:]), hist


def pair_distribution(X, r_max, bins=50, box=None):
    """Radial pair distribution g(r) of body centers, free-space normalized.

    X: (T, B, 3).  box: optional (Lx, Ly) — measure pair separations through
    the minimum-image wrap (trajectories from periodic runs keep unwrapped
    coordinates, so pass the run's ``SimulationConfig.box`` here).
    Returns (r_centers, g).
    """
    X = np.asarray(X)
    T, B, _ = X.shape
    counts = np.zeros(bins)
    edges = np.linspace(0.0, r_max, bins + 1)
    iu = np.triu_indices(B, 1)
    for t in range(T):
        dv = X[t][:, None] - X[t][None, :]
        if box is not None:
            for c in range(2):
                dv[..., c] -= box[c] * np.round(dv[..., c] / box[c])
        d = np.linalg.norm(dv, axis=-1)
        h, _ = np.histogram(d[iu], bins=edges)
        counts += h
    centers = 0.5 * (edges[:-1] + edges[1:])
    shell_vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    n_pairs = T * B * (B - 1) / 2
    # normalize by ideal-gas expectation in a sphere of radius r_max
    v_total = 4.0 / 3.0 * np.pi * r_max**3
    g = counts / n_pairs / (shell_vol / v_total)
    return centers, g


def diffusion_coefficient(X, dt, axes=(0, 1, 2), skip_lags=1, max_lag=None):
    """Fit D from MSD(τ) = 2·D·τ per axis (averaged over ``axes``).

    Returns the fitted D (scalar).  dt is the frame spacing in time units.
    """
    lags, m = msd(X, max_lag=max_lag)
    t = lags[skip_lags:] * dt
    y = np.mean(m[skip_lags:][:, list(axes)], axis=1)
    # least-squares through the origin
    return float(np.sum(t * y) / np.sum(t * t) / 2.0)
