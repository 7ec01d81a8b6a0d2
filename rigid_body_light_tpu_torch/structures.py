"""Blob-geometry structure files — the port of ``structures.py``.

Reads the icosphere shells that ship with the JAX package
(``rigid_body_light_tpu/structures/shell_N_*.csv``) by file path: the
files are shared, not copied, and the JAX package is never imported (its
``__init__`` imports ``jax``).  Format: two comment lines, the second
``# <sep>,<N>,<Rg>,<Rh>``, then N whitespace-separated ``x y z`` rows.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

_STRUCT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "rigid_body_light_tpu", "structures")

SHELLS = (12, 42, 162, 642, 2562)


def structure_path(name: str) -> str:
    """Path to a shipped structure file, e.g. ``structure_path('shell_N_12')``."""
    if not name.endswith(".csv"):
        name = name + ".csv"
    return os.path.join(_STRUCT_DIR, name)


def load_structure(file_name: str) -> Tuple[Dict, np.ndarray]:
    """Parse a structure CSV → (params, (N, 3) reference config)."""
    if os.sep not in file_name and not os.path.exists(file_name):
        file_name = structure_path(file_name)
    with open(file_name, "r") as f:
        _ = f.readline()
        params_line = f.readline().strip().split(",")
        sep = float(params_line[0].split(" ")[1])
        n = int(params_line[1])
        rg = float(params_line[2])
        rh = float(params_line[3])
        cfg = np.loadtxt(f, delimiter=" ")
    params = {"sep": sep, "N": n, "Rg": rg, "Rh": rh}
    if cfg.shape != (n, 3):
        raise RuntimeError(
            f"Structure file {file_name} declares N={n} blobs but has shape "
            f"{cfg.shape}")
    return params, cfg


def shell(n_blobs: int) -> Tuple[Dict, np.ndarray]:
    """Load one of the shipped icosphere shells by blob count."""
    if n_blobs not in SHELLS:
        raise ValueError(f"No shipped shell with {n_blobs} blobs; have {SHELLS}")
    return load_structure(structure_path(f"shell_N_{n_blobs}"))
