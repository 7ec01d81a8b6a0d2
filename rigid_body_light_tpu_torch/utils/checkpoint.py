"""Checkpoint reader — the port of ``load_checkpoint`` from
``rigid_body_light_tpu/utils/checkpoint.py`` (format versions 1 and 2).

A checkpoint is one npz: (X, Q) — or (X_s, Q_s) per species of a mixture
with ``n_species`` — plus ``step``, a JSON ``metadata`` string and, where
the writer had one, the raw data of a ``jax.random`` key.  The port never
makes a JAX key: it returns that data as a numpy uint32 array, for a
caller that seeds its own generator from it or hands it back to the JAX
package.  The writer comes with ROADMAP.md queue 1, item 14.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from rigid_body_light_tpu_torch.state import BodyState, resolve_device

# the highest format this reader takes (2: the mixture layout)
MAX_READ_VERSION = 2


def load_checkpoint(path: str, dtype=torch.float32, device="cuda"
                    ) -> Tuple[object, Optional[np.ndarray], int, dict]:
    """Read a checkpoint → (state, key_data | None, step, metadata).

    ``state`` is a :class:`BodyState` on ``device`` (the card unless the
    caller names another), or a tuple of them for a mixture checkpoint.
    ``key_data`` is the stored key's raw uint32 data, or None.
    """
    device = resolve_device(device)

    def state_of(X, Q):
        return BodyState(X=torch.as_tensor(X, dtype=dtype, device=device),
                         Q=torch.as_tensor(Q, dtype=dtype, device=device))

    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > MAX_READ_VERSION:
            raise RuntimeError(f"Checkpoint {path} has format v{version}; "
                               f"this build reads ≤ v{MAX_READ_VERSION}")
        if "n_species" in z.files:
            state = tuple(state_of(z[f"X_{s}"], z[f"Q_{s}"])
                          for s in range(int(z["n_species"])))
        else:
            state = state_of(z["X"], z["Q"])
        step = int(z["step"])
        metadata = json.loads(str(z["metadata"]))
        key_data = (np.asarray(z["key_data"], np.uint32)
                    if "key_data" in z.files else None)
    return state, key_data, step, metadata
