"""Body state — the port of ``rigid_body_light_tpu/state.py``.

``(X, Q)`` is the complete configuration; everything else (K, the
preconditioner, the noise) is derived or passed explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BodyState(NamedTuple):
    """State of B rigid bodies.

    X: (B, 3) body tracking points (centroid of the blob reference config).
    Q: (B, 4) unit quaternions, scalar-first (w, x, y, z).
    """

    X: torch.Tensor
    Q: torch.Tensor

    @property
    def n_bodies(self) -> int:
        return self.X.shape[0]

    @property
    def dtype(self):
        return self.X.dtype


def make_state(X, Q, dtype=torch.float32, device=None) -> BodyState:
    """Build a normalized BodyState from (B,3)/(B,4) (or flat) arrays.

    Quaternions are normalized on set, as the JAX ``make_state`` does.
    """
    X = torch.as_tensor(X, dtype=dtype, device=device).reshape(-1, 3)
    Q = torch.as_tensor(Q, dtype=dtype, device=device).reshape(-1, 4)
    Q = Q / torch.linalg.norm(Q, dim=-1, keepdim=True)
    return BodyState(X=X, Q=Q)
