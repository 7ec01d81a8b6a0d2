"""Checkpoint / resume — the port of
``rigid_body_light_tpu/utils/checkpoint.py`` (format versions 1 and 2).

A checkpoint is one npz: (X, Q) — or (X_s, Q_s) per species of a mixture
with ``n_species`` (format 2) — plus ``step`` and a JSON ``metadata``
string, written to a temporary file and renamed into place, as the JAX
package writes it.  Its random state differs by writer:

- the JAX package stores the raw data of its ``jax.random`` key
  (``key_data``, uint32);
- the port stores its ``torch.Generator``'s state (``torch_generator_state``,
  uint8, the bytes of ``Generator.get_state()``) and the generator's device
  type (``torch_generator_device``).

Each package's reader ignores the other's field.  :func:`load_checkpoint`
returns the random state it finds as ``rng``: the generator state (uint8)
where the port wrote one, else the key data (uint32), else None, and
:func:`restore_generator` turns it into a generator.  A JAX checkpoint
resumes with a generator seeded deterministically from its key data (the
key's uint32 words, little endian, read as one integer modulo 2⁶³): the
same file gives the same stream, which is not the JAX package's stream.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from rigid_body_light_tpu_torch.state import BodyState, resolve_device

FORMAT_VERSION = 1        # single-species layout (X/Q arrays)
FORMAT_VERSION_MULTI = 2  # mixture layout (X_s/Q_s arrays + n_species)
# the highest format this reader takes
MAX_READ_VERSION = 2


def save_checkpoint(path: str, state, generator: torch.Generator = None,
                    step: int = 0, metadata: Optional[dict] = None) -> None:
    """Write (X, Q, generator state, step, metadata) to ``path`` (npz,
    atomic rename).  ``state``: a :class:`BodyState`, or a sequence of them
    (one per species of a mixture, format 2)."""
    payload = {"step": np.asarray(step),
               "metadata": json.dumps(metadata or {})}
    if isinstance(state, BodyState):
        payload["format_version"] = FORMAT_VERSION
        payload["X"] = state.X.detach().cpu().numpy()
        payload["Q"] = state.Q.detach().cpu().numpy()
    else:
        payload["format_version"] = FORMAT_VERSION_MULTI
        payload["n_species"] = np.asarray(len(state))
        for s_idx, s in enumerate(state):
            payload[f"X_{s_idx}"] = s.X.detach().cpu().numpy()
            payload[f"Q_{s_idx}"] = s.Q.detach().cpu().numpy()
    if generator is not None:
        payload["torch_generator_state"] = generator.get_state().numpy()
        payload["torch_generator_device"] = generator.device.type
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, dtype=torch.float32, device="cuda"
                    ) -> Tuple[object, Optional[np.ndarray], int, dict]:
    """Read a checkpoint → (state, rng, step, metadata).

    ``state`` is a :class:`BodyState` on ``device`` (the card unless the
    caller names another), or a tuple of them for a mixture checkpoint.
    ``rng``: the port's generator state (uint8), or the JAX package's key
    data (uint32), or None (the module docstring)."""
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
        if "torch_generator_state" in z.files:
            rng = np.asarray(z["torch_generator_state"], np.uint8)
            gen_dev = str(z["torch_generator_device"])
            if gen_dev != device.type:
                raise RuntimeError(
                    f"checkpoint {path} holds a {gen_dev} generator's state; "
                    f"resume it on a {gen_dev} device, not {device.type}")
        elif "key_data" in z.files:
            rng = np.asarray(z["key_data"], np.uint32)
        else:
            rng = None
    return state, rng, step, metadata


def restore_generator(rng, device) -> Optional[torch.Generator]:
    """A ``torch.Generator`` on ``device`` from :func:`load_checkpoint`'s
    ``rng``: the saved state restored (uint8), or seeded from JAX key data
    (uint32, the module docstring's rule), or None."""
    if rng is None:
        return None
    gen = torch.Generator(device=resolve_device(device))
    rng = np.asarray(rng)
    if rng.dtype == np.uint8:
        gen.set_state(torch.from_numpy(rng.copy()))
    else:
        seed = int.from_bytes(rng.astype("<u4").tobytes(), "little")
        gen.manual_seed(seed % (1 << 63))
    return gen
