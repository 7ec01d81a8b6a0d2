"""Port parity of the external force fields (``forces.py``) against the
JAX package in float64: each field and their sum on the same state."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import forces as forces_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import forces as forces_t  # noqa: E402
from rigid_body_light_tpu_torch import make_state as make_state_t  # noqa: E402

B = 7


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(2)
    X = rng.uniform([0, 0, 0.6], [9, 9, 4], (B, 3))
    Q = rng.standard_normal((B, 4))
    return (make_state_j(X, Q, dtype=jnp.float64),
            make_state_t(X, Q, dtype=torch.float64, device="cpu"))


FIELDS = {
    "gravity": lambda m: m.gravity(np.array([0.1, 0, -1.0, 0, 0.2, 0])),
    "gravity per body": lambda m: m.gravity(
        np.arange(6 * B, dtype=float).reshape(B, 6) / 10),
    "wall_repulsion": lambda m: m.wall_repulsion(4.0, 0.3, 1.0),
    "harmonic_trap": lambda m: m.harmonic_trap(2.5, np.array([4.0, 4.0, 2.0])),
    "pair_yukawa": lambda m: m.pair_yukawa(3.0, 0.5, 2.0),
    "pair_yukawa in a box": lambda m: m.pair_yukawa(3.0, 0.5, 2.0,
                                                    box=(6.0, 7.0)),
    "sum": lambda m: m.sum_forces(
        m.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        m.wall_repulsion(4.0, 0.3, 1.0), m.pair_yukawa(3.0, 0.5, 2.0)),
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_force_matches(states, name):
    st_j, st_t = states
    f_j = np.asarray(FIELDS[name](forces_j)(st_j, 3))
    f_t = FIELDS[name](forces_t)(st_t, 3)
    assert f_t.shape == (B, 6) and f_t.dtype == torch.float64
    assert f_t.device == st_t.X.device
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-13, atol=1e-13)
