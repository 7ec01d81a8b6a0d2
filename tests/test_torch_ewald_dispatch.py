"""Port parity of the periodic operator's saddle dispatch against the JAX
package (float64 on the CPU): ``ewald_rc``, ``ewald_grid_p`` and per-blob
radii in a 3-D box reach the operator JAX's ``saddle._ewald_apply_fn``
builds, within 1e-10 of max|U|; the CUDA sweep K4 serves monodisperse
float32 with no ``rc`` only, as the JAX package's Pallas kernel does; the
host tables are built once per configuration.

120 blobs in a cubic L = 9 box, a = 0.3, ewald_tol 1e-4, rc = 3.0, grid
p = 3 (p = 2 where only the routing is checked); radii from {0.25, 0.3,
0.4}.  The JAX references are compiled at XLA's cheapest CPU
optimization, as ``tests/test_torch_poly.py`` compiles its references.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
import rigid_body_light_tpu_torch as rt  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald as ewald_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_pme as pme_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402

BOX = (9.0, 9.0, 9.0)
OP_TOL = 1e-10      # of max|U|
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _rel(U, ref):
    U, ref = np.asarray(U, np.float64), np.asarray(ref, np.float64)
    return np.abs(U - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(9)
    r = rng.uniform(0, 9, (120, 3))
    F = rng.standard_normal((2, 120, 3))
    radii = rng.choice([0.25, 0.3, 0.4], size=120)
    return r, F, radii


@pytest.mark.parametrize("kw,poly", [
    (dict(ewald_rc=3.0), False),
    (dict(ewald_rc=3.0, ewald_grid_p=3), False),
    ({}, True),
    (dict(ewald_rc=3.0), True),
    (dict(ewald_rc=3.0, ewald_grid_p=3), True),
], ids=["rc", "rc-grid", "radii", "rc-radii", "rc-grid-radii"])
def test_saddle_dispatch_matches_jax(cloud, kw, poly):
    """The config-built operator (1 and 2 RHS) equals the JAX package's
    for the balanced split, its grid and radii in a 3-D box."""
    r, F, radii = cloud
    cfg_j = SimulationConfig(a=0.3, dt=0.01, box=BOX, ewald_tol=1e-4,
                             dtype=jnp.float64, **kw)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    rad_j = jnp.asarray(radii) if poly else None
    rad_t = torch.from_numpy(radii) if poly else None
    U2_j = jax_fast(saddle_j.mobility_apply_multi_fn(cfg_j, radii=rad_j),
                    jnp.asarray(F), jnp.asarray(r))
    r_t, F_t = torch.from_numpy(r), torch.from_numpy(F)
    U_t = saddle_t.mobility_apply_fn(cfg_t, radii=rad_t)(F_t[0], r_t)
    U2_t = saddle_t.mobility_apply_multi_fn(cfg_t, radii=rad_t)(F_t, r_t)
    # one JAX compile a case: its 2-RHS product's first RHS is the 1-RHS
    # product to roundoff
    assert _rel(U_t, U2_j[0]) < OP_TOL and _rel(U2_t, U2_j) < OP_TOL


def test_tables_are_built_once_per_configuration(cloud):
    """A step asks for the operator anew: the params, the grid and the
    float32 species-pair fits come from caches, not new host builds."""
    r, _, radii = cloud
    cfg = rt.SimulationConfig(a=0.3, box=BOX, ewald_rc=3.0, ewald_grid_p=4,
                              ewald_tol=1e-4, dtype=torch.float32)
    rad = torch.from_numpy(radii).float()
    saddle_t.mobility_apply_fn(cfg, radii=rad)
    grid_misses = saddle_t._ewald_grid.cache_info().misses
    pt_misses = saddle_t._poly_tables.cache_info().misses
    saddle_t.mobility_apply_fn(cfg, radii=rad)
    saddle_t.mobility_apply_multi_fn(cfg, radii=rad)
    assert saddle_t._ewald_grid.cache_info().misses == grid_misses
    assert saddle_t._poly_tables.cache_info().misses == pt_misses
    g = saddle_t._ewald_grid(
        (BOX, 0.3, 1.0, None, 1e-4, 3.0), 4,
        saddle_t._radii_key(rad))
    assert isinstance(g, pme_t.EwaldGrid) and g.sidx is not None


@pytest.mark.parametrize("kw,poly,k4", [
    ({}, False, True),
    (dict(ewald_rc=3.0), False, False),
    (dict(ewald_rc=3.0, ewald_grid_p=2), False, False),
    ({}, True, False),
    (dict(use_pallas=False), False, False),
    (dict(dtype=torch.float64), False, False),
], ids=["classic", "rc", "rc-grid", "radii", "no-kernel", "float64"])
def test_k4_serves_mono_classic_float32_only(cloud, monkeypatch, kw, poly,
                                             k4):
    """K4's wrapper is reached (on the CPU it takes its plain version) for
    monodisperse float32 with no rc, as the JAX package reaches its Pallas
    kernel; every other configuration takes the plain operator."""
    r, F, radii = cloud
    calls = []
    real_pair_sum = ewald_cuda.real_pair_sum

    def counted(*args, **kwargs):
        calls.append(1)
        return real_pair_sum(*args, **kwargs)

    monkeypatch.setattr(ewald_cuda, "real_pair_sum", counted)
    cfg = rt.SimulationConfig(**{**dict(a=0.3, box=BOX, ewald_tol=1e-4,
                                        dtype=torch.float32), **kw})
    rad = torch.from_numpy(radii).to(cfg.dtype) if poly else None
    r_t = torch.from_numpy(r).to(cfg.dtype)
    F_t = torch.from_numpy(F).to(cfg.dtype)
    U = saddle_t.mobility_apply_fn(cfg, radii=rad)(F_t[0], r_t)
    U2 = saddle_t.mobility_apply_multi_fn(cfg, radii=rad)(F_t, r_t)
    assert len(calls) == (2 if k4 else 0)
    assert bool(torch.isfinite(U).all()) and U2.shape == F.shape
    with pytest.raises(ValueError, match="classic split"):
        ewald_cuda.mobility_apply(F_t[0].float(), r_t.float(),
                                  ewald_t.make_params(BOX, 0.3, rc=2.5))
