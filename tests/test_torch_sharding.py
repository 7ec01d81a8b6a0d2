"""Port parity of the sharded pair sweeps (``rigid_body_light_tpu_torch.
parallel``) against the JAX package's, on 4 gloo ranks of the CPU
(``tests/torch_dist_ranks.py``, one spawn for the file) beside the JAX
package on 4 of conftest's 8 virtual CPU devices: the 1-D gather sweep
and SUMMA on a 2 × 2 mesh at n 64 and 101 (padded), wall on and off, the
sharded mobility product (``test_sharding.py::test_sharded_matvec_parity``
and ``test_2d_sharded_matvec_parity`` on 4 devices), and the ring (the
wall, the exact image ring, the POLY ring, two RHS), float64 to 1e-12 of
max|U|; the same ring in float32 through K2's slab entry
(``rpy_cuda.pair_sum_slab``, the plain sweep with global ids on the CPU)
to float32 roundoff; the slab entry's contract at nonzero offsets, and
the rows it streams (``rpy_cuda.mobility_apply_rows``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu import parallel as par_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy as rpy_j  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy as rpy_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy_cuda  # noqa: E402

D = 4
AX = "bodies"
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TOL = 1e-12
TOL32 = 2e-6
A_RING = 0.36


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _gather_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for n in (64, 101):
        r = rng.uniform(-3, 3, (n, 3)) + [0, 0, 4.0]
        F = rng.standard_normal((n, 3))
        for wall in (False, True):
            cases[(n, wall)] = dict(r=r, F=F, a=0.5, wall=wall)
    return cases


def _ring_cases():
    """8 × shell_N_12 above the wall (tests/test_distributed.py::_setup's
    lattice), 96 blobs, 24 a rank."""
    _, ref = load_structure("shell_N_12")
    xs = np.array([[2.5 * (i % 4), 2.5 * (i // 4), 2.0 + 0.2 * (i % 3)]
                   for i in range(8)])
    r = (xs[:, None, :] + np.asarray(ref)[None] * 2.2).reshape(-1, 3)
    rng = np.random.default_rng(1)
    F = rng.standard_normal(r.shape)
    F2 = rng.standard_normal((2,) + r.shape)
    radii = rng.choice([0.25, 0.45], r.shape[0])
    base = dict(r=r, a=A_RING, wall=True)
    return {("wall",): dict(base, F=F),
            ("2rhs",): dict(base, F=F2),
            ("image",): dict(base, F=F, box=(11.0, 11.0), image_shells=2),
            ("poly",): dict(base, F=F, radii=radii)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, and the JAX package's, computed meanwhile."""
    gather, ring = _gather_cases(), _ring_cases()
    handle = torch_dist_ranks.launch(
        "sharding_task", D, tmp_path_factory.mktemp("sharding"),
        {"gather": gather, "ring": ring})
    mesh = par_j.make_mesh(D)
    mesh2 = par_j.make_mesh_2d((2, 2))
    ref = {}
    for key, c in gather.items():
        kw = dict(a=c["a"], wall=c["wall"])
        cfg = SimulationConfig(a=c["a"], eta=1.3, wall=c["wall"],
                               dtype=jnp.float64)

        def kinds(r, F, kw=kw, cfg=cfg):
            return (par_j.sharded_pair_sum(r, F, mesh, **kw),
                    par_j.sharded_pair_sum_2d(r, F, mesh2, **kw),
                    par_j.sharded_mobility_apply_fn(cfg, mesh)(F, r),
                    par_j.sharded_mobility_apply_fn(cfg, mesh2)(F, r))

        out = jax_fast(kinds, jnp.asarray(c["r"]), jnp.asarray(c["F"]))
        for name, U in zip(("1d", "2d", "mob1d", "mob2d"), out):
            ref[(name,) + key] = U
    mesh_b = par_j.make_mesh(D, axis_name=AX)
    for key, c in ring.items():
        kw = dict(a=c["a"], wall=c["wall"], box=c.get("box"),
                  image_shells=c.get("image_shells", 0))
        F = jnp.asarray(c["F"])
        f_spec = P(AX) if F.ndim == 2 else P(None, AX)
        fn = functools.partial(par_j.ring_pair_sum_local, n_devices=D,
                               axis_name=AX, **kw)
        radii = jnp.asarray(c.get("radii", np.ones(c["r"].shape[0])))
        poly = "radii" in c
        ring_j = shard_map(
            lambda r_l, F_l, a_l, fn=fn, poly=poly: fn(
                r_l, F_l, radii_l=a_l if poly else None),
            mesh=mesh_b, in_specs=(P(AX), f_spec, P(AX)), out_specs=f_spec,
            check_vma=False)
        ref[("ring",) + key] = jax_fast(ring_j, jnp.asarray(c["r"]), F,
                                        radii)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return torch_dist_ranks.collect(handle), ref


def _ring_result(res, key):
    """The ranks' local rows of a ring result, in rank order."""
    parts = [r[key] for r in res]
    return np.concatenate(parts, axis=parts[0].ndim - 2)


@pytest.mark.parametrize("n", [64, 101])
@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("kind", ["1d", "2d", "mob1d", "mob2d"])
def test_gather_sweeps_match_jax(ranks, kind, n, wall):
    res, ref = ranks
    key = (kind, n, wall)
    for r in res:   # every rank returns the global product
        assert _rel(r[key], ref[key]) < TOL, (key, _rel(r[key], ref[key]))
    assert res[0][key].shape == (n, 3)


@pytest.mark.parametrize("case", ["wall", "2rhs", "image", "poly"])
def test_ring_matches_jax(ranks, case):
    res, ref = ranks
    U = _ring_result(res, ("ring", case))
    want = ref[("ring", case)]
    assert U.shape == want.shape
    assert _rel(U, want) < TOL, (case, _rel(U, want))
    # float32 through K2's slab entry (its CPU version)
    U32 = _ring_result(res, ("ring32", case))
    assert _rel(U32, want) < TOL32, (case, _rel(U32, want))


def test_image_ring_engages_the_images(ranks):
    """The exact image ring is not the minimum image: the two differ."""
    res, ref = ranks
    assert _rel(ref[("ring", "wall")], ref[("ring", "image")]) > 1e-3


@pytest.mark.parametrize("poly", [False, True])
def test_slab_entry_at_offsets(poly):
    """``pair_sum_slab`` of rows [30, 70) against columns [20, 101) at their
    global offsets (the block holds the rows' own ids, so the self pairs
    inside it are masked; box with image shells, a blob keeping its own
    images) equals the JAX package's plain sweep with those global ids, to
    float32 roundoff; without the offsets it would mask other pairs."""
    rng = np.random.default_rng(2)
    n, a = 101, 0.5
    r = rng.uniform(0, 5, (n, 3)) + [0, 0, 1.0]
    F = rng.standard_normal((2, n, 3))
    radii = rng.choice([0.4, 0.6], n) if poly else None
    rows, cols = slice(30, 70), slice(20, 101)
    ids = np.arange(n)
    kw = dict(a=a, wall=True, box=(5.0, 5.0), image_shells=1)
    want = np.asarray(rpy_j.pair_sum(
        jnp.asarray(r[rows]), jnp.asarray(ids[rows]), jnp.asarray(r[cols]),
        jnp.asarray(ids[cols]), jnp.asarray(F[:, cols]),
        radii_rows=None if radii is None else jnp.asarray(radii[rows]),
        radii_cols=None if radii is None else jnp.asarray(radii[cols]),
        **kw))
    ah = None if radii is None else torch.tensor(radii) / a
    got = rpy_cuda.pair_sum_slab(
        torch.tensor(r[rows]) / a, 30, torch.tensor(r[cols]) / a,
        torch.tensor(F[:, cols]), True, col_offset=20, box_over_a=(10., 10.),
        ahat_rows=None if ah is None else ah[rows],
        ahat_cols=None if ah is None else ah[cols], image_shells=1)
    assert got.shape == (2, 40, 3)
    assert _rel(got.double().numpy(), want) < TOL32
    wrong = rpy_cuda.pair_sum_slab(
        torch.tensor(r[rows]) / a, 0, torch.tensor(r[cols]) / a,
        torch.tensor(F[:, cols]), True, box_over_a=(10., 10.),
        ahat_rows=None if ah is None else ah[rows],
        ahat_cols=None if ah is None else ah[cols], image_shells=1)
    assert _rel(wrong.double().numpy(), want) > 1e-3


@pytest.mark.parametrize("poly", [False, True])
def test_mobility_apply_rows_are_the_products_rows(poly):
    """``mobility_apply_rows`` (float32, K2's slab entry): rows [40, 90) of
    the damped wall product with its self terms, against the float64 plain
    product's rows."""
    rng = np.random.default_rng(3)
    n, a = 120, 0.5
    r = torch.tensor(rng.uniform(0, 5, (n, 3)) + [0, 0, 0.6])
    F = torch.tensor(rng.standard_normal((n, 3)))
    radii = torch.tensor(rng.choice([0.4, 0.6], n)) if poly else None
    want = rpy_t.mobility_apply(F, r, a=a, eta=1.3, wall=True, radii=radii)
    got = rpy_cuda.mobility_apply_rows(F, r, 40, 50, a=a, eta=1.3, wall=True,
                                       radii=radii)
    assert got.shape == (50, 3) and got.dtype == torch.float32
    assert _rel(got.double().numpy(), want[40:90].numpy()) < TOL32
