"""Port parity of the distributed far field
(``farfield.mobility_apply_local``: the node moments all-reduced, the
near part swept by equal row-tile slices of the gathered sorted tiles)
against the JAX package's ``mobility_apply_local`` on 4 of conftest's 8
virtual CPU devices, on 4 gloo ranks of the CPU
(``tests/torch_dist_ranks.py``, one spawn for the file), float64: 800
blobs above the wall, mono and with per-blob radii, and the band tier at
order 6, to 1e-10 of max|U|; the apply with the ctx of ``prepare_local``
and with a pinned geometry tier bitwise equal to the apply without; the
slices' boundary pairs counted.  In the pytest process: K3's row-tile
slice (``farfield_cuda.near_sweep`` with ``t0`` / ``nt``, its plain
version on the CPU) at D = 4 against the whole near sweep, and the
distributed context at one rank against the single-device one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu import parallel as par_j  # noqa: E402
from rigid_body_light_tpu.ops import farfield as ff_j  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield, farfield_cuda, tiles  # noqa: E402

D = 4
AX = "bodies"
TOL = 1e-10
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _cases():
    rng = np.random.default_rng(3)
    n = 800
    r = rng.uniform(0, 14, (n, 3)) + [0, 0, 1.0]
    F = rng.standard_normal((n, 3))
    radii = rng.choice([0.7, 1.2], n)
    kw = dict(a=0.9, eta=1.3, grid=(3, 3, 2), p=3, wall=True)
    rb = rng.uniform(0, 16, (n, 3)) + [0, 0, 1.0]
    return {"mono": dict(r=r, F=F, kw=kw),
            "poly": dict(r=r, F=F, radii=radii, kw=kw),
            "band6": dict(r=rb, F=F, kw=dict(kw, grid=(3, 3, 1),
                                             band_p=6))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = _cases()
    handle = torch_dist_ranks.launch("farfield_task", D,
                                     tmp_path_factory.mktemp("farfield"),
                                     cases)
    mesh = par_j.make_mesh(D, axis_name=AX)
    ref = {}
    for name, c in cases.items():
        poly = "radii" in c

        def local(F_l, r_l, a_l, kw=c["kw"], poly=poly):
            return ff_j.mobility_apply_local(F_l, r_l, D, AX,
                                             radii_l=a_l if poly else None,
                                             **kw)

        radii = jnp.asarray(c.get("radii", np.ones(c["r"].shape[0])))
        fn = shard_map(local, mesh=mesh, in_specs=(P(AX), P(AX), P(AX)),
                       out_specs=P(AX), check_vma=False)
        ref[name] = np.asarray(jax_fast(fn, jnp.asarray(c["F"]),
                                        jnp.asarray(c["r"]), radii))
    return torch_dist_ranks.collect(handle), ref


def _rows(res, key):
    return np.concatenate([r[key] for r in res])


@pytest.mark.parametrize("name", ["mono", "poly", "band6"])
def test_local_apply_matches_jax(results, name):
    res, ref = results
    U = _rows(res, name)
    rel = np.abs(U - ref[name]).max() / np.abs(ref[name]).max()
    assert rel < TOL, (name, rel)


@pytest.mark.parametrize("name", ["mono", "poly", "band6"])
def test_hoisted_ctx_is_the_same_computation(results, name):
    """prepare_local / prepare_geometry_local: a prebuilt ctx, with or
    without a reused geometry tier, gives the ctx-free apply bitwise."""
    res, _ = results
    for r in res:
        np.testing.assert_array_equal(r[name + "_ctx"], r[name])
        np.testing.assert_array_equal(r[name + "_pinned"], r[name])


def test_slices_count_their_boundary_pairs(results):
    res, _ = results
    for r in res:
        assert 0 < r["mono_boundary"] < r["mono_pairs"]


def _cloud(n=1000, seed=4):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(0, 12, (n, 3)) + [0, 0, 1.0])


@pytest.mark.parametrize("wall", [False, True])
def test_row_tile_slices_give_the_whole_sweep(wall):
    """K3's slice entry at D = 4 (each slice's work list from
    ``tiles.slice_pairs``), its plain version here, against one whole sweep."""
    r = _cloud()
    ctx = farfield.prepare(r, a=0.9, wall=wall, grid=(3, 3, 2), p=3)
    live = ctx.id_s >= 0
    F = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, ctx.x_s.shape[0], 3)))
    full = farfield_cuda.near_sweep(ctx.x_s, ctx.ci_s, live, F, ctx.nbr, wall,
                                    0.75, pairs=(ctx.pairs, ctx.n_pairs))
    t = ctx.nbr.shape[0]
    assert t % D == 0
    nt = t // D
    parts = []
    for d in range(D):
        pairs, count, _ = tiles.slice_pairs(ctx.pairs, ctx.n_pairs,
                                                d * nt, nt)
        parts.append(farfield_cuda.near_sweep(
            ctx.x_s, ctx.ci_s, live, F, ctx.nbr, wall, 0.75,
            pairs=(pairs, count), t0=d * nt, nt=nt))
    U = torch.cat(parts, dim=1)
    assert U.shape == full.shape
    rel = ((U - full)[:, live].abs().max() / full[:, live].abs().max()).item()
    assert rel < 1e-6


def test_one_rank_context_is_the_single_device_one():
    """prepare_local with no group (one rank, the JAX package's name for
    prepare over a group) holds the single-device context's arrays, with
    the whole pair list and no slice, and its apply is the single-device
    apply."""
    r = _cloud()
    F = torch.from_numpy(np.random.default_rng(2).standard_normal(r.shape))
    kw = dict(a=0.9, eta=1.3, wall=True, grid=(3, 3, 2), p=3)
    ctx = farfield.prepare(r, **kw)
    ctx_l = farfield.prepare_local(r, None, **kw)
    for f in ("x_s", "ci_s", "id_s", "nbr", "cid", "W3"):
        assert torch.equal(getattr(ctx, f), getattr(ctx_l, f)), f
    assert int(ctx_l.n_pairs) == int(ctx.n_pairs)
    assert torch.equal(ctx_l.pairs, ctx.pairs)
    assert ctx_l.n_boundary is None
    np.testing.assert_array_equal(
        farfield.mobility_apply_local(F, r, None, ctx=ctx_l, **kw).numpy(),
        farfield.mobility_apply(F, r, ctx=ctx, **kw).numpy())
