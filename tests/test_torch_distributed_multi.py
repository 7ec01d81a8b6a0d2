"""Port parity of the gather mesh's operator with a mixture's radii and of
the distributed mixture (``parallel.make_distributed_step_multi`` /
``make_distributed_run_bd_multi``) against the JAX package, on 4 gloo
ranks of the CPU (``tests/torch_dist_ranks.py``, one spawn for the file)
beside the JAX package on 4 of conftest's 8 virtual devices, float64 at
``tests/test_distributed.py``'s mixture (8 × shell_N_12 + 8 × shell_N_42
at 1.4a above the wall):

- the gather mesh's operator (``sharded_mobility_apply_fn``) on the
  mixture's positions: monodisperse against the JAX gather path, and with
  the mixture's radii against the JAX package's single-device mixture
  operator (``multi._mob_fns``; its gather path drops the radii), to
  1e-12 of max|U|;
- the kBT = 0 distributed mixture steps through the polydisperse ring,
  the sliced far field (grid (3, 3, 2), p = 3) and the distributed Ewald
  (4 + 4 bodies in L = 12, ``ewald_rc`` 4), against the JAX package's
  distributed mixture steps: X and Q to 1e-12, equal GMRES iterations;
- a stochastic ring step, each rank fed the draws of its device, and a
  3-step ``make_distributed_run_bd_multi`` against the JAX package's;
- a group without its local operator (the JAX text).

In the pytest process: the run driver's gather mode refuses a 3-D box and
a ``farfield_grid`` before it writes anything.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu import (SimulationConfig, load_structure,  # noqa: E402
                                  multi, parallel)
from rigid_body_light_tpu.state import make_state  # noqa: E402
from rigid_body_light_tpu_torch import run as run_t  # noqa: E402

D = 4
AX = "bodies"
TOL = 1e-12
N_RUN = 3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _cfg_dict(cfg):
    return dict(dataclasses.asdict(cfg), dtype="float64")


def _mixture(box=None):
    """``tests/test_distributed.py::_setup_mixture``; with ``box`` 4 + 4
    bodies on a lattice in that 3-D box, no wall."""
    pa, ca = load_structure("shell_N_12")
    pb, cb = load_structure("shell_N_42")
    rng = np.random.default_rng(21)
    a = pa["sep"] / 2
    if box is None:
        Xa = rng.uniform(0, 20, (8, 3)) + [0, 0, 4.0]
        Xb = rng.uniform(0, 20, (8, 3)) + [0, 0, 9.0]
    else:
        g = np.array([[i % 2, (i // 2) % 2, 0] for i in range(4)], float)
        Xa = 1.5 + 6.0 * g + [0, 0, 1.5]
        Xb = 4.5 + 6.0 * g + [0, 0, 4.5]
    nb = Xa.shape[0]
    qa = rng.standard_normal((nb, 4))
    qa /= np.linalg.norm(qa, axis=1, keepdims=True)
    qb = rng.standard_normal((nb, 4))
    qb /= np.linalg.norm(qb, axis=1, keepdims=True)
    cfg = SimulationConfig(a=a, dt=0.02, kBT=0.0, wall=box is None,
                           dtype=jnp.float64, gmres_tol=1e-9,
                           pc_mode="block_free", use_pallas=False,
                           lanczos_iters=8)
    return (ca, cb), (None, 1.4 * a), (Xa, Xb), (qa, qb), cfg


def _jax_mixture(refs, radii, Xs, Qs):
    mg = multi.MultiGeometry.create(list(refs), dtype=jnp.float64,
                                    radii=radii)
    states = tuple(make_state(x, q, dtype=jnp.float64)
                   for x, q in zip(Xs, Qs))
    return mg, states


def _forces(nb):
    return tuple(np.tile([0.0, 0, v, 0, 0, 0], (nb, 1)) for v in (-1.0, -2.0))


def _device_draws(key, n_l):
    """The (W1, W2, W_rfd) the JAX distributed mixture step draws on each
    device: the key folded with the device index, split in three, W_rfd
    the RFD's (N_l, 3)."""
    out = []
    for d in range(D):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, d), 3)
        out.append(tuple(np.array(jax.random.normal(k, s, jnp.float64))
                         for k, s in ((k1, (3 * n_l,)), (k2, (3 * n_l,)),
                                      (k3, (n_l, 3)))))
    return out


def _payload_mixture(refs, radii, Xs, Qs):
    return dict(refs=[np.asarray(r) for r in refs], radii=radii, Xs=Xs,
                Qs=Qs, forces=_forces(Xs[0].shape[0]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    refs, radii, Xs, Qs, cfg = _mixture()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_far = cfg.replace(farfield_grid=(3, 3, 2), farfield_p=3)
    refs_e, radii_e, Xs_e, Qs_e, cfg_e = _mixture(box=(12.0, 12.0, 12.0))
    cfg_e = cfg_e.replace(box=(12.0, 12.0, 12.0), ewald_rc=4.0,
                          ewald_tol=1e-4)
    cfg_st = cfg.replace(kBT=0.5, gmres_tol=1e-8)
    key = jax.random.key(3)
    mg, states = _jax_mixture(refs, radii, Xs, Qs)
    opses = multi.geometry_ops_multi(mg, states)
    pos = np.asarray(multi.concat_positions(opses))
    rad = np.asarray(multi.blob_radii_multi(mg, opses, cfg))
    n_l = pos.shape[0] // D
    Fg = np.random.default_rng(4).standard_normal(pos.shape)
    payload = dict(
        _payload_mixture(refs, radii, Xs, Qs), cfg=_cfg_dict(cfg),
        gather={"mono": dict(r=pos, F=Fg, radii=None),
                "poly": dict(r=pos, F=Fg, radii=rad)},
        ring=_cfg_dict(cfg), far=_cfg_dict(cfg_far), stoch=_cfg_dict(cfg_st),
        ewald=_cfg_dict(cfg_e),
        ewald_mixture=_payload_mixture(refs_e, radii_e, Xs_e, Qs_e),
        draws=_device_draws(key, n_l), n_run=N_RUN)
    handle = torch_dist_ranks.launch("multi_task", D,
                                     tmp_path_factory.mktemp("multi"),
                                     payload)

    mesh = parallel.make_mesh(D, axis_name=AX)
    out = {}
    r_, F_ = jnp.asarray(pos), jnp.asarray(Fg)
    out["mono"] = np.asarray(jax_fast(
        parallel.sharded_mobility_apply_fn(cfg, mesh, axis_name=AX), F_, r_))
    mob_poly = multi._mob_fns(mg, opses, cfg)[0]
    out["poly"] = np.asarray(jax_fast(mob_poly, F_, r_))
    F = tuple(jnp.asarray(f) for f in _forces(8))
    for name, c, (m_, s_) in (
            ("ring", cfg, (mg, states)), ("far", cfg_far, (mg, states)),
            ("ewald", cfg_e, _jax_mixture(refs_e, radii_e, Xs_e, Qs_e))):
        f_ = F if name != "ewald" else tuple(
            jnp.asarray(f) for f in _forces(4))
        step = parallel.make_distributed_step_multi(m_, c, mesh)
        ss, res = jax_fast(step, s_, jax.random.key(0), f_)
        out[name] = dict(X=[np.asarray(s.X) for s in ss],
                         Q=[np.asarray(s.Q) for s in ss],
                         iters=int(res.iters))
    step = parallel.make_distributed_step_multi(mg, cfg_st, mesh)
    ss, res = jax_fast(step, states, key, F)
    out["stoch"] = dict(X=[np.asarray(s.X) for s in ss],
                        iters=int(res.iters))

    def force_fn(ss_, i):
        return tuple(jnp.zeros((s.X.shape[0], 6), jnp.float64).at[:, 2].set(v)
                     for s, v in zip(ss_, (-1.0, -2.0)))

    run = parallel.make_distributed_run_bd_multi(mg, cfg, mesh, N_RUN,
                                                  force_fn=force_fn)
    final, traj = jax_fast(run, states, jax.random.key(0))
    out["run"] = dict(X=[np.asarray(s.X) for s in final],
                      residual=np.asarray(traj["residual"]),
                      tX=[np.asarray(x) for x in traj["X"]])
    return torch_dist_ranks.collect(handle), out, Xs


@pytest.mark.parametrize("name", ["mono", "poly"])
def test_gather_mesh_operator_with_radii(results, name):
    """The gather mesh's operator: without radii the JAX gather path; with
    the mixture's radii the JAX single-device mixture operator."""
    res, ref, _ = results
    scale = np.abs(ref[name]).max()
    for r in res:
        assert np.abs(r[name] - ref[name]).max() < TOL * scale


@pytest.mark.parametrize("name", ["ring", "far", "ewald"])
def test_distributed_mixture_step_matches_jax(results, name):
    res, ref, _ = results
    for r in res:
        got = r[name]
        for s in range(2):
            assert np.abs(got["X"][s] - ref[name]["X"][s]).max() < TOL
            assert np.abs(got["Q"][s] - ref[name]["Q"][s]).max() < TOL
        assert got["iters"] == ref[name]["iters"]


def test_distributed_mixture_stochastic_step_matches_jax(results):
    res, ref, Xs = results
    for r in res:
        for s in range(2):
            assert np.abs(r["stoch"]["X"][s] - ref["stoch"]["X"][s]).max() \
                < TOL
        assert r["stoch"]["iters"] == ref["stoch"]["iters"]
    assert np.abs(ref["stoch"]["X"][0] - Xs[0]).max() > 1e-4


def test_distributed_mixture_run_matches_jax(results):
    res, ref, _ = results
    for r in res:
        got = r["run"]
        for s in range(2):
            assert got["tX"][s].shape == (N_RUN, 8, 3)
            assert np.abs(got["tX"][s] - ref["run"]["tX"][s]).max() < TOL
            assert np.abs(got["X"][s] - ref["run"]["X"][s]).max() < TOL
        assert np.abs(got["residual"] - ref["run"]["residual"]).max() < 1e-9


def test_distributed_mixture_needs_its_operator(results):
    res, _, _ = results
    for r in res:
        assert r["no_mob"] == ("distributed stochastic_step_multi needs an "
                               "explicit local mob_apply "
                               "(parallel.ring_mobility_apply_fn with the "
                               "mixture's radii)")


@pytest.mark.parametrize("extra", [
    {"box": [12.0, 12.0, 12.0], "wall": False},
    {"solver": {"farfield_grid": (3, 3, 2)}}])
def test_gather_mode_refuses_other_operators(tmp_path, extra):
    """The gather sweep is the all-pairs minimum-image RPY: a 3-D box or a
    far-field grid raises before the output directory exists."""
    conf = {"structure": "shell_N_12", "n_bodies": 2, "n_steps": 2,
            "save_every": 1, "checkpoint_every": 2, "dt": 0.01,
            "kBT": 0.0, "wall": True, "dtype": "float64",
            "output_dir": str(tmp_path / "out"),
            "placement": {"type": "grid", "spacing": 4.0, "z0": 2.0},
            "mesh": {"shape": [1]}, **extra}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(conf))
    with pytest.raises(ValueError, match="mesh mode 'gather' sweeps the "
                       "all-pairs minimum-image RPY"):
        run_t.main([str(path), "--device", "cpu"])
    assert not os.path.exists(conf["output_dir"])
