"""The port's utilities on the CPU: the checkpoint reader against files the
JAX package wrote, and the step timer's spans and metrics."""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu.utils import checkpoint as ckpt_j  # noqa: E402
from rigid_body_light_tpu_torch.utils import checkpoint as ckpt_t  # noqa: E402
from rigid_body_light_tpu_torch.utils import profiling  # noqa: E402

SETTLED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "data", "settled_642.npz")


def test_reads_the_settled_checkpoint():
    st_j, key_j, step_j, meta_j = ckpt_j.load_checkpoint(SETTLED,
                                                         dtype=jnp.float32)
    st_t, key_t, step_t, meta_t = ckpt_t.load_checkpoint(
        SETTLED, dtype=torch.float32, device="cpu")
    assert st_t.X.shape == (16, 3) and st_t.X.dtype == torch.float32
    np.testing.assert_array_equal(st_t.X.numpy(), np.asarray(st_j.X))
    np.testing.assert_array_equal(st_t.Q.numpy(), np.asarray(st_j.Q))
    assert key_t.dtype == np.uint32
    np.testing.assert_array_equal(key_t, np.asarray(jax.random.key_data(key_j)))
    assert (step_t, meta_t) == (step_j, meta_j)


def test_reads_a_mixture_checkpoint(tmp_path):
    """A two-species file from the JAX writer, with a key, and one without:
    equal arrays, equal key data, step and metadata."""
    rng = np.random.default_rng(0)
    species = [make_state_j(rng.uniform(0, 5, (b, 3)),
                            rng.standard_normal((b, 4)), dtype=jnp.float64)
               for b in (3, 5)]
    key = jax.random.key(17)
    path = str(tmp_path / "mix.npz")
    ckpt_j.save_checkpoint(path, species, key=key, step=42,
                           metadata={"note": "mixture", "dt": 0.01})
    st_t, key_t, step_t, meta_t = ckpt_t.load_checkpoint(
        path, dtype=torch.float64, device="cpu")
    assert isinstance(st_t, tuple) and len(st_t) == 2
    for s_t, s_j in zip(st_t, species):
        np.testing.assert_array_equal(s_t.X.numpy(), np.asarray(s_j.X))
        np.testing.assert_array_equal(s_t.Q.numpy(), np.asarray(s_j.Q))
    np.testing.assert_array_equal(key_t, np.asarray(jax.random.key_data(key)))
    assert step_t == 42 and meta_t == {"note": "mixture", "dt": 0.01}
    bare = str(tmp_path / "bare.npz")
    ckpt_j.save_checkpoint(bare, species[0])
    st_b, key_b, step_b, meta_b = ckpt_t.load_checkpoint(
        bare, dtype=torch.float64, device="cpu")
    assert key_b is None and step_b == 0 and meta_b == {}
    np.testing.assert_array_equal(st_b.X.numpy(), np.asarray(species[0].X))


def test_refuses_a_newer_format(tmp_path):
    path = str(tmp_path / "v9.npz")
    np.savez(path, format_version=9, X=np.zeros((1, 3)), Q=np.ones((1, 4)),
             step=0, metadata=json.dumps({}))
    with pytest.raises(RuntimeError, match="v9"):
        ckpt_t.load_checkpoint(path, device="cpu")


def test_step_timer_nests_spans_and_splits_their_time():
    """Spans nest: a part's own time is its time less its children's, the
    children's times lie inside the parent's, and repeated spans add up."""
    with profiling.StepTimer(device="cpu") as timer:
        with profiling.span("step"):
            for _ in range(2):
                with profiling.span("gmres"):
                    time.sleep(0.01)
                    with profiling.span("mobility"):
                        with profiling.span("pair_sweep_sym"):
                            time.sleep(0.02)
            with profiling.span("noise"):
                time.sleep(0.005)
    split = timer.split()
    assert set(split) == {"step", "gmres", "mobility", "pair_sweep_sym",
                          "noise"}
    assert split["gmres"]["count"] == 2 and split["step"]["count"] == 1
    assert split["gmres"]["ms"] >= 2 * 30.0
    assert split["gmres"]["ms"] >= split["mobility"]["ms"]
    assert split["mobility"]["ms"] >= split["pair_sweep_sym"]["ms"] >= 40.0
    assert 20.0 <= split["gmres"]["self_ms"] < split["gmres"]["ms"] - 40.0
    assert 0.0 <= split["mobility"]["self_ms"] == pytest.approx(
        split["mobility"]["ms"] - split["pair_sweep_sym"]["ms"])
    own = sum(p["self_ms"] for p in split.values())
    assert abs(own - split["step"]["ms"]) < 1e-6    # every ms counted once
    # no timer active: span() does nothing
    with profiling.span("step"):
        pass
    assert timer.split() == split


def test_step_timer_splits_a_cpu_step():
    """The timer around one small float64 step on the CPU sees the parts
    of a step: noise, RFD, the solve's PC build, GMRES and the PC applies,
    the mobility products and kinematics, each inside the step."""
    from rigid_body_light_tpu_torch import load_structure, make_state
    from rigid_body_light_tpu_torch import SimulationConfig
    from rigid_body_light_tpu_torch.dynamics import stochastic_step
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    params, ref = load_structure("shell_N_12")
    cfg = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=1.0, wall=True,
                           dtype=torch.float64, lanczos_iters=4,
                           gmres_tol=1e-6, pc_mode="ras", pc_halo=4.0,
                           pc_halo_max=8)
    geom = kin.make_ref_geometry(ref, dtype=torch.float64, device="cpu")
    X = np.array([[0.0, 0.0, 1.4], [2.3, 0.0, 1.4], [0.0, 2.3, 1.5]])
    state = make_state(X, np.tile([1.0, 0, 0, 0], (3, 1)),
                       dtype=torch.float64, device="cpu")
    force = torch.zeros((3, 6), dtype=torch.float64)
    force[:, 2] = -1.0
    gen = torch.Generator().manual_seed(0)
    with profiling.StepTimer(device="cpu") as timer:
        _, aux = stochastic_step(geom, cfg, state, force, generator=gen)
    split = timer.split()
    for part in ("step", "noise", "rfd", "kinematics", "pc_build", "gmres",
                 "pc_apply", "mobility"):
        assert split[part]["count"] >= 1, part
        assert split[part]["ms"] <= split["step"]["ms"] + 1e-9, part
    assert split["mobility"]["count"] >= aux.iters + 4 + 2  # GMRES, noise, RFD
    assert set(split) <= set(profiling.PARTS)


def test_step_metrics():
    m = profiling.StepMetrics()
    assert m.steps_per_sec == 0.0
    m.record(0, 0.5, 1e-5)
    m.record(1, 0.25, 2e-5, iters=7)
    m.record(2, 0.25, 3e-5)
    assert m.steps_per_sec == pytest.approx(3.0)
    assert m.steps[1] == {"step": 1, "wall_time_s": 0.25,
                          "gmres_residual": 2e-5, "iters": 7}
    holder = {}
    with profiling.timed("block", holder):
        time.sleep(0.01)
    assert holder["block"] >= 0.01
    assert profiling.sync(torch.ones(3)) == 3.0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path)) as prof:
        (torch.ones(64) * 2.0).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert len(prof.key_averages()) > 0
