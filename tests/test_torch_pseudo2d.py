"""Port parity of the pseudo-2D film (a wall-bounded (Lx, Ly) box): the
plain sweep's minimum-image wrap and exact doubly-periodic image sum against
the JAX package in float64, the pair-sweep wrappers (kernels K1/K2's
contract) against the Pallas kernels in interpret mode in float32, and the
config.  A film step: tests/test_torch_pseudo2d_step.py.

The cloud is two shell_N_42 bodies (84 blobs) in an (8, 8) box with a =
0.25, so that 1/a and 1/L are exact: one blob pair sits exactly on the x
seam (Δx = −L/2) and one exactly on the y seam (Δy = +L/2), where
``jnp.round`` keeps the displacement (half to even).  Pairs within
rounding of a seam in boxes whose 1/L is inexact pin where the port's
float32 wrap (the exact difference's image) departs from the JAX
package's float32 plain sweep and Pallas kernels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import load_structure  # noqa: E402
from rigid_body_light_tpu.ops import rpy as rpy_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy_pallas  # noqa: E402
import rigid_body_light_tpu_torch as rt  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy, rpy_cuda  # noqa: E402

A, ETA = 0.25, 1.3
BOX = (8.0, 8.0)
# float32 kernel route vs the Pallas kernel, relative to max|U| — the bound
# tests/test_pallas.py holds the TPU kernel to against a float64 oracle
KERNEL_TOL = 5e-6
LATTICES = [(0, True), (1, True), (1, False), (2, True), (2, False)]


@pytest.fixture(scope="module")
def cloud():
    """Two randomly turned shell_N_42 bodies, heights 1.2-2.2, two blobs
    moved onto the seams; forces (2, 84, 3), float64."""
    _, ref = load_structure("shell_N_42")
    rng = np.random.default_rng(21)
    bodies = []
    for center in ((1.5, 2.0, 1.2), (5.0, 6.5, 2.2)):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        bodies.append(ref @ R.T + np.array(center))
    r = np.concatenate(bodies)
    # Δx = x_3 − x_47 = −4 = −Lx/2 exactly; Δy = y_10 − y_60 = +4 = +Ly/2
    r[3] = (0.75, 1.5, 1.25)
    r[47] = (4.75, 1.5, 2.0)
    r[10] = (2.5, 6.0, 1.5)
    r[60] = (2.5, 2.0, 2.5)
    F = rng.standard_normal((2, r.shape[0], 3))
    return r, F


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


def test_seam_pairs_keep_their_displacement(cloud):
    """Both packages leave a pair at exactly ±L/2 where it is (round half
    to even), in float64 and float32."""
    r, _ = cloud
    box_n = tuple(b / A for b in BOX)
    for dtype, jdt in ((torch.float64, jnp.float64),
                       (torch.float32, jnp.float32)):
        ri = torch.from_numpy(r[[3, 10]] / A).to(dtype)
        rj = torch.from_numpy(r[[47, 60]] / A).to(dtype)
        d = ri - rj
        w_t = rpy._displacement(ri, rj, box_n).diagonal().T
        w_j = rpy_j._wrap_xy(jnp.asarray(d.numpy(), jdt), box_n)
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        np.testing.assert_array_equal(w_t.numpy(), d.numpy())
        assert w_t[0, 0] == -box_n[0] / 2 and w_t[1, 1] == box_n[1] / 2


@pytest.mark.parametrize("shells", [1, 2, 3])
def test_image_lattice_matches(shells):
    box_n = tuple(b / A for b in BOX)
    np.testing.assert_array_equal(
        rpy.image_offsets(box_n, shells).numpy(),
        np.asarray(rpy_j.image_offsets(box_n, shells, jnp.float64)))
    np.testing.assert_array_equal(
        rpy.image_tail_weights(shells).numpy(),
        np.asarray(rpy_j.image_tail_weights(shells, jnp.float64)))
    assert rpy.tail_coeffs(shells) == rpy_j.tail_coeffs(shells)


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("shells, tail", [(1, True), (2, True), (2, False)])
def test_self_image_sum_matches(cloud, shells, tail, wall):
    r, F = cloud
    box_n = tuple(b / A for b in BOX)
    U_t = rpy.self_image_sum(torch.from_numpy(r / A), torch.from_numpy(F),
                             wall, box_n, shells, tail=tail)
    U_j = rpy_j.self_image_sum(jnp.asarray(r / A), jnp.asarray(F), wall,
                               box_n, shells, tail=tail)
    assert U_t.shape == (2, 84, 3)
    assert _rel(U_t, U_j) < 1e-12


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shells, tail", LATTICES)
def test_pair_sum_matches(cloud, shells, tail, k):
    """Row slab 20..70 against all columns (global ids mask the self pairs
    at offset 0 only), k RHS."""
    r, F = cloud
    ids = np.arange(84)
    Fk = F[0] if k == 1 else F
    kw = dict(a=A, wall=True, box=BOX, image_shells=shells, image_tail=tail)
    U_t = rpy.pair_sum(torch.from_numpy(r[20:70]), torch.from_numpy(ids[20:70]),
                       torch.from_numpy(r), torch.from_numpy(ids),
                       torch.from_numpy(Fk), row_tile=16, **kw)
    U_j = rpy_j.pair_sum(jnp.asarray(r[20:70]), jnp.asarray(ids[20:70]),
                         jnp.asarray(r), jnp.asarray(ids), jnp.asarray(Fk),
                         row_tile=16, **kw)
    assert U_t.shape == np.asarray(U_j).shape
    assert _rel(U_t, U_j) < 1e-12


@pytest.mark.parametrize("shells, tail", LATTICES)
def test_mobility_apply_matches(cloud, shells, tail):
    r, F = cloud
    kw = dict(box=BOX, image_shells=shells, image_tail=tail)
    U_t = rpy.mobility_apply(torch.from_numpy(F[0]), torch.from_numpy(r), A,
                             ETA, True, row_tile=32, **kw)
    U_j = rpy_j.mobility_apply(jnp.asarray(F[0]), jnp.asarray(r), A, ETA,
                               True, row_tile=32, **kw)
    assert _rel(U_t, U_j) < 1e-12


@pytest.mark.parametrize("shells, tail", LATTICES)
def test_mobility_apply_multi_matches(cloud, shells, tail):
    r, F = cloud
    kw = dict(box=BOX, image_shells=shells, image_tail=tail)
    U_t = rpy.mobility_apply_multi(torch.from_numpy(F), torch.from_numpy(r),
                                   A, ETA, True, **kw)
    U_j = rpy_j.mobility_apply_multi(jnp.asarray(F), jnp.asarray(r), A, ETA,
                                     True, **kw)
    assert _rel(U_t, U_j) < 1e-12


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("shells, tail", LATTICES)
def test_mobility_matrix_matches(cloud, shells, tail, wall):
    r, _ = cloud
    kw = dict(box=BOX, image_shells=shells, image_tail=tail)
    M_t = rpy.mobility_matrix(torch.from_numpy(r), A, ETA, wall, **kw)
    M_j = rpy_j.mobility_matrix(jnp.asarray(r), A, ETA, wall, **kw)
    assert M_t.shape == (252, 252)
    assert _rel(M_t, M_j) < 1e-12


def test_image_shells_need_a_2d_box(cloud):
    r, F = cloud
    r_t, F_t = torch.from_numpy(r), torch.from_numpy(F[0])
    for box in (None, (8.0, 8.0, 8.0)):
        with pytest.raises(ValueError, match="2-D"):
            rpy.mobility_apply(F_t, r_t, A, wall=True, box=box,
                               image_shells=1)
    with pytest.raises(ValueError, match="2-D"):
        rpy_cuda.pair_sum(r_t / A, F_t, True, image_shells=1)
    for box in ((32.0,), (32.0, 32.0, 32.0), (32.0, -1.0)):
        with pytest.raises(ValueError, match=r"positive \(Lx, Ly\)"):
            rpy_cuda.pair_sum(r_t / A, F_t, True, box_over_a=box)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shells", [0, 2])
def test_wrapper_matches_pallas_kernel(cloud, shells, k):
    """rpy_cuda.pair_sum (its CPU twin; K1's route at k = 1, K2's at k = 2)
    against rpy_pallas.pair_sum → _kernel_sym / _kernel in interpret mode,
    float32, the seam pairs included (1/L is exact, so both wraps keep
    them)."""
    r, F = cloud
    r32 = (r / A).astype(np.float32)
    F32 = (F[0] if k == 1 else F).astype(np.float32)
    box_n = tuple(b / A for b in BOX)
    U_j = np.asarray(rpy_pallas.pair_sum(
        jnp.asarray(r32), jnp.asarray(F32), True, box_over_a=box_n,
        image_shells=shells, interpret=True))
    U_t = rpy_cuda.pair_sum(torch.from_numpy(r32), torch.from_numpy(F32),
                            True, box_over_a=box_n, image_shells=shells)
    assert U_t.dtype == torch.float32 and U_t.shape == U_j.shape
    assert rpy_cuda.uses_sym(k, 84) == (k == 1)
    assert _rel(U_t, U_j.astype(np.float64)) < KERNEL_TOL


def _wrap_mirror(xi, xj, L):
    """A numpy mirror of the kernels' wrap (csrc/rpy_fields.cuh::wrap):
    the float32 quotient decides unless it lies within its rounding error
    of a half-integer, where the float64 quotient of the exact difference
    does; then fmaf(−n, L, d)."""
    f = np.float32
    xi, xj, L = f(xi), f(xj), f(L)
    d = f(xi - xj)
    q = f(d * f(f(1.0) / L))
    n = f(np.rint(q))
    if abs(abs(f(q - n)) - f(0.5)) <= f(1e-6) * abs(q):
        n = f(np.rint((np.float64(xi) - np.float64(xj)) / np.float64(L)))
    return f(np.float64(d) - np.float64(n) * np.float64(L))


def test_kernel_wrap_takes_the_float64_image():
    """On float32 positions within a few ulps of a seam, and exactly on it,
    the kernels' wrap takes the image of the exact difference, as the
    float64 plain sweep does, and the plain float32 sweep's displacement
    equals it bitwise."""
    rng = np.random.default_rng(5)
    L = np.float32(41.06)
    for _ in range(2000):
        xj = np.float32(rng.uniform(-60, 60))
        half = np.float32(rng.choice([-1.5, -0.5, 0.5, 1.5]) * L)
        xi = np.float32(xj + half)
        for _ in range(rng.integers(0, 4)):
            xi = np.nextafter(xi, np.float32(rng.choice([-1e9, 1e9])))
        got = _wrap_mirror(xi, xj, L)
        want = rpy._displacement(
            torch.tensor([[float(xi), 0.0, 0.0]], dtype=torch.float64),
            torch.tensor([[float(xj), 0.0, 0.0]], dtype=torch.float64),
            (float(L), float(L)))[0, 0, 0].item()
        assert abs(float(got) - want) <= 4 * np.spacing(L), (xi, xj, got, want)
        plain = rpy._displacement(torch.tensor([[xi, 0.0, 0.0]]),
                                  torch.tensor([[xj, 0.0, 0.0]]),
                                  (float(L), float(L)))[0, 0, 0]
        assert plain.dtype == torch.float32 and plain.item() == got


def _f32(x):
    return np.float32(x)


# Float32 blob pairs at a seam or within an ulp of it, in boxes whose 1/L
# is not exact: (L, x_0, x_1), and the image n = round((x_0 − x_1)/L) that
# each float32 wrap takes — the port's (plain sweep and kernels: the exact
# difference, in float64), the JAX package's plain sweep (_wrap_xy:
# fl(fl(x_0 − x_1)/L)) and its Pallas kernels (fl(fl(x_0 − x_1)·fl(1/L))).
SEAM_CASES = {
    # x_0 − x_1 = −L/2 exactly: the Pallas quotient rounds past −0.5
    "tie": (30.6, _f32(9.7), _f32(25.0), (0, 0, -1)),
    # one ulp past −L/2: the Pallas quotient rounds back to −0.5
    "one ulp past": (30.1, np.nextafter(_f32(25.0 - _f32(_f32(30.1) / 2)),
                                        _f32(-1e9)), _f32(25.0), (-1, -1, 0)),
    # x_0 − x_1 exceeds L/2 by 1.5e-7 but rounds to L/2 in float32
    "rounded difference": (30.6, _f32(_f32(-2 / 7) + _f32(_f32(30.6) / 2)),
                           _f32(-2 / 7), (1, 0, 1)),
}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", sorted(SEAM_CASES))
def test_float32_seam_images_depart_from_jax(case, k):
    """Where the port's float32 results depart from the JAX package's: a
    pair within rounding of a seam.  The port takes the image of the exact
    difference, so its float32 plain sweep and its kernels agree (the
    operator jumps at a seam); the JAX package's float32 plain sweep and
    Pallas kernels each round the quotient their own way.  Each of the
    three matches the float64 sweep at the image its rule predicts, and
    two of them differ by the jump exactly where their images differ."""
    L, x0, x1, want = SEAM_CASES[case]
    L32 = float(_f32(L))
    d32 = _f32(x0 - x1)
    n = {"port": np.rint((float(x0) - float(x1)) / L32),
         "jax": np.rint(d32 / _f32(L)),
         "pallas": np.rint(_f32(d32 * _f32(1.0 / L)))}
    assert (n["port"], n["jax"], n["pallas"]) == want
    r32 = np.array([[x0, 3.0, 2.0], [x1, 5.5, 3.1]], np.float32)
    F = np.random.default_rng(9).standard_normal((k, 2, 3))
    Fk = (F[0] if k == 1 else F).astype(np.float32)
    ids = np.arange(2)
    U = {
        "port": rpy_cuda.pair_sum(torch.from_numpy(r32), torch.from_numpy(Fk),
                                  True, box_over_a=(L, L)).numpy(),
        "jax": np.asarray(rpy_j.pair_sum(
            jnp.asarray(r32), jnp.asarray(ids), jnp.asarray(r32),
            jnp.asarray(ids), jnp.asarray(Fk), a=1.0, wall=True, box=(L, L))),
        "pallas": np.asarray(rpy_pallas.pair_sum(
            jnp.asarray(r32), jnp.asarray(Fk), True, box_over_a=(L, L),
            interpret=True)),
    }
    for who, U_who in U.items():
        assert U_who.dtype == np.float32
        r = r32.astype(np.float64)
        r[0, 0] -= n[who] * L32        # blob 0 at the image its rule takes
        ids_t = torch.from_numpy(ids)
        U_ref = rpy.pair_sum(torch.from_numpy(r), ids_t, torch.from_numpy(r),
                             ids_t, torch.from_numpy(F[0] if k == 1 else F),
                             a=1.0, wall=True).numpy()
        assert _rel(U_who, U_ref) < KERNEL_TOL, who
    for one, other in (("port", "jax"), ("port", "pallas"), ("jax", "pallas")):
        jump = _rel(U[one], U[other].astype(np.float64))
        assert (jump > 1e-2) == (n[one] != n[other]), (one, other, jump)


def test_config_takes_the_film_box():
    cfg = rt.SimulationConfig(wall=True, box=[10, 10], image_shells=2)
    assert cfg.box == (10.0, 10.0) and cfg.image_shells == 2
    with pytest.raises(ValueError, match="2-D"):
        rt.SimulationConfig(wall=True, image_shells=1)
    with pytest.raises(ValueError, match="2-D"):
        rt.SimulationConfig(box=(10.0, 10.0, 10.0), image_shells=1)
    with pytest.raises(ValueError, match="incompatible"):
        rt.SimulationConfig(box=(10.0, 10.0, 10.0), wall=True)
    # the film's far field: accepted with the wall and image_shells ≥ 1,
    # refused without either, as in the JAX package
    cfg = rt.SimulationConfig(wall=True, box=(10.0, 10.0), image_shells=1,
                              farfield_grid=(4, 4, 2), gmres_tol=5e-3)
    assert cfg.farfield_grid == (4, 4, 2) and cfg.image_shells == 1
    with pytest.raises(ValueError, match="image_shells"):
        rt.SimulationConfig(wall=True, box=(10.0, 10.0),
                            farfield_grid=(4, 4, 2), gmres_tol=5e-3)
    with pytest.raises(ValueError, match="wall"):
        rt.SimulationConfig(box=(10.0, 10.0), image_shells=1,
                            farfield_grid=(4, 4, 2), gmres_tol=5e-3)
