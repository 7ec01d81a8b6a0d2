"""The CUDA kernels on the card (the pair sweeps K1/K2, the far field's
near sweep K3, the Ewald real-space sweep K4 and the FP32 peak probe P),
against their plain PyTorch versions, with the distributed path's forms
(K2's slab entry at nonzero offsets, K3's row-tile slice, K4's slab
form); the RigidBody API through K1; the
balanced-split Ewald operator on the card against the CPU, and its tile
kernel K4 tiles against its plain twin; and the adjoints: K1's autograd Function against autograd
through the plain sweep, and the raises of the kernels without a backward.

Marked ``cuda``: they skip without a CUDA device.  The GPU machine has no
JAX, so run them there without the JAX test harness's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rigid_body_light_tpu_torch as rt  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald, ewald_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_cells, ewald_pme  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield, farfield_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import kinematics, rpy, rpy_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import tiles  # noqa: E402
from rigid_body_light_tpu_torch.utils import roofline  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 5e-6   # float32 kernel vs float64 plain sweep, relative to max|U|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the pair-sweep kernels run only there")
    rpy_cuda.build()
    return torch.device("cuda", 0)


@pytest.fixture
def cloud(dev):
    """700 blobs (units of a) whose heights straddle the 0.75a floor."""
    rng = np.random.default_rng(1)
    r = rng.uniform([-10, -10, 0.3], [10, 10, 7], (700, 3))
    F = rng.standard_normal((2, 700, 3))
    return torch.from_numpy(r).to(dev), torch.from_numpy(F).to(dev)


def _rel(U, ref):
    return ((U.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("wall", [False, True])
def test_k1_matches_plain(cloud, wall):
    r, F = cloud
    ids = torch.arange(r.shape[0], device=r.device)
    ref = rpy.pair_sum(r, ids, r, ids, F[0], wall=wall)
    U = rpy_cuda.pair_sweep_sym(r.float().contiguous(),
                                F[0].float().contiguous(), wall, 0.75)
    torch.cuda.synchronize()
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_k2_slab_matches_plain(cloud, wall, k):
    """Rows 100..399 against all columns, with the global row offset."""
    r, F = cloud
    ids = torch.arange(r.shape[0], device=r.device)
    ref = rpy.pair_sum(r[100:400], ids[100:400], r, ids, F[:k], wall=wall)
    r32 = r.float().contiguous()
    U = rpy_cuda.pair_sweep_ordered(r32[100:400].contiguous(), 100, r32,
                                    F[:k].float().contiguous(), 0, wall, 0.75)
    torch.cuda.synchronize()
    assert U.shape == (k, 300, 3)
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("n", [1, 2, 31, 33, 129, 515])
def test_ragged_sizes_match_plain(dev, n):
    """Sizes off every tile edge (K1's 32-column sub-tiles and 128 × 128
    items, K2's 64-row blocks and 256-column chunks)."""
    rng = np.random.default_rng(n)
    r = torch.from_numpy(rng.uniform([-6, -6, 0.3], [6, 6, 5], (n, 3))).to(dev)
    F = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev)
    ids = torch.arange(n, device=dev)
    r32, F32 = r.float().contiguous(), F.float().contiguous()
    U1 = rpy_cuda.pair_sweep_sym(r32, F32[0], True, 0.75)
    U2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, True, 0.75)
    torch.cuda.synchronize()
    ref = rpy.pair_sum(r, ids, r, ids, F, wall=True)
    if n == 1:   # no pairs: exact zeros
        assert not U1.any() and not U2.any()
        return
    assert _rel(U1, ref[0]) < TOL
    assert _rel(U2, ref) < TOL


def test_k2_block_offsets_match_plain(cloud):
    """A row block × column block of the pair matrix with both global
    offsets (the 2-D sharded-slab contract), self pairs inside the
    overlap masked."""
    r, F = cloud
    ids = torch.arange(r.shape[0], device=r.device)
    rows, cols = slice(100, 400), slice(250, 650)
    ref = rpy.pair_sum(r[rows], ids[rows], r[cols], ids[cols], F[:, cols],
                       wall=True)
    r32 = r.float()
    U = rpy_cuda.pair_sweep_ordered(
        r32[rows].contiguous(), 100, r32[cols].contiguous(),
        F[:, cols].float().contiguous(), 250, True, 0.75)
    torch.cuda.synchronize()
    assert _rel(U, ref) < TOL


def test_k1_is_repeatable_and_counted(cloud):
    r, F = cloud
    r32, F32 = r.float().contiguous(), F[0].float().contiguous()
    before = rpy_cuda.sym_launches
    U1 = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75)
    U2 = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75)
    assert rpy_cuda.sym_launches == before + 2
    assert torch.equal(U1, U2)   # no atomics: bitwise repeatable


@pytest.mark.parametrize("wall", [False, True])
def test_k1_two_rhs_matches_plain(cloud, wall):
    """K1 at 2 RHS, the form _kernel_sym has: both RHS share the fields."""
    r, F = cloud
    ids = torch.arange(r.shape[0], device=r.device)
    ref = rpy.pair_sum(r, ids, r, ids, F, wall=wall)
    before = rpy_cuda.sym_launches
    U = rpy_cuda.pair_sweep_sym(r.float().contiguous(), F.float().contiguous(),
                                wall, 0.75)
    torch.cuda.synchronize()
    assert rpy_cuda.sym_launches == before + 1
    assert U.shape == (2, r.shape[0], 3) and U.dtype == torch.float32
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 31, 33, 127, 129, 257, 515])
def test_ragged_sizes_both_kernels_match_plain(dev, n, k):
    """K1 and K2 at 1 and 2 RHS off every edge: K1's 32-column halves of
    its 64-column steps and its 128 × 128 items (257 leaves one blob in the
    last tile), K2's 32-row lane halves, 64-row blocks and 256-column
    chunks."""
    rng = np.random.default_rng(100 + n)
    r = torch.from_numpy(rng.uniform([-6, -6, 0.3], [6, 6, 5], (n, 3))).to(dev)
    F = torch.from_numpy(rng.standard_normal((k, n, 3))).to(dev)
    ids = torch.arange(n, device=dev)
    r32, F32 = r.float().contiguous(), F.float().contiguous()
    for wall in (False, True):
        U1 = rpy_cuda.pair_sweep_sym(r32, F32, wall, 0.75)
        U2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, wall, 0.75)
        torch.cuda.synchronize()
        assert U1.shape == U2.shape == (k, n, 3)
        if n == 1:   # no pairs: exact zeros
            assert not U1.any() and not U2.any()
            continue
        ref = rpy.pair_sum(r, ids, r, ids, F, wall=wall)
        assert _rel(U1, ref) < TOL
        assert _rel(U2, ref) < TOL


def test_k1_two_rhs_and_k2_are_repeatable(cloud):
    r, F = cloud
    r32, F32 = r.float().contiguous(), F.float().contiguous()
    for k in (1, 2):
        Fk = F32[:k].contiguous()
        assert torch.equal(rpy_cuda.pair_sweep_sym(r32, Fk, True, 0.75),
                           rpy_cuda.pair_sweep_sym(r32, Fk, True, 0.75))
        a = rpy_cuda.pair_sweep_ordered(r32[100:400].contiguous(), 100, r32,
                                        Fk, 0, True, 0.75)
        b = rpy_cuda.pair_sweep_ordered(r32[100:400].contiguous(), 100, r32,
                                        Fk, 0, True, 0.75)
        assert torch.equal(a, b)


@pytest.mark.parametrize("n, sym", [(65024, False), (65025, True)])
def test_two_rhs_dispatch_follows_the_pallas_rule(dev, n, sym):
    """A 2-RHS mobility product goes to K1 once n padded to 512 reaches
    65,536 (rpy_pallas.py:623), else to K2; the two kernels agree."""
    rng = np.random.default_rng(12)
    r = torch.from_numpy(rng.uniform([0, 0, 0.5], [300, 300, 20], (n, 3))
                         ).to(dev).float()
    F = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
    before = rpy_cuda.launch_counts()
    U = rpy_cuda.mobility_apply_multi(F, r, wall=True)
    after = rpy_cuda.launch_counts()
    assert after["pair_sweep_sym"] - before["pair_sweep_sym"] == int(sym)
    assert (after["pair_sweep_ordered"] - before["pair_sweep_ordered"]
            == int(not sym))
    assert U.shape == (2, n, 3) and torch.isfinite(U).all()
    P1 = rpy_cuda.pair_sweep_sym(r, F, True, 0.75)
    P2 = rpy_cuda.pair_sweep_ordered(r, 0, r, F, 0, True, 0.75)
    assert _rel(P1, P2.double()) < TOL


def test_kernel_refuses_float64(cloud):
    r, F = cloud
    with pytest.raises(TypeError, match="float32"):
        rpy_cuda.pair_sweep_sym(r, F[0], True, 0.75)


@pytest.fixture
def near(dev):
    """A 1,500-blob cloud in two clumps (so some cells are empty), heights
    straddling the 0.75a floor, sorted and tiled by the far field's
    prepare on a (5, 5, 3) grid; float64 on the card."""
    farfield_cuda.build()
    rng = np.random.default_rng(3)
    r = np.concatenate([rng.uniform([0, 0, 0.3], [8, 8, 6], (800, 3)),
                        rng.uniform([14, 14, 0.3], [20, 20, 6], (700, 3))])
    ctx = farfield.prepare(torch.from_numpy(r).to(dev), wall=True,
                           grid=(5, 5, 3), p=4)
    n_pad = ctx.x_s.shape[0]
    F = torch.from_numpy(rng.standard_normal((2, n_pad, 3))).to(dev)
    return ctx, F


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_k3_matches_plain(near, wall, k):
    ctx, F = near
    live = ctx.id_s >= 0
    ref = farfield._near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s, F[:k], ctx.nbr,
                               wall, 0.75)
    before = farfield_cuda.near_launches
    U = farfield_cuda.near_sweep(ctx.x_s, ctx.ci_s, live, F[:k], ctx.nbr,
                                 wall, 0.75, pairs=(ctx.pairs, ctx.n_pairs))
    torch.cuda.synchronize()
    assert farfield_cuda.near_launches == before + 1
    assert U.shape == (k, ctx.x_s.shape[0], 3) and U.dtype == torch.float32
    assert _rel(U[:, live], ref[:, live]) < TOL


@pytest.mark.parametrize("k", [1, 2])
def test_k3_is_repeatable(near, k):
    ctx, F = near
    args = (ctx.x_s.float().contiguous(), ctx.ci_s.contiguous(),
            (ctx.id_s >= 0).contiguous(), F[:k].float().contiguous(),
            ctx.nbr, ctx.pairs, ctx.n_pairs, True, 0.75)
    U1 = farfield_cuda.near_sweep_kernel(*args)
    U2 = farfield_cuda.near_sweep_kernel(*args)
    assert torch.equal(U1, U2)   # one writer per partial, no atomics


@pytest.mark.parametrize("k", [1, 2])
def test_k3_diagonal_only_tiles_and_pad_twins(dev, k):
    """Three clumps in cells far apart (128, 128 and 70 blobs in cell-snake
    order): each tile lists only itself, so K3 sweeps diagonal pairs alone,
    and the last tile's 58 pad rows sit on its last real blob, at zero
    separation from it — only the live mask keeps those pairs out.  A
    single partial tile (one list of one entry) too."""
    farfield_cuda.build()
    rng = np.random.default_rng(6)
    clouds = [np.concatenate([
        rng.uniform([0, 0, 0.3], [3, 3, 3], (128, 3)),
        rng.uniform([0, 40, 0.3], [3, 43, 3], (128, 3)),
        rng.uniform([40, 0, 0.3], [43, 3, 3], (70, 3))]),
        rng.uniform([0, 0, 0.3], [4, 4, 3], (90, 3))]
    for r in clouds:
        ctx = farfield.prepare(torch.from_numpy(r).to(dev), wall=True,
                               grid=(4, 4, 1), p=4)
        t = ctx.nbr.shape[0]
        assert int(ctx.n_pairs.item()) == t
        assert (ctx.nbr[:, 0].cpu() == torch.arange(t)).all()
        live = ctx.id_s >= 0
        F = torch.from_numpy(rng.standard_normal(
            (k, ctx.x_s.shape[0], 3))).to(dev)
        ref = farfield._near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s, F, ctx.nbr,
                                   True, 0.75)
        U = farfield_cuda.near_sweep(ctx.x_s, ctx.ci_s, live, F, ctx.nbr,
                                     True, 0.75,
                                     pairs=(ctx.pairs, ctx.n_pairs))
        torch.cuda.synchronize()
        assert torch.isfinite(U[:, live]).all()
        assert _rel(U[:, live], ref[:, live]) < TOL


def test_k3_needs_the_pair_list(near):
    ctx, F = near
    with pytest.raises(ValueError, match="tile-pair list"):
        farfield_cuda.near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s >= 0, F,
                                 ctx.nbr, True, 0.75)


def test_k3_refuses_three_rhs(near):
    ctx, F = near
    F3 = torch.cat([F, F[:1]]).float().contiguous()
    with pytest.raises(ValueError, match="at most 2 RHS"):
        farfield_cuda.near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s >= 0, F3,
                                 ctx.nbr, True, 0.75)
    with pytest.raises(ValueError, match="1 or 2 RHS"):
        farfield_cuda.near_sweep_kernel(
            ctx.x_s.float().contiguous(), ctx.ci_s, ctx.id_s >= 0, F3,
            ctx.nbr, ctx.pairs, ctx.n_pairs, True, 0.75)


def test_far_field_operator_through_k3(near):
    """float32 through K3 against float64 through the plain sweep, and the
    far field against the exact operator at its interpolation error."""
    ctx, _ = near
    r = ctx.x_s[ctx.id_s >= 0]
    F = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(r.shape))).to(r.device)
    kw = dict(wall=True, grid=(5, 5, 3), p=4)
    before = farfield_cuda.near_launches
    U32 = farfield.mobility_apply(F.float(), r.float(), **kw)
    U64 = farfield.mobility_apply(F, r, **kw)
    assert farfield_cuda.near_launches == before + 1
    assert _rel(U32, U64) < 1e-5
    # no atomic sums anywhere in the operator: it repeats bitwise
    assert torch.equal(U32, farfield.mobility_apply(F.float(), r.float(),
                                                    **kw))
    # p = 4 interpolation error on this coarse (5, 5, 3) grid: 1.07e-2 for
    # this draw, and 1.08e-2 with every blob lifted 0.45a, above the 0.75a
    # wall floor, so the floor is not its cause (both float64, the plain
    # near sweep).  5e-3 is the JAX config's estimate for regular
    # suspensions on a finer grid.
    for lift in (0.0, 0.45):
        rl = r + torch.tensor([0.0, 0.0, lift], dtype=r.dtype, device=r.device)
        exact = rpy.mobility_apply(F, rl, wall=True)
        assert _rel(farfield.mobility_apply(F, rl, **kw), exact) < 2e-2


@pytest.fixture
def film_near(dev):
    """The edge clouds of chip_smoke.py's phase 24 (across both seams, on
    the g = 4 seam tie, a tile meeting itself across the seam), each with
    its far-field context (float32, the main path's), its float32 box as
    the kernel sees it and forces."""
    from chip_smoke import film_near_clouds

    farfield_cuda.build()
    rng = np.random.default_rng(12)
    out = {}
    for name, (r, box, grid) in film_near_clouds().items():
        ctx = farfield.prepare(torch.from_numpy(r).to(dev), wall=True,
                               grid=grid, p=3, box=box, image_shells=1)
        F = torch.from_numpy(rng.standard_normal(
            (2, ctx.x_s.shape[0], 3)).astype(np.float32)).to(dev)
        out[name] = (ctx, F, tuple(float(np.float32(b)) for b in box),
                     grid[:2])
    return out


def test_film_tie_cloud_has_its_pairs(film_near):
    """The tie cloud gives what it is for: blobs wrapped to exactly L in
    the clipped last cell, and a tile that lists itself across the seam in
    the self cloud."""
    ctx, _, box, _ = film_near["ties"]
    x = ctx.x_s[ctx.id_s >= 0]
    assert (x[:, 0] == box[0]).sum() == 3 and (x[:, 1] == box[1]).sum() == 2
    ctx, _, _, _ = film_near["self"]
    span = ctx.ci_s[:128, 0]
    assert int(span.min()) == 0 and int(span.max()) == 3
    assert ctx.nbr.tolist() == [[0, 1], [0, 1]]
    assert int(ctx.n_pairs.item()) == 3


@pytest.mark.parametrize("cloud", ["ragged", "ties", "self"])
@pytest.mark.parametrize("k", [1, 2])
def test_k3_box_form_matches_plain(film_near, cloud, k):
    """K3's box form against the float64 plain near sweep on the same
    float32 inputs and box (so both take the same image of every pair,
    the ties included)."""
    ctx, F, box, wrap = film_near[cloud]
    live = ctx.id_s >= 0
    ref = farfield._near_sweep(ctx.x_s.double(), ctx.ci_s, ctx.id_s,
                               F[:k].double(), ctx.nbr, True, 0.75,
                               box_n=box, wrap_xy=wrap)
    before = farfield_cuda.near_launches
    U = farfield_cuda.near_sweep(ctx.x_s, ctx.ci_s, live, F[:k], ctx.nbr,
                                 True, 0.75, pairs=(ctx.pairs, ctx.n_pairs),
                                 box_over_a=box, wrap_cells=wrap)
    torch.cuda.synchronize()
    assert farfield_cuda.near_launches == before + 1
    assert torch.isfinite(U[:, live]).all()
    assert _rel(U[:, live], ref[:, live]) < TOL


@pytest.mark.parametrize("k", [1, 2])
def test_k3_box_form_is_repeatable(film_near, k):
    for ctx, F, box, wrap in film_near.values():
        args = (ctx.x_s.contiguous(), ctx.ci_s.contiguous(),
                (ctx.id_s >= 0).contiguous(), F[:k].contiguous(), ctx.nbr,
                ctx.pairs, ctx.n_pairs, True, 0.75, box, wrap)
        assert torch.equal(farfield_cuda.near_sweep_kernel(*args),
                           farfield_cuda.near_sweep_kernel(*args))


def test_film_operator_through_k3(film_near):
    """The film's far field in float32 through K3's box form against
    float64 through the plain sweep."""
    ctx, _, _, _ = film_near["ragged"]
    r = ctx.x_s[ctx.id_s >= 0].double()
    F = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(r.shape))).to(r.device)
    kw = dict(wall=True, grid=(6, 5, 2), p=3, box=(24.0, 20.0),
              image_shells=2)
    before = farfield_cuda.near_launches
    U32 = farfield.mobility_apply(F.float(), r.float(), **kw)
    U64 = farfield.mobility_apply(F, r, **kw)
    assert farfield_cuda.near_launches == before + 1
    assert _rel(U32, U64) < 1e-5
    # no atomic sums anywhere in the operator: it repeats bitwise
    assert torch.equal(U32, farfield.mobility_apply(F.float(), r.float(),
                                                    **kw))


@pytest.fixture(scope="module")
def ewald_boxes():
    """Two operators alive at once: (9, 11, 10) with a = 0.45 at the
    default tolerance (degree 58) and the periodic slice's cubic L = 14
    box with a = 0.0675 at 1e-4 (degree 81)."""
    return (ewald.make_params((9.0, 11.0, 10.0), 0.45),
            ewald.make_params((14.0, 14.0, 14.0), 0.06752767533299997,
                              tol=1e-4))


def _periodic_cloud(dev, box, n, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 1, (n, 3)) * np.asarray(box)
    F = rng.standard_normal((2, n, 3))
    return torch.from_numpy(r).to(dev), torch.from_numpy(F).to(dev)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("k", [1, 2])
def test_k4_matches_plain(dev, ewald_boxes, which, k):
    """K4 (float32) against the float64 Clenshaw sweep on the same fit."""
    params = ewald_boxes[which]
    r, F = _periodic_cloud(dev, params.box, 700, 11)
    ref = ewald.real_space_apply(F[:k], r, params, cheb=True)
    before = ewald_cuda.sweep_launches
    U = ewald_cuda.real_pair_sum(F[:k], r, params)
    torch.cuda.synchronize()
    assert ewald_cuda.sweep_launches == before + 1
    assert U.shape == (k, 700, 3) and U.dtype == torch.float32
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("n", [1, 2, 31, 33, 129, 257, 515, 1025])
def test_k4_ragged_sizes_match_plain(dev, ewald_boxes, n):
    """Sizes off every edge of K4's work items (32-column sub-tiles, 64
    columns a thread's pair of sub-tiles, 128 × 128 items, so a ragged last
    item row and column; 257 leaves one blob in the last tile), with pairs
    closer than 2a (the overlap segment).
    The cloud's side grows with n at a fixed density, so that a few blobs
    are neighbours too (beyond min(L)/2 the fields are below the Ewald
    tolerance, and max|U| would be no scale to compare against)."""
    params = ewald_boxes[0]
    side = np.minimum(params.box, 2.5 * params.a * n ** (1 / 3))
    r, F = _periodic_cloud(dev, side, n, n)
    if n > 2:
        r[1] = r[0] + 0.3 * params.a     # segment 1
        r[2] = r[0] + 0.01 * params.a    # below the clamp radius
    U = ewald_cuda.real_pair_sum(F, r, params)
    torch.cuda.synchronize()
    if n == 1:   # no pairs: exact zeros
        assert not U.any()
        return
    ref = ewald.real_space_apply(F, r, params, cheb=True)
    assert torch.isfinite(U).all() and _rel(U, ref) < TOL


def test_k4_is_repeatable_and_operators_do_not_mix(dev, ewald_boxes):
    """Two launches agree bitwise (no atomics), also with another box's
    operator launched in between: every launch carries its own table."""
    p0, p1 = ewald_boxes
    r, F = _periodic_cloud(dev, p0.box, 700, 5)
    r32, F32 = r.float().contiguous(), F.float().contiguous()
    U1 = ewald_cuda.real_sweep_kernel(r32, F32, p0)
    V1 = ewald_cuda.real_sweep_kernel(r32, F32, p1)
    U2 = ewald_cuda.real_sweep_kernel(r32, F32, p0)
    V2 = ewald_cuda.real_sweep_kernel(r32, F32, p1)
    assert torch.equal(U1, U2) and torch.equal(V1, V2)
    assert not torch.equal(U1, V1)
    assert _rel(V1, ewald.real_space_apply(F, r, p1, cheb=True)) < TOL


def test_k4_table_is_kept_per_operator(dev, ewald_boxes):
    """The coefficient table goes to the device once per operator and is
    reused; two operators launched in turn keep their own tables, and an
    operator with equal contents but another identity gets its own entry
    and the same result."""
    p0, p1 = ewald_boxes
    r, F = _periodic_cloud(dev, p0.box, 300, 8)
    r32, F32 = r.float().contiguous(), F[:1].float().contiguous()
    U0 = ewald_cuda.real_sweep_kernel(r32, F32, p0)
    t0 = ewald_cuda.operator_tables(p0, r32.device)
    ewald_cuda.real_sweep_kernel(r32, F32, p1)
    t1 = ewald_cuda.operator_tables(p1, r32.device)
    assert ewald_cuda.operator_tables(p0, r32.device)[0] is t0[0]
    assert t1[0] is not t0[0] and t1[2] != t0[2]
    twin = p0._replace()
    assert torch.equal(ewald_cuda.real_sweep_kernel(r32, F32, twin), U0)
    assert ewald_cuda.operator_tables(twin, r32.device)[0] is not t0[0]
    assert torch.equal(ewald_cuda.real_sweep_kernel(r32, F32, p0), U0)


def test_k4_refuses_float64_and_three_rhs(dev, ewald_boxes):
    params = ewald_boxes[0]
    r, F = _periodic_cloud(dev, params.box, 100, 2)
    with pytest.raises(TypeError, match="float32"):
        ewald_cuda.real_sweep_kernel(r, F, params)
    F3 = torch.cat([F, F[:1]]).float().contiguous()
    with pytest.raises(ValueError, match="1 or 2 RHS"):
        ewald_cuda.real_sweep_kernel(r.float().contiguous(), F3, params)
    with pytest.raises(NotImplementedError, match="RHS"):
        ewald_cuda.real_pair_sum(F3, r, params)


def test_ewald_operator_through_k4(dev, ewald_boxes):
    """float32 through K4 against float64 with the closed-form scalars
    (the fit is 3e-6 of scale), and the operator's symmetry."""
    params = ewald_boxes[1]
    r, F = _periodic_cloud(dev, params.box, 700, 7)
    before = ewald_cuda.sweep_launches
    U = ewald_cuda.mobility_apply_multi(F, r, params)
    assert ewald_cuda.sweep_launches == before + 1
    ref = ewald.mobility_apply_multi(F, r, params)
    assert _rel(U, ref) < 1e-4
    U0 = ewald_cuda.mobility_apply(F[0], r, params)
    assert torch.equal(U0, ewald_cuda.mobility_apply_multi(F[:1], r,
                                                           params)[0])
    f1m2 = (F[0] * U[1].double()).sum().item()
    f2m1 = (F[1] * U[0].double()).sum().item()
    assert abs(f1m2 - f2m1) / abs(f1m2) < 1e-5


SLAB_F32_MARGIN = 1e-6  # the slab form's error over the float32 plain
# block's on the same inputs, relative to max|U|


def _slab_case(dev, box, case):
    """(rows, row0, columns, col0, column forces) of a slab case.  On 700
    columns and 333 other rows (a last row block of 77 of the kernel's
    128, a last chunk of 28 of 32): rows apart from the columns, rows
    inside them at offsets 0 and 100 (their self pairs masked), the
    columns against themselves, fewer rows than a block against fewer
    columns than a chunk, one column.  On clouds of 20·c + 7 columns for
    c = 32 and 64 (647 and 1,287: last chunks of 7 of 32 columns)
    and 589 other rows (a last row block of 77): rows apart from the
    columns and inside them at offset 50."""
    if case.startswith("ragged"):
        c = int(case.rsplit("_", 1)[1])
        cols, F = _periodic_cloud(dev, box, 20 * c + 7, 13)
        rows = _periodic_cloud(dev, box, 589, 14)[0]
        if "inside" in case:
            return cols[50:639], 50, cols, 0, F
        return rows, 0, cols, 20 * c + 7, F
    cols, F = _periodic_cloud(dev, box, 700, 13)
    rows = _periodic_cloud(dev, box, 333, 14)[0]
    return {"apart": (rows, 0, cols, 700, F),
            "inside_0": (cols[:333], 0, cols, 0, F),
            "inside_100": (cols[100:433], 100, cols, 0, F),
            "whole": (cols, 0, cols, 0, F),
            "few": (rows[:5], 0, cols[:29], 700, F[:, :29]),
            "one_column": (rows, 0, cols[:1], 700, F[:, :1])}[case]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", ["apart", "inside_0", "inside_100",
                                  "whole", "few", "one_column", "ragged_32",
                                  "ragged_64", "ragged_inside_32",
                                  "ragged_inside_64"])
def test_k4_slab_matches_plain(dev, ewald_boxes, which, k, case):
    """K4's slab form (ordered rows × columns at global offsets, the pair
    of equal ids left out) against the float64 Clenshaw block on the same
    fit: ragged last row blocks and column chunks, rows apart from the
    columns and inside them (their self pairs masked), the block against
    itself, fewer rows than a block and columns than a chunk, one column;
    within TOL of max|U|, and within SLAB_F32_MARGIN of the float32 plain
    block's error on the same inputs (printed beside it); two launches
    bitwise equal, each counted."""
    params = ewald_boxes[which]
    rows, row0, cols, col0, F = _slab_case(dev, params.box, case)
    n_r, n_c = rows.shape[0], cols.shape[0]
    row_ids = row0 + torch.arange(n_r, device=dev)
    col_ids = col0 + torch.arange(n_c, device=dev)
    ref = ewald.real_space_block(rows, row_ids, cols, col_ids, F[:k], params,
                                 cheb=True)
    plain = ewald.real_space_block(rows.float(), row_ids, cols.float(),
                                   col_ids, F[:k].float(), params, cheb=True)
    before = ewald_cuda.slab_launches
    U = ewald_cuda.real_pair_sum_slab(F[:k], rows, row0, cols, col0, params)
    V = ewald_cuda.real_pair_sum_slab(F[:k], rows, row0, cols, col0, params)
    torch.cuda.synchronize()
    assert ewald_cuda.slab_launches == before + 2
    assert U.shape == (k, n_r, 3) and U.dtype == torch.float32
    assert torch.equal(U, V)
    err, err_plain = _rel(U, ref), _rel(plain, ref)
    print(f"K4 slab {case} box {which} k={k}: {err:.3e} of max|U|, the "
          f"float32 plain block {err_plain:.3e}")
    assert err < TOL
    assert err <= err_plain + SLAB_F32_MARGIN


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_k4_slab_ring_matches_float64(dev, ewald_boxes, D, k):
    """The distributed ring's real part in one process: each rank's rows
    against every rank's block (ewald.ring_slab: K4's sweep on the
    diagonal block, the slab form on the others), summed in the ring's
    order, against the float64 Clenshaw sweep of all pairs, at the
    periodic slice's box and fit; D·(D − 1) slab launches, D sweeps."""
    params = ewald_boxes[1]
    n = 1000
    r, F = _periodic_cloud(dev, params.box, n, 17)
    r32, F32 = r.float().contiguous(), F[:k].float().contiguous()
    ref = ewald.real_space_apply(F[:k], r, params, cheb=True)
    m = n // D
    slabs, sweeps = ewald_cuda.slab_launches, ewald_cuda.sweep_launches
    U = torch.empty((k, n, 3), dtype=torch.float32, device=dev)
    for idx in range(D):
        rows = slice(idx * m, (idx + 1) * m)
        acc = None
        for s in range(D):
            src = (idx - s) % D
            cols = slice(src * m, (src + 1) * m)
            part = ewald.ring_slab(F32[:, cols].contiguous(), r32[rows],
                                   idx * m, r32[cols], src * m, params,
                                   use_kernel=True, diagonal=s == 0)
            acc = part if acc is None else acc + part
        U[:, rows] = acc
    torch.cuda.synchronize()
    assert ewald_cuda.slab_launches == slabs + D * (D - 1)
    assert ewald_cuda.sweep_launches == sweeps + D
    assert _rel(U, ref) < TOL


def test_k4_slab_refuses_float64_three_rhs_and_grad(dev, ewald_boxes):
    params = ewald_boxes[0]
    r, F = _periodic_cloud(dev, params.box, 100, 2)
    with pytest.raises(TypeError, match="float32"):
        ewald_cuda.real_slab_kernel(r, 0, r, 0, F, params)
    F3 = torch.cat([F, F[:1]])
    with pytest.raises(NotImplementedError, match="RHS"):
        ewald_cuda.real_pair_sum_slab(F3, r, 0, r, 0, params)
    with pytest.raises(RuntimeError, match="no backward"):
        ewald_cuda.real_pair_sum_slab(F.float().requires_grad_(), r, 0, r,
                                      0, params)


def test_fma_probe_matches_plain(dev):
    """P fuses each step (one rounding), the plain chain multiplies, then
    adds (two): 64 steps of at most half an ulp each, averaged over the
    row, stay inside 1e-6 relative."""
    rng = np.random.default_rng(9)
    n = 1300    # ragged: 11 row tiles, 3 column chunks
    x = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(dev)
    before = roofline.peak_launches
    out = roofline.fma_chain(x, c)
    out2 = roofline.fma_chain(x, c)
    torch.cuda.synchronize()
    assert roofline.peak_launches == before + 2
    assert torch.equal(out, out2)
    ref = roofline.fma_chain_plain(x.double(), c.double())
    assert _rel(out, ref) < 1e-6
    assert _rel(roofline.fma_chain_plain(x, c), ref) < 1e-6
    with pytest.raises(TypeError, match="float32"):
        roofline.fma_chain_kernel(x.double(), c.double())
    with pytest.raises(ValueError, match="chains 64"):
        roofline.fma_chain(x, c, chain=8)
    ms, tflops = roofline.measure_fp32_peak(n=2048, reps=3)
    assert ms > 0 and 0 < tflops < 200


def test_entry_points_default_to_the_card(dev):
    _, ref = rt.load_structure("shell_N_12")
    state = rt.make_state(np.zeros((1, 3)), np.array([[1.0, 0, 0, 0]]))
    geom = kinematics.make_ref_geometry(ref)
    assert state.X.device.type == "cuda" and state.Q.device.type == "cuda"
    assert geom.ref_cfg.device.type == "cuda"


@pytest.mark.parametrize("n", [65_664, 100_000])
@pytest.mark.parametrize("k", [1, 2])
def test_k1_grouped_tiles_match_plain_and_repeat(dev, n, k):
    """Past 65,536 blobs a K1 block walks a pair of tile groups
    (``tiles.sweep_groups``: 513 tiles in 256 groups, one of 3; 782 tiles
    in 256 groups, 14 of 4) into O(n) partials: against the float64 plain
    sweep on 512 sampled rows, wall, bitwise repeatable, and the scratch
    the wrapper allocates is ``tiles.partial_shape``'s."""
    from rigid_body_light_tpu_torch.ops import tiles

    rng = np.random.default_rng(n + k)
    side = (n / 1.5) ** 0.5
    r = torch.from_numpy(rng.uniform([0, 0, 0.5], [side, side, 12.0],
                                     (n, 3))).to(dev)
    F = torch.from_numpy(rng.standard_normal((k, n, 3))).to(dev)
    r32, F32 = r.float().contiguous(), F.float().contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    U = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75)
    torch.cuda.synchronize()
    scratch = 2 * 4 * int(np.prod(tiles.partial_shape(n, k)))
    assert torch.cuda.max_memory_allocated(dev) - base <= (
        scratch + 12 * k * n + 4 * 2**20)
    rows = torch.from_numpy(np.sort(rng.choice(n, 512, replace=False))).to(dev)
    ids = torch.arange(n, device=dev)
    ref = rpy.pair_sum(r.float().double()[rows], rows, r32.double(), ids,
                       F32.double(), wall=True, row_tile=64)
    assert _rel(U[:, rows], ref) < TOL
    assert torch.equal(U, rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75))


@pytest.mark.parametrize("k", [1, 2])
def test_k4_grouped_tiles_match_plain_and_repeat(dev, ewald_boxes, k):
    """K4 over tile groups (65,664 blobs in the L = 14 box: 513 tiles in
    256 groups, one of 3): against the float64 Clenshaw sweep on 256
    sampled rows, bitwise repeatable."""
    params = ewald_boxes[1]
    n = 65_664
    r, F = _periodic_cloud(dev, params.box, n, 5)
    U = ewald_cuda.real_pair_sum(F[:k], r, params)
    torch.cuda.synchronize()
    rows = torch.from_numpy(np.sort(np.random.default_rng(6).choice(
        n, 256, replace=False))).to(dev)
    ref = ewald.real_space_block(r[rows], rows, r, torch.arange(n, device=dev),
                                 F[:k], params, cheb=True)
    assert _rel(U[:, rows], ref) < TOL
    assert torch.equal(U, ewald_cuda.real_pair_sum(F[:k], r, params))


@pytest.fixture
def film(dev):
    """900 blobs (units of a) spread across the edges of a (40, 36) box and
    over the 0.75a height floor, two pairs exactly on the seams; float32
    values and the same values in float64."""
    rng = np.random.default_rng(8)
    r = rng.uniform([-6, -6, 0.3], [46, 42, 7], (900, 3)).astype(np.float32)
    r[1] = (3.0, 5.0, 1.0)
    r[2] = (23.0, 5.0, 2.0)      # Δx = −20 = −Lx/2
    r[3] = (7.5, 30.0, 1.5)
    r[4] = (7.5, 12.0, 0.5)      # Δy = +18 = +Ly/2
    F = rng.standard_normal((2, 900, 3)).astype(np.float32)
    r32 = torch.from_numpy(r).to(dev)
    F32 = torch.from_numpy(F).to(dev)
    return r32, F32, (40.0, 36.0)


def _film_ref(r32, F32, box, shells, rows=None):
    """The float64 plain sweep on the kernels' own float32 inputs."""
    n = r32.shape[0]
    ids = torch.arange(n, device=r32.device)
    rows = ids if rows is None else rows
    r64 = r32.double()
    return rpy.pair_sum(r64[rows], rows, r64, ids, F32.double(), wall=True,
                        box=box, image_shells=shells, row_tile=64)


@pytest.mark.parametrize("shells", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2])
def test_box_forms_match_plain(film, shells, k):
    """K1 (plus the self-image diagonal) and K2 in the box, minimum image
    and image lattice, against the float64 plain sweep on the same float32
    inputs: the kernels' wrap takes the same images, the seams included."""
    r32, F32, box = film
    Fk = F32[:k].contiguous()
    ref = _film_ref(r32, Fk, box, shells)
    args = rpy_cuda.box_args(box, shells)
    before = rpy_cuda.launch_counts()
    U1 = rpy_cuda.pair_sweep_sym(r32, Fk, True, 0.75, box=args)
    if shells:
        U1 = U1 + rpy.self_image_sum(r32, Fk, True, box, shells)
    U2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, Fk, 0, True, 0.75, box=args)
    torch.cuda.synchronize()
    after = rpy_cuda.launch_counts()
    assert after["pair_sweep_sym"] == before["pair_sweep_sym"] + 1
    assert after["pair_sweep_ordered"] == before["pair_sweep_ordered"] + 1
    assert _rel(U1, ref) < TOL
    assert _rel(U2, ref) < TOL
    assert _rel(rpy_cuda.pair_sum(r32, Fk, True, box_over_a=box,
                                  image_shells=shells), ref) < TOL


@pytest.mark.parametrize("k", [1, 2])
def test_box_forms_are_repeatable(film, k):
    """Two launches of each box form agree bitwise (no atomics)."""
    r32, F32, box = film
    Fk = F32[:k].contiguous()
    for shells in (0, 2):
        args = rpy_cuda.box_args(box, shells)
        for fn in (lambda: rpy_cuda.pair_sweep_sym(r32, Fk, True, 0.75,
                                                   box=args),
                   lambda: rpy_cuda.pair_sweep_ordered(r32, 0, r32, Fk, 0,
                                                       True, 0.75, box=args)):
            assert torch.equal(fn(), fn())


def test_k2_box_slab_keeps_self_images(film):
    """A K2 row slab with its global offset in the box: the self pair is
    masked at offset 0 only, so its rows match the square plain sweep."""
    r32, F32, box = film
    ids = torch.arange(r32.shape[0], device=r32.device)
    ref = _film_ref(r32, F32, box, 2, rows=ids[100:400])
    U = rpy_cuda.pair_sweep_ordered(r32[100:400].contiguous(), 100, r32,
                                    F32, 0, True, 0.75,
                                    box=rpy_cuda.box_args(box, 2))
    torch.cuda.synchronize()
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("k", [1, 2])
def test_k1_grouped_box_form_matches_plain(dev, k):
    """K1's grouped kernel (66,000 blobs) in the box at 2 shells, on 256
    sampled rows."""
    n = 66_000
    rng = np.random.default_rng(9)
    box = (200.0, 200.0)
    r32 = torch.from_numpy(rng.uniform([0, 0, 0.5], [200, 200, 12], (n, 3))
                           .astype(np.float32)).to(dev)
    F32 = torch.from_numpy(rng.standard_normal((k, n, 3))
                           .astype(np.float32)).to(dev)
    U = rpy_cuda.pair_sum(r32, F32, True, box_over_a=box, image_shells=2)
    torch.cuda.synchronize()
    rows = torch.from_numpy(np.sort(rng.choice(n, 256, replace=False))).to(dev)
    assert _rel(U[:, rows], _film_ref(r32, F32, box, 2, rows)) < TOL


# ---- K1's and K2's POLY forms (per-blob radii in units of a)

@pytest.fixture
def poly_cloud(cloud):
    """The 700-blob cloud with radii from {0.6, 1.1}, and 40 blobs in 20
    close pairs of unequal radii (the deep and overlap branches)."""
    r, F = cloud
    rng = np.random.default_rng(2)
    ahat = torch.from_numpy(rng.choice([0.6, 1.1], 700)).to(r.device)
    base = rng.uniform([-3, -3, 0.3], [3, 3, 3], (20, 3))
    d = np.geomspace(0.01, 1.6, 20)[:, None] * np.array([[1.0, 0, 0]])
    r[:40] = torch.from_numpy(np.stack([base, base + d], 1).reshape(-1, 3))
    ahat[:40] = torch.tensor([0.6, 1.1] * 20)
    return r, ahat, F


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_poly_forms_match_plain(poly_cloud, wall, k):
    """Both POLY forms against the float64 plain sweep with radii; K2 also
    as a row slab with its global offset (its radii sliced with its
    rows)."""
    r, ahat, F = poly_cloud
    ids = torch.arange(r.shape[0], device=r.device)
    poly = dict(radii_rows=ahat, radii_cols=ahat)
    ref = rpy.pair_sum(r, ids, r, ids, F[:k], wall=wall, **poly)
    r32, a32 = r.float().contiguous(), ahat.float().contiguous()
    F32 = F[:k].float().contiguous()
    U1 = rpy_cuda.pair_sweep_sym(r32, F32, wall, 0.75, ahat=a32)
    U2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, wall, 0.75,
                                     ahat_rows=a32, ahat_cols=a32)
    U3 = rpy_cuda.pair_sweep_ordered(r32[100:400].contiguous(), 100, r32, F32,
                                     0, wall, 0.75,
                                     ahat_rows=a32[100:400].contiguous(),
                                     ahat_cols=a32)
    torch.cuda.synchronize()
    assert _rel(U1, ref) < TOL and _rel(U2, ref) < TOL
    assert _rel(U3, ref[:, 100:400]) < TOL


def test_poly_forms_repeat_and_count(poly_cloud):
    """Bitwise repeatable; the POLY launches counted under their own keys,
    the monodisperse counts unmoved; the product routes radii to them."""
    r, ahat, F = poly_cloud
    r32, a32, F32 = (x.float().contiguous() for x in (r, ahat, F))
    before = rpy_cuda.launch_counts()
    U1 = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75, ahat=a32)
    U2 = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75, ahat=a32)
    V1 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, True, 0.75,
                                     ahat_rows=a32, ahat_cols=a32)
    V2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, True, 0.75,
                                     ahat_rows=a32, ahat_cols=a32)
    assert torch.equal(U1, U2) and torch.equal(V1, V2)
    rpy_cuda.mobility_apply_multi(F32, r32, wall=True, radii=a32)
    rpy_cuda.mobility_apply(F32[0], r32, wall=True, radii=a32)
    after = rpy_cuda.launch_counts()
    assert after["pair_sweep_sym_poly"] == before["pair_sweep_sym_poly"] + 3
    assert (after["pair_sweep_ordered_poly"]
            == before["pair_sweep_ordered_poly"] + 3)
    assert after["pair_sweep_sym"] == before["pair_sweep_sym"]
    assert after["pair_sweep_ordered"] == before["pair_sweep_ordered"]


def test_poly_product_matches_plain(poly_cloud):
    """rpy_cuda.mobility_apply(_multi) with physical radii (ahat = radii/a,
    damping at z/aᵢ, the self term at aᵢ) against the float64 twin."""
    r, ahat, F = poly_cloud
    a = 0.7
    r_p, rad = r * a, ahat * a
    for k in (1, 2):
        ref = rpy.mobility_apply_multi(F[:k], r_p, a, 1.3, True, radii=rad)
        U = rpy_cuda.mobility_apply_multi(F[:k].float(), r_p.float(), a, 1.3,
                                          True, radii=rad.float())
        torch.cuda.synchronize()
        assert _rel(U, ref) < TOL


def _poly_box_ref(r32, a32, F32, box, shells, wall=True):
    """The float64 plain sweep with radii, box and images (the self images
    included) on the float32 inputs."""
    ids = torch.arange(r32.shape[0], device=r32.device)
    return rpy.pair_sum(r32.double(), ids, r32.double(), ids, F32.double(),
                        wall=wall, box=box, image_shells=shells,
                        radii_rows=a32.double(), radii_cols=a32.double())


def test_poly_box_form_raises_on_the_card(poly_cloud):
    """The POLY × box forms through ``pair_sum`` (once refused here): K1
    with the self images at each blob's radius at 1 RHS, K2 at 2 RHS, at
    image_shells 0 and 2 in a box the cloud crosses, wall and free, against
    the float64 plain sweep; counted under their own launch keys only."""
    r, ahat, F = poly_cloud
    box = (float(np.float32(17.0)), float(np.float32(15.0)))
    r32, a32 = r.float().contiguous(), ahat.float().contiguous()
    for shells in (0, 2):
        for wall in (True, False):
            for k in (1, 2):
                F32 = F[:k].float().contiguous()
                before = rpy_cuda.launch_counts()
                U = rpy_cuda.pair_sum(r32, F32, wall, box_over_a=box,
                                      ahat=a32, image_shells=shells)
                torch.cuda.synchronize()
                after = rpy_cuda.launch_counts()
                assert _rel(U, _poly_box_ref(r32, a32, F32, box, shells,
                                             wall)) < TOL
                key = ("pair_sweep_sym_poly_box" if k == 1
                       else "pair_sweep_ordered_poly_box")
                moved = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}
                assert moved == {key: 1}


@pytest.mark.parametrize("k", [1, 2])
def test_poly_box_sweeps_match_plain_and_repeat(poly_cloud, k):
    """K1 (its pair terms, no self images) and K2 (a blob's own images
    kept) in their POLY × box forms at image_shells 2, and K2 as a row slab
    with its global offset, against the float64 plain sweep; two launches
    bitwise equal."""
    r, ahat, F = poly_cloud
    box = (float(np.float32(17.0)), float(np.float32(15.0)))
    args = rpy_cuda.box_args(box, 2)
    r32, a32 = r.float().contiguous(), ahat.float().contiguous()
    F32 = F[:k].float().contiguous()
    ref = _poly_box_ref(r32, a32, F32, box, 2)
    self_img = rpy.self_image_sum(r32.double(), F32.double(), True, box, 2,
                                  ahat=a32.double())
    U1 = rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75, box=args, ahat=a32)
    U2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, True, 0.75,
                                     box=args, ahat_rows=a32, ahat_cols=a32)
    U3 = rpy_cuda.pair_sweep_ordered(r32[100:400].contiguous(), 100, r32, F32,
                                     0, True, 0.75, box=args,
                                     ahat_rows=a32[100:400].contiguous(),
                                     ahat_cols=a32)
    torch.cuda.synchronize()
    assert _rel(U1.double() + self_img, ref) < TOL
    assert _rel(U2, ref) < TOL and _rel(U3, ref[:, 100:400]) < TOL
    assert torch.equal(U1, rpy_cuda.pair_sweep_sym(r32, F32, True, 0.75,
                                                   box=args, ahat=a32))
    assert torch.equal(U2, rpy_cuda.pair_sweep_ordered(
        r32, 0, r32, F32, 0, True, 0.75, box=args, ahat_rows=a32,
        ahat_cols=a32))


# ---- K3's POLY form (per-blob radii in units of a), open and in the box

def _with_close_pairs(r, rng, n_pairs=20, lo=(-3, -3, 0.3), hi=(3, 3, 3)):
    """r (n, 3) with its first 2·n_pairs blobs replaced by close pairs at
    distances 0.01-1.6 (radii 0.6 and 1.1: the deep and overlap branches);
    returns (r, radii)."""
    n = r.shape[0]
    ahat = rng.choice([0.6, 1.1], n)
    base = rng.uniform(lo, hi, (n_pairs, 3))
    d = np.geomspace(0.01, 1.6, n_pairs)[:, None] * np.array([[0.6, 0.8, 0]])
    r = r.copy()
    r[:2 * n_pairs] = np.stack([base, base + d], 1).reshape(-1, 3)
    ahat[:2 * n_pairs] = [0.6, 1.1] * n_pairs
    return r, ahat


@pytest.fixture
def near_poly(dev):
    """The near-sweep fixture's two-clump cloud with radii {0.6, 1.1} and
    close pairs of unequal radii, prepared with radii (float64 on the
    card)."""
    farfield_cuda.build()
    rng = np.random.default_rng(13)
    r = np.concatenate([rng.uniform([0, 0, 0.3], [8, 8, 6], (800, 3)),
                        rng.uniform([14, 14, 0.3], [20, 20, 6], (700, 3))])
    r, ahat = _with_close_pairs(r, rng, lo=(1, 1, 0.3), hi=(7, 7, 3))
    ctx = farfield.prepare(torch.from_numpy(r).to(dev), wall=True,
                           grid=(5, 5, 3), p=4,
                           radii=torch.from_numpy(ahat).to(dev))
    F = torch.from_numpy(rng.standard_normal(
        (2, ctx.x_s.shape[0], 3))).to(dev)
    return ctx, F


def _poly_near_check(ctx, F, k, wall, box=None, wrap=None):
    """K3's POLY form (float32) against the float64 plain near sweep on the
    same float32 inputs; the launch counted under its own key."""
    live = ctx.id_s >= 0
    x32, a32 = ctx.x_s.float(), ctx.ah_s.float()
    F32 = F[:k].float()
    ref = farfield._near_sweep(x32.double(), ctx.ci_s, ctx.id_s,
                               F32.double(), ctx.nbr, wall, 0.75,
                               box_n=box, wrap_xy=wrap, ah_s=a32.double())
    before = farfield_cuda.launch_counts()
    U = farfield_cuda.near_sweep(x32, ctx.ci_s, live, F32, ctx.nbr, wall,
                                 0.75, pairs=(ctx.pairs, ctx.n_pairs),
                                 box_over_a=box, wrap_cells=wrap,
                                 ahat_s=a32)
    torch.cuda.synchronize()
    after = farfield_cuda.launch_counts()
    assert after["near_sweep_poly"] == before["near_sweep_poly"] + 1
    assert after["near_sweep"] == before["near_sweep"]
    assert torch.isfinite(U[:, live]).all()
    assert _rel(U[:, live], ref[:, live]) < TOL


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_k3_poly_form_matches_plain(near_poly, wall, k):
    ctx, F = near_poly
    _poly_near_check(ctx, F, k, wall)


@pytest.mark.parametrize("cloud", ["ragged", "ties", "self"])
@pytest.mark.parametrize("k", [1, 2])
def test_k3_poly_box_form_matches_plain(film_near, cloud, k):
    """The POLY × BOX form on the film's edge clouds (across both seams,
    the seam tie, a tile meeting itself across the seam) with radii."""
    ctx, F, box, wrap = film_near[cloud]
    rng = np.random.default_rng(14)
    ahat = torch.from_numpy(rng.choice([0.6, 1.1], ctx.x_s.shape[0])).to(
        ctx.x_s.device)
    _poly_near_check(ctx._replace(ah_s=ahat), F, k, True, box, wrap)


@pytest.mark.parametrize("k", [1, 2])
def test_k3_poly_forms_are_repeatable(near_poly, film_near, k):
    ctx, F = near_poly
    args = (ctx.x_s.float().contiguous(), ctx.ci_s.contiguous(),
            (ctx.id_s >= 0).contiguous(), F[:k].float().contiguous(),
            ctx.nbr, ctx.pairs, ctx.n_pairs, True, 0.75)
    a32 = ctx.ah_s.float().contiguous()
    assert torch.equal(farfield_cuda.near_sweep_kernel(*args, ahat_s=a32),
                       farfield_cuda.near_sweep_kernel(*args, ahat_s=a32))
    ctx, F, box, wrap = film_near["ragged"]
    a32 = torch.full((ctx.x_s.shape[0],), 0.6, device=ctx.x_s.device)
    a32[::3] = 1.1
    args = (ctx.x_s.contiguous(), ctx.ci_s.contiguous(),
            (ctx.id_s >= 0).contiguous(), F[:k].contiguous(), ctx.nbr,
            ctx.pairs, ctx.n_pairs, True, 0.75, box, wrap, a32)
    assert torch.equal(farfield_cuda.near_sweep_kernel(*args),
                       farfield_cuda.near_sweep_kernel(*args))


@pytest.mark.parametrize("film", [False, True])
def test_far_field_poly_operator_through_k3(near_poly, film):
    """The polydisperse far field in float32 through K3's POLY form (and
    POLY × BOX in a film) against float64 through the plain sweep;
    bitwise repeatable; radii equal to a give the monodisperse operator."""
    ctx, _ = near_poly
    live = ctx.id_s >= 0
    r, rad = ctx.x_s[live] * 0.7, ctx.ah_s[live] * 0.7
    order = torch.argsort(ctx.id_s[live])
    r, rad = r[order], rad[order]
    F = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(r.shape))).to(r.device)
    kw = dict(a=0.7, eta=1.3, wall=True, grid=(5, 5, 3), p=4)
    if film:
        kw.update(box=(14.7, 14.7), grid=(4, 4, 3), image_shells=2)
    before = farfield_cuda.launch_counts()
    U32 = farfield.mobility_apply(F.float(), r.float(), radii=rad.float(),
                                  **kw)
    U64 = farfield.mobility_apply(F, r, radii=rad, **kw)
    after = farfield_cuda.launch_counts()
    assert after["near_sweep_poly"] == before["near_sweep_poly"] + 1
    assert after["near_sweep"] == before["near_sweep"]
    assert _rel(U32, U64) < 1e-5
    assert torch.equal(U32, farfield.mobility_apply(
        F.float(), r.float(), radii=rad.float(), **kw))
    U_eq = farfield.mobility_apply(F.float(), r.float(),
                                   radii=torch.full_like(rad.float(), 0.7),
                                   **kw)
    U_mono = farfield.mobility_apply(F.float(), r.float(), **kw)
    assert _rel(U_eq, U_mono.double()) < 2e-6


@pytest.fixture
def rigid(dev):
    """The port's RigidBody on the card: 4 × shell_N_162 above the wall,
    float32 (the kernels' path), block_free at GMRES tol 1e-4."""
    params, ref = rt.load_structure("shell_N_162")
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 2.0 + 0.2 * i]
                  for i in range(4)])
    Q = np.random.default_rng(21).standard_normal((4, 4))
    cfg = rt.SimulationConfig(wall=True, pc_mode="block_free",
                              gmres_tol=1e-4, gmres_restart=20,
                              gmres_maxiter=60)
    return rt.RigidBody(ref, X, Q, params["sep"] / 2, 1.0, 0.01, config=cfg)


def test_rigid_body_apply_M_through_k1(rigid):
    """RigidBody.apply_M (numpy in and out) launches K1 once and agrees with
    the float64 plain operator at the same positions."""
    pos = rigid.get_blob_positions()
    F = np.random.default_rng(22).standard_normal(pos.size)
    before = rpy_cuda.launch_counts()
    U = rigid.apply_M(F, pos)
    after = rpy_cuda.launch_counts()
    assert after["pair_sweep_sym"] == before["pair_sweep_sym"] + 1
    assert U.dtype == np.float32 and U.shape == F.shape
    ref = rpy.mobility_apply(
        torch.from_numpy(F).to(rigid.device).reshape(-1, 3),
        torch.from_numpy(pos).to(rigid.device).double(), a=rigid.config.a,
        wall=True)
    ref = ref.cpu().numpy().ravel()
    assert np.abs(U - ref).max() / np.abs(ref).max() < TOL


def test_rigid_body_solve_mobility_launches_k1(rigid):
    F = np.zeros((4, 6))
    F[:, 2] = -1.0
    before = rpy_cuda.launch_counts()["pair_sweep_sym"]
    U, lam, res = rigid.solve_mobility(F)
    assert rpy_cuda.launch_counts()["pair_sweep_sym"] > before
    assert res < rigid.config.gmres_tol
    assert U.shape == (4, 6) and np.isfinite(U).all() and U[:, 2].max() < 0


@pytest.mark.parametrize("op", ["apply_PC", "apply_saddle", "apply_M"])
def test_rigid_body_raises_below_the_wall_on_the_card(rigid, op):
    X, Q = rigid.get_config()
    rigid.set_config(X - [0.0, 0.0, 2.0], Q)
    n_sys = 3 * rigid.total_blobs + 6 * rigid.N_bodies
    with pytest.raises(RuntimeError, match="below the wall"):
        if op == "apply_M":
            rigid.apply_M(np.ones(3 * rigid.total_blobs),
                          rigid.get_blob_positions())
        else:
            getattr(rigid, op)(np.ones(n_sys))


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
def test_balanced_split_on_the_card_matches_the_cpu(dev, poly):
    """The balanced split (the tile sweep and the gridded wave part, with
    and without radii) in float32 on the card against float64 on the CPU
    from the same float32 inputs, within 2e-4 of max|U| (the JAX package's
    float32 bound for the grid); two applies bitwise equal; the tile sweep
    through K4 tiles, one launch an apply, K4 not launched."""
    rng = np.random.default_rng(13)
    n, L = 1500, 10.0
    r = torch.from_numpy(rng.uniform(0, L, (n, 3))).float()
    F = torch.from_numpy(rng.standard_normal((2, n, 3))).float()
    radii = (torch.from_numpy(rng.choice([0.2, 0.3], n)).float() if poly
             else None)
    par = ewald.make_params((L, L, L), 0.3, tol=1e-4, rc=3.0)
    g = ewald_pme.make_grid(par, p=4, radii=radii)
    on_card = dict(radii=None if radii is None else radii.to(dev), grid=g)
    before = ewald_cuda.launch_counts()
    U = ewald.mobility_apply_multi(F.to(dev), r.to(dev), par, **on_card)
    U2 = ewald.mobility_apply_multi(F.to(dev), r.to(dev), par, **on_card)
    torch.cuda.synchronize()
    after = ewald_cuda.launch_counts()
    assert after["ewald_real_tiles"] == before["ewald_real_tiles"] + 2
    assert {k: v for k, v in after.items() if k != "ewald_real_tiles"} == {
        k: v for k, v in before.items() if k != "ewald_real_tiles"}
    assert torch.equal(U, U2)
    ref = ewald.mobility_apply_multi(
        F.double(), r.double(), par, grid=g,
        radii=None if radii is None else radii.double())
    assert _rel(U.cpu(), ref) < 2e-4
    w = ewald_cells.neighbor_width(r.to(dev), par)
    assert w == ewald_cells.neighbor_width(r, par)



def _tile_case(dev, poly, n=3000, L=10.0, seed=17):
    """ewald_cells.sorted_tiles of a uniform cloud in an L box (rc 3.0, a =
    0.3, tol 1e-4; radii {0.2, 0.3} with their species-pair fits) on the
    card, at 2 RHS: (params, tiles, float32 positions, forces, the sweep's
    extra arguments)."""
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.uniform(0, L, (n, 3))).float().to(dev)
    F = torch.from_numpy(rng.standard_normal((2, n, 3))).float().to(dev)
    par = ewald.make_params((L, L, L), 0.3, tol=1e-4, rc=3.0)
    kw = {}
    if poly:
        radii = torch.from_numpy(rng.choice([0.2, 0.3], n)).float().to(dev)
        kw = dict(radii=radii, poly_tables=ewald.make_poly_tables(par, radii))
    tiles_ = ewald_cells.sorted_tiles(ewald_cells._fold(r, par), F, par,
                                      -(-n // 32), **kw)
    return par, tiles_, r, F, kw


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
@pytest.mark.parametrize("k", [1, 2])
def test_k4_tiles_match_plain_twin(dev, poly, k):
    """K4 tiles against its plain twin (ewald_cells._cell_sweep) on the
    card, on the real rows, and against the all-pairs sweep with the cut,
    within 5e-6 of max|U|; one launch counted."""
    par, (order, r_pad, ids_pad, F_pad, pp, nbr, of), r, F, kw = _tile_case(
        dev, poly)
    assert not bool(of)
    Fk = F_pad[:k].contiguous()
    before = ewald_cuda.launch_counts()["ewald_real_tiles"]
    U = ewald_cuda.tile_pair_sum(r_pad, ids_pad, Fk, nbr, par, poly=pp)
    torch.cuda.synchronize()
    assert ewald_cuda.launch_counts()["ewald_real_tiles"] == before + 1
    twin = ewald_cells._cell_sweep(r_pad, ids_pad, Fk, nbr, par, poly=pp)
    real = ids_pad >= 0
    assert U.shape == (k, r_pad.shape[0], 3)
    assert _rel(U[:, real], twin[:, real].double()) < TOL
    U_o = torch.empty((k, r.shape[0], 3), device=dev)
    U_o[:, order] = U[:, :r.shape[0]]
    if poly:   # the plain all-pairs sweep with the same fits
        ref = ewald.real_space_apply(F[:k], r, par, **kw)
    else:      # the float64 Clenshaw of the same fit
        ref = ewald.real_space_apply(F[:k].double(), r.double(), par,
                                     cheb=True)
    assert _rel(U_o, ref.double()) < TOL


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
def test_k4_tiles_slices_and_repeat(dev, poly):
    """Two launches bitwise equal; the row-tile slices for 1, 2 and 4 ranks
    (tiles padded to a multiple of the ranks) bitwise the whole launch, at
    D = 4 with tile pairs straddling a slice's edge (each evaluated by
    both slices, each writing its own side)."""
    par, _, r, F, kw = _tile_case(dev, poly)
    rf = ewald_cells._fold(r, par)
    for d in (1, 2, 4):
        _, r_pad, ids_pad, F_pad, pp, nbr, _ = ewald_cells.sorted_tiles(
            rf, F, par, -(-r.shape[0] // 32), d, **kw)
        whole = ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, par,
                                         poly=pp)
        assert torch.equal(whole, ewald_cuda.tile_pair_sum(
            r_pad, ids_pad, F_pad, nbr, par, poly=pp))
        nt = nbr.shape[0] // d
        parts = [ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, par,
                                          poly=pp, t0=i * nt, nt=nt)
                 for i in range(d)]
        assert torch.equal(torch.cat(parts, dim=1), whole)
        if d == 4:
            full = tiles.tile_pairs(nbr.to(torch.int32))
            edge = [int(tiles.slice_pairs(*full, i * nt, nt)[2])
                    for i in range(d)]
            assert min(edge) > 0, edge


def test_k4_tiles_tile_adjacent_to_itself_across_the_face(dev):
    """A tile straddling the box's z face (its diagonal pair keeps pairs
    that meet only through the face) and a tile across the x face from
    it: K4 tiles within 5e-6 of the twin and of the float64 Clenshaw of
    the same fit over all pairs with the cut, one launch; the slices at
    D = 4 (a whole pad tile) bitwise the whole launch."""
    rng = np.random.default_rng(5)
    r = np.empty((96, 3))
    r[:32, :2] = rng.uniform(0.4, 1.0, (32, 2))
    r[:32, 2] = np.concatenate([rng.uniform(0.02, 0.4, 16),
                                rng.uniform(5.6, 5.98, 16)])
    r[32:64] = rng.uniform([5.3, 0.3, 2.0], [5.9, 1.2, 3.5], (32, 3))
    r[64:] = rng.uniform([2.5, 4.6, 2.5], [3.5, 5.4, 3.5], (32, 3))
    r = torch.from_numpy(r).float().to(dev)
    F = torch.from_numpy(rng.standard_normal((2, 96, 3))).float().to(dev)
    par = ewald.make_params((6.0, 6.0, 6.0), 0.3, tol=1e-5, rc=2.5)
    rf = ewald_cells._fold(r, par)
    order, r_pad, ids_pad, F_pad, pp, nbr, of = ewald_cells.sorted_tiles(
        rf, F, par, 3)
    assert not bool(of)
    z = r_pad[:, 2].reshape(-1, 32)
    assert bool(((z.min(dim=1).values < 0.5)
                 & (z.max(dim=1).values > 5.5)).any())
    before = ewald_cuda.launch_counts()["ewald_real_tiles"]
    U = ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, par)
    torch.cuda.synchronize()
    assert ewald_cuda.launch_counts()["ewald_real_tiles"] == before + 1
    twin = ewald_cells._cell_sweep(r_pad, ids_pad, F_pad, nbr, par)
    assert _rel(U[:, :96], twin[:, :96].double()) < TOL
    U_o = torch.empty_like(U[:, :96])
    U_o[:, order] = U[:, :96]
    ref = ewald.real_space_apply(F.double(), rf.double(), par, cheb=True)
    assert _rel(U_o, ref) < TOL
    _, r_pad, ids_pad, F_pad, pp, nbr, _ = ewald_cells.sorted_tiles(
        rf, F, par, 3, 4)
    whole = ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, par)
    parts = [ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, par,
                                      t0=i, nt=1) for i in range(4)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_k4_tiles_overflow_poisons_and_grad_raises(dev):
    """A list one slot narrower than the widest NaN-poisons the apply
    through the kernel (the width itself does not); a force that requires
    grad raises instead of missing the pair terms; without autograd it
    runs."""
    par, (_, r_pad, ids_pad, F_pad, pp, nbr, _), r, F, _ = _tile_case(
        dev, False)
    w = ewald_cells.neighbor_width(r, par)
    before = ewald_cuda.launch_counts()["ewald_real_tiles"]
    U_ok = ewald_cells.real_space_apply_cells(F, r, par, max_nbr=w)
    U_bad = ewald_cells.real_space_apply_cells(F, r, par, max_nbr=w - 1)
    torch.cuda.synchronize()
    assert ewald_cuda.launch_counts()["ewald_real_tiles"] == before + 2
    assert bool(torch.isfinite(U_ok).all()) and bool(torch.isnan(U_bad).all())
    Fg = F_pad.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="K4 tiles.*no backward"):
        ewald_cuda.tile_pair_sum(r_pad, ids_pad, Fg, nbr, par)
    with torch.no_grad():
        ewald_cuda.tile_pair_sum(r_pad, ids_pad, Fg, nbr, par)


# ------------------------------------------------- the adjoints (item 15)
@pytest.mark.parametrize("case", ["wall", "box", "radii"])
def test_k1_function_backward_matches_plain(cloud, case):
    """``rpy_cuda.MobilityApply`` on the card: F̄ through one more K1
    launch, r̄ through the plain sweep, against ``torch.autograd`` through
    the plain float32 sweep on the same inputs."""
    r, F = cloud
    r32, F32, Ub = r.float(), F[0].float(), F[1].float()
    kw = dict(a=1.0, eta=1.0, wall=True)
    if case == "box":
        kw.update(box=(20.0, 20.0), image_shells=1)
    if case == "radii":
        kw["radii"] = torch.where(torch.arange(r.shape[0], device=r.device)
                                  % 2 == 0, 0.6, 1.0).float()
    grads = []
    for fn in (rpy_cuda.mobility_apply, rpy.mobility_apply):
        rr, FF = r32.clone().requires_grad_(), F32.clone().requires_grad_()
        U = fn(FF, rr, **kw)
        grads.append(torch.autograd.grad(U, (FF, rr), Ub))
    (gF_k, gr_k), (gF_p, gr_p) = grads
    torch.cuda.synchronize()
    assert _rel(gF_k, gF_p.double()) < TOL
    assert _rel(gr_k, gr_p.double()) < 1e-6


def test_k1_function_launches_k1_for_the_force_cotangent(cloud):
    r, F = cloud
    FF = F[0].float().clone().requires_grad_()
    U = rpy_cuda.mobility_apply(FF, r.float(), wall=True)
    rpy_cuda.reset_launch_counts()
    (g,) = torch.autograd.grad(U, FF, F[1].float())
    assert rpy_cuda.launch_counts()["pair_sweep_sym"] == 1
    assert torch.isfinite(g).all()


def test_kernels_without_backward_raise(dev, cloud, ewald_boxes):
    """A gradient through K2 (or K1 at 2 RHS), K3 or K4 on the card raises
    instead of silently missing the pair terms."""
    r, F = cloud
    r32 = r.float().clone().requires_grad_()
    with pytest.raises(RuntimeError, match="K2 at 2 RHS.*item 15"):
        rpy_cuda.mobility_apply_multi(F.float(), r32, wall=True)
    with pytest.raises(RuntimeError, match="K3 near_sweep.*item 15"):
        farfield.mobility_apply(F[0].float(), r32, wall=True,
                                grid=(4, 4, 2), p=3)
    params = ewald_boxes[0]
    rp, Fp = _periodic_cloud(dev, params.box, 300, 4)
    with pytest.raises(RuntimeError, match="K4 ewald_real_sweep.*item 15"):
        ewald_cuda.mobility_apply(Fp[0].float().requires_grad_(),
                                  rp.float(), params)
    # without autograd the same calls run
    with torch.no_grad():
        rpy_cuda.mobility_apply_multi(F.float(), r32, wall=True)


# ------------------------------------------------ the distributed forms
@pytest.mark.parametrize("box", [False, True], ids=["open", "box"])
@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
@pytest.mark.parametrize("k", [1, 2])
def test_k2_slab_entry_at_offsets_matches_plain(cloud, box, poly, k):
    """K2's slab entry (rpy_cuda.pair_sum_slab): rows [130, 430) against
    the column block [64, 700) at their global offsets, 300 rows (not a
    multiple of K2's 64), R ≠ N; with the box's image sum (a blob keeping
    its own images) and with radii; counted as a slab."""
    r, F = cloud
    rng = np.random.default_rng(21)
    ahat = (torch.from_numpy(rng.choice([0.6, 1.1], r.shape[0])).to(r.device)
            if poly else None)
    kw = dict(box=(11.0, 13.0), image_shells=1) if box else {}
    ids = torch.arange(r.shape[0], device=r.device)
    rows, cols = slice(130, 430), slice(64, 700)
    r32, F32 = r.float(), F[:k].float()
    ref = rpy.pair_sum(r32[rows].double(), ids[rows], r32[cols].double(),
                       ids[cols], F32[:, cols].double(), wall=True,
                       radii_rows=None if ahat is None else ahat[rows],
                       radii_cols=None if ahat is None else ahat[cols], **kw)
    before = rpy_cuda.launch_counts()
    U = rpy_cuda.pair_sum_slab(
        r32[rows], 130, r32[cols], F32[:, cols], True, col_offset=64,
        h_floor=0.75, box_over_a=kw.get("box"),
        ahat_rows=None if ahat is None else ahat[rows],
        ahat_cols=None if ahat is None else ahat[cols],
        image_shells=kw.get("image_shells", 0))
    torch.cuda.synchronize()
    after = rpy_cuda.launch_counts()
    key = ("pair_sweep_slab" if not poly else
           "pair_sweep_slab_poly_box" if box else "pair_sweep_slab_poly")
    assert after[key] == before[key] + 1
    assert after["pair_sweep_ordered"] == before["pair_sweep_ordered"]
    assert U.shape == (k, 300, 3)
    assert _rel(U, ref) < TOL


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_k3_row_slices_match_plain(near, wall, k):
    """K3's row-tile slice at D = 2 and 4 of the fixture's 12 tiles: each
    slice against the plain sweep's rows of that slice, and two launches
    bitwise equal; counted as a slice."""
    ctx, F = near
    t = ctx.nbr.shape[0]
    live = ctx.id_s >= 0
    x32, F32 = ctx.x_s.float(), F[:k].float()
    for D in (2, 4):
        nt = t // D
        for d in range(D):
            t0 = d * nt
            pairs, count, _ = tiles.slice_pairs(ctx.pairs, ctx.n_pairs,
                                                    t0, nt)
            ref = farfield._near_sweep(x32.double(), ctx.ci_s, ctx.id_s,
                                       F32.double(), ctx.nbr, wall, 0.75,
                                       t0=t0, nt=nt)
            before = farfield_cuda.launch_counts()["near_sweep_slice"]
            U = farfield_cuda.near_sweep(
                x32, ctx.ci_s, live, F32, ctx.nbr, wall, 0.75,
                pairs=(pairs, count), t0=t0, nt=nt)
            U2 = farfield_cuda.near_sweep(
                x32, ctx.ci_s, live, F32, ctx.nbr, wall, 0.75,
                pairs=(pairs, count), t0=t0, nt=nt)
            torch.cuda.synchronize()
            assert farfield_cuda.launch_counts()["near_sweep_slice"] == \
                before + 2
            rows = live[t0 * 128:(t0 + nt) * 128]
            assert U.shape == (k, nt * 128, 3)
            assert torch.equal(U, U2)
            assert _rel(U[:, rows], ref[:, rows]) < TOL


def test_distributed_forms_refuse_grad(dev, cloud, near):
    """K2's slab entry and K3's slice have no backward: a CUDA tensor that
    requires grad raises at both."""
    r, F = cloud
    r32 = r.float().clone().requires_grad_()
    with pytest.raises(RuntimeError, match="K2's slab.*item 15"):
        rpy_cuda.pair_sum_slab(r32[:100], 0, r32, F[0].float(), True)
    ctx, Fn = near
    t = ctx.nbr.shape[0]
    pairs, count, _ = tiles.slice_pairs(ctx.pairs, ctx.n_pairs, 0, t // 2)
    with pytest.raises(RuntimeError, match="K3 near_sweep_slice.*item 15"):
        farfield_cuda.near_sweep(
            ctx.x_s.float().requires_grad_(), ctx.ci_s, ctx.id_s >= 0,
            Fn[:1].float(), ctx.nbr, True, 0.75, pairs=(pairs, count),
            t0=0, nt=t // 2)
