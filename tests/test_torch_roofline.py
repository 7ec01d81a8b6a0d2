"""The FP32 peak probe's plain version
(``rigid_body_light_tpu_torch/utils/roofline.py``) against the same
recurrence in float32 numpy.

The JAX probe (``measure_vpu_peak`` in ``scripts/tpu_kernel_roofline.py``)
fixes N = 10240 and TPU memory spaces inside the function that launches
it, so it cannot run on the CPU as it stands; numpy is the reference here.
Plain PyTorch and numpy both multiply, then add, in float32, element by
element, so the chains agree bitwise; only the row sums are ordered
differently.  The CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rigid_body_light_tpu_torch.utils import roofline  # noqa: E402


def chain_numpy(x, c, chain):
    """out_i = Σ_j v_ij after ``chain`` steps of v = v·1.000001 + c_j from
    v = x_i·c_j, float32 throughout; the row sum in float64."""
    mul = np.float32(roofline.MUL)
    v = x[:, None] * c[None, :]
    for _ in range(chain):
        v = v * mul + c[None, :]
    assert v.dtype == np.float32
    return v, v.sum(axis=1, dtype=np.float64)


@pytest.mark.parametrize("n,chain", [(700, 64), (130, 7), (1, 64)])
def test_plain_chain_matches_numpy(n, chain):
    rng = np.random.default_rng(n)
    x = rng.uniform(0.5, 1.5, n).astype(np.float32)
    c = rng.uniform(0.5, 1.5, n).astype(np.float32)
    _, ref = chain_numpy(x, c, chain)
    before = roofline.peak_launches
    out = roofline.fma_chain(torch.from_numpy(x), torch.from_numpy(c), chain)
    assert roofline.peak_launches == before   # no kernel on the CPU
    assert out.shape == (n,) and out.dtype == torch.float32
    # float32 row sums over column tiles against a float64 sum
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6)


def test_plain_chain_is_the_probes_recurrence():
    """On ones, as the probe runs it: every (i, j) carries the same chain
    value, the geometric sum 1.000001⁶⁴ + Σ_{s<64} 1.000001ˢ."""
    n = 600
    one = torch.ones(n)
    out = roofline.fma_chain(one, one)
    m = 1.000001
    exact = m ** 64 + (m ** 64 - 1) / (m - 1)
    np.testing.assert_allclose(out.numpy(), n * exact, rtol=1e-5)
    v, _ = chain_numpy(np.ones(4, np.float32), np.ones(4, np.float32), 64)
    assert (v == v[0, 0]).all()
    np.testing.assert_allclose(out[0].item() / n, v[0, 0], rtol=1e-6)


def test_column_tiles_do_not_change_the_function():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, 300).astype(np.float32))
    c = torch.from_numpy(rng.uniform(0.5, 1.5, 300).astype(np.float32))
    a = roofline.fma_chain_plain(x, c, col_tile=512)
    b = roofline.fma_chain_plain(x, c, col_tile=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_multiplier_is_the_kernels_float32_constant():
    assert roofline.MUL == float(np.float32(1.000001))


def test_peak_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        roofline.measure_fp32_peak(device="cpu")
    assert roofline.launch_counts() == {"fma_peak": roofline.peak_launches}
