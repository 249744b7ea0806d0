"""complex64 Householder QR and SVD on CPU tensors, and the complex64 TDVP
that rides on them: the port against complex128 and the JAX package.

PyTorch's CPU LAPACK (torch 2.13) returns NaN from complex64 Householder
QR, and does not converge in the complex64 SVD, on some rank-deficient panels
(a few random nonzero rows: what a product state padded to chi gives).
``decompositions.lapack_factor`` factors complex64 CPU tensors in
complex128 and casts the factors back; these tests hold that rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.models import tdvp as jtdvp
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.models import tdvp as ttdvp
from tensornetwork_tpu_torch.ops import decompositions as TD

# complex64 factors against the complex128 factors of the same panel: one
# complex64 rounding of each entry (~6e-8) times the panel's size
C64_TOL = 1e-5
# 1 - |<psi_port|psi_jax>| after evolve(0.2, 4) in complex64: both carry
# f32 rounding over 4 sweeps of N=6 local steps (~1e-6 measured)
C64_OVERLAP_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Thousands of tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rank2_panels(seed, count, shape=(16, 8)):
    """complex64 panels with two random nonzero rows at random places."""
    rng = np.random.default_rng(seed)
    out = np.zeros((count,) + shape, np.complex128)
    for p in out:
        rows = rng.choice(shape[0], 2, replace=False)
        p[rows] = (rng.standard_normal((2, shape[1]))
                   + 1j * rng.standard_normal((2, shape[1])))
    return torch.as_tensor(out, dtype=torch.complex64)


@pytest.mark.parametrize("batch", [None, (1,), (4,)],
                         ids=["unbatched", "b1", "b4"])
def test_householder_qr_complex64_rank_deficient_panels(batch):
    panels = _rank2_panels(0, 40)
    if batch is not None:
        panels = panels.reshape((-1,) + batch + (16, 8))
    for m in panels:
        q, r = TD.qr(m, "householder")
        assert q.dtype == r.dtype == torch.complex64
        assert bool(torch.isfinite(torch.view_as_real(q)).all()
                    and torch.isfinite(torch.view_as_real(r)).all())
        q2, r2 = torch.linalg.qr(m.to(torch.complex128))
        assert float((q.to(torch.complex128) - q2).abs().max()) < C64_TOL
        assert float((r.to(torch.complex128) - r2).abs().max()) < C64_TOL
        assert float((q @ r - m).abs().max()) < C64_TOL


def test_svd_masked_complex64_rank_deficient_panels():
    panels = _rank2_panels(1, 40)
    for m in panels:
        out = TD.svd_masked(m, 8)
        assert out.u.dtype == out.vh.dtype == torch.complex64
        assert out.s.dtype == torch.float32
        for t in (out.u, out.vh):
            assert bool(torch.isfinite(torch.view_as_real(t)).all())
        ref = TD.svd_masked(m.to(torch.complex128), 8)
        np.testing.assert_allclose(out.s.numpy(), ref.s.numpy(),
                                   atol=C64_TOL)
        # the rank-2 part is unique up to phases: compare the products
        rec = (out.u[:, :2] * out.s[:2]) @ out.vh[:2]
        assert float((rec - m).abs().max()) < C64_TOL


def test_factor_rule_is_by_device_and_dtype():
    m = _rank2_panels(2, 1)[0]
    calls = []

    def fn(x):
        calls.append(x.dtype)
        return torch.linalg.qr(x)

    TD.lapack_factor(fn, m)
    TD.lapack_factor(fn, m.to(torch.complex128))
    TD.lapack_factor(fn, m.real.contiguous())
    assert calls == [torch.complex128, torch.complex128, torch.float32]


def _dense(As):
    As = np.asarray(As)
    acc = As[0]
    for A in As[1:]:
        acc = np.einsum("a...b,bsc->a...sc", acc, A)
    chi = As.shape[1]
    return acc.reshape(chi, -1, chi)[0, :, 0]


@pytest.mark.parametrize("two_site", [False, True], ids=["1site", "2site"])
def test_tdvp_complex64_product_state_matches_jax(two_site):
    N, chi = 6, 8
    As = np.zeros((N, chi, 2, chi), np.complex64)
    As[:, 0, :, 0] = np.array([1.0, 0.3]) / np.hypot(1.0, 0.3)
    jt = jtdvp.TDVP(jnp.asarray(As), jmpo.FiniteTFI(-1.0, -1.2, N=N,
                                                    dtype=jnp.float32))
    # a float32 time keeps the JAX sweep in complex64 under x64 (a Python
    # float makes its coefficient complex128 and its scan carry wider)
    jt.evolve(np.float32(0.2), 4, two_site=two_site)
    tt = ttdvp.TDVP(torch.as_tensor(As), tmpo.FiniteTFI(
        -1.0, -1.2, N=N, dtype=torch.float32, device="cpu"))
    tt.evolve(0.2, 4, two_site=two_site)
    assert tt.As.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(tt.As)).all())
    a, b = _dense(tt.As.numpy()), _dense(jt.As)
    overlap = abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
    assert overlap >= 1 - C64_OVERLAP_TOL
