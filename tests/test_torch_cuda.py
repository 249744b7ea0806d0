"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

Marked ``cuda``: they skip without a CUDA card (the kernels have no CPU
mode).  On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.ops import kernels as TK

pytestmark = pytest.mark.cuda

# fp32 kernel and twin sum the same products in other orders: a few ulp of
# chi*M*d-term sums (1e-5 relative); the Lanczos recurrence carries that
# over m steps (1e-4).  f64: the same at double precision.
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-10)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _operands(B, chi, d, M, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, chi, M, chi))
    L = (L + L.transpose(0, 3, 2, 1)) / 2
    R = rng.standard_normal((B, chi, M, chi))
    R = (R + R.transpose(0, 3, 2, 1)) / 2
    W = rng.standard_normal((M, M, d, d))
    W = (W + W.transpose(1, 0, 3, 2)) / 2
    x = rng.standard_normal((B, chi, d, chi))
    return TK.prepare_operands(*(torch.as_tensor(a, dtype=dtype, device=device)
                                 for a in (L, W, R, x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chi", [24, 64, 80])  # partial, one and 2x2 tiles
def test_heff_matvec_kernel_matches_twin(cuda, dtype, chi):
    Lt, W, Rt, xt = _operands(3, chi, 2, 3, dtype, cuda)
    TK.reset_launch_counts()
    y = TK.heff_matvec(Lt, W, Rt, xt)
    assert TK.launch_counts["heff_matvec"] == 1
    with highest_precision():
        ref = TK.heff_matvec_plain(Lt, W, Rt, xt)
    assert _rel(y, ref) < TOL[dtype][0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chi", [16, 64, 80])
def test_fused_lanczos_kernel_matches_twin(cuda, dtype, chi):
    Lt, W, Rt, xt = _operands(4, chi, 2, 3, dtype, cuda)
    TK.reset_launch_counts()
    V, ab = TK.fused_lanczos(Lt, W, Rt, xt, 6)
    assert TK.launch_counts["fused_lanczos"] == 1
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(Lt, W, Rt, xt, 6)
    assert _rel(ab, ab0) < TOL[dtype][1]
    assert _rel(V, V0) < TOL[dtype][1]


def test_fused_lanczos_kernel_breakdown(cuda):
    chi, d = 8, 2
    W = torch.eye(d, device=cuda).reshape(1, 1, d, d)
    Lt = torch.diag(torch.arange(1.0, chi + 1.0, device=cuda)).reshape(1, 1, chi, chi)
    Rt = torch.eye(chi, device=cuda).reshape(1, 1, chi, chi)
    x = torch.zeros((2, d, chi, chi), device=cuda)
    x[0, 0, 0, 0] = 2.0  # an eigenvector; instance 1 is a zero start
    V, ab = TK.fused_lanczos(Lt.expand(2, -1, -1, -1).contiguous(), W,
                             Rt.expand(2, -1, -1, -1).contiguous(), x, 4)
    V0, ab0 = TK.fused_lanczos_plain(Lt.expand(2, -1, -1, -1), W,
                                     Rt.expand(2, -1, -1, -1), x, 4)
    torch.testing.assert_close(ab, ab0, rtol=0, atol=0)
    torch.testing.assert_close(V, V0, rtol=0, atol=0)
    assert float(ab[0, 0, 0]) == 1.0 and bool((ab[0, 0, 1:] == 1e10).all())
    assert bool((ab[1, 0] == 1e10).all()) and bool((ab[:, 1] == 0).all())


def test_sweep_on_the_card_is_variational(cuda):
    N, chi = 8, 8
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device=cuda)
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo))[0]
    As = tdmrg.random_mps_stack(0, N, chi, 2, dtype=torch.float64, device=cuda)
    TK.reset_launch_counts()
    e = tdmrg.FiniteDMRG(As, mpo).run_one_site(num_sweeps=3, num_krylov_vecs=8)
    assert TK.launch_counts["fused_lanczos"] > 0
    assert exact - 1e-9 <= e < exact + 1e-8
