"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

Marked ``cuda``: they skip without a CUDA card (the kernels have no CPU
mode).  On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
import functools

import numpy as np
import pytest
import torch

from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.ops import decompositions as TD
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


# ---------------------------------------------------------------------------
# The large-chi tiers: K3 (two-pass), K4 (streamed), K7 (streamed matvec)
# ---------------------------------------------------------------------------


def _breakdown(device, dtype, chi=8, d=2):
    """A diagonal operator; instance 0 starts on an eigenvector (dies at
    step 0), instance 1 from zero (dead from the start)."""
    W = torch.eye(d, dtype=dtype, device=device).reshape(1, 1, d, d)
    Lt = torch.diag(torch.arange(1.0, chi + 1.0, dtype=dtype, device=device))
    Lt = Lt.reshape(1, 1, chi, chi).repeat(2, 1, 1, 1)
    Rt = torch.eye(chi, dtype=dtype, device=device).reshape(1, 1, chi, chi)
    Rt = Rt.repeat(2, 1, 1, 1)
    x = torch.zeros((2, d, chi, chi), dtype=dtype, device=device)
    x[0, 0, 0, 0] = 2.0
    return Lt, W, Rt, x


# chi=50: rows not 16-byte aligned (the 4-byte cp.async path); chi=200:
# ragged for the 64 and 128 tiles; B=8, chi=256: no split of stage 2
# (lgrid_plan)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,chi", [(1, 16), (1, 80), (3, 64), (1, 50),
                                   (1, 200), (8, 256)])
def test_streamed_lanczos_kernel_matches_twin_and_k2(cuda, dtype, B, chi):
    Lt, W, Rt, xt = _operands(B, chi, 2, 3, dtype, cuda)
    TK.reset_launch_counts()
    V, ab = TK.fused_lanczos_streamed(Lt, W, Rt, xt, 6)
    assert TK.launch_counts["fused_lanczos_streamed"] == 1
    assert TK.last_grid["fused_lanczos_streamed"] > 1  # the card on B=1 too
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(Lt, W, Rt, xt, 6)
    assert _rel(ab, ab0) < TOL[dtype][1] and _rel(V, V0) < TOL[dtype][1]
    V2, ab2 = TK.fused_lanczos(Lt, W, Rt, xt, 6)  # K2: the same function
    assert _rel(ab, ab2) < TOL[dtype][1] and _rel(V, V2) < TOL[dtype][1]
    # deterministic reductions: a second launch gives the same bits
    V3, ab3 = TK.fused_lanczos_streamed(Lt, W, Rt, xt, 6)
    assert torch.equal(V, V3) and torch.equal(ab, ab3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chi", [16, 80, 50, 200])
def test_two_pass_kernels_match_twins(cuda, dtype, chi):
    m = 6
    Lt, W, Rt, xt = _operands(2, chi, 2, 3, dtype, cuda)
    TK.reset_launch_counts()
    ab = TK.fused_lanczos_fact(Lt, W, Rt, xt, m)
    assert TK.launch_counts["fused_lanczos_fact"] == 1
    with highest_precision():
        ab0 = TK.fused_lanczos_fact_plain(Lt, W, Rt, xt, m)
    assert _rel(ab, ab0) < TOL[dtype][1]
    g = torch.Generator(device=cuda).manual_seed(0)
    wts = torch.randn((2, m), dtype=dtype, device=cuda, generator=g)
    y = TK.fused_lanczos_replay(Lt, W, Rt, xt, wts, ab)
    assert TK.launch_counts["fused_lanczos_replay"] == 1
    with highest_precision():
        y0 = TK.fused_lanczos_replay_plain(Lt, W, Rt, xt, wts, ab)
    assert _rel(y, y0) < TOL[dtype][1]
    # fact runs K4's recurrence bit for bit, and replay regenerates its
    # basis: replay with the weights e_j returns K4's v_j exactly
    V, ab4 = TK.fused_lanczos_streamed(Lt, W, Rt, xt, m)
    assert torch.equal(ab, ab4)
    for j in (0, 1, m - 1):
        e_j = torch.zeros((2, m), dtype=dtype, device=cuda)
        e_j[:, j] = 1.0
        assert torch.equal(TK.fused_lanczos_replay(Lt, W, Rt, xt, e_j, ab),
                           V[:, j])


def _two_pass(Lt, W, Rt, xt, m, wts, fact, replay):
    ab = fact(Lt, W, Rt, xt, m)
    return ab, replay(Lt, W, Rt, xt, wts, ab)


@pytest.mark.parametrize("chi", [64, 200])
def test_grid_lanczos_f32_error_against_f64(cuda, chi):
    # the 3xTF32 products keep K3's (ab, y) and K4's (ab, V) errors against
    # an f64 run of the twins on the same f32 operands within 4x the f32
    # twins' (cuBLAS SGEMM), as K2's; one TF32 product would read ~1e3 x.
    # y: each pass pipeline with the same Ritz weights.
    m = 6
    ops = _operands(2, chi, 2, 3, torch.float32, cuda, seed=chi)
    ops64 = [t.double() for t in ops]
    g = torch.Generator(device=cuda).manual_seed(1)
    wts = torch.randn((2, m), device=cuda, generator=g)

    def err(a, ref):
        return float((a.double() - ref).norm() / ref.norm())

    V, ab = TK.fused_lanczos_streamed(*ops, m)
    V64, ab64 = TK.fused_lanczos_plain(*ops64, m)
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(*ops, m)
        y0 = TK.fused_lanczos_replay_plain(*ops, wts, ab0)
    abf, y = _two_pass(*ops, m, wts, TK.fused_lanczos_fact,
                       TK.fused_lanczos_replay)
    y64 = TK.fused_lanczos_replay_plain(*ops64, wts.double(), ab64)
    assert err(ab, ab64) <= 4 * err(ab0, ab64), (err(ab, ab64), err(ab0, ab64))
    assert err(V, V64) <= 4 * err(V0, V64), (err(V, V64), err(V0, V64))
    assert err(abf, ab64) <= 4 * err(ab0, ab64)
    assert err(y, y64) <= 4 * err(y0, y64), (err(y, y64), err(y0, y64))


@pytest.mark.parametrize("tile", [(128, 128), (64, 64)])
@pytest.mark.parametrize("chi", [200, 256])
def test_grid_lanczos_kernels_at_each_tile(cuda, monkeypatch, chi, tile):
    # each block tile of the f32 grid kernels (lgrid_plan picks one by
    # shape), forced: against the twins, fact's ab is K4's and replay
    # regenerates K4's basis, bit for bit; chi=200 is ragged for both tiles
    m = 6
    plan = TK.lgrid_plan
    monkeypatch.setattr(TK, "lgrid_plan", lambda *a: plan(*a, tile=tile))
    ops = _operands(1, chi, 2, 3, torch.float32, cuda, seed=chi)
    V, ab = TK.fused_lanczos_streamed(*ops, m)
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(*ops, m)
    assert _rel(ab, ab0) < TOL[torch.float32][1]
    assert _rel(V, V0) < TOL[torch.float32][1]
    assert torch.equal(TK.fused_lanczos_fact(*ops, m), ab)
    e = torch.zeros((1, m), device=cuda)
    e[:, m - 1] = 1.0
    assert torch.equal(TK.fused_lanczos_replay(*ops, e, ab), V[:, m - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,chi", [(2, 64), (1, 200)])
def test_two_pass_kernels_repeat_launch_same_bits(cuda, dtype, B, chi):
    # fixed-slot sums in a fixed order, no float atomics: a second launch
    # of fact and of replay gives the same bits
    m = 5
    ops = _operands(B, chi, 2, 3, dtype, cuda, seed=chi + B)
    g = torch.Generator(device=cuda).manual_seed(2)
    wts = torch.randn((B, m), dtype=dtype, device=cuda, generator=g)
    ab, y = _two_pass(*ops, m, wts, TK.fused_lanczos_fact,
                      TK.fused_lanczos_replay)
    ab2, y2 = _two_pass(*ops, m, wts, TK.fused_lanczos_fact,
                        TK.fused_lanczos_replay)
    assert torch.equal(ab, ab2) and torch.equal(y, y2)
    assert torch.equal(TK.fused_lanczos_replay(*ops, wts, ab), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_lanczos_kernels_breakdown(cuda, dtype):
    # the breakdown chains equal the twins' bits: the operators are small
    # integers, which the 3xTF32 split keeps exact
    Lt, W, Rt, x = _breakdown(cuda, dtype, chi=64)
    V, ab = TK.fused_lanczos_streamed(Lt, W, Rt, x, 4)
    V0, ab0 = TK.fused_lanczos_plain(Lt, W, Rt, x, 4)
    assert torch.equal(ab, ab0) and torch.equal(V, V0)
    assert torch.equal(TK.fused_lanczos_fact(Lt, W, Rt, x, 4), ab0)
    wd = torch.ones((2, 4), dtype=dtype, device=cuda)
    assert torch.equal(TK.fused_lanczos_replay(Lt, W, Rt, x, wd, ab),
                       TK.fused_lanczos_replay_plain(Lt, W, Rt, x, wd, ab0))


def _matvec_operands(cuda, dtype, B, chi, nt, per_instance, seed):
    M = 3
    g = torch.Generator(device=cuda).manual_seed(seed)
    kw = dict(dtype=dtype, device=cuda, generator=g)
    Lt, Rt = (torch.randn((B, M, chi, chi), **kw) for _ in range(2))
    C = torch.randn((B, M, M, nt, nt) if per_instance else (M, M, nt, nt),
                    **kw)
    return Lt, C, Rt, torch.randn((B, nt, chi, chi), **kw)


# chi=200: a ragged edge of the 128, 64 and 32-deep tiles of gemm_tc32.cuh
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chi,nt", [(24, 2), (80, 2), (64, 4), (40, 4),
                                    (200, 2), (200, 4)])
@pytest.mark.parametrize("per_instance", [False, True])
def test_streamed_matvec_kernel_matches_twin(cuda, dtype, chi, nt,
                                             per_instance):
    Lt, C, Rt, x = _matvec_operands(cuda, dtype, 2, chi, nt, per_instance,
                                    chi + nt)
    TK.reset_launch_counts()
    y, alpha = TK.streamed_matvec(Lt, C, Rt, x)
    assert TK.launch_counts["streamed_matvec"] == 1
    with highest_precision():
        y0, alpha0 = TK.streamed_matvec_plain(Lt, C, Rt, x)
        own = (x * y).sum(dim=(1, 2, 3))
    assert _rel(y, y0) < TOL[dtype][0]
    scale = float(x.norm() * y0.norm())  # alpha may cancel
    assert float((alpha - alpha0).abs().max()) < TOL[dtype][0] * scale
    # alpha is <x, y> of the kernel's own y
    assert float((alpha - own).abs().max()) < TOL[dtype][0] * scale
    # no float atomics: a second launch gives the same bits
    y2, alpha2 = TK.streamed_matvec(Lt, C, Rt, x)
    assert torch.equal(y, y2) and torch.equal(alpha, alpha2)


@pytest.mark.parametrize("chi,nt", [(128, 2), (200, 4), (256, 4)])
@pytest.mark.parametrize("xl", [False, True])
def test_streamed_matvec_f32_error_against_f64(cuda, chi, nt, xl):
    # 3xTF32 keeps fp32 accuracy: y against an f64 einsum of the same f32
    # operands within 4x the f32 twin's error (one TF32 product: ~1e3x)
    Lt, C, Rt, x = _matvec_operands(cuda, torch.float32, 1, chi, nt, False,
                                    7 * chi + nt)
    y = (TK.streamed_matvec_xl(Lt, C, Rt, x, K3=2) if xl
         else TK.streamed_matvec(Lt, C, Rt, x))[0]
    with highest_precision():
        y0 = TK.streamed_matvec_plain(Lt, C, Rt, x)[0]
    y64 = TK.streamed_matvec_plain(*(t.double() for t in (Lt, C, Rt, x)))[0]

    def err(a):
        return float((a.double() - y64).norm() / y64.norm())

    assert err(y) <= 4 * err(y0), (err(y), err(y0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_large_chi_kernels_breakdown(cuda, dtype):
    Lt, W, Rt, x = _breakdown(cuda, dtype)
    m = 4
    V, ab = TK.fused_lanczos_streamed(Lt, W, Rt, x, m)
    V0, ab0 = TK.fused_lanczos_plain(Lt, W, Rt, x, m)
    assert torch.equal(V, V0) and torch.equal(ab, ab0)
    assert float(ab[0, 0, 0]) == 1.0 and bool((ab[0, 0, 1:] == 1e10).all())
    assert bool((ab[1, 0] == 1e10).all()) and bool((ab[:, 1] == 0).all())
    assert bool((V[0, 1:] == 0).all()) and bool((V[1] == 0).all())
    assert torch.equal(TK.fused_lanczos_fact(Lt, W, Rt, x, m), ab0)
    wts = torch.ones((2, m), dtype=dtype, device=cuda)
    y = TK.fused_lanczos_replay(Lt, W, Rt, x, wts, ab0)
    assert torch.equal(y, TK.fused_lanczos_replay_plain(Lt, W, Rt, x, wts, ab0))
    assert torch.equal(y[0], x[0] / 2) and bool((y[1] == 0).all())
    Vs, abs_ = TK.streamed_lanczos(Lt, W, Rt, x, m)
    assert torch.equal(Vs, V0) and torch.equal(abs_, ab0)


@pytest.mark.parametrize("tier", ["two_pass", "streamed", "streamed_matvec"])
def test_sweep_through_each_tier_is_variational(cuda, monkeypatch, tier):
    N, chi = 8, 8
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device=cuda)
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo))[0]
    As = tdmrg.random_mps_stack(0, N, chi, 2, dtype=torch.float64, device=cuda)
    monkeypatch.setattr(TK, "one_site_tier", lambda *a: tier)
    TK.reset_launch_counts()
    e = tdmrg.FiniteDMRG(As, mpo).run_one_site(num_sweeps=3, num_krylov_vecs=8)
    kernels = {"two_pass": ("fused_lanczos_fact", "fused_lanczos_replay"),
               "streamed": ("fused_lanczos_streamed",),
               "streamed_matvec": ("streamed_matvec",)}[tier]
    assert all(TK.launch_counts[k] > 0 for k in kernels)
    assert TK.launch_counts["fused_lanczos"] == 0
    assert exact - 1e-9 <= e < exact + 1e-8


# ---------------------------------------------------------------------------
# The two-site slice: K8 (XL streamed matvec) and K2 at nt=4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chi,nt", [(64, 4), (80, 2), (128, 4), (200, 2)])
@pytest.mark.parametrize("K3", [1, 2, 4])
@pytest.mark.parametrize("per_instance", [False, True])
def test_streamed_matvec_xl_kernel_matches_twin(cuda, dtype, chi, nt, K3,
                                                per_instance):
    Lt, C, Rt, x = _matvec_operands(cuda, dtype, 2, chi, nt, per_instance,
                                    chi + nt + K3)
    TK.reset_launch_counts()
    y, alpha = TK.streamed_matvec_xl(Lt, C, Rt, x, K3=K3)
    assert TK.launch_counts["streamed_matvec_xl"] == 1
    with highest_precision():
        y0, alpha0 = TK.streamed_matvec_xl_plain(Lt, C, Rt, x, K3)
        y7, _ = TK.streamed_matvec(Lt, C, Rt, x)
        own = (x * y).sum(dim=(1, 2, 3))
    assert _rel(y, y0) < TOL[dtype][0] and _rel(y, y7) < TOL[dtype][0]
    scale = float(x.norm() * y0.norm())  # alpha may cancel
    assert float((alpha - alpha0).abs().max()) < TOL[dtype][0] * scale
    assert float((alpha - own).abs().max()) < TOL[dtype][0] * scale
    # fixed-order sums: a second launch gives the same bits
    y2, alpha2 = TK.streamed_matvec_xl(Lt, C, Rt, x, K3=K3)
    assert torch.equal(y, y2) and torch.equal(alpha, alpha2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_streamed_matvec_xl_breakdown(cuda, dtype):
    Lt, W, Rt, x = _breakdown(cuda, dtype)
    m = 4
    V0, ab0 = TK.fused_lanczos_plain(Lt, W, Rt, x, m)
    for K3 in (1, 2, 4):
        V, ab = TK.streamed_lanczos(Lt, W, Rt, x, m, matvec=functools.partial(
            TK.streamed_matvec_xl, K3=K3))
        assert torch.equal(V, V0) and torch.equal(ab, ab0)
    assert float(ab0[0, 0, 0]) == 1.0 and bool((ab0[0, 0, 1:] == 1e10).all())
    assert bool((ab0[1, 0] == 1e10).all()) and bool((ab0[:, 1] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_lanczos_kernel_nt4_matches_twin(cuda, dtype):
    # the two-site resident tier: K2 with nt = d*d = 4 tiles
    Lt, C, Rt, xt = _operands(4, 64, 4, 3, dtype, cuda)
    TK.reset_launch_counts()
    V, ab = TK.fused_lanczos(Lt, C, Rt, xt, 6)
    assert TK.launch_counts["fused_lanczos"] == 1
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(Lt, C, Rt, xt, 6)
    assert _rel(ab, ab0) < TOL[dtype][1] and _rel(V, V0) < TOL[dtype][1]


@pytest.mark.parametrize("nt", [2, 4])
def test_fused_lanczos_f32_error_against_f64(cuda, nt):
    # the 3xTF32 products keep the kernel's error against an f64 run of the
    # same f32 operands within 4x the f32 twin's (cuBLAS SGEMM); one TF32
    # product would read ~1e3 x
    Lt, C, Rt, xt = _operands(4, 64, nt, 3, torch.float32, cuda, seed=nt)
    V, ab = TK.fused_lanczos(Lt, C, Rt, xt, 6)
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(Lt, C, Rt, xt, 6)
    V64, ab64 = TK.fused_lanczos_plain(Lt.double(), C.double(), Rt.double(),
                                       xt.double(), 6)

    def err(a, ref):
        return float((a.double() - ref).norm() / ref.norm())

    assert err(ab, ab64) <= 4 * err(ab0, ab64), (err(ab, ab64), err(ab0, ab64))
    assert err(V, V64) <= 4 * err(V0, V64), (err(V, V64), err(V0, V64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nt,chi", [(2, 64), (4, 64), (2, 80), (3, 24)])
def test_fused_lanczos_kernel_repeat_launch_same_bits(cuda, dtype, nt, chi):
    # fixed-order sums, no float atomics: a second launch gives the same
    # bits (nt=3 takes the kernel's run-time M, nt path)
    Lt, C, Rt, xt = _operands(3, chi, nt, 3, dtype, cuda, seed=chi)
    V, ab = TK.fused_lanczos(Lt, C, Rt, xt, 5)
    V2, ab2 = TK.fused_lanczos(Lt, C, Rt, xt, 5)
    assert torch.equal(V, V2) and torch.equal(ab, ab2)
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(Lt, C, Rt, xt, 5)
    assert _rel(ab, ab0) < TOL[dtype][1] and _rel(V, V0) < TOL[dtype][1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_lanczos_kernel_nt4_breakdown(cuda, dtype):
    # the two-site tier's breakdown chains equal the twin's bits: the
    # operators are small integers, which the 3xTF32 split keeps exact
    Lt, W, Rt, x = _breakdown(cuda, dtype, chi=64, d=4)
    V, ab = TK.fused_lanczos(Lt, W, Rt, x, 4)
    V0, ab0 = TK.fused_lanczos_plain(Lt, W, Rt, x, 4)
    torch.testing.assert_close(ab, ab0, rtol=0, atol=0)
    torch.testing.assert_close(V, V0, rtol=0, atol=0)
    assert float(ab[0, 0, 0]) == 1.0 and bool((ab[0, 0, 1:] == 1e10).all())
    assert bool((ab[1, 0] == 1e10).all()) and bool((ab[:, 1] == 0).all())


@pytest.mark.parametrize("tier,kernel", [
    ("resident", "fused_lanczos"), ("streamed_matvec", "streamed_matvec"),
    ("streamed_matvec_xl", "streamed_matvec_xl")])
def test_two_site_sweep_through_each_tier_is_variational(cuda, monkeypatch,
                                                         tier, kernel):
    N, chi = 8, 16
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device=cuda)
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo))[0]
    As = tdmrg.random_mps_stack(0, N, chi, 2, dtype=torch.float64, device=cuda)
    monkeypatch.setattr(TK, "two_site_tier", lambda *a: tier)
    TK.reset_launch_counts()
    e = tdmrg.FiniteDMRG(As, mpo).run_two_site(num_sweeps=4, num_krylov_vecs=8)
    assert TK.launch_counts[kernel] > 0
    assert sum(TK.launch_counts.values()) == TK.launch_counts[kernel]
    assert exact - 1e-9 <= e < exact + 1e-8


def test_one_site_sweep_through_the_xl_tier_is_variational(cuda, monkeypatch):
    N, chi = 8, 8
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device=cuda)
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo))[0]
    As = tdmrg.random_mps_stack(0, N, chi, 2, dtype=torch.float64, device=cuda)
    monkeypatch.setattr(TK, "one_site_tier", lambda *a: "streamed_matvec_xl")
    TK.reset_launch_counts()
    e = tdmrg.FiniteDMRG(As, mpo).run_one_site(num_sweeps=3, num_krylov_vecs=8)
    # every sweep solves 2N sites with m=8 matvecs each (it may stop early)
    count = TK.launch_counts["streamed_matvec_xl"]
    assert count > 0 and count % (2 * N * 8) == 0
    assert sum(TK.launch_counts.values()) == count
    assert exact - 1e-9 <= e < exact + 1e-8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_svd_masked_on_the_card_is_orthonormal(cuda, dtype):
    # the truncation isometry of the two-site sweep: cuSOLVER's gesvd keeps
    # f32 singular vectors orthonormal to rounding (the Jacobi routine did
    # not, and biased the sweep's Ritz energies)
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((2, 64, 64), dtype=dtype, device=cuda, generator=g)
    res = TD.svd_masked(a, 32)
    eye = torch.eye(32, dtype=dtype, device=cuda)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((res.u.mT @ res.u - eye).abs().max()) < tol
    assert float((res.vh @ res.vh.mT - eye).abs().max()) < tol
    ref = TD.svd_masked(a.cpu(), 32)
    torch.testing.assert_close(res.s.cpu(), ref.s, rtol=10 * tol, atol=10 * tol)


# ---------------------------------------------------------------------------
# K5 (the fused gauge-and-environment epilogue), K6 (the transfer chain) and
# K9 (the chained-GEMM probe)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,chi", [(3, 16), (4, 64), (1, 80), (1, 256)])
def test_fused_gauge_env_kernel_matches_twin(cuda, dtype, B, chi):
    M, d = 3, 2
    g = torch.Generator(device=cuda).manual_seed(chi + B)
    kw = dict(dtype=dtype, device=cuda, generator=g)
    W = torch.randn((M, M, d, d), **kw)
    E = torch.randn((B, M, chi, chi), **kw) / chi
    A = torch.randn((B, d * chi, chi), **kw)
    qi, ci = TK.polar_iters(dtype)
    TK.reset_launch_counts()
    Q, P, Enew = TK.fused_gauge_env(W, E, A, qi, ci)
    assert TK.launch_counts["fused_gauge_env"] == 1
    assert TK.last_grid["fused_gauge_env"] >= 1
    with highest_precision():
        ref = TK.fused_gauge_env_plain(W, E, A, qi, ci)
    # the polar steps contract rounding differences: the f32 and f64 gates
    # of the Lanczos kernels hold
    for out, want in zip((Q, P, Enew), ref):
        assert _rel(out, want) < TOL[dtype][1]
    eye = torch.eye(chi, dtype=dtype, device=cuda)
    assert float((Q.mT @ Q - eye).abs().max()) < TOL[dtype][1]
    assert float((Q @ P - A).norm() / A.norm()) < TOL[dtype][1]
    # fixed-order sums: a second launch gives the same bits
    Q2, P2, E2 = TK.fused_gauge_env(W, E, A, qi, ci)
    assert torch.equal(Q, Q2) and torch.equal(P, P2) and torch.equal(Enew, E2)


def test_fused_epilogue_sweep_on_the_card_is_variational(cuda):
    N, chi = 8, 8
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device=cuda)
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo))[0]
    As = tdmrg.random_mps_stack(0, N, chi, 2, dtype=torch.float64, device=cuda)
    TK.reset_launch_counts()
    e = tdmrg.FiniteDMRG(As, mpo).run_one_site(
        num_sweeps=3, num_krylov_vecs=8, qr_impl="polar", epilogue_impl="fused")
    # the prepass (N) and 2N per sweep, unless a sweep stops early
    assert TK.launch_counts["fused_gauge_env"] >= 3 * N
    assert exact - 1e-9 <= e < exact + 1e-8


@pytest.mark.parametrize("dtype,chi,d,B,N", [
    (torch.bfloat16, 128, 2, 3, 5), (torch.bfloat16, 40, 2, 3, 5),
    (torch.float32, 64, 2, 3, 5), (torch.float32, 15, 3, 3, 5),
    # the shapes the route "tiled" opened: chi > 128, f32 at chi = 128,
    # d beyond the resident budget, a chi that is padded
    (torch.bfloat16, 256, 2, 16, 8), (torch.float32, 256, 2, 16, 8),
    (torch.float32, 128, 2, 16, 8), (torch.bfloat16, 128, 3, 4, 4),
    (torch.bfloat16, 150, 2, 2, 3)])
def test_transfer_chain_kernel_matches_twin(cuda, dtype, chi, d, B, N):
    g = torch.Generator(device=cuda).manual_seed(chi + d)
    As = (torch.randn((B, N, chi, d, chi), device=cuda, generator=g)
          / (d * chi) ** 0.5).to(dtype)
    E0 = torch.eye(chi, device=cuda).expand(B, chi, chi)
    route = TK.transfer_chain_route(chi, d, dtype)
    TK.reset_launch_counts()
    E = TK.transfer_chain(As, E0)
    assert TK.launch_counts["transfer_chain"] == 1
    assert TK.route_counts["transfer_chain_" + route] == 1
    assert E.dtype == torch.float32 and E.shape == (B, chi, chi)
    ref = TK.transfer_chain_plain(As, E0)
    # bf16: the same exact products summed in another order; a rounding of
    # Y flips on a near-tie (one bf16 ulp, 3.9e-3 of an entry)
    tol = 2e-2 if dtype == torch.bfloat16 else TOL[torch.float32][0]
    assert _rel(E, ref) < tol
    assert torch.equal(E, TK.transfer_chain(As, E0))


@pytest.mark.parametrize("M,K,N,P,reps", [(32, 16, 16, 1, 1),
                                          (64, 32, 48, 2, 3),
                                          (128, 128, 128, 4, 2)])
def test_gemm_chain_kernel_matches_twin(cuda, M, K, N, P, reps):
    from tensornetwork_tpu_torch.benchmarks import mxu_micro
    x, b, c = mxu_micro.chain_inputs(M, K, N, P, device=cuda)
    TK.reset_launch_counts()
    out = TK.gemm_chain(x, b, c, reps)
    assert TK.launch_counts["gemm_chain"] == 1
    ref = TK.gemm_chain_plain(x, b, c, reps)
    # bf16 between the steps, as for the transfer chain
    assert _rel(out.float(), ref.float()) < 2e-2
