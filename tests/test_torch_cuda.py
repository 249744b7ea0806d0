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
from tensornetwork_tpu_torch.ops import krylov as TKr
from tensornetwork_tpu_torch.utils import tracing

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
@pytest.mark.parametrize("chi,cb,nt,B", [(64, 16, 2, 3), (80, 40, 4, 2),
                                         (100, 25, 2, 1)])
def test_heff_matvec_block_contract_matches_twin(cuda, dtype, chi, cb, nt,
                                                 B):
    """K1 on a block of the right bond (the bond-sharded sweep's partial:
    xt (B, nt, chi, cb), Rt (B, M, cb, chi)) takes route "rect"."""
    rng = np.random.default_rng(chi + cb)
    M = 3
    L, R = (rng.standard_normal((B, chi, M, chi)) for _ in range(2))
    W = rng.standard_normal((M, M, nt, nt))
    x = rng.standard_normal((B, chi, nt, chi))
    Lt, Wt, Rt, xt = TK.prepare_operands(*(
        torch.as_tensor(a, dtype=dtype, device=cuda)
        for a in (L, W, R[:, :cb], x[..., :cb])))
    TK.reset_launch_counts()
    y = TK.heff_matvec(Lt, Wt, Rt, xt)
    assert TK.route_counts["heff_matvec_rect"] == 1
    assert y.shape == (B, nt, chi, chi)
    with highest_precision():
        ref = TK.heff_matvec_plain(Lt, Wt, Rt, xt)
    assert _rel(y, ref) < TOL[dtype][0]
    assert torch.equal(y, TK.heff_matvec(Lt, Wt, Rt, xt))


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


def _per_instance(W, B, seed):
    """(B, M, M, nt, nt) Hermitian couplings, one set per instance."""
    rng = np.random.default_rng(seed)
    Wb = rng.standard_normal((B,) + tuple(W.shape))
    Wb = (Wb + Wb.transpose(0, 2, 1, 4, 3)) / 2
    return torch.as_tensor(Wb, dtype=W.dtype, device=W.device)


@pytest.mark.parametrize("route", ["tc32", "simt"])
@pytest.mark.parametrize("B", [1, 3, 256])
@pytest.mark.parametrize("chi", [16, 64, 100])
@pytest.mark.parametrize("nt", [2, 4])
@pytest.mark.parametrize("per_instance", [False, True])
def test_heff_matvec_f32_routes_match_twin(cuda, route, B, chi, nt,
                                           per_instance):
    # "tc32", the route of every f32 call: the twin's products summed in
    # other orders on the 3xTF32 core; "simt", the first port's kernel,
    # kept as its yardstick
    fn = TK.heff_matvec if route == "tc32" else TK.heff_matvec_simt
    Lt, W, Rt, xt = _operands(B, chi, nt, 3, torch.float32, cuda,
                              seed=B + chi + nt)
    if per_instance:
        W = _per_instance(W, B, seed=chi)
    TK.reset_launch_counts()
    y = fn(Lt, W, Rt, xt)
    assert TK.launch_counts["heff_matvec"] == 1
    assert TK.route_counts["heff_matvec_" + route] == 1
    with highest_precision():
        ref = TK.heff_matvec_plain(Lt, W, Rt, xt)
    assert _rel(y, ref) < TOL[torch.float32][0]
    # no float atomics: a second launch gives the same bits
    assert torch.equal(y, fn(Lt, W, Rt, xt))


@pytest.mark.parametrize("B,nt", [(1, 2), (1, 4), (256, 2), (256, 4)])
def test_heff_matvec_f32_error_against_f64(cuda, B, nt):
    # on the route the router picks, y against an f64 run of the twin on
    # the same f32 operands within 2x the f32 twin's error (cuBLAS SGEMM)
    Lt, W, Rt, xt = _operands(B, 64, nt, 3, torch.float32, cuda, seed=nt)
    y = TK.heff_matvec(Lt, W, Rt, xt)
    with highest_precision():
        y0 = TK.heff_matvec_plain(Lt, W, Rt, xt)
    y64 = TK.heff_matvec_plain(*(t.double() for t in (Lt, W, Rt, xt)))

    def err(a):
        return float((a.double() - y64).norm() / y64.norm())

    assert err(y) <= 2 * err(y0), (err(y), err(y0))


def test_heff_matvec_f64_takes_the_simt_route(cuda):
    Lt, W, Rt, xt = _operands(3, 40, 2, 3, torch.float64, cuda)
    TK.reset_launch_counts()
    y = TK.heff_matvec(Lt, W, Rt, xt)
    assert TK.route_counts["heff_matvec_simt"] == 1
    assert _rel(y, TK.heff_matvec_plain(Lt, W, Rt, xt)) < TOL[torch.float64][0]
    assert torch.equal(y, TK.heff_matvec_simt(Lt, W, Rt, xt))


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


# (dtype, B, chi, route asked for, route taken): f32 takes the resident
# route at chi padded to 32 and 64, and at 96 and 128 from 8 and 64
# instances; each of its four instances also runs when asked; the grid
# route takes the rest, f32 when asked, and f64
@pytest.mark.parametrize("dtype,B,chi,ask,route", [
    (torch.float32, 3, 16, None, "resident"),
    (torch.float32, 4, 64, None, "resident"),
    (torch.float32, 1, 80, "resident", "resident"),
    (torch.float32, 1, 128, "resident", "resident"),
    (torch.float32, 1, 80, None, "grid"),
    (torch.float32, 1, 256, None, "grid"),
    (torch.float32, 4, 64, "grid", "grid"),
    (torch.float64, 3, 16, None, "grid"),
    (torch.float64, 4, 64, None, "grid"),
    (torch.float64, 1, 80, None, "grid"),
    (torch.float64, 1, 256, None, "grid")])
def test_fused_gauge_env_kernel_matches_twin(cuda, dtype, B, chi, ask, route):
    M, d = 3, 2
    g = torch.Generator(device=cuda).manual_seed(chi + B)
    kw = dict(dtype=dtype, device=cuda, generator=g)
    W = torch.randn((M, M, d, d), **kw)
    E = torch.randn((B, M, chi, chi), **kw) / chi
    A = torch.randn((B, d * chi, chi), **kw)
    qi, ci = TK.polar_iters(dtype)
    assert ask is not None or TK.gauge_env_route(chi, d, M, dtype, B) == route
    TK.reset_launch_counts()
    Q, P, Enew = TK.fused_gauge_env(W, E, A, qi, ci, route=ask)
    assert TK.launch_counts["fused_gauge_env"] == 1
    assert TK.route_counts["fused_gauge_env_" + route] == 1
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
    Q2, P2, E2 = TK.fused_gauge_env(W, E, A, qi, ci, route=ask)
    assert torch.equal(Q, Q2) and torch.equal(P, P2) and torch.equal(Enew, E2)


def test_fused_gauge_env_resident_rank_deficient_panel(cuda):
    # rank 40 of 64 columns on the resident route: on the panel's range Q
    # is an isometry and agrees with the twin; the null directions hold
    # rounding noise that the quintic steps inflate (3.44x a step),
    # differently on the two sides, so only the range part, P, QP = A and
    # U^T Q Q^T U = I are compared (tests/test_torch_gauge_env.py on the CPU)
    B, chi, d, M, rank = 2, 64, 2, 3, 40
    rng = np.random.default_rng(5)
    U = np.linalg.qr(rng.standard_normal((B, d * chi, rank)))[0]
    V = np.linalg.qr(rng.standard_normal((B, chi, rank)))[0]
    A = np.einsum("Bkr,r,Bcr->Bkc", U, np.linspace(1.0, 0.2, rank), V)
    E = rng.standard_normal((B, M, chi, chi)) / chi
    W = rng.standard_normal((M, M, d, d))
    A, E, W = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
               for a in (A, E, W))
    U = torch.as_tensor(U, dtype=torch.float64, device=cuda)
    assert TK.gauge_env_route(chi, d, M, torch.float32) == "resident"
    TK.reset_launch_counts()
    Q, P, _ = TK.fused_gauge_env(W, E, A, 14, 7)
    assert TK.route_counts["fused_gauge_env_resident"] == 1
    with highest_precision():
        Qr, Pr, _ = TK.fused_gauge_env_plain(W, E, A, 14, 7)
    proj = lambda q: U @ (U.mT @ q.double())  # noqa: E731
    tol = TOL[torch.float32][1]
    assert _rel(proj(Q), proj(Qr)) < tol
    assert _rel(P, Pr) < tol
    assert float((Q @ P - A).norm() / A.norm()) < tol
    UQ = U.mT @ Q.double()
    eye = torch.eye(rank, dtype=torch.float64, device=cuda)
    assert float((UQ @ UQ.mT - eye).abs().max()) < 10 * tol


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


def _ladder_and_ragged():
    from tensornetwork_tpu_torch.benchmarks import mxu_micro
    # the probe's ladder at reps=2, and panels of 32 rows past a multiple
    # of 64 (M=32, M=96), which the wgmma route zero-fills and clips
    return [s[:4] + (2,) for s in mxu_micro.LADDER] + [(32, 128, 128, 2, 2),
                                                       (96, 128, 256, 3, 2)]


@pytest.mark.parametrize("M,K,N,P,reps", _ladder_and_ragged())
def test_gemm_chain_wgmma_route_matches_twin(cuda, M, K, N, P, reps):
    from tensornetwork_tpu_torch.benchmarks import mxu_micro
    assert TK.gemm_chain_route(M, K, N, P) == "wgmma"
    x, b, c = mxu_micro.chain_inputs(M, K, N, P, device=cuda)
    TK.reset_launch_counts()
    out = TK.gemm_chain(x, b, c, reps)
    assert TK.route_counts["gemm_chain_wgmma"] == 1
    ref = TK.gemm_chain_plain(x, b, c, reps)
    # bf16 between the steps, as for the transfer chain
    assert _rel(out.float(), ref.float()) < 2e-2
    assert torch.equal(out, TK.gemm_chain(x, b, c, reps))
    # the WMMA route, kept as the yardstick, on the same operands
    wmma = TK.gemm_chain(x, b, c, reps, route="wmma")
    assert TK.route_counts["gemm_chain_wmma"] == 1
    assert _rel(wmma.float(), ref.float()) < 2e-2


# ---------------------------------------------------------------------------
# K2 at TDVP's shapes: the realified site (nt'=4, M'=6) and bond (nt'=2)
# steps, and the real bond step of imaginary time (nt=1)
# ---------------------------------------------------------------------------


def _tdvp_operands(B, chi, d, M, real, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def herm():
        a = rng.standard_normal((B, chi, M, chi)) + 1j * rng.standard_normal(
            (B, chi, M, chi))
        return (a + a.transpose(0, 3, 2, 1).conj()) / 2

    L, R = herm(), herm()
    x = rng.standard_normal((B, chi, d, chi)) + 1j * rng.standard_normal(
        (B, chi, d, chi))
    W = rng.standard_normal((M, M, d, d))
    W = (W + W.transpose(1, 0, 3, 2)) / 2 if d > 1 else np.eye(M).reshape(
        M, M, 1, 1)
    if real:
        return TK.prepare_operands(*(torch.as_tensor(
            a.real, dtype=dtype, device=device) for a in (L, W, R, x)))
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    L, R, x = (torch.as_tensor(a, dtype=cdtype, device=device)
               for a in (L, R, x))
    return TK.realify_sandwich_operands(
        L, torch.as_tensor(W, dtype=dtype, device=device), R, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["sc_site", "sc_bond", "real_bond"])
def test_fused_lanczos_at_tdvp_shapes_matches_twin(cuda, dtype, case):
    B, d, real = {"sc_site": (4, 2, False), "sc_bond": (4, 1, False),
                  "real_bond": (1, 1, True)}[case]
    ops = _tdvp_operands(B, 64, d, 3, real, dtype, cuda)
    TK.reset_launch_counts()
    V, ab = TK.fused_lanczos(*ops, 10)
    assert TK.launch_counts["fused_lanczos"] == 1
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(*ops, 10)
    assert _rel(ab, ab0) < TOL[dtype][1]
    assert _rel(V, V0) < TOL[dtype][1]


def _overlaps(A, B):
    """<A|B> per instance of (b, N, chi, d, chi) stacks, identity
    boundaries."""
    A, B = A.to(torch.complex128), B.to(torch.complex128)
    E = torch.eye(A.shape[2], dtype=A.dtype, device=A.device).expand(
        A.shape[0], -1, -1)
    for i in range(A.shape[1]):
        E = torch.einsum("Bac,Basb,Bcsd->Bbd", E, A[:, i].conj(), B[:, i])
    return E.diagonal(dim1=1, dim2=2).sum(-1)


def test_batched_tdvp_sweep_on_the_card_matches_plain(cuda):
    from tensornetwork_tpu_torch.parallel.batch import (
        batched_tdvp_one_site_sweep_sc)
    B, N, chi = 4, 8, 16
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32, device=cuda)
    psi = tdmrg.random_mps_stack(3, B * N, chi, 2, dtype=torch.float32,
                                 device=cuda).reshape(B, N, chi, 2, chi)
    TK.reset_launch_counts()
    got = batched_tdvp_one_site_sweep_sc(psi.to(torch.complex64), mpo.Ws,
                                         mpo.vL, mpo.vR, 0.05,
                                         num_krylov_vecs=10)
    assert TK.launch_counts["fused_lanczos"] == 4 * N
    ref = batched_tdvp_one_site_sweep_sc(psi.double().to(torch.complex128),
                                         mpo.Ws.double(), mpo.vL.double(),
                                         mpo.vR.double(), 0.05,
                                         num_krylov_vecs=10,
                                         lanczos_impl="plain")
    assert TK.launch_counts["fused_lanczos"] == 4 * N
    fid = _overlaps(got, ref).abs() / (_overlaps(got, got).real
                                       * _overlaps(ref, ref).real).sqrt()
    # one f32 sweep against complex128: f32 rounding over 4N local steps
    assert float(fid.min()) > 1 - 1e-5


# ---------------------------------------------------------------------------
# VUMPS (K2 in the AC and C solves) and the complex64 gauges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,d,instance", [("ac", 2, "tc<3,2>"),
                                             ("c", 1, "tc<0,0>")])
def test_fused_lanczos_at_vumps_shapes_matches_twin(cuda, dtype, case, d,
                                                    instance):
    # B=1, chi=64, M=3, m=25: the AC solve (nt=2) and the C solve (nt=1,
    # identity couplings)
    ops = _tdvp_operands(1, 64, d, 3, True, dtype, cuda, seed=11)
    TK.reset_launch_counts()
    V, ab = TK.fused_lanczos(*ops, 25)
    assert TK.launch_counts["fused_lanczos"] == 1
    want = instance if dtype == torch.float32 else "simt"
    assert TK.route_counts["fused_lanczos_" + want] == 1
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(*ops, 25)
        V64, ab64 = TK.fused_lanczos_plain(*(t.double() for t in ops), 25)
    # m=25 plain steps carry the rounding further than m=10: hold the
    # kernel to 3x its twin's error against f64 (chip_smoke's bar)
    for got, twin, ref in ((ab, ab0, ab64), (V, V0, V64)):
        err = float((got.double() - ref).norm() / ref.norm())
        err0 = float((twin.double() - ref).norm() / ref.norm())
        assert err <= 3 * err0 + 1e-13


def _vumps_state(dtype, device, chi=16):
    from tensornetwork_tpu_torch.models import vumps as TV
    st = TV.random_vumps_state(3, chi, dtype=torch.float64, device="cpu")
    return TV.VUMPSState(*(x.to(dtype=dtype, device=device) for x in st))


@pytest.mark.parametrize("dtype,e_tol,fid_tol", [
    (torch.float64, 1e-10, 1e-10), (torch.float32, 1e-5, 1e-5)])
def test_vumps_iteration_on_the_card_matches_cpu(cuda, dtype, e_tol,
                                                 fid_tol):
    from tensornetwork_tpu_torch.models import vumps as TV
    W = tmpo.FiniteTFI(-1.0, -0.8, N=3, dtype=dtype, device="cpu").Ws[1]
    lams = TV.mpo_diagonal_coefficients(W)
    TK.reset_launch_counts()
    TV.reset_counts()
    got = TV.vumps_iteration(_vumps_state(dtype, cuda), W.to(cuda), lams,
                             solve_tol=1e-6)
    launched = TK.launch_counts["fused_lanczos"]
    assert launched == TV.counts["ac_passes"] + TV.counts["c_passes"] > 0
    ref = TV.vumps_iteration(_vumps_state(dtype, "cpu"), W, lams,
                             lanczos_impl="fused", solve_tol=1e-6)
    assert abs(float(got[1]) - float(ref[1])) < e_tol
    a = got[0].AC.double().cpu().reshape(-1)
    b = ref[0].AC.double().reshape(-1)
    assert float(torch.dot(a, b).abs() / (a.norm() * b.norm())) > 1 - fid_tol


def test_vumps_default_launches_k2_on_real_states_only(cuda):
    from tensornetwork_tpu_torch.models import vumps as TV
    W = tmpo.FiniteTFI(-1.0, -1.0, N=3, dtype=torch.float32,
                       device=cuda).Ws[1]
    lams = TV.mpo_diagonal_coefficients(W)
    TK.reset_launch_counts()
    TV.reset_counts()
    TV.vumps_iteration(_vumps_state(torch.float32, cuda), W, lams,
                       lanczos_restarts=2)
    assert TV.counts == {"ac_passes": 2, "c_passes": 2, "ritz_checks": 0}
    assert TK.route_counts["fused_lanczos_tc<3,2>"] == 2
    assert TK.route_counts["fused_lanczos_tc<0,0>"] == 2
    assert TK.launch_counts["fused_lanczos"] == 4
    TK.reset_launch_counts()
    TV.vumps_iteration(_vumps_state(torch.complex64, cuda), W, lams,
                       lanczos_restarts=2)
    assert TK.launch_counts["fused_lanczos"] == 0


@pytest.mark.parametrize("two_site", [False, True], ids=["1site", "2site"])
def test_tdvp_complex64_product_state_on_the_card(cuda, two_site):
    from tensornetwork_tpu_torch.models import tdvp as ttdvp
    N, chi = 6, 8
    As = np.zeros((N, chi, 2, chi), np.complex64)
    As[:, 0, :, 0] = np.array([1.0, 0.3]) / np.hypot(1.0, 0.3)
    runs = []
    for dtype, device in ((torch.complex64, cuda),
                          (torch.complex128, "cpu")):
        real = torch.float32 if dtype == torch.complex64 else torch.float64
        mpo = tmpo.FiniteTFI(-1.0, -1.2, N=N, dtype=real, device=device)
        t = ttdvp.TDVP(torch.as_tensor(As, dtype=dtype, device=device), mpo)
        t.evolve(0.2, 4, two_site=two_site)
        runs.append(t.As.to(torch.complex128).cpu())
    got, ref = runs
    assert bool(torch.isfinite(torch.view_as_real(got)).all())

    def dense(A):
        acc = A[0]
        for X in A[1:]:
            acc = torch.einsum("a...b,bsc->a...sc", acc, X)
        return acc.reshape(chi, -1, chi)[0, :, 0]

    a, b = dense(got), dense(ref)
    overlap = float(torch.vdot(a, b).abs() / (a.norm() * b.norm()))
    assert overlap >= 1 - 1e-4


# The MPS object layer: the card against the CPU in f64/complex128.  The
# same algorithms (cuSOLVER against LAPACK for the factorizations) on the
# same inputs: ~1e-13 seen where gauge-free.
OBJ_TOL = 1e-10


def _mps_stack(dtype, N=6, chi=8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, chi, 2, chi))
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal(a.shape)
    return torch.as_tensor(a / np.sqrt(2 * chi), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_finite_mps_measurements_on_the_card_match_cpu(cuda, dtype):
    from tensornetwork_tpu_torch.models.mps import FiniteMPS
    X, Z = np.array([[0.0, 1.0], [1.0, 0.0]]), np.diag([1.0, -1.0])
    out = {}
    for dev in ("cpu", cuda):
        m = FiniteMPS(_mps_stack(dtype).to(dev))
        assert m.device.type == torch.device(dev).type
        norm = m.position(3)
        # the deviation from canonical form is rounding on both sides
        assert float(m.check_canonical()) < 1e-12
        out[str(dev)] = [norm,
                         torch.stack(m.measure_local_operator([Z, X] * 3,
                                                              range(6))),
                         torch.stack(m.measure_two_body_correlator(
                             X, X, 2, range(6))), m.to_dense()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _rel(a.cpu(), b) < OBJ_TOL


@pytest.mark.parametrize("imaginary", [False, True])
def test_tebd_sweep_on_the_card_matches_cpu(cuda, imaginary):
    from tensornetwork_tpu_torch.models import tebd
    from tensornetwork_tpu_torch.models.mps import FiniteMPS
    X, Z = np.array([[0.0, 1.0], [1.0, 0.0]]), np.diag([1.0, -1.0])
    h2 = -np.kron(X, X) - 0.5 * (np.kron(Z, np.eye(2)) + np.kron(np.eye(2), Z))
    out = {}
    for dev in ("cpu", cuda):
        m = FiniteMPS(_mps_stack(torch.complex128, seed=1).to(dev))
        gate = tebd.trotter_gate(h2, 0.1, imaginary=imaginary, device=dev)
        w = tebd.tebd_sweep(m, gate, max_singular_values=6)
        out[str(dev)] = (w, m.to_dense(), tebd.measure_energy(m, h2))
    assert abs(out["cuda"][0] - out["cpu"][0]) < OBJ_TOL
    assert _rel(out["cuda"][1].cpu(), out["cpu"][1]) < OBJ_TOL
    assert abs(out["cuda"][2] - out["cpu"][2]) < OBJ_TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_infinite_mps_canonicalize_on_the_card_matches_cpu(cuda, dtype):
    from tensornetwork_tpu_torch.models.infinite_mps import InfiniteMPS
    out = {}
    for dev in ("cpu", cuda):
        m = InfiniteMPS(_mps_stack(dtype, N=2, chi=6, seed=2).to(dev))
        eta, r = m.canonicalize()
        out[str(dev)] = (eta, r, m.As, m.check_right_canonical())
    assert abs(out["cuda"][0] - out["cpu"][0]) < OBJ_TOL
    assert _rel(out["cuda"][1].cpu(), out["cpu"][1]) < 1e-8
    assert _rel(out["cuda"][2].cpu(), out["cpu"][2]) < 1e-8
    assert out["cuda"][3] < 1e-10


def test_mera_iteration_on_the_card_matches_cpu(cuda):
    from tensornetwork_tpu_torch.models import mera
    rng = np.random.default_rng(3)
    us = [np.linalg.qr(rng.standard_normal((16, 16)))[0].reshape((4,) * 4)]
    ws = [np.linalg.qr(rng.standard_normal((16, 4)))[0].T.reshape((4,) * 3)]
    out = {}
    for dev in ("cpu", cuda):
        state = mera.MERAState([torch.as_tensor(u, device=dev) for u in us],
                               [torch.as_tensor(w, device=dev) for w in ws])
        h = mera.blocked_ising_hamiltonian(device=dev)
        out[str(dev)] = mera.optimize_mera(h, state, num_iterations=1,
                                           num_top_iters=4)
    (sc, ec), (sp, ep) = out["cuda"], out["cpu"]
    assert abs(ec - ep) < OBJ_TOL
    for a, b in zip(sc.us + sc.ws, sp.us + sp.ws):
        assert _rel(a.cpu(), b) < 1e-8


# ---------------------------------------------------------------------------
# K10: the power Ritz step (tridiag_ritz_power) against its twin
# ---------------------------------------------------------------------------

# lam relative, w absolute.  The closed-form 2x2 step stalls about sqrt(eps)
# from the eigenvector, at a point the rounding picks: K10 and the twin,
# which sum in other orders, agree on w to that floor (a gap factor above
# it where 60 steps leave an instance short of it) and on lam to about its
# square (tests/test_torch_tridiag_ritz.py).  K10's own arithmetic is held
# bit for bit against _k10_model.
RITZ_TOL = {torch.float32: (2e-5, 2e-3), torch.float64: (1e-11, 1e-6)}
RITZ_CASES = ("projection", "dead", "zero_beta")


def _ritz_projections(B, m, case, dtype, device, seed=0):
    """ab (B, 2, m) in the fused Lanczos's layout (alphas in row 0, betas
    in row 1): m Lanczos steps in float64 on random symmetric matrices
    with a gapped ground state, from a start near the ground vector, cast
    to ``dtype``.  ``"dead"``: the factorization broken down after m // 2
    steps (beta 0 and the alpha sentinel 1e10 after them, as the fused
    Lanczos leaves it); ``"zero_beta"``: beta zero at m // 2, the later
    steps kept."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=torch.float64, device=device)
    n = 2 * m + 8
    q, _ = torch.linalg.qr(torch.randn(B, n, n, generator=g, **kw))
    spectrum = torch.cat([torch.full((B, 1), -1.5, **kw),
                          2 * torch.rand(B, n - 1, generator=g, **kw) - 1], 1)
    H = (q * spectrum[:, None, :]) @ q.transpose(1, 2)
    v0 = q[:, :, 0] + 0.5 * torch.randn(B, n, generator=g, **kw) / n ** 0.5
    _, al, be = TKr.lanczos_factorization(
        lambda x: (H @ x[..., None])[..., 0], v0, m)
    k = max(m // 2, 1)
    if case == "dead":
        al[:, k:] = TKr.LARGE
        be[:, k - 1:] = 0.0
    if case == "zero_beta" and m > 1:
        be[:, k - 1] = 0.0
    ab = torch.zeros((B, 2, m), dtype=dtype, device=device)
    ab[:, 0] = al
    ab[:, 1, :m - 1] = be
    return ab


def _leading_ground(ab, case):
    """The smallest eigenvalue (float64) of the block of each tridiagonal
    that e1 lies in."""
    m = ab.shape[-1]
    k = max(m // 2, 1) if case == "zero_beta" else m
    al, be = ab[:, 0, :k].double(), ab[:, 1, :k - 1].double()
    T = (torch.diag_embed(al) + torch.diag_embed(be, 1)
         + torch.diag_embed(be, -1))
    return torch.linalg.eigvalsh(T)[:, 0].to(ab.dtype)


def _k10_model(ab, iters=60):
    """K10's arithmetic in numpy: T u sums a row's three terms left to
    right, a dot product is a butterfly over 32 lanes holding entries j and
    j + 32, and every operation rounds once, as the kernel's ``_rn``
    intrinsics do.  Returns (lam (B,), w (B, m))."""
    a, b = ab[:, 0].cpu().numpy(), ab[:, 1, :-1].cpu().numpy()
    B, m = a.shape
    t = a.dtype.type

    def rows(x, n, shift):  # x[:, i + shift], i < 64, zero outside [0, n)
        out = np.zeros((B, 64), a.dtype)
        i = np.arange(64) + shift
        ok = (i >= 0) & (i < n)
        out[:, ok] = x[:, i[ok]]
        return out

    lo, d, hi = rows(b, m - 1, -1), rows(a, m, 0), rows(b, m - 1, 0)
    zero = np.zeros((B, 1), a.dtype)
    lane = np.arange(32)

    def tmv(u):
        um = np.concatenate([zero, u[:, :-1]], 1)
        up = np.concatenate([u[:, 1:], zero], 1)
        return lo * um + d * u + hi * up

    def dot(x, y):
        s = x[:, :32] * y[:, :32] + x[:, 32:] * y[:, 32:]
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, lane ^ o]
        return s[:, :1]

    w = np.zeros((B, 64), a.dtype)
    w[:, 0] = 1
    with np.errstate(all="ignore"):
        for _ in range(iters):
            tw = tmv(w)
            lam = dot(w, tw)
            r = tw - lam * w
            r = r - dot(w, r) * w
            rn = np.sqrt(dot(r, r))
            u = r / np.where(rn > t(1e-30), rn, t(1))
            tu = tmv(u)
            h, g = dot(w, tu), dot(u, tu)
            lg = lam - g
            q = lg * lg / t(4) + h * h
            q = np.where(q < 0, t(0), q)
            mu = (lam + g) / t(2) - np.sqrt(q)
            v = h * w + (mu - lam) * u
            vn = np.sqrt(dot(v, v))
            keep = (rn > t(1e-14)) & (vn > t(1e-30))
            w = np.where(keep, v / np.where(vn > t(1e-30), vn, t(1)), w)
        return dot(w, tmv(w))[:, 0], w[:, :m]


@pytest.mark.parametrize("case", RITZ_CASES)
@pytest.mark.parametrize("m", [1, 2, 3, 10, 20, 32, 64])
@pytest.mark.parametrize("B", [1, 32, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tridiag_ritz_kernel_matches_twin(cuda, dtype, B, m, case):
    ab = _ritz_projections(B, m, case, dtype, cuda, seed=m)
    # strided rows of ab, as the fused tiers pass them
    al, be = ab[:, 0, :], ab[:, 1, :m - 1]
    TK.reset_launch_counts()
    lam, w = TK.tridiag_ritz_power(al, be)
    assert TK.launch_counts["tridiag_ritz"] == 1
    assert lam.shape == (B,) and w.shape == (B, m) and w.dtype == dtype
    lam0, w0 = TKr.tridiag_ritz_power_plain(al, be)
    lam_tol, w_tol = RITZ_TOL[dtype]
    # in float32 the shared step can turn a converged 2x2 pair off its
    # eigenvector, or over to its negative (h = |r| is rounding noise, and
    # so is the cancelled mu - lam): there K10 and the twin each follow
    # their own rounding
    exact = _leading_ground(ab, case)
    off = ((lam - exact > lam_tol * exact.abs())
           | (lam0 - exact > lam_tol * exact.abs()))
    sign = torch.sign((w * w0).sum(-1, keepdim=True))
    if dtype != torch.float32 or m != 2:
        assert not bool(off.any()) and bool((sign > 0).all())
    w0 = w0 * sign
    rel = torch.where(off, 0.0, (lam - lam0).abs() / lam0.abs())
    assert float(rel.max()) <= lam_tol
    assert float(torch.where(off[:, None], 0.0, (w - w0).abs()).max()
                 ) <= w_tol
    model_lam, model_w = _k10_model(ab)
    np.testing.assert_array_equal(lam.cpu().numpy(), model_lam)
    np.testing.assert_array_equal(w.cpu().numpy(), model_w)
    lam2, w2 = TK.tridiag_ritz_power(al, be)
    assert torch.equal(lam, lam2) and torch.equal(w, w2)
    if case == "dead":
        assert not bool(w[:, max(m // 2, 1):].any())


def test_tridiag_ritz_kernel_takes_any_leading_shape(cuda):
    ab = _ritz_projections(32, 10, "projection", torch.float32, cuda)
    lam, w = TK.tridiag_ritz_power(ab[:, 0], ab[:, 1, :9])
    # (8, 4) instances whose rows cannot be viewed as (32, m): a copy
    al = ab[:, 0].reshape(4, 8, 10).transpose(0, 1)
    be = ab[:, 1, :9].reshape(4, 8, 9).transpose(0, 1)
    lam2, w2 = TK.tridiag_ritz_power(al, be)
    assert lam2.shape == (8, 4) and w2.shape == (8, 4, 10)
    assert torch.equal(lam2, lam.reshape(4, 8).T)
    assert torch.equal(w2, w.reshape(4, 8, 10).transpose(0, 1))


def test_tridiag_ritz_kernel_keeps_a_converged_vector(cuda):
    # tests/test_torch_symmetric_dmrg_batched.py's 2x2 case: a zero step
    # (h = 0, mu = lam) must leave w as it is, not zero it
    a = np.array([-0.7061787843704224, -1.6161364316940308], np.float32)
    b = np.array([0.1387786865234375], np.float32)
    al = torch.tensor(a, device=cuda)[None]
    be = torch.tensor(b, device=cuda)[None]
    lam, w = TK.tridiag_ritz_power(al, be)
    lam0, w0 = TKr.tridiag_ritz_power_plain(al, be)
    exact = np.linalg.eigvalsh(np.diag(a.astype(np.float64))
                               + np.diag(b, 1) + np.diag(b, -1))[0]
    assert abs(float(lam[0]) - exact) < 1e-6
    assert abs(float(torch.linalg.vector_norm(w)) - 1.0) < 1e-6
    assert float((w - w0).abs().max()) <= RITZ_TOL[torch.float32][1]


def test_power_ritz_on_the_card_launches_k10_or_raises(cuda):
    ab = _ritz_projections(4, 10, "projection", torch.float32, cuda)
    tracing.reset()
    TK.reset_launch_counts()
    TKr.tridiag_ritz(ab[:, 0], ab[:, 1, :9], "power")
    assert TK.launch_counts["tridiag_ritz"] == 1
    assert tracing.counts.get("ritz.kernel") == 1
    assert "ritz.plain" not in tracing.counts
    a = torch.randn(3, 65, device=cuda)
    b = torch.rand(3, 64, device=cuda)
    with pytest.raises(ValueError, match="m <= 64"):
        TKr.tridiag_ritz(a, b, "power")
    with pytest.raises(TypeError):
        TK.tridiag_ritz_power(a[:, :10].to(torch.complex64),
                              b[:, :9].to(torch.complex64))
    with pytest.raises(ValueError, match="CUDA device"):
        TK.tridiag_ritz_power(a[:, :10].cpu(), b[:, :9])
    with pytest.raises(ValueError, match="CUDA device"):
        TK.tridiag_ritz_power(a[:, :10], b[:, :9].cpu())
    assert TK.launch_counts["tridiag_ritz"] == 1
    tracing.reset()


def test_batched_sweep_with_k10_matches_the_twin(cuda, monkeypatch):
    from tensornetwork_tpu_torch.parallel.batch import batched_one_site_sweep
    N, chi, B, sweeps = 8, 16, 8, 4
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32, device=cuda)
    As0 = tdmrg.random_mps_stack(3, B * N, chi, 2, dtype=torch.float32,
                                 device=cuda).reshape(B, N, chi, 2, chi)

    def run():
        TK.reset_launch_counts()
        As, renvs = As0.clone(), None
        for _ in range(sweeps):
            res = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                         num_krylov_vecs=10, renvs=renvs)
            As, renvs = res.As, res.renvs
        return res.energy.cpu().numpy(), TK.launch_counts["tridiag_ritz"]

    e_kernel, launches = run()
    assert launches == sweeps * 2 * N
    monkeypatch.setattr(TK, "tridiag_ritz_power",
                        TKr.tridiag_ritz_power_plain)
    e_twin, launches = run()
    assert launches == 0
    np.testing.assert_allclose(e_kernel, e_twin, rtol=1e-5, atol=0)


def test_symmetric_sweep_with_k10_matches_the_twin(cuda, monkeypatch):
    from tensornetwork_tpu_torch.blocksparse import batched as TBt
    from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    N, chi, B, sweeps = 6, 8, 2, 4
    skel = TBt.uniform_skeleton_mps(N, chi, dtype=torch.float32, device=cuda)
    data = TBt.random_data_batch(skel, B, seed=1, device=cuda)
    mpo = u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float32, device=cuda)

    def run():
        TK.reset_launch_counts()
        d = BatchedSymmetricDMRG(skel, [x.clone() for x in data], mpo)
        es = d.run_one_site(num_sweeps=sweeps)
        return np.asarray(es), TK.launch_counts["tridiag_ritz"]

    e_kernel, launches = run()
    assert launches == sweeps * 2 * (N - 1)
    monkeypatch.setattr(TK, "tridiag_ritz_power",
                        TKr.tridiag_ritz_power_plain)
    e_twin, launches = run()
    assert launches == 0
    np.testing.assert_allclose(e_kernel, e_twin, rtol=1e-5, atol=0)
