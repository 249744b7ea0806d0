"""The f32 core of the large-chi streamed matvecs and of the resident
Lanczos kernel (``csrc/gemm_tc32.cuh``) on the CPU: the plain model of its
3xTF32 product against float64, the Lanczos recurrence on a matvec built
from that model against exact diagonalisation -- around K7, and K2's
whole factorization in its own GEMM shapes -- and the tile and K3 rules
at the path shapes.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card."""
import numpy as np
import pytest
import torch

from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.ops import kernels as TK

H100_SMS = 132
# (chi, nt) of the four path shapes of K7 and K8 (M=3, B=1): one-site
# chi=1024 and 2048 (nt=2), two-site chi=512 and 1024 (nt=4)
PATH_SHAPES = ((1024, 2), (512, 4), (1024, 4), (2048, 2))


def _rna_reference(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to 11 significant bits (10 stored), ties
    away from zero, in float64 arithmetic."""
    m, e = np.frexp(a.astype(np.float64))      # a = m 2^e, 1/2 <= |m| < 1
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return (r * 2.0 ** (e - 11)).astype(np.float32)


def _fro_rel(y, ref):
    return float((y.double() - ref).norm() / ref.norm())


def _matmul(a, b, terms):
    """The 3xTF32 model (terms=3) or one TF32 product (terms=1)."""
    if terms == 3:
        return TK.tf32x3_matmul_plain(a, b)
    with highest_precision():
        return TK.tf32_rna(a) @ TK.tf32_rna(b)


def test_tf32_rna_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096))
    ties = 1.0 + np.array([0.0, 2.0 ** -11, 2.0 ** -12, 3 * 2.0 ** -12,
                           2.0 ** -10 + 2.0 ** -11])
    a = np.concatenate([a, ties, -ties, [0.0, 1.0, 3.0, 1024.0]])
    a = a.astype(np.float32)
    got = TK.tf32_rna(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, _rna_reference(a))
    # a tie rounds away from zero: 1 + 2^-11 -> 1 + 2^-10
    assert float(TK.tf32_rna(torch.tensor([1.0 + 2.0 ** -11]))) == 1.0 + 2.0 ** -10


@pytest.mark.parametrize("m,k,n,seed", [(16, 16, 16, 0), (64, 128, 32, 1),
                                        (8, 1024, 8, 2), (128, 64, 128, 3)])
def test_tf32x3_product_keeps_fp32_accuracy(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    ref = a.double() @ b.double()
    with highest_precision():
        f32 = _fro_rel(a @ b, ref)
    x3 = _fro_rel(_matmul(a, b, 3), ref)
    tf32 = _fro_rel(_matmul(a, b, 1), ref)
    assert x3 <= 4 * f32, (x3, f32)
    assert tf32 >= 100 * f32, (tf32, f32)   # the test can see TF32


def test_tf32x3_product_is_exact_on_small_integers():
    # values of <= 22 significant bits split exactly (big + small), so the
    # breakdown operators of the Lanczos tests keep their exact bits
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-2000, 2000, (32, 48)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-3, 4, (48, 16)).astype(np.float32))
    b[:, 0] = 1.0
    torch.testing.assert_close(TK.tf32x3_matmul_plain(a, b),
                               (a.double() @ b.double()).float(),
                               rtol=0, atol=0)


def _tf32x3_matvec(Lt, C, Rt, x, terms=3):
    """K7/K8's function with both GEMM stages in the 3xTF32 model (or, with
    ``terms=1``, one TF32 product): P = Lt_w x_t, the fold in float32,
    y_s = sum_v Q_vs Rt_v; and <x, y>."""
    P = _matmul(Lt[:, :, None], x[:, None], terms)
    spec = "wvst" if C.dim() == 4 else "Bwvst"
    with highest_precision():
        Q = torch.einsum(f"{spec},Bwtcb->Bvscb", C, P)
    y = _matmul(Q, Rt[:, :, None], terms).sum(1)
    return y, (x * y).sum(dim=(1, 2, 3))


@pytest.mark.parametrize("nt,per_instance", [(2, False), (4, True)])
def test_tf32x3_matvec_matches_the_twin_and_f64(nt, per_instance):
    rng = np.random.default_rng(nt)
    B, chi, M = 2, 16, 3
    Lt, Rt = (rng.standard_normal((B, M, chi, chi)) for _ in range(2))
    C = rng.standard_normal((B, M, M, nt, nt) if per_instance
                            else (M, M, nt, nt))
    x = rng.standard_normal((B, nt, chi, chi))
    ops32 = [torch.from_numpy(a.astype(np.float32)) for a in (Lt, C, Rt, x)]
    ops64 = [t.double() for t in ops32]
    y64, _ = TK.streamed_matvec_plain(*ops64)
    y, alpha = _tf32x3_matvec(*ops32)
    with highest_precision():
        y32, alpha32 = TK.streamed_matvec_plain(*ops32)
    assert _fro_rel(y, y64) <= 4 * _fro_rel(y32, y64)
    assert float((y - y32).abs().max() / y32.abs().max()) < 1e-5
    scale = float(ops32[3].norm() * y32.norm())
    assert float((alpha - alpha32).abs().max()) < 1e-5 * scale


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("run,tier_fn", [("run_one_site", "one_site_tier"),
                                         ("run_two_site", "two_site_tier")])
def test_lanczos_on_the_3xtf32_model_is_variational(monkeypatch, run, tier_fn,
                                                    terms):
    # the recurrence around K7 with the kernel's product model: TFI N=8,
    # chi=16 (exact at the middle bond) in float32.  The state is judged in
    # float64; the sweep's own f32 Ritz value scatters ~1e-5 either side
    # of the exact energy with the plain f32 matvec too.  One TF32 product
    # (terms=1) leaves the state 3e-5...3e-4 above, or the Ritz value up
    # to 2e-3 below: the test can see TF32.
    N, chi = 8, 16
    mpo64 = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device="cpu")
    exact = float(np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo64))[0])
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(TK, tier_fn, lambda *a: "streamed_matvec")
    calls = []

    def matvec(*ops):
        calls.append(1)
        return _tf32x3_matvec(*ops, terms=terms)

    monkeypatch.setattr(TK, "streamed_matvec", matvec)
    As = tdmrg.random_mps_stack(0, N, chi, 2, dtype=torch.float32,
                                device="cpu")
    dm = tdmrg.FiniteDMRG(As, mpo)
    e = getattr(dm, run)(num_sweeps=4, num_krylov_vecs=10, tol=0.0)
    state = float(tdmrg.mps_mpo_expectation(dm.As.double(), mpo64.Ws,
                                            mpo64.vL, mpo64.vR))
    assert calls
    if terms == 3:
        assert exact - 1e-6 <= state <= exact + 1e-6, (state, exact)
        assert abs(e - exact) < 2e-5, (e, exact)
    else:
        assert abs(state - exact) > 1e-5 or e < exact - 1e-4, (e, state)


def _k2_tc32_matvec(Lt, C, Rt, x):
    """K2's f32 matvec in the 3xTF32 model, in the kernel's GEMM shapes:
    stage 1 one (M chi) x (nt chi) GEMM, the coupling fold in float32,
    stage 2 one chi x (M chi) GEMM per s; and <x, y>."""
    B, nt, chi, _ = x.shape
    M = Lt.shape[1]
    P = TK.tf32x3_matmul_plain(Lt.reshape(B, M * chi, chi),
                               x.permute(0, 2, 1, 3).reshape(B, chi, nt * chi))
    P = P.reshape(B, M, chi, nt, chi)                       # [w, c, t, b]
    spec = "wvst" if C.dim() == 4 else "Bwvst"
    with highest_precision():
        Q = torch.einsum(f"{spec},Bwctb->Bscvb", C, P)      # [s, c, v, b]
    y = TK.tf32x3_matmul_plain(Q.reshape(B, nt, chi, M * chi),
                               Rt.reshape(B, 1, M * chi, chi))
    return y, (x * y).sum(dim=(1, 2, 3))


def _k2_model(Lt, C, Rt, x0, num_krylov_vecs, delta=1e-8):
    """K2's factorization on the model: fused_lanczos_plain's recurrence,
    masks and sentinels around :func:`_k2_tc32_matvec`."""
    return TK._lanczos_recurrence(lambda v: _k2_tc32_matvec(Lt, C, Rt, v),
                                  x0, num_krylov_vecs, delta)


@pytest.mark.parametrize("nt,per_instance", [(2, False), (4, True)])
def test_k2_model_matches_the_twin(nt, per_instance):
    # the model against the plain twin on the same f32 operands: a few f32
    # ulps per matvec, carried over m=6 steps of the recurrence (the card
    # tests hold the kernel to the twin at 1e-4 for the same reason)
    rng = np.random.default_rng(10 + nt)
    B, chi, M = 2, 16, 3
    L = rng.standard_normal((B, M, chi, chi))
    Lt = (L + L.transpose(0, 1, 3, 2)) / 2
    R = rng.standard_normal((B, M, chi, chi))
    Rt = (R + R.transpose(0, 1, 3, 2)) / 2
    C = rng.standard_normal((M, M, nt, nt))
    C = (C + C.transpose(1, 0, 3, 2)) / 2
    if per_instance:
        C = np.stack([C, C[::-1, ::-1]])
    x = rng.standard_normal((B, nt, chi, chi))
    ops = [torch.from_numpy(a.astype(np.float32)) for a in (Lt, C, Rt, x)]
    V, ab = _k2_model(*ops, 6)
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(*ops, 6)
    assert float((ab - ab0).abs().max() / ab0.abs().max()) < 1e-4
    assert float((V - V0).abs().max() / V0.abs().max()) < 1e-4
    # the breakdown operators are small integers, which split exactly: a
    # product state of a diagonal operator dies at step 0, bit for bit
    Wd = torch.eye(nt).reshape(1, 1, nt, nt)
    Ld = torch.diag(torch.arange(1.0, 9.0)).reshape(1, 1, 8, 8).repeat(2, 1, 1, 1)
    Rd = torch.eye(8).reshape(1, 1, 8, 8).repeat(2, 1, 1, 1)
    xd = torch.zeros((2, nt, 8, 8))
    xd[0, 0, 0, 0] = 2.0
    Vd, abd = _k2_model(Ld, Wd, Rd, xd, 4)
    Vd0, abd0 = TK.fused_lanczos_plain(Ld, Wd, Rd, xd, 4)
    assert torch.equal(abd, abd0) and torch.equal(Vd, Vd0)


@pytest.mark.parametrize("run", ["run_one_site", "run_two_site"])
def test_lanczos_on_the_k2_model_is_variational(monkeypatch, run):
    # K2's whole factorization in the model, on the resident tier of both
    # sweeps: TFI N=8, chi=16 in float32.  The state is judged in float64;
    # the sweep's own f32 Ritz value scatters ~1e-5 about the exact energy
    # with the plain f32 matvec too, so it may sit at most 2e-5 below.
    N, chi = 8, 16
    mpo64 = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device="cpu")
    exact = float(np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo64))[0])
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32, device="cpu")
    calls = []

    def fused_lanczos(Lt, W, Rt, xt, m, delta=1e-8):
        calls.append(1)
        return _k2_model(Lt, W, Rt, xt, m, delta)

    monkeypatch.setattr(TK, "fused_lanczos", fused_lanczos)
    As = tdmrg.random_mps_stack(1, N, chi, 2, dtype=torch.float32,
                                device="cpu")
    dm = tdmrg.FiniteDMRG(As, mpo)
    e = getattr(dm, run)(num_sweeps=2, num_krylov_vecs=10, tol=0.0)
    state = float(tdmrg.mps_mpo_expectation(dm.As.double(), mpo64.Ws,
                                            mpo64.vL, mpo64.vR))
    assert calls
    assert e >= exact - 2e-5, (e, exact)
    assert exact - 1e-6 <= state <= exact + 1e-6, (state, exact)


@pytest.mark.parametrize("chi,nt", PATH_SHAPES)
def test_tile_picker_fills_the_card_at_the_path_shapes(chi, nt):
    grids = TK.tc32_grids(chi, nt, 3, 1, 1, H100_SMS)   # K3 = 1: K7, and K8's pick
    # one wave: every SM a block, but for a tail of at most 1/8 (one-site
    # chi=1024: 128 blocks of 128x128 on 132 SMs)
    for stage in ("stage1", "stage2"):
        assert 8 * grids[stage][2] >= 7 * H100_SMS, grids
    assert grids["stage1"][:2] == (128, 128)
    want2 = (128, 64) if (chi, nt) == (512, 4) else (128, 128)
    assert grids["stage2"][:2] == want2


def test_tile_picker_takes_the_largest_tile_that_covers_the_card():
    assert TK.tc32_tile(1024, 1024, 4, 132) == 0        # 256 blocks
    assert TK.tc32_tile(1024, 1024, 2, 132) == 0        # 128 >= 7/8 x 132
    assert TK.tc32_tile(512, 512, 4, 132) == 1          # 64 -> 128
    assert TK.tc32_tile(512, 512, 2, 132) == 2          # 32, 64 -> 128
    assert TK.tc32_tile(16, 16, 1, 132) == 2            # nothing covers it
    assert TK.tc32_grids(200, 2, 3, 2, 1, 132)["stage2"] == (64, 64, 64)


@pytest.mark.parametrize("chi,nt", [(1024, 4), (2048, 2)])
def test_xl_chunk_count_at_the_path_shapes(chi, nt):
    # K8's two path shapes: stage 1 alone gives >= two blocks per SM
    assert TK.xl_chunk_count(chi, nt, 3, 1, H100_SMS) == 1


@pytest.mark.parametrize("dtype,xl", [(torch.float32, False),
                                      (torch.float32, True),
                                      (torch.float64, False),
                                      (torch.float64, True)])
def test_matvec_scratch_follows_the_stage_tiles(dtype, xl):
    B, chi, nt, M, K3 = 2, 200, 2, 3, (2 if xl else 1)
    x = torch.zeros((B, nt, chi, chi), dtype=dtype)
    P, Q, part, tile1, tile2 = TK._matvec_scratch(x, B, chi, nt, M, K3, xl)
    if dtype == torch.float32:
        grids = TK.tc32_grids(chi, nt, M, B, K3, H100_SMS)
        assert P.shape == (B, K3, M * chi, nt * chi)
        assert Q.shape == (B, nt, chi, M * chi)
        assert part.shape == (B, grids["stage2"][2] // B)
        assert (TK._TC32_TILES[tile1], TK._TC32_TILES[tile2]) == (
            grids["stage1"][:2], grids["stage2"][:2])
    else:   # the SIMT kernels' slots and 64 x 64 tiles
        slots = P if xl else Q
        assert (Q if xl else P) is None
        assert slots.shape == (B, K3, M * nt, chi, chi)
        assert part.shape == (B, nt * 4 * 4)
