"""The f32 grid-wide Lanczos kernels (K3 fact and replay, K4;
``csrc/lanczos_grid.cuh``) on the CPU: the host plan of their tile jobs
and scratch, and a model of their arithmetic -- stage 1 one (M chi) x (d
chi) GEMM in the 3xTF32 product model, the coupling fold in float32, stage
2 split over the MPO bond into slots summed in order, <v, w> summed in
float64 -- inside the twins' recurrence, against the twins, exact
diagonalisation and the replay's bit-for-bit regeneration of the basis.
The kernels themselves run in ``tests/test_torch_cuda.py`` on the card."""
import numpy as np
import pytest
import torch

from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.ops import kernels as TK

H100_SMS = 132
BLOCKS = 2 * H100_SMS   # the resident blocks: two 256-thread blocks an SM


@pytest.mark.parametrize("chi,tile,blocks", [(384, (64, 64), 264),
                                             (512, (128, 128), 132)])
def test_plan_at_the_path_shapes(chi, tile, blocks):
    # the one-site chi=384 (K3) and chi=512 (K4) solves, B=1, d=2, M=3: the
    # tile that ran each faster on an H100 (lgrid_breakdown.py: 64x64 at
    # chi=384, 128x128 at chi=512), stage 2 split over the 3 values of v,
    # and each stage one wave over most of the resident blocks
    plan = TK.lgrid_plan(chi, 2, 3, 1, H100_SMS)
    assert (plan.tile, plan.split, plan.blocks) == (tile, 3, blocks)
    tiles = -(-chi // tile[0]) * -(-chi // tile[1])
    assert plan.jobs1 == plan.jobs2 == 3 * 2 * tiles
    for jobs in (plan.jobs1, plan.jobs2):
        assert 0.7 * blocks <= jobs <= blocks
    # without the split stage 2 would leave two thirds of them idle
    assert 2 * tiles <= blocks // 3


def test_plan_splits_stage_2_only_where_it_leaves_blocks_idle():
    plan = TK.lgrid_plan(256, 2, 3, 16, H100_SMS)
    assert (plan.tile, plan.split) == ((128, 128), 1)   # 128 stage-2 jobs
    assert 8 * plan.jobs2 >= 7 * plan.blocks
    assert TK.lgrid_plan(16, 2, 3, 2, H100_SMS)[:2] == ((64, 64), 3)
    assert TK.lgrid_plan(16, 2, 1, 2, H100_SMS).split == 1  # M = 1
    # a tile the caller names
    assert TK.lgrid_plan(512, 2, 3, 1, H100_SMS, (64, 64)).blocks == 264


@pytest.mark.parametrize("split", [1, 3])
def test_grid_scratch_follows_the_plan(split):
    B, chi, d, M = 2, 50, 2, 3
    P, slots, apart, bpart, alive0 = TK._grid_scratch(B, chi, d, M, split,
                                                      dtype=torch.float32)
    nseg = -(-d * chi * chi // 1024)
    assert P.numel() == B * M * d * chi * chi
    assert slots.shape == (B, split, d, chi, chi)
    for part in (apart, bpart):
        assert part.shape == (B, nseg) and part.dtype == torch.float64
    assert alive0.shape == (B,)


def test_grid_wrappers_ask_for_one_plan(monkeypatch):
    # the three wrappers' launches, recorded on meta tensors (no memory):
    # each passes every argument of its C entry point, and all three pass
    # the plan of the shape, f32 at the one-site chi=384 solve
    B, chi, d, M, m = 1, 384, 2, 3, 10
    meta = dict(dtype=torch.float32, device="meta")
    Lt, Rt = (torch.empty((B, M, chi, chi), **meta) for _ in range(2))
    W = torch.empty((M, M, d, d), **meta)
    x0 = torch.empty((B, d, chi, chi), **meta)
    monkeypatch.setattr(TK, "_validate", lambda *ops: (B, chi, d, M, 0))
    calls = {}
    monkeypatch.setattr(TK, "_launch_grid",
                        lambda name, dtype, device, *args:
                        calls.setdefault(name, args))
    TK.fused_lanczos_streamed(Lt, W, Rt, x0, m)
    ab = TK.fused_lanczos_fact(Lt, W, Rt, x0, m)
    TK.fused_lanczos_replay(Lt, W, Rt, x0, torch.empty((B, m), **meta), ab)
    TK.reset_launch_counts()
    plan = TK.lgrid_plan(chi, d, M, B, H100_SMS)
    want = (TK._TC32_TILES.index(plan.tile), plan.split)
    assert len(calls) == 3
    for name, args in calls.items():
        assert len(args) + 2 == len(TK._ARGTYPES[name])   # + grid, stream
        assert tuple(args[-3:-1]) == want, name


def _grid_matvec(Lt, C, Rt, x, split):
    """K3/K4's f32 matvec in the 3xTF32 model, in the kernel's GEMM shapes:
    stage 1 one (M chi) x (d chi) GEMM, the coupling fold in float32,
    stage 2 per slot k one chi x (M/split chi) GEMM per s over its v, the
    slots summed in order 0..split-1; and <x, y> summed in float64."""
    B, d, chi, _ = x.shape
    M = Lt.shape[1]
    P = TK.tf32x3_matmul_plain(Lt.reshape(B, M * chi, chi),
                               x.permute(0, 2, 1, 3).reshape(B, chi, d * chi))
    P = P.reshape(B, M, chi, d, chi)                        # [w, c, t, b]
    spec = "wvst" if C.dim() == 4 else "Bwvst"
    with highest_precision():
        Q = torch.einsum(f"{spec},Bwctb->Bscvb", C, P)      # [s, c, v, b]
    vs = M // split
    y = None
    for k in range(split):
        v = slice(k * vs, (k + 1) * vs)
        slot = TK.tf32x3_matmul_plain(
            Q[:, :, :, v].reshape(B, d, chi, vs * chi),
            Rt[:, v].reshape(B, 1, vs * chi, chi))
        y = slot if y is None else y + slot
    alpha = (x.double() * y.double()).sum(dim=(1, 2, 3)).float()
    return y, alpha


def _split(Lt, x0):
    """The split the kernels take at this shape (:func:`TK.lgrid_plan`)."""
    B, d, chi, _ = x0.shape
    return TK.lgrid_plan(chi, d, Lt.shape[1], B, H100_SMS).split


def _model(Lt, C, Rt, x0, m, delta=1e-8, split=None):
    """The f32 kernels' factorization on the model: the twins' recurrence,
    masks and sentinels around :func:`_grid_matvec`."""
    split = _split(Lt, x0) if split is None else split
    return TK._lanczos_recurrence(
        lambda v: _grid_matvec(Lt, C, Rt, v, split), x0, m, delta)


def _model_replay(Lt, C, Rt, x0, weights, ab, delta=1e-8):
    split = _split(Lt, x0)
    return TK._replay_recurrence(
        lambda v: _grid_matvec(Lt, C, Rt, v, split)[0], x0, weights, ab,
        delta)


def _operands(seed, B=2, chi=16, d=2, M=3, per_instance=False):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, M, chi, chi))
    Lt = (L + L.transpose(0, 1, 3, 2)) / 2
    R = rng.standard_normal((B, M, chi, chi))
    Rt = (R + R.transpose(0, 1, 3, 2)) / 2
    C = rng.standard_normal((M, M, d, d))
    C = (C + C.transpose(1, 0, 3, 2)) / 2
    if per_instance:
        C = np.stack([C, C[::-1, ::-1]])
    x = rng.standard_normal((B, d, chi, chi))
    return [torch.from_numpy(a.astype(np.float32)) for a in (Lt, C, Rt, x)]


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("per_instance", [False, True])
def test_grid_model_matches_the_twin(per_instance, split):
    # a few f32 ulps per matvec, carried over m=6 steps of the recurrence
    # (the card tests hold the kernels to the twins at 1e-4 for the same
    # reason)
    ops = _operands(20 + split, per_instance=per_instance)
    V, ab = _model(*ops, 6, split=split)
    with highest_precision():
        V0, ab0 = TK.fused_lanczos_plain(*ops, 6)
    assert float((ab - ab0).abs().max() / ab0.abs().max()) < 1e-4
    assert float((V - V0).abs().max() / V0.abs().max()) < 1e-4


def test_grid_model_replay_regenerates_the_basis():
    # replay with the weights e_j returns fact's v_j bit for bit: the same
    # matvec, coefficients and rounding steps
    m = 6
    ops = _operands(30)
    V, ab = _model(*ops, m)
    for j in (0, 1, m - 1):
        e_j = torch.zeros((2, m))
        e_j[:, j] = 1.0
        assert torch.equal(_model_replay(*ops, e_j, ab), V[:, j])


def test_grid_model_breakdown_equals_the_twin():
    # the breakdown operators are small integers, which split exactly: a
    # product state of a diagonal operator dies at step 0 and a zero start
    # is dead from the start, bit for bit as the twin
    d = 2
    Wd = torch.eye(d).reshape(1, 1, d, d)
    Ld = torch.diag(torch.arange(1.0, 9.0)).reshape(1, 1, 8, 8).repeat(2, 1, 1, 1)
    Rd = torch.eye(8).reshape(1, 1, 8, 8).repeat(2, 1, 1, 1)
    xd = torch.zeros((2, d, 8, 8))
    xd[0, 0, 0, 0] = 2.0
    Vd, abd = _model(Ld, Wd, Rd, xd, 4)
    Vd0, abd0 = TK.fused_lanczos_plain(Ld, Wd, Rd, xd, 4)
    assert torch.equal(abd, abd0) and torch.equal(Vd, Vd0)
    wd = torch.ones((2, 4))
    assert torch.equal(_model_replay(Ld, Wd, Rd, xd, wd, abd),
                       TK.fused_lanczos_replay_plain(Ld, Wd, Rd, xd, wd, abd0))


@pytest.mark.parametrize("tier", ["two_pass", "streamed"])
def test_sweep_on_the_grid_model_is_variational(monkeypatch, tier):
    # the two grid tiers' local solves in the model, TFI N=8, chi=16 in
    # float32.  The state is judged in float64; the sweep's own f32 Ritz
    # value scatters ~1e-5 about the exact energy with the plain f32
    # matvec too, so it may sit at most 2e-5 below.
    N, chi = 8, 16
    mpo64 = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device="cpu")
    exact = float(np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo64))[0])
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32, device="cpu")
    calls = []

    def streamed(Lt, W, Rt, xt, m, delta=1e-8):
        calls.append("streamed")
        return _model(Lt, W, Rt, xt, m, delta)

    def fact(Lt, W, Rt, xt, m, delta=1e-8):
        calls.append("fact")
        return _model(Lt, W, Rt, xt, m, delta)[1]

    def replay(Lt, W, Rt, xt, weights, ab, delta=1e-8):
        calls.append("replay")
        return _model_replay(Lt, W, Rt, xt, weights.to(xt.dtype), ab, delta)

    monkeypatch.setattr(TK, "one_site_tier", lambda *a: tier)
    monkeypatch.setattr(TK, "fused_lanczos_streamed", streamed)
    monkeypatch.setattr(TK, "fused_lanczos_fact", fact)
    monkeypatch.setattr(TK, "fused_lanczos_replay", replay)
    As = tdmrg.random_mps_stack(2, N, chi, 2, dtype=torch.float32,
                                device="cpu")
    dm = tdmrg.FiniteDMRG(As, mpo)
    e = dm.run_one_site(num_sweeps=2, num_krylov_vecs=10, tol=0.0)
    state = float(tdmrg.mps_mpo_expectation(dm.As.double(), mpo64.Ws,
                                            mpo64.vL, mpo64.vR))
    want = {"streamed"} if tier == "streamed" else {"fact", "replay"}
    assert set(calls) == want
    assert e >= exact - 2e-5, (e, exact)
    assert exact - 1e-6 <= state <= exact + 1e-6, (state, exact)
