"""K1's and K9's kernel routes, as pure functions, and K1's 3xTF32 model
against the Pallas kernel.

The CUDA routes run only on the card (tests/test_torch_cuda.py and
chip_smoke.py); here the routers and the wgmma route's shared-memory plan
are checked as functions, and K1's tensor-core arithmetic through its
model (``tf32x3_matmul_plain`` stages in the kernel's GEMM shapes) against
the JAX package's ``make_heff_matvec`` in interpret mode on the same numpy
inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.ops import kernels as JK
from tensornetwork_tpu_torch.benchmarks import mxu_micro
from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.ops import kernels as TK

SMEM = 232_448
LADDER = list(mxu_micro.LADDER)
# the shapes K1's routes were measured at (benchmarks/k1_routes.py)
K1_BATCHES, K1_CHIS = (1, 8, 64, 256), (32, 64, 128, 256)


@pytest.mark.parametrize("chi,nt,B", [(64, 2, 1), (64, 4, 256), (24, 2, 3),
                                      (256, 2, 8)])
def test_heff_matvec_route_keeps_f64_on_simt(chi, nt, B):
    assert TK.heff_matvec_route(chi, nt, 3, B, torch.float64) == "simt"


@pytest.mark.parametrize("nt", [2, 4])
@pytest.mark.parametrize("chi", K1_CHIS)
def test_heff_matvec_route_puts_f32_on_the_tensor_cores(chi, nt):
    for B in K1_BATCHES:
        assert TK.heff_matvec_route(chi, nt, 3, B, torch.float32) == "tc32"


@pytest.mark.parametrize("nt", [2, 4])
@pytest.mark.parametrize("chi", K1_CHIS)
@pytest.mark.parametrize("B", K1_BATCHES)
def test_heff_matvec_route_follows_the_measurement(nt, chi, B):
    # "tc32" beat the f32 SIMT kernel in device time at every point that
    # benchmarks/k1_routes.py measured (H100 80GB HBM3, 700 W, M=3), so
    # no f32 shape takes "simt"
    assert TK.heff_matvec_route(chi, nt, 3, B, torch.float32) == "tc32"


@pytest.mark.parametrize("shape", LADDER)
def test_gemm_chain_route_takes_wgmma_on_the_ladder(shape):
    M, K, N, P, _ = shape
    assert TK.gemm_chain_route(M, K, N, P) == "wgmma"
    plan = TK.gemm_chain_plan(M, K, N)
    assert plan.smem_bytes <= SMEM
    # b and c stay resident where 4 K N bytes fit beside the panels
    want = "resident" if (K, N) in ((128, 128), (128, 256)) else "streamed"
    assert plan.mode == want
    assert (plan.stages == 0) == (want == "resident")


@pytest.mark.parametrize("M,K,N", [(32, 16, 16), (64, 32, 48), (32, 48, 64),
                                   (64, 2048, 1024)])
def test_gemm_chain_route_gives_the_rest_to_wmma(M, K, N):
    # K or N not a multiple of 64, or panels too wide for any plan: the
    # wrapper's admission (M % 32, K, N % 16) stays whole
    assert TK.gemm_chain_plan(M, K, N) is None
    assert TK.gemm_chain_route(M, K, N, 1) == "wmma"


# each ladder shape's plan, as csrc/gemm_chain.cu's header states it:
# (M, K, N) -> mode, ring stages, slab depth, widest chunk, bytes
LADDER_PLANS = {
    (128, 128, 128): ("resident", 0, 64, 128, 99_400),
    (128, 128, 256): ("resident", 0, 64, 256, 181_320),
    (128, 128, 512): ("streamed", 4, 64, 256, 214_088),
    (128, 256, 256): ("streamed", 4, 64, 256, 197_704),
    (256, 256, 256): ("streamed", 4, 64, 256, 197_704),
    (256, 256, 512): ("streamed", 4, 64, 256, 230_472),
    (512, 512, 512): ("streamed", 3, 64, 256, 230_472),
    (512, 512, 1024): ("streamed", 2, 32, 256, 230_472),
}


@pytest.mark.parametrize("shape", sorted(LADDER_PLANS))
def test_gemm_chain_plan_of_each_ladder_shape(shape):
    assert {s[:3] for s in LADDER} == set(LADDER_PLANS)
    plan = TK.gemm_chain_plan(*shape)
    assert (plan.mode, plan.stages, plan.kd, max(plan.nc1, plan.nc2),
            plan.smem_bytes) == LADDER_PLANS[shape]
    assert plan.smem_bytes <= SMEM


def test_gemm_chain_plan_chunks_are_wgmma_widths():
    for M, K, N, _, _ in LADDER:
        plan = TK.gemm_chain_plan(M, K, N)
        assert N % plan.nc1 == 0 and K % plan.nc2 == 0
        assert {plan.nc1, plan.nc2} <= {64, 128, 256}


def test_cpu_tensors_take_the_twins_whatever_the_route():
    x, b, c = mxu_micro.chain_inputs(32, 64, 64, 2, device="cpu")
    TK.reset_launch_counts()
    for route in (None, "wgmma", "wmma"):
        assert torch.equal(TK.gemm_chain(x, b, c, 2, route=route),
                           TK.gemm_chain_plain(x, b, c, 2))
    rng = np.random.default_rng(0)
    ops = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((2, 3, 8, 8), (3, 3, 2, 2), (2, 3, 8, 8), (2, 2, 8, 8))]
    for fn in (TK.heff_matvec, TK.heff_matvec_simt):
        assert torch.equal(fn(*ops), TK.heff_matvec_plain(*ops))
    assert sum(TK.launch_counts.values()) == 0
    assert sum(TK.route_counts.values()) == 0
    with pytest.raises(ValueError):
        TK.gemm_chain(x, b, c, 1, route="mxu")


def _k1_model(Lt, W, Rt, x):
    """K1's f32 route in the 3xTF32 model, in its GEMM shapes: stage 1
    one (M chi) x (nt chi) GEMM, the coupling fold in float32, stage 2 one
    chi x (M chi) GEMM per s."""
    B, nt, chi, _ = x.shape
    M = Lt.shape[1]
    P = TK.tf32x3_matmul_plain(Lt.reshape(B, M * chi, chi),
                               x.permute(0, 2, 1, 3).reshape(B, chi, nt * chi))
    P = P.reshape(B, M, chi, nt, chi)                       # [w, c, t, b]
    with highest_precision():
        Q = torch.einsum("wvst,Bwctb->Bscvb", W, P)         # [s, c, v, b]
    return TK.tf32x3_matmul_plain(Q.reshape(B, nt, chi, M * chi),
                                  Rt.reshape(B, 1, M * chi, chi))


def _fro(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("nt", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_k1_tensor_core_model_matches_the_pallas_kernel(nt, seed):
    # the model and the Pallas kernel (f32, HIGHEST) sum the same products
    # in other orders: a few ulp of chi*M*nt-term sums, 1e-5 relative to
    # the largest entry; against an f64 run, the model stays within 2x the
    # f32 twin's error, as the card test asks of the kernel
    rng = np.random.default_rng(seed)
    B, chi, M = 2, 16, 3
    L = rng.standard_normal((B, chi, M, chi)).astype(np.float32)
    R = rng.standard_normal((B, chi, M, chi)).astype(np.float32)
    W = rng.standard_normal((M, M, nt, nt)).astype(np.float32)
    x = rng.standard_normal((B, chi, nt, chi)).astype(np.float32)
    f = JK.make_heff_matvec(chi, nt, M, interpret=True,
                            precision=jax.lax.Precision.HIGHEST)
    ops_j = JK.prepare_operands(*(jnp.asarray(a) for a in (L, W, R, x)))
    y_pallas = np.asarray(f(*ops_j))

    ops = TK.prepare_operands(*(torch.from_numpy(a) for a in (L, W, R, x)))
    y = _k1_model(*ops)
    with highest_precision():
        y32 = TK.heff_matvec_plain(*ops)
    y64 = TK.heff_matvec_plain(*(t.double() for t in ops))
    assert np.max(np.abs(y.numpy() - y_pallas)) < 1e-5 * np.max(np.abs(y_pallas))
    assert _fro(y, y64) <= 2 * _fro(y32, y64)
