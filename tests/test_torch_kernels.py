"""The port's kernel twins against the JAX package's Pallas kernels.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these twins); here every wrapper gets
CPU tensors and so runs its plain-PyTorch twin.  The Pallas kernels run in
interpret mode, as tests/test_kernels.py runs them.  Inputs are made with
numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.ops import kernels as JK
from tensornetwork_tpu_torch.ops import kernels as TK

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
# f32: the two sides sum the same products in other orders (XLA's dot vs
# torch's matmul); over chi*M*d-term sums that is a few ulp of the result's
# scale, so 1e-5 relative to the largest entry.  f64: the same argument at
# double precision.
MATVEC_TOL = {"f32": 1e-5, "f64": 1e-12}
# The Lanczos recurrence feeds each step's rounding into the next; over
# m=5 steps on these well-conditioned Hermitian operators the basis and
# (alpha, beta) drift apart by ~1e-5 relative in f32 (measured ~1e-6) and
# ~1e-13 in f64.
LANCZOS_TOL = {"f32": 5e-5, "f64": 1e-11}
# A Ritz vector moves by (perturbation of T) / (spectral gap): with gaps of
# ~0.1 here the f32 drift above grows ~10x (measured ~1e-4).  In f64 the
# power Ritz solve freezes once its residual is below 1e-14, at a point set
# by the last bits of T, which leaves ~6e-9 between the two vectors.
EVEC_TOL = {"f32": 5e-4, "f64": 1e-7}
# f64 runs the same checks at chi=8: JAX's interpret mode is the slow side.
CHI = {"f32": 16, "f64": 8}


def _operands(rng, B, chi, d, M, np_dtype, hermitian=False):
    L = rng.standard_normal((B, chi, M, chi))
    R = rng.standard_normal((B, chi, M, chi))
    W = rng.standard_normal((M, M, d, d))
    x = rng.standard_normal((B, chi, d, chi))
    if hermitian:
        L = (L + L.transpose(0, 3, 2, 1)) / 2
        R = (R + R.transpose(0, 3, 2, 1)) / 2
        W = (W + W.transpose(1, 0, 3, 2)) / 2
    return tuple(a.astype(np_dtype) for a in (L, W, R, x))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_heff_matvec_twin_matches_pallas(rng, kind):
    np_dt, t_dt = DTYPES[kind]
    B, chi, d, M = 3, CHI[kind], 2, 3
    L, W, R, x = _operands(rng, B, chi, d, M, np_dt)
    Lt, W_, Rt, xt = JK.prepare_operands(*(jnp.asarray(a) for a in (L, W, R, x)))
    f = JK.make_heff_matvec(chi, d, M, accum_dtype=jnp.dtype(np_dt),
                            interpret=True,
                            precision=jax.lax.Precision.HIGHEST)
    y_pallas = np.asarray(JK.finalize_output(f(Lt, W_, Rt, xt)))
    y_ref = np.asarray(JK.heff_matvec_reference(*(jnp.asarray(a)
                                                  for a in (L, W, R, x))))

    tL, tW, tR, tx = _torch(L, W, R, x)
    TK.reset_launch_counts()
    y = TK.finalize_output(TK.heff_matvec(*TK.prepare_operands(tL, tW, tR, tx)))
    assert y.dtype == t_dt
    assert TK.launch_counts["heff_matvec"] == 0  # the twin is no launch
    assert _rel(y, y_pallas) < MATVEC_TOL[kind]
    assert _rel(y, y_ref) < MATVEC_TOL[kind]
    assert _rel(TK.heff_matvec_reference(tL, tW, tR, tx), y_ref) < MATVEC_TOL[kind]


def test_heff_matvec_per_instance_couplings(rng):
    B, chi, d, M = 3, 8, 2, 3
    L, _, R, x = _operands(rng, B, chi, d, M, np.float64)
    Wb = rng.standard_normal((B, M, M, d, d))
    Lt, _, Rt, xt = TK.prepare_operands(*_torch(L, Wb[0], R, x))
    y = TK.heff_matvec(Lt, torch.from_numpy(Wb), Rt, xt)
    for b in range(B):
        yb = TK.heff_matvec(Lt[b:b + 1], torch.from_numpy(Wb[b]),
                            Rt[b:b + 1], xt[b:b + 1])
        torch.testing.assert_close(y[b:b + 1], yb, rtol=1e-12, atol=1e-12)


def test_kernel_wrappers_validate_inputs():
    Lt = torch.zeros((2, 3, 8, 8))
    Rt = torch.zeros((2, 3, 8, 8))
    W = torch.zeros((3, 3, 2, 2))
    x = torch.zeros((2, 2, 8, 8))
    with pytest.raises(TypeError):
        TK.heff_matvec(Lt, W, Rt, x.double())
    with pytest.raises(TypeError):
        TK.fused_lanczos(Lt.half(), W.half(), Rt.half(), x.half(), 4)
    with pytest.raises(ValueError):
        TK.heff_matvec(Lt, torch.zeros((3, 3, 2, 3)), Rt, x)
    with pytest.raises(ValueError):
        TK.heff_matvec(Lt, W, Rt, torch.zeros((2, 2, 8, 7)))
    with pytest.raises(ValueError):
        TK.heff_matvec(Lt, W, Rt, x.transpose(2, 3))
    with pytest.raises(ValueError):
        TK.fused_lanczos(Lt, W, Rt, x, 0)


def _pallas_lanczos(L, W, R, x, m, np_dt):
    Lt, W_, Rt, xt = JK.prepare_operands(*(jnp.asarray(a) for a in (L, W, R, x)))
    f = JK.make_fused_lanczos(Lt.shape[2], xt.shape[1], W.shape[0], m,
                              accum_dtype=jnp.dtype(np_dt), interpret=True,
                              precision=jax.lax.Precision.HIGHEST)
    V, ab = f(Lt, W_, Rt, xt)
    return np.asarray(V), np.asarray(ab)


def _port_lanczos(L, W, R, x, m):
    Lt, W_, Rt, xt = TK.prepare_operands(*_torch(L, W, R, x))
    TK.reset_launch_counts()
    V, ab = TK.fused_lanczos(Lt, W_, Rt, xt, m)
    assert TK.launch_counts["fused_lanczos"] == 0
    return V.numpy(), ab.numpy()


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_fused_lanczos_twin_matches_pallas(rng, kind):
    np_dt, _ = DTYPES[kind]
    B, chi, d, M, m = 2, CHI[kind], 2, 3, 5
    L, W, R, x = _operands(rng, B, chi, d, M, np_dt, hermitian=True)
    V_j, ab_j = _pallas_lanczos(L, W, R, x, m, np_dt)
    V_t, ab_t = _port_lanczos(L, W, R, x, m)
    assert V_t.shape == V_j.shape == (B, m, d, chi, chi)
    assert ab_t.shape == ab_j.shape == (B, 2, m)
    assert ab_t.dtype == np_dt
    assert _rel(ab_t, ab_j) < LANCZOS_TOL[kind]
    assert _rel(V_t, V_j) < LANCZOS_TOL[kind]
    assert np.all(ab_t[:, 1, -1] == 0)


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_fused_lanczos_breakdown_sentinels(kind):
    # a product-state start on a diagonal operator: x is an eigenvector,
    # so step 0 breaks down and steps 1.. are dead on both sides
    np_dt, _ = DTYPES[kind]
    chi, d, m = 8, 2, 4
    W = np.eye(d, dtype=np_dt).reshape(1, 1, d, d)
    L = np.diag(np.arange(1.0, chi + 1.0)).astype(np_dt).reshape(1, chi, 1, chi)
    R = np.eye(chi, dtype=np_dt).reshape(1, chi, 1, chi)
    x = np.zeros((1, chi, d, chi), np_dt)
    x[0, 0, 0, 0] = 2.0
    V_j, ab_j = _pallas_lanczos(L, W, R, x, m, np_dt)
    V_t, ab_t = _port_lanczos(L, W, R, x, m)
    for V, ab in ((V_j, ab_j), (V_t, ab_t)):
        np.testing.assert_allclose(ab[0, 0, 0], 1.0, rtol=1e-6)
        np.testing.assert_array_equal(ab[0, 0, 1:], np.float32(1e10).astype(np_dt))
        np.testing.assert_array_equal(ab[0, 1], 0.0)
        np.testing.assert_array_equal(V[0, 1:], 0.0)
        assert V[0, 0, 0, 0, 0] == 1.0
    np.testing.assert_array_equal(ab_t, ab_j)
    np.testing.assert_array_equal(V_t, V_j)
    # a zero start is dead from step 0: every alpha is a sentinel
    _, ab_0 = _port_lanczos(L, W, R, np.zeros_like(x), m)
    np.testing.assert_array_equal(ab_0[0, 0], np.float32(1e10).astype(np_dt))


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_fused_ground_state_matches_jax(rng, kind):
    # the Hermitian setup of tests/test_kernels.py
    np_dt, _ = DTYPES[kind]
    B, chi, d, M, m = 3, CHI[kind], 2, 3, 5
    L, W, R, x = _operands(rng, B, chi, d, M, np_dt, hermitian=True)
    ev_j, vec_j = JK.fused_lanczos_ground_state(
        *(jnp.asarray(a) for a in (L, W, R, x)), num_krylov_vecs=m,
        ritz_method="power", interpret=True,
        precision=jax.lax.Precision.HIGHEST)
    ev_t, vec_t = TK.fused_lanczos_ground_state(
        *_torch(L, W, R, x), num_krylov_vecs=m, ritz_method="power")
    assert vec_t.shape == (B, chi, d, chi)
    assert _rel(ev_t, ev_j) < LANCZOS_TOL[kind]
    assert _rel(vec_t, vec_j) < EVEC_TOL[kind]
