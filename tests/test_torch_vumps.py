"""VUMPS, iTDVP and the unit-cell MPOs: the port against the JAX package.

Both packages start from the same uniform MPS: the JAX package's
``random_vumps_state`` carried into the port by
``interop.vumps_state_from_numpy``.  The port's K2 wrapper gets CPU
tensors and so runs its plain twin (``lanczos_impl="fused"``); the JAX
package's ``"fused"`` runs its Pallas kernel in interpret mode.  One
VUMPS iteration against the JAX package's is tested in
``test_torch_vumps_iteration.py``, iTDVP in ``test_torch_itdvp.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.ops import krylov as tkrylov

JV = importlib.import_module("tensornetwork_tpu.models.vumps")
TV = importlib.import_module("tensornetwork_tpu_torch.models.vumps")

# the same GMRES solves on the same inputs in f64 (1e-15 seen)
ENV_TOL = 1e-10
# xi of the same state: both take the second transfer eigenvalue by
# restarted Arnoldi to 1e-8
XI_RTOL = 1e-6
CHI = 8
W_ITER = (-1.0, -0.8)     # TFI (J, h) of the one-iteration comparison


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Thousands of tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tfi_w(J, h, dtype=np.float64):
    return np.array(jmpo.FiniteTFI(J, h, N=3).Ws[1], dtype)


def _decaying_xx_w(lam=0.5, h=0.7):
    """H = sum_{i<j} lam^(j-i-1) X_i X_j + h sum Z_i: a middle channel with
    W[1, 1] = lam I, the environment branch no MPO of the zoo reaches."""
    X, Z, I = np.array([[0, 1], [1, 0.0]]), np.diag([1.0, -1.0]), np.eye(2)
    W = np.zeros((3, 3, 2, 2))
    W[0, 0], W[1, 0], W[1, 1] = I, X, lam * I
    W[2, 0], W[2, 1], W[2, 2] = h * Z, X, I
    return W


def _w(name):
    if name == "tfi":
        return _tfi_w(*W_ITER)
    if name == "xxz":
        return np.array(jmpo.FiniteXXZ(1.0, 1.0, 0.3, N=3).Ws[1])
    return _decaying_xx_w()


def _jax_state(seed, chi, dtype):
    return JV.random_vumps_state(jax.random.PRNGKey(seed), chi, 2, dtype)


def _port_state(jstate):
    return interop.vumps_state_from_numpy(
        *(np.asarray(x) for x in jstate), device="cpu")


# ---------------------------------------------------------------------------
# MPOs and the diagonal coefficients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(1.0, 0.5, 0.3, 2, 3),
                                  (0.7, 1.1, -0.2, 3, 3),
                                  (1.0, 1.0, 0.0, 1, 4)])
def test_free_fermion_2d_bitwise(args):
    a = jmpo.FiniteFreeFermion2D(*args, dtype=jnp.float64)
    b = tmpo.FiniteFreeFermion2D(*args, device="cpu")
    for x, y in ((a.Ws, b.Ws), (a.vL, b.vL), (a.vR, b.vR)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_infinite_mpo_roll_bitwise():
    ja = jmpo.FiniteTFI([1.0, 2.0, 3.0], [4.0, 5.0, 6.0, 7.0],
                        dtype=jnp.float64)
    ta = tmpo.FiniteTFI([1.0, 2.0, 3.0], [4.0, 5.0, 6.0, 7.0], device="cpu")
    jm = jmpo.InfiniteMPO(ja.Ws, ja.vL, ja.vR)
    tm = tmpo.InfiniteMPO(ta.Ws, ta.vL, ta.vR)
    for n in (1, 2, -1):
        r = tm.roll(n)
        assert isinstance(r, tmpo.InfiniteMPO)
        np.testing.assert_array_equal(r.Ws.numpy(), np.asarray(jm.roll(n).Ws))
        np.testing.assert_array_equal(r.vL.numpy(), np.asarray(ja.vL))


@pytest.mark.parametrize("name", ["tfi", "xxz", "decaying"])
def test_mpo_diagonal_coefficients(name):
    W = _w(name)
    assert (TV.mpo_diagonal_coefficients(torch.as_tensor(W))
            == JV.mpo_diagonal_coefficients(W))


@pytest.mark.parametrize("fault", ["diagonal", "upper", "corner"])
def test_mpo_diagonal_coefficients_errors(fault):
    W = _tfi_w(-1.0, -1.0)
    if fault == "diagonal":
        W[1, 1] = np.array([[1.0, 0.5], [0.0, 1.0]])
    elif fault == "upper":
        W[0, 1] = np.eye(2)
    else:
        W[2, 2] = 2 * np.eye(2)
    with pytest.raises(ValueError) as jerr:
        JV.mpo_diagonal_coefficients(W)
    with pytest.raises(ValueError) as terr:
        TV.mpo_diagonal_coefficients(torch.as_tensor(W))
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# environments, one iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tfi", "xxz", "decaying"])
def test_environments_match_jax(name):
    W = _w(name)
    lams = JV.mpo_diagonal_coefficients(W)
    js = _jax_state(1, CHI, jnp.float64)
    AL, AR, C, _ = js
    r0 = C @ C.T / jnp.trace(C @ C.T)
    l0 = C.T @ C / jnp.trace(C.T @ C)
    rj = JV._fixed_point_right(AL, r0, 10)
    lj = JV._fixed_point_left(AR, l0, 10)
    LWj, eLj = JV.left_mpo_environment(AL, jnp.asarray(W), rj, lams,
                                       jnp.zeros_like(C), 30, 2)
    RWj, eRj = JV.right_mpo_environment(AR, jnp.asarray(W), lj, lams,
                                        jnp.zeros_like(C), 30, 2)
    ts = _port_state(js)
    t = [torch.as_tensor(np.asarray(x)) for x in (r0, l0, rj, lj)]
    np.testing.assert_allclose(TV._fixed_point_right(ts.AL, t[0], 10).numpy(),
                               np.asarray(rj), atol=ENV_TOL)
    np.testing.assert_allclose(TV._fixed_point_left(ts.AR, t[1], 10).numpy(),
                               np.asarray(lj), atol=ENV_TOL)
    Wt = torch.as_tensor(W)
    LW, eL = TV.left_mpo_environment(ts.AL, Wt, t[2], lams,
                                     torch.zeros_like(ts.C), 30, 2)
    RW, eR = TV.right_mpo_environment(ts.AR, Wt, t[3], lams,
                                      torch.zeros_like(ts.C), 30, 2)
    for got, ref in ((LW, LWj), (RW, RWj), (eL, eLj), (eR, eRj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ENV_TOL)


def test_lanczos_impl_choice():
    st = TV.random_vumps_state(0, 4, device="cpu")
    assert TV._lanczos_impl(None, st.C) == "plain"           # CPU tensors
    cst = TV.VUMPSState(*(x.to(torch.complex128) for x in st))
    assert TV._lanczos_impl(None, cst.C) == "plain"
    W = _tfi_w(-1.0, -1.0)
    with pytest.raises(ValueError, match="real state"):
        TV.vumps_iteration(cst, W, JV.mpo_diagonal_coefficients(W),
                           lanczos_impl="fused")
    with pytest.raises(ValueError, match="unknown"):
        TV.vumps_iteration(st, W, JV.mpo_diagonal_coefficients(W),
                           lanczos_impl="xla")


def test_vumps_runs_on_the_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W = _tfi_w(-1.0, -1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.vumps(W, chi=4, num_iterations=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.random_vumps_state(0, 4)
    res = TV.vumps(W, chi=4, num_iterations=1, device="cpu")
    assert res.state.AC.device.type == "cpu"


def test_random_vumps_state():
    a = TV.random_vumps_state(5, 6, device="cpu")
    b = TV.random_vumps_state(torch.Generator().manual_seed(5), 6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    AL, AR, C, AC = a
    assert AL.shape == AR.shape == AC.shape == (6, 2, 6)
    np.testing.assert_allclose(torch.einsum("asb,asc->bc", AL, AL).numpy(),
                               np.eye(6), atol=1e-12)
    np.testing.assert_allclose(torch.einsum("asb,csb->ac", AR, AR).numpy(),
                               np.eye(6), atol=1e-12)
    np.testing.assert_allclose(torch.einsum("asb,bc->asc", AL, C).numpy(),
                               AC.numpy(), atol=1e-14)
    assert abs(float(torch.linalg.vector_norm(C)) - 1) < 1e-14


# ---------------------------------------------------------------------------
# converged states
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gapped_result():
    W = torch.as_tensor(_tfi_w(-1.0, -1.3))
    return TV.vumps(W, chi=CHI, num_iterations=60, tol=1e-9, seed=1)


def test_vumps_tfi_energy_matches_free_fermion_integral(gapped_result):
    # tests/test_vumps.py:19-26's bars
    res = gapped_result
    assert abs(res.energy - TV.tfi_exact_energy_density(-1.0, -1.3)) < 1e-8
    assert res.gradient_norms[-1] < 1e-6
    assert TV.tfi_exact_energy_density(-1.0, -1.3) == \
        JV.tfi_exact_energy_density(-1.0, -1.3)
    # the identity channels stay exactly identity
    np.testing.assert_allclose(res.LW[:, 2, :].numpy(), np.eye(CHI),
                               atol=1e-10)
    np.testing.assert_allclose(res.RW[:, 0, :].numpy(), np.eye(CHI),
                               atol=1e-10)


def test_mixed_gauge_invariants():
    # tests/test_vumps.py:46-62's bars
    W = torch.as_tensor(_tfi_w(-1.0, -1.5))
    res = TV.vumps(W, chi=CHI, num_iterations=50, tol=1e-9, seed=2)
    AL, AR, C, AC = (x.numpy() for x in res.state)
    np.testing.assert_allclose(np.einsum("asb,asc->bc", AL, AL.conj()),
                               np.eye(CHI), atol=1e-8)
    np.testing.assert_allclose(np.einsum("asb,csb->ac", AR, AR.conj()),
                               np.eye(CHI), atol=1e-8)
    np.testing.assert_allclose(np.einsum("asb,bc->asc", AL, C), AC,
                               atol=1e-6)
    np.testing.assert_allclose(np.einsum("ab,bsc->asc", C, AR), AC,
                               atol=1e-6)


def test_correlation_length_matches_jax(gapped_result):
    AL = gapped_result.state.AL
    xi = TV.correlation_length(AL)
    xj = JV.correlation_length(jnp.asarray(AL.numpy()))
    assert abs(xi - xj) < XI_RTOL * xj
    assert 0.1 < xi < 50.0


def test_solve_counts_are_host_checks():
    # the residual-targeted solves: one host check before each pass
    st = TV.random_vumps_state(2, 6, device="cpu")
    W = _tfi_w(-1.0, -1.0)
    lams = TV.mpo_diagonal_coefficients(W)
    TV.reset_counts()
    tkrylov.reset_counts()
    TV.vumps_iteration(st, W, lams, num_krylov_vecs=10, solve_tol=1e-30,
                       lanczos_restarts=3)
    # the target cannot be met: every pass runs, each after a check
    assert TV.counts == {"ac_passes": 3, "c_passes": 3, "ritz_checks": 6}
    # and at least one GMRES restart for each fixed point and environment
    assert tkrylov.counts["host_checks"] >= 4
