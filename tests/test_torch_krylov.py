"""Arnoldi, the restarted eigensolvers and GMRES: the port against the JAX
package's ``ops/krylov.py`` on the same operators and starts.

Operators and starts are made with numpy from a seed and handed to both
packages in float64 (complex128 where stated).  GMRES solves its
least-squares problem by a QR where the JAX package rotates by Givens:
the same solution up to rounding.  The restarted eigensolvers take their
shifts from ``torch.linalg.eig``/``eigh`` where the JAX package runs a
real double-shift QR iteration: the converged eigenpairs agree to the
stated tolerance, the bases in between need not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.ops import krylov as J
from tensornetwork_tpu_torch.ops import krylov as T

# f64 solutions of the same system by the same Krylov space: rounding of
# the orthogonalisation and of the small least-squares solve (1e-14 seen)
X_RTOL = 1e-10
# Arnoldi basis and Hessenberg of the same recurrence in f64 (1e-14 seen)
FACT_TOL = 1e-10
# converged eigenvalues of both packages (and of numpy / scipy): the
# restart tolerance is 1e-9 .. 1e-10 relative
EIG_RTOL = 1e-7


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ops(A):
    """The same dense operator for both packages."""
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    return (lambda x: Aj @ x), (lambda x: At @ x)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _herm(rng, n):
    H = rng.standard_normal((n, n))
    return (H + H.T) / 2


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,maxiter,with_x0", [(10, 5, True), (20, 3, False),
                                               (60, 1, True)])
def test_gmres_matches_jax(m, maxiter, with_x0):
    rng = np.random.default_rng(m)
    n = 60
    A = rng.standard_normal((n, n)) + 3 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n) if with_x0 else None
    mj, mt = _ops(A)
    xj, _ = J.gmres(mj, jnp.asarray(b),
                    x0=None if x0 is None else jnp.asarray(x0),
                    num_krylov_vectors=m, maxiter=maxiter, tol=1e-12)
    T.reset_counts()
    xt, info = T.gmres(mt, torch.as_tensor(b),
                       x0=None if x0 is None else torch.as_tensor(x0),
                       num_krylov_vectors=m, maxiter=maxiter, tol=1e-12)
    assert info == 0
    assert _rel(xt.numpy(), xj) < X_RTOL
    # one host check before each cycle, the cycles bounded by maxiter
    assert 1 <= T.counts["gmres_restarts"] <= maxiter
    assert T.counts["host_checks"] in (T.counts["gmres_restarts"],
                                       T.counts["gmres_restarts"] + 1)


@pytest.mark.parametrize("maxiter", [1, 3])
def test_gmres_kernel_residual_matches_jax(maxiter):
    # a threshold no cycle meets: every cycle runs, and the residual norm
    # the kernel returns is the one the JAX package's Givens recurrence
    # carries
    rng = np.random.default_rng(12)
    n = 80
    A = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    mj, mt = _ops(A)
    xj, rj = J.gmres_kernel(mj, jnp.asarray(b), jnp.asarray(x0), 6, maxiter,
                            0.0)
    T.reset_counts()
    xt, rt = T.gmres_kernel(mt, torch.as_tensor(b), torch.as_tensor(x0), 6,
                            maxiter, 0.0)
    assert T.counts["gmres_restarts"] == maxiter
    assert _rel(xt.numpy(), xj) < X_RTOL
    assert abs(float(rt) - float(rj)) < X_RTOL * float(rj)
    np.testing.assert_allclose(float(rt), np.linalg.norm(b - A @ xt.numpy()),
                               rtol=1e-8)


def test_gmres_complex_matches_jax():
    rng = np.random.default_rng(3)
    n = 40
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
         + 4 * np.sqrt(n) * np.eye(n))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    mj, mt = _ops(A)
    xj, _ = J.gmres(mj, jnp.asarray(b), num_krylov_vectors=8, maxiter=6,
                    tol=1e-12)
    xt, _ = T.gmres(mt, torch.as_tensor(b), num_krylov_vectors=8,
                    maxiter=6, tol=1e-12)
    assert _rel(xt.numpy(), xj) < X_RTOL


def test_gmres_kernel_invariant_subspace_found_early():
    # b lies in a 3-dim invariant subspace: the Arnoldi breaks down at
    # step 3 of 10, the dead columns must not disturb x
    n = 30
    A = np.diag(np.arange(1.0, n + 1))
    b = np.zeros(n)
    b[:3] = 1.0
    mj, mt = _ops(A)
    xj, rj = J.gmres_kernel(mj, jnp.asarray(b), jnp.zeros(n), 10, 2, 1e-14)
    T.reset_counts()
    xt, rt = T.gmres_kernel(mt, torch.as_tensor(b),
                            torch.zeros(n, dtype=torch.float64), 10, 2,
                            1e-14)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(xt.numpy()[:3], [1.0, 0.5, 1 / 3],
                               rtol=1e-14)
    assert float(rt) < 1e-12 and float(rj) < 1e-12
    # the residual meets the threshold after one cycle: no second cycle
    assert T.counts["gmres_restarts"] == 1


def test_gmres_kernel_ends_on_the_residual():
    rng = np.random.default_rng(4)
    n = 40
    A = rng.standard_normal((n, n)) + 4 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal(n)
    x = np.linalg.solve(A, b)
    _, mt = _ops(A)
    T.reset_counts()
    # a start that already meets the threshold: no cycle at all
    xt, _ = T.gmres_kernel(mt, torch.as_tensor(b), torch.as_tensor(x), 5, 8,
                           1e-6 * np.linalg.norm(b))
    assert T.counts == {"gmres_restarts": 0, "host_checks": 1}
    np.testing.assert_array_equal(xt.numpy(), x)


# ---------------------------------------------------------------------------
# Arnoldi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_arnoldi_factorization_matches_jax(dtype):
    rng = np.random.default_rng(5)
    n, m = 50, 12
    A = rng.standard_normal((n, n)).astype(dtype)
    v0 = rng.standard_normal(n).astype(dtype)
    if dtype == np.complex128:
        A = A + 1j * rng.standard_normal((n, n))
        v0 = v0 + 1j * rng.standard_normal(n)
    mj, mt = _ops(A)
    Vj, Hj = J.arnoldi_factorization(mj, jnp.asarray(v0), m)
    Vt, Ht = T.arnoldi_factorization(mt, torch.as_tensor(v0), m)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=FACT_TOL)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=FACT_TOL)
    # warm start from the first 5 steps gives the same factorization
    V5, H5 = T.arnoldi_factorization(mt, torch.as_tensor(v0), 5)
    V0 = torch.zeros_like(Vt)
    H0 = torch.zeros_like(Ht)
    V0[:6], H0[:6, :5] = V5, H5
    Vw, Hw = T.arnoldi_factorization(mt, None, m, V0=V0, H0=H0, start=5)
    np.testing.assert_allclose(Vw.numpy(), Vt.numpy(), atol=FACT_TOL)
    np.testing.assert_allclose(Hw.numpy(), Ht.numpy(), atol=FACT_TOL)
    assert not V0[6:].any()      # the warm start is copied, not changed


def test_arnoldi_breakdown_leaves_zero_rows():
    n = 20
    A = np.diag(np.arange(1.0, n + 1))
    v0 = np.zeros(n)
    v0[:2] = 1.0
    mj, mt = _ops(A)
    Vj, Hj = J.arnoldi_factorization(mj, jnp.asarray(v0), 6)
    Vt, Ht = T.arnoldi_factorization(mt, torch.as_tensor(v0), 6)
    assert not Vt[2:].any()
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=FACT_TOL)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=FACT_TOL)


# ---------------------------------------------------------------------------
# eigs / iram
# ---------------------------------------------------------------------------


def _sorted(z):
    return np.sort_complex(np.asarray(z))


def test_iram_numeig4_matches_jax_and_numpy():
    rng = np.random.default_rng(6)
    n = 120
    A = rng.standard_normal((n, n)) / np.sqrt(n) + np.diag(
        np.linspace(0.0, 2.0, n))
    v0 = rng.standard_normal(n)
    mj, mt = _ops(A)
    kw = dict(num_krylov_vecs=30, numeig=4, which="LM", maxiter=60,
              tol=1e-9)
    ej, _ = J.iram(mj, jnp.asarray(v0), **kw)
    et, vt = T.iram(mt, torch.as_tensor(v0), **kw)
    ev = np.linalg.eigvals(A)
    ref = ev[np.argsort(-np.abs(ev))[:4]]
    np.testing.assert_allclose(_sorted(et.numpy()), _sorted(ej),
                               rtol=EIG_RTOL)
    np.testing.assert_allclose(_sorted(et.numpy()), _sorted(ref),
                               rtol=EIG_RTOL)
    for lam, v in zip(et.numpy(), vt):
        v = v.numpy()
        assert abs(np.linalg.norm(v) - 1) < 1e-12
        assert np.linalg.norm(A @ v - lam * v) < 1e-6


@pytest.mark.parametrize("method", ["iram", "explicit"])
def test_eigs_complex_pair_matches_jax(method):
    # a real operator whose dominant eigenvalues are the pair 2 +- 1j
    rng = np.random.default_rng(7)
    n = 80
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    A[:2, :2] = [[2.0, -1.0], [1.0, 2.0]]
    A[:2, 2:] = 0.0
    A[2:, :2] = 0.0
    v0 = rng.standard_normal(n)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    kw = dict(num_krylov_vecs=24, numeig=2, which="LM", tol=1e-8,
              method=method, maxiter=40 if method == "iram" else 6)
    # the explicit restart vector is complex (a sum of complex Ritz
    # vectors): the port's matvec takes the operator to its dtype, as
    # JAX promotes
    mj = lambda x: Aj @ x  # noqa: E731
    mt = lambda x: At.to(x.dtype) @ x  # noqa: E731
    ej, _ = J.eigs(mj, jnp.asarray(v0), **kw)
    et, vt = T.eigs(mt, torch.as_tensor(v0), **kw)
    np.testing.assert_allclose(_sorted(et.numpy()), _sorted(ej),
                               rtol=EIG_RTOL)
    np.testing.assert_allclose(np.sort(et.numpy().imag), [-1.0, 1.0],
                               rtol=EIG_RTOL)
    np.testing.assert_allclose(et.numpy().real, [2.0, 2.0], rtol=EIG_RTOL)
    assert len(vt) == 2 and vt[0].shape == (n,)


@pytest.mark.parametrize("which", ["LR", "SR"])
def test_iram_which_matches_jax(which):
    rng = np.random.default_rng(8)
    n = 60
    A = rng.standard_normal((n, n)) / np.sqrt(n) + np.diag(
        np.linspace(-1.0, 1.0, n))
    v0 = rng.standard_normal((6, 10))       # a tensor-shaped state
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    kw = dict(num_krylov_vecs=30, numeig=2, which=which, maxiter=80,
              tol=1e-9)
    ej, _ = J.iram(lambda x: (Aj @ x.reshape(-1)).reshape(6, 10),
                   jnp.asarray(v0), **kw)
    et, vt = T.iram(lambda x: (At @ x.reshape(-1)).reshape(6, 10),
                    torch.as_tensor(v0), **kw)
    np.testing.assert_allclose(_sorted(et.numpy()), _sorted(ej),
                               rtol=EIG_RTOL)
    assert vt[0].shape == (6, 10)


def test_iram_invariant_subspace_restricts_to_alive_rows():
    # a start inside a 3-dim invariant subspace: the factorization breaks
    # down, the dead rows must not add spurious zero eigenvalues
    n = 30
    A = np.diag(np.arange(1.0, n + 1))
    v0 = np.zeros(n)
    v0[[4, 9, 19]] = 1.0
    mj, mt = _ops(A)
    ej, _ = J.iram(mj, jnp.asarray(v0), num_krylov_vecs=8, numeig=4)
    et, _ = T.iram(mt, torch.as_tensor(v0), num_krylov_vecs=8, numeig=4)
    assert et.shape == (3,)
    np.testing.assert_allclose(_sorted(et.numpy()), _sorted(ej),
                               rtol=EIG_RTOL)
    np.testing.assert_allclose(np.sort(et.numpy().real), [5.0, 10.0, 20.0],
                               rtol=EIG_RTOL)


# ---------------------------------------------------------------------------
# eigsh / ir_lanczos
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["SA", "LA", "LM"])
def test_eigsh_matches_jax(which):
    rng = np.random.default_rng(9)
    n = 40
    H = _herm(rng, n)
    v0 = rng.standard_normal(n)
    mj, mt = _ops(H)
    ej, vj = J.eigsh(mj, jnp.asarray(v0), num_krylov_vecs=30, numeig=2,
                     which=which)
    et, vt = T.eigsh(mt, torch.as_tensor(v0), num_krylov_vecs=30, numeig=2,
                     which=which)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-10)
    for a, b in zip(vt, vj):
        assert abs(abs(np.dot(a.numpy(), np.asarray(b))) - 1) < 1e-8
    with pytest.raises(ValueError):
        T.eigsh(mt, torch.as_tensor(v0), which="SM")


@pytest.mark.parametrize("which", ["SA", "LA"])
def test_ir_lanczos_matches_jax(which):
    rng = np.random.default_rng(10)
    n = 200
    H = _herm(rng, n)
    v0 = rng.standard_normal(n)
    mj, mt = _ops(H)
    kw = dict(num_krylov_vecs=20, numeig=3, which=which, maxiter=60,
              tol=1e-10)
    ej, _ = J.ir_lanczos(mj, jnp.asarray(v0), **kw)
    et, vt = T.ir_lanczos(mt, torch.as_tensor(v0), **kw)
    exact = np.linalg.eigvalsh(H)
    exact = exact[:3] if which == "SA" else exact[::-1][:3]
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=EIG_RTOL)
    np.testing.assert_allclose(et.numpy(), exact, rtol=EIG_RTOL)
    for lam, v in zip(et.numpy(), vt.numpy()):
        assert np.linalg.norm(H @ v - lam * v) < 1e-5


def test_ir_lanczos_tensor_shape_and_complex():
    rng = np.random.default_rng(11)
    n = 64
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (H + H.conj().T) / 2
    v0 = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    Hj, Ht = jnp.asarray(H), torch.as_tensor(H)
    kw = dict(num_krylov_vecs=16, numeig=1, which="LA", maxiter=40,
              tol=1e-10)
    ej, _ = J.ir_lanczos(lambda x: (Hj @ x.reshape(-1)).reshape(8, 8),
                         jnp.asarray(v0), **kw)
    et, vt = T.ir_lanczos(lambda x: (Ht @ x.reshape(-1)).reshape(8, 8),
                          torch.as_tensor(v0), **kw)
    assert vt.shape == (1, 8, 8)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=EIG_RTOL)
    np.testing.assert_allclose(et.numpy()[0], np.linalg.eigvalsh(H)[-1],
                               rtol=EIG_RTOL)
