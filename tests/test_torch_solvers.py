"""The port's MPO and solver pieces against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages, with
explicit dtypes (the test session runs JAX with x64 on).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.ops import decompositions as jdec
from tensornetwork_tpu.ops import krylov as jkrylov
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.ops import decompositions as tdec
from tensornetwork_tpu_torch.ops import krylov as tkrylov


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("couplings", [(1.0, 1.0, 6), ([0.5, -1.0, 2.0], [1.0, 0.3, -0.7, 2.5], None)])
def test_finite_tfi_bitwise(couplings):
    Jx, Bz, N = couplings
    j = jmpo.FiniteTFI(Jx, Bz, N=N, dtype=jnp.float64)
    t = tmpo.FiniteTFI(Jx, Bz, N=N, dtype=torch.float64, device="cpu")
    for a, b in ((j.Ws, t.Ws), (j.vL, t.vL), (j.vR, t.vR)):
        assert b.dtype == torch.float64
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(jmpo.mpo_to_dense(j), tmpo.mpo_to_dense(t))
    assert (t.num_sites, t.bond_dim, t.phys_dim) == (j.num_sites, j.bond_dim, j.phys_dim)
    t32 = tmpo.FiniteTFI(Jx, Bz, N=N, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(np.asarray(jmpo.FiniteTFI(Jx, Bz, N=N, dtype=jnp.float32).Ws),
                                  t32.Ws.numpy())


def test_interop_carries_arrays(rng):
    j = jmpo.FiniteTFI(1.0, 0.5, N=4, dtype=jnp.float64)
    t = interop.mpo_from_numpy(np.asarray(j.Ws), np.asarray(j.vL), np.asarray(j.vR),
                               device="cpu", dtype=torch.float32)
    assert t.Ws.dtype == torch.float32 and t.Ws.device.type == "cpu"
    np.testing.assert_array_equal(t.Ws.numpy(), np.asarray(j.Ws, np.float32))
    As = rng.standard_normal((4, 3, 2, 3))
    tA = interop.mps_from_numpy(As, device="cpu")
    assert tA.dtype == torch.float64
    np.testing.assert_array_equal(tA.numpy(), As)


def _low_rank_panel(rng, n, k, rank):
    U, _ = np.linalg.qr(rng.standard_normal((n, rank)))
    V, _ = np.linalg.qr(rng.standard_normal((k, rank)))
    return U @ np.diag(np.linspace(1.0, 0.2, rank)) @ V.T, U


# f64 Newton-Schulz reaches ~1e-15 isometry on both sides; the two differ
# only in summation order, amplified by the iteration on the smallest
# singular values (cond ~5 here): 1e-10.  f32 (14, 7 steps): 1e-4 of the
# unit-scale factors, the same amplification at single precision.
POLAR_TOL = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.mark.parametrize("np_dt", [np.float64, np.float32])
def test_ns_polar_matches_jax(rng, np_dt):
    B, n, k = 3, 12, 6
    m = rng.standard_normal((B, n, k)).astype(np_dt)
    Qj, Pj = jdec.ns_polar(jnp.asarray(m))
    Qt, Pt = tdec.ns_polar(torch.from_numpy(m))
    assert Qt.dtype == torch.from_numpy(m).dtype
    assert _rel(Qt, Qj) < POLAR_TOL[np_dt]
    assert _rel(Pt, Pj) < POLAR_TOL[np_dt]
    G = (Qt.mT @ Qt).numpy().astype(np.float64)
    np.testing.assert_allclose(G, np.broadcast_to(np.eye(k), G.shape),
                               atol=10 * POLAR_TOL[np_dt])
    np.testing.assert_allclose((Qt @ Pt).numpy(), m, atol=10 * POLAR_TOL[np_dt])


@pytest.mark.parametrize("np_dt", [np.float64, np.float32])
def test_ns_polar_rank_deficient_panel(rng, np_dt):
    # rank 3 of 6 columns: on the range of the panel Q is an isometry and
    # agrees with JAX; the null directions hold rounding noise that the
    # iteration inflates (3.44x per quintic step), differently on the two
    # sides, so only the range part and P = Q^T m are compared.
    B, n, k, rank = 3, 12, 6, 3
    panels = [_low_rank_panel(rng, n, k, rank) for _ in range(B)]
    m = np.stack([p for p, _ in panels]).astype(np_dt)
    U = np.stack([u for _, u in panels])
    Qj, Pj = jdec.ns_polar(jnp.asarray(m))
    Qt, Pt = tdec.ns_polar(torch.from_numpy(m))
    proj = lambda Q: U @ (U.transpose(0, 2, 1) @ np.asarray(Q, np.float64))
    tol = POLAR_TOL[np_dt]
    assert _rel(proj(Qt.numpy()), proj(Qj)) < tol
    assert _rel(Pt, Pj) < tol
    np.testing.assert_allclose((Qt @ Pt).numpy(), m, atol=10 * tol)
    # Q's range part is a partial isometry of rank 3: U^T Q Q^T U = I_3
    UQ = U.transpose(0, 2, 1) @ Qt.numpy().astype(np.float64)
    np.testing.assert_allclose(UQ @ UQ.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(rank), (B, rank, rank)),
                               atol=10 * tol)


def test_qr_impls_split_the_panel(rng):
    m = torch.from_numpy(rng.standard_normal((2, 10, 4)))
    for impl in ("householder", "cholesky", "polar"):
        q, r = tdec.qr(m, impl)
        torch.testing.assert_close(q @ r, m, rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(q.mT @ q, torch.eye(4, dtype=m.dtype).expand(2, 4, 4),
                                   rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError):
        tdec.qr(m, "lu")


def _tridiag(rng, B, m):
    return rng.standard_normal((B, m)), np.abs(rng.standard_normal((B, m - 1))) + 0.1


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_tridiag_ritz_matches_jax(rng, method):
    B, m = 4, 8
    al, be = _tridiag(rng, B, m)
    lam_j, w_j = jax.vmap(lambda a, b: jkrylov.tridiag_ritz(a, b, method))(
        jnp.asarray(al), jnp.asarray(be))
    lam_t, w_t = tkrylov.tridiag_ritz(torch.from_numpy(al), torch.from_numpy(be), method)
    # f64 both sides; eigh vectors are compared up to their sign
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-10, atol=1e-10)
    w_j = np.asarray(w_j)
    sign = np.sign(np.sum(w_j * w_t.numpy(), axis=1, keepdims=True))
    np.testing.assert_allclose(w_t.numpy() * sign, w_j, atol=1e-8)
    exact = np.linalg.eigvalsh(np.stack([np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
                                         for a, b in zip(al, be)]))[:, 0]
    assert np.all(lam_t.numpy() >= exact - 1e-10)


def test_tridiag_ritz_power_skips_sentinels():
    al = torch.tensor([[0.5, 1e10, 1e10]], dtype=torch.float64)
    be = torch.zeros((1, 2), dtype=torch.float64)
    lam, w = tkrylov.tridiag_ritz(al, be, "power")
    assert float(lam) == 0.5
    np.testing.assert_array_equal(w.numpy(), [[1.0, 0.0, 0.0]])


def _hermitian(rng, B, n):
    H = rng.standard_normal((B, n, n))
    return (H + H.transpose(0, 2, 1)) / 2


@pytest.mark.parametrize("reorth", [True, False])
def test_lanczos_factorization_matches_jax(rng, reorth):
    B, n, m = 3, 20, 6
    H = _hermitian(rng, B, n)
    v0 = rng.standard_normal((B, n))
    out_j = jax.vmap(lambda h, v: jkrylov.lanczos_factorization(
        lambda x: h @ x, v, m, reorthogonalize=reorth))(jnp.asarray(H), jnp.asarray(v0))
    Ht = torch.from_numpy(H)
    out_t = tkrylov.lanczos_factorization(
        lambda x: (Ht @ x[..., None])[..., 0], torch.from_numpy(v0), m,
        reorthogonalize=reorth)
    for a, b in zip(out_t, out_j):  # f64 both sides, 6 steps
        assert a.shape == np.asarray(b).shape
        assert _rel(a, b) < 1e-10


@pytest.mark.parametrize("reorth", [True, False])
@pytest.mark.parametrize("method", ["eigh", "power"])
def test_eigsh_lanczos_matches_jax(rng, reorth, method):
    B, shape, m = 3, (4, 2, 4), 12
    n = int(np.prod(shape))
    H = _hermitian(rng, B, n)
    x0 = rng.standard_normal((B,) + shape)
    ev_j, vec_j = jax.vmap(lambda h, v: jkrylov.eigsh_lanczos(
        lambda x: (h @ x.reshape(-1)).reshape(shape), v, num_krylov_vecs=m,
        numeig=1, reorthogonalize=reorth, ritz_method=method))(
            jnp.asarray(H), jnp.asarray(x0))
    Ht = torch.from_numpy(H)
    ev_t, vec_t = tkrylov.eigsh_lanczos(
        lambda x: (Ht @ x.reshape(B, n, 1)).reshape((B,) + shape),
        torch.from_numpy(x0), num_krylov_vecs=m, numeig=1,
        reorthogonalize=reorth, ritz_method=method)
    assert ev_t.shape == (B, 1) and vec_t.shape == (B, 1) + shape
    # f64; without reorthogonalisation the basis drifts from orthogonality
    # identically on both sides, so the same 1e-8
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), rtol=1e-8, atol=1e-8)
    vj, vt = np.asarray(vec_j).reshape(B, -1), vec_t.numpy().reshape(B, -1)
    sign = np.sign(np.sum(vj * vt, axis=1, keepdims=True))
    np.testing.assert_allclose(vt * sign, vj, atol=1e-6)
    assert np.all(ev_t.numpy()[:, 0] >= np.linalg.eigvalsh(H)[:, 0] - 1e-10)
