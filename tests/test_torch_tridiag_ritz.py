"""The power Ritz step (``krylov.tridiag_ritz(method="power")``) on the CPU.

The plain loop, the twin of the card's kernel K10, against the JAX
package's ``tridiag_ritz`` (vmapped) on tridiagonal Lanczos projections:
whole ones, ones that broke down (the 1e10 sentinels of dead steps) and
ones with a zero beta before the last step (an invariant subspace reached
early).  Inputs are made in float64 with numpy and cast for both sides.

Tolerances.  The closed-form 2x2 step stalls once its correction h^2 /
(g - lam) falls under the rounding of mu - lam: w stops about sqrt(eps)
from the eigenvector (times a gap factor), at a point the rounding picks,
so two summation orders agree on w only to that floor (the loop against
the JAX package here: up to 5.3e-4 in float32, 1.4e-7 in float64 where
60 steps leave one instance short of it) and on lam, quadratic in w's
error, to a few eps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.ops import krylov as jkrylov
from tensornetwork_tpu_torch.ops import _build
from tensornetwork_tpu_torch.ops import krylov as tkrylov
from tensornetwork_tpu_torch.utils import tracing

# lam relative, w absolute
TOL = {torch.float32: (2e-5, 2e-3), torch.float64: (1e-12, 1e-6)}
CASES = ("projection", "dead", "zero_beta")
_jax_power = jax.jit(jax.vmap(
    lambda a, b: jkrylov.tridiag_ritz(a, b, "power")))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def lanczos_projection(rng, m: int, case: str):
    """(alphas (m,), betas (m-1,)) of m Lanczos steps (float64, full
    reorthogonalisation) on a random symmetric matrix with a gapped ground
    state, from a start near its ground vector, as a DMRG solve sees it.
    ``"dead"``: the start spans an invariant subspace of dimension m // 2,
    so the factorization breaks down there (beta 0, alpha 1e10 after it);
    ``"zero_beta"``: beta zero at m // 2 with the steps after it kept."""
    n = 2 * m + 8
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    spectrum = np.concatenate([[-1.5], rng.uniform(-1.0, 1.0, n - 1)])
    H = (q * spectrum) @ q.T
    k = max(m // 2, 1) if case == "dead" else m
    if case == "dead":
        v = q[:, :k] @ rng.standard_normal(k)
    else:
        v = q[:, 0] + 0.5 * rng.standard_normal(n) / np.sqrt(n)
    V = [v / np.linalg.norm(v)]
    alphas = np.full(m, tkrylov.LARGE)
    betas = np.zeros(m - 1)
    for j in range(k):
        w = H @ V[j]
        alphas[j] = V[j] @ w
        if j == k - 1:
            break
        for _ in range(2):
            w -= np.stack(V).T @ (np.stack(V) @ w)
        betas[j] = np.linalg.norm(w)
        V.append(w / betas[j])
    if case == "zero_beta" and m > 1:
        betas[max(m // 2, 1) - 1] = 0.0
    return alphas, betas


def _inputs(m: int, case: str, B: int = 6, seed: int = 0):
    rng = np.random.default_rng(1000 * m + CASES.index(case) + seed)
    pairs = [lanczos_projection(rng, m, case) for _ in range(B)]
    return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])


def _exact_ground(al, be, case):
    """The smallest eigenvalue of each tridiagonal's leading block, the
    one e1 lies in."""
    m = al.shape[-1]
    k = max(m // 2, 1) if case == "zero_beta" else m
    al, be = al[:, :k], be[:, :k - 1]
    T = np.stack([np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
                  for a, b in zip(al, be)])
    return np.linalg.eigvalsh(T)[:, 0]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("lead", [(6,), (2, 3)])
@pytest.mark.parametrize("m", [1, 2, 3, 10, 20, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_power_ritz_matches_jax(dtype, m, lead, case):
    al, be = _inputs(m, case)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    al, be = al.astype(np_dtype), be.astype(np_dtype)
    lam_j, w_j = _jax_power(jnp.asarray(al), jnp.asarray(be))
    lam_j, w_j = np.asarray(lam_j), np.asarray(w_j)
    assert lam_j.dtype == np_dtype
    lam, w = tkrylov.tridiag_ritz(
        torch.from_numpy(al).reshape(lead + (m,)),
        torch.from_numpy(be).reshape(lead + (m - 1,)), "power")
    assert lam.shape == lead and w.shape == lead + (m,)
    assert lam.dtype == w.dtype == dtype
    lam, w = lam.reshape(-1).numpy(), w.reshape(-1, m).numpy()
    lam_tol, w_tol = TOL[dtype]
    np.testing.assert_allclose(lam, lam_j, rtol=lam_tol, atol=0)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=w_tol)
    np.testing.assert_allclose(np.linalg.norm(w, axis=1), 1.0,
                               rtol=0, atol=10 * np.finfo(np_dtype).eps)
    # variational, and at the ground energy of the block e1 lies in
    exact = _exact_ground(al.astype(np.float64), be.astype(np.float64),
                          case)
    assert np.all(lam >= exact - lam_tol * np.abs(exact))
    np.testing.assert_allclose(lam, exact, rtol=lam_tol, atol=0)
    if case == "dead":
        # the weights of dead steps stay exactly zero
        assert not np.any(w[:, max(m // 2, 1):])


def test_power_ritz_on_the_cpu_builds_nothing(monkeypatch):
    """A CPU call runs the plain loop: it never loads a CUDA library (nor
    the kernels module's builder) and counts ``ritz.plain``."""
    def refuse(source):
        raise AssertionError(f"CPU power Ritz loaded {source}")

    monkeypatch.setattr(_build, "load", refuse)
    tracing.reset()
    al, be = _inputs(10, "projection")
    lam, w = tkrylov.tridiag_ritz(torch.from_numpy(al),
                                  torch.from_numpy(be), "power")
    ref_lam, ref_w = tkrylov.tridiag_ritz_power_plain(
        torch.from_numpy(al), torch.from_numpy(be))
    assert torch.equal(lam, ref_lam) and torch.equal(w, ref_w)
    assert tracing.counts.get("ritz.plain") == 1
    assert "ritz.kernel" not in tracing.counts
    tkrylov.tridiag_ritz(torch.from_numpy(al), torch.from_numpy(be), "eigh")
    assert tracing.counts.get("ritz.plain") == 1
    tracing.reset()
