"""The port's binary MERA against the JAX package's, on the CPU.

The ascending and descending superoperators, the energy, the polar updates
(their environments are gradients: the JAX package's gradient of a real
function of a complex input is the conjugate of PyTorch's, so the complex128
cases hold the port's conjugation), the scale-invariant top density and
three iterations of the optimizer.  Inputs are made with numpy from a seed.
Also: every contraction of more than two tensors in the MPS object layer
gives the same bits with and without ``opt_einsum``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mera as jmera
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import infinite_mps as timps
from tensornetwork_tpu_torch.models import mera as tmera
from tensornetwork_tpu_torch.models import mps as tmps
from tensornetwork_tpu_torch.models import tebd as ttebd

# chi=4 networks of a few hundred thousand products summed in other orders
# in f64: ~1e-15 relative seen
TOL = 1e-10
DTYPES = ["float64", "complex128"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _inputs(seed, dtype):
    """Random h, rho (6 legs), u and w of bond dimension 4."""
    rng = np.random.default_rng(seed)
    return (_rand(rng, (4,) * 6, dtype), _rand(rng, (4,) * 6, dtype),
            _rand(rng, (4,) * 4, dtype) / 4, _rand(rng, (4,) * 3, dtype) / 4)


def _hermitian(a):
    m = a.reshape(64, 64)
    return (m + m.conj().T).reshape(a.shape)


def _close(t, j, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, atol=tol * max(np.abs(j).max(), 1.0),
                               rtol=tol)


def _both(fn_t, fn_j, *arrays):
    return (fn_t(*(torch.from_numpy(a) for a in arrays)),
            fn_j(*(jnp.asarray(a) for a in arrays)))


def _trace_pair(a, b):
    return torch.einsum("ij,ji->", a.reshape(64, 64), b.reshape(64, 64))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ascend_and_descend_match_jax(dtype):
    h, rho, u, w = _inputs(0, dtype)
    t, j = _both(tmera.ascend, jmera.ascend, h, u, w)
    _close(t, j)
    t, j = _both(tmera.descend, jmera.descend, rho, u, w)
    _close(t, j)


def test_ascend_of_the_identity_with_identity_tensors():
    state = tmera.initialize_mera(4, 1, device="cpu")
    ident = torch.eye(64, dtype=torch.float64).reshape((4,) * 6)
    _close(tmera.ascend(ident, state.us[0], state.ws[0]), ident, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_descend_is_the_adjoint_of_ascend(dtype):
    h, rho, u, w = (torch.from_numpy(a) for a in _inputs(1, dtype))
    if dtype == "float64":
        # tests/test_mera_tebd_imps.py:22-30: Tr[rho asc(h)] = Tr[desc(rho) h]
        _close(_trace_pair(rho, tmera.ascend(h, u, w)),
               _trace_pair(tmera.descend(rho, u, w), h))
        return
    # complex: the JAX package's descend is conj(A^T rho) for the plain
    # transpose A^T of the ascending map in the entrywise pairing, so
    # Tr[rho asc(h)] = Tr[desc(rho^T) h] for Hermitian rho and h, where
    # rho^T = conj(rho) swaps the in and out triples
    h, rho = (torch.from_numpy(_hermitian(a.numpy())) for a in (h, rho))
    _close(_trace_pair(rho, tmera.ascend(h, u, w)),
           _trace_pair(tmera.descend(torch.conj(rho), u, w), h))
    _close((rho * tmera.ascend(h, u, w)).sum(),
           (torch.conj(tmera.descend(rho, u, w)) * h).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_energy_matches_jax(dtype):
    h, rho, _, _ = _inputs(2, dtype)
    t, j = _both(tmera.energy, jmera.energy, h, rho)
    assert t.dtype == torch.float64
    _close(t, j)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["disentangler", "isometry"])
def test_polar_updates_match_jax(dtype, which):
    h, rho, u, w = _inputs(3, dtype)
    h, rho = _hermitian(h), _hermitian(rho)
    fn_t = getattr(tmera, "update_" + which)
    fn_j = getattr(jmera, "update_" + which)
    t, j = _both(fn_t, fn_j, h, rho, u, w)
    _close(t, j, 1e-9)
    m = t.reshape((16, 16) if which == "disentangler" else (4, 16))
    _close(m @ m.mH, np.eye(m.shape[0]), 1e-12)


def test_top_density_matches_jax():
    h3 = tmera.blocked_ising_hamiltonian(device="cpu")
    _, _, u, w = _inputs(4, "float64")
    t = tmera.top_density(h3, torch.from_numpy(u), torch.from_numpy(w), 5)
    j = jmera.top_density(jnp.asarray(h3.numpy()), jnp.asarray(u),
                          jnp.asarray(w), 5)
    _close(t, j)
    _close(tmera._trace3(t), 1.0, 1e-12)


def _isometric_start(seed, layers):
    """Random isometries: the polar factor of an environment is unique only
    where it has full rank, which the identity start does not give."""
    rng = np.random.default_rng(seed)
    us = [np.linalg.qr(rng.standard_normal((16, 16)))[0].reshape((4,) * 4)
          for _ in range(layers)]
    ws = [np.linalg.qr(rng.standard_normal((16, 4)))[0].T.reshape((4,) * 3)
          for _ in range(layers)]
    return us, ws


def test_three_iterations_of_optimize_mera_match_jax():
    jh = jmera.blocked_ising_hamiltonian()
    th = tmera.blocked_ising_hamiltonian(device="cpu")
    js, ts = jmera.initialize_mera(4, 2), tmera.initialize_mera(
        4, 2, device="cpu")
    for t, j in zip(ts.us + ts.ws, js.us + js.ws):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    us, ws = _isometric_start(7, 2)
    js = jmera.MERAState([jnp.asarray(u) for u in us],
                         [jnp.asarray(w) for w in ws])
    ts = interop.mera_state_from_numpy(us, ws, device="cpu")
    js, je = jmera.optimize_mera(jh, js, num_iterations=3, num_top_iters=4)
    ts, te = tmera.optimize_mera(th, ts, num_iterations=3, num_top_iters=4)
    _close(te, je)
    for t, j in zip(ts.us + ts.ws, js.us + js.ws):
        _close(t, j, 1e-8)


def test_blocked_ising_hamiltonian_bit_for_bit():
    t = tmera.blocked_ising_hamiltonian(device="cpu")
    assert t.dtype == torch.float64 and t.shape == (4,) * 6
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(jmera.blocked_ising_hamiltonian()))
    t32 = tmera.blocked_ising_hamiltonian(torch.float32, device="cpu")
    np.testing.assert_array_equal(t32.numpy(), t.numpy().astype(np.float32))


def _networks():
    """The outputs of every multi-tensor contraction of the MPS object
    layer, on fixed inputs."""
    h, rho, u, w = (torch.from_numpy(a) for a in _inputs(5, "complex128"))
    rng = np.random.default_rng(6)
    As = torch.from_numpy(_rand(rng, (5, 4, 2, 4), "complex128"))
    m = tmps.FiniteMPS(As.clone(), canonicalize=False)
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    h2 = np.kron(X, X) + 0.3 * np.kron(Z, np.eye(2))
    imps = timps.InfiniteMPS(As[:2].clone())
    out = [tmera.ascend(h, u, w), tmera.descend(rho, u, w),
           torch.tensor(ttebd.measure_energy(m, h2)),
           torch.stack(m.measure_local_operator([Z, X], [1, 3])),
           torch.stack(m.measure_two_body_correlator(X, Z, 2, [0, 2, 4])),
           imps._propagate_right(torch.eye(4, dtype=As.dtype)),
           imps._propagate_left(torch.eye(4, dtype=As.dtype))]
    m.apply_two_site_gate(h2.reshape(2, 2, 2, 2), 1)
    return out + [m.As]


def test_contraction_order_does_not_depend_on_opt_einsum():
    if not torch.backends.opt_einsum.is_available():
        pytest.skip("opt_einsum is not installed")
    saved = torch.backends.opt_einsum.enabled
    try:
        torch.backends.opt_einsum.enabled = True
        with_opt = _networks()
        torch.backends.opt_einsum.enabled = False
        without = _networks()
    finally:
        torch.backends.opt_einsum.enabled = saved
    for a, b in zip(with_opt, without):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
