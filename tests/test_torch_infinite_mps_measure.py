"""The port's InfiniteMPS measurements against the JAX package's, on the
CPU: ``roll``, local operators and the two-body correlator.

Both packages get the same unit cell, made with numpy from a seed.  The
transfer eigenvectors come with an arbitrary phase (the port's ``eigs``
returns complex vectors for a real cell), so the comparisons are of
phase-free quantities: eigenvalues, the normalised fixed point,
canonicalised tensors and measurements.  The transfer eigenpairs and
canonical form are in tests/test_torch_infinite_mps.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import infinite_mps as jimps
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import infinite_mps as timps

# two restarted Arnoldi runs to tol 1e-10 on the same operator: the fixed
# points agree to ~1e-12, and everything gauged or measured through them
TOL = 1e-9
CELLS = [(1, 6, "float64"), (2, 4, "float64"), (2, 4, "complex128")]
# Each JAX measurement compiles its Arnoldi anew (~1.5 s): one operator a
# site, one correlator site per cell.
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cell(seed, n, chi, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, chi, 2, chi))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(a.shape)
    return (a / np.sqrt(2 * chi)).astype(dtype)


def _pair(seed, n, chi, dtype):
    a = _cell(seed, n, chi, dtype)
    return (jimps.InfiniteMPS(jnp.asarray(a)),
            timps.InfiniteMPS(interop.mps_from_numpy(a, device="cpu")))


def _close(t, j, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("cell", CELLS[1:])
def test_roll_and_local_measurements(cell):
    jm, tm = _pair(2, *cell)
    jm.canonicalize()
    tm.canonicalize()
    _close(tm.roll(1).As, jm.roll(1).As)
    np.testing.assert_array_equal(tm.roll(1).As.numpy(),
                                  torch.roll(tm.As, -1, 0).numpy())
    for site in range(cell[0]):
        _close(tm.measure_local_operator(0.3 * Z + X, site),
               jm.measure_local_operator(0.3 * Z + X, site))


@pytest.mark.parametrize("cell,site1", [(CELLS[0], 0), (CELLS[2], 1)])
def test_two_body_correlator_matches_jax(cell, site1):
    jm, tm = _pair(3, *cell)
    jm.canonicalize()
    tm.canonicalize()
    sites2 = [site1, site1 + 1, site1 + 4, site1 + 2]
    t = tm.measure_two_body_correlator(Z, X, site1, sites2)
    j = jm.measure_two_body_correlator(Z, X, site1, sites2)
    assert len(t) == len(sites2)
    for a, b in zip(t, j):
        _close(a, b)
    assert tm.measure_two_body_correlator(Z, Z, 0, []) == []


def test_product_state_measurements():
    # |up> on every site: <Z> = 1, <Z_0 Z_r> = 1, <Z_0 X_r> = 0
    A = np.zeros((1, 3, 2, 3))
    A[0, 0, 0, 0] = 1.0
    tm = timps.InfiniteMPS(torch.from_numpy(A))
    _close(tm.measure_local_operator(Z).real, 1.0, 1e-8)
    _close(torch.stack(tm.measure_two_body_correlator(Z, Z, 0, [0, 1, 3])
                       ).real, np.ones(3), 1e-8)
    _close(tm.measure_two_body_correlator(Z, X, 0, [2])[0].real, 0.0, 1e-8)
