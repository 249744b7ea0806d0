"""The port's InfiniteMPS against the JAX package's, on the CPU.

Both packages get the same unit cell, made with numpy from a seed.  The
transfer eigenvectors come with an arbitrary phase (the port's ``eigs``
returns complex vectors for a real cell), so the comparisons are of
phase-free quantities: eigenvalues, the normalised fixed point,
canonicalised tensors and measurements.  The measurements are in
tests/test_torch_infinite_mps_measure.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import infinite_mps as jimps
from tensornetwork_tpu.ops import krylov as jkrylov
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import infinite_mps as timps
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.models import vumps as tvumps
from tensornetwork_tpu_torch.ops import krylov as tkrylov

# two restarted Arnoldi runs to tol 1e-10 on the same operator: the fixed
# points agree to ~1e-12, and everything gauged or measured through them
TOL = 1e-9
CELLS = [(1, 6, "float64"), (2, 4, "float64"), (2, 4, "complex128")]


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


def _unit_trace(v):
    v = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return v / np.trace(v)


@pytest.mark.parametrize("cell", CELLS[::2])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_transfer_matrix_eigs_match_jax(cell, direction):
    jm, tm = _pair(0, *cell)
    je, jv = jm.transfer_matrix_eigs(direction, 1)
    te, tv = tm.transfer_matrix_eigs(direction, 1)
    _close(te, je)
    _close(_unit_trace(tv[0]), _unit_trace(jv[0]))
    # the dense transfer matrix's dominant eigenvalue
    if cell[0] == 1:
        A = _cell(0, *cell)[0]
        T = np.einsum("asc,bsd->abcd", A, A.conj()).reshape(
            cell[1] ** 2, -1)
        dense = np.linalg.eigvals(T)
        _close(abs(complex(te[0])), np.abs(dense).max())


@pytest.mark.parametrize("cell", CELLS)
def test_canonicalize_matches_jax(cell):
    jm, tm = _pair(1, *cell)
    jeta, jr = jm.canonicalize()
    teta, tr = tm.canonicalize()
    assert isinstance(teta, float)
    _close(teta, jeta)
    _close(tr, jr)
    _close(tm.As, jm.As)
    assert tm.As.dtype == torch.from_numpy(np.array(jm.As)).dtype
    assert tm.check_right_canonical() < 1e-10
    _close(tm.check_right_canonical(), jm.check_right_canonical(), 1e-10)
    te, _ = tm.transfer_matrix_eigs("right", 1)
    _close(abs(complex(te[0])), 1.0)


@pytest.fixture(scope="module")
def critical_cell():
    """The port's VUMPS state of the critical Ising chain at chi=12 (20
    iterations, f64): transfer eigenvalues 1 and -0.9953, a correlation
    length of about 210 sites."""
    W = tmpo.FiniteTFI(1.0, 1.0, N=3, dtype=torch.float64,
                       device="cpu").Ws[1]
    res = tvumps.vumps(W, chi=12, num_iterations=20, tol=1e-9, seed=1,
                       device="cpu")
    return res.state.AL.numpy()[None]


def _jax_shifts(Hm, hermitian):
    """The port's Ritz data of the restart with the JAX package's shifts:
    the eigenvalues of its fixed count of double-shift QR steps without
    deflation, where the port takes those of a full eigensolver."""
    _, _, lasts = _port_small_eig(Hm, hermitian)
    T = jkrylov._real_schur_qr(jnp.asarray(Hm.numpy()), max(40,
                                                           4 * Hm.shape[0]))
    jre, jim = jkrylov._quasi_tri_eigvals(T)
    return (torch.from_numpy(np.array(jre)), torch.from_numpy(np.array(jim)),
            lasts)


_port_small_eig = tkrylov._small_eig


@pytest.mark.parametrize("krylov", [30, 10])
def test_canonicalize_of_a_critical_cell_against_jax(critical_cell, krylov,
                                                     monkeypatch):
    jm = jimps.InfiniteMPS(jnp.asarray(critical_cell))
    tm = timps.InfiniteMPS(torch.from_numpy(critical_cell.copy()))
    jeta, _ = jm.canonicalize(krylov)
    teta, _ = tm.canonicalize(krylov)
    jres, tres = jm.check_right_canonical(), tm.check_right_canonical()
    if krylov == 30:
        # the defaults resolve the fixed point in both packages
        _close(teta, jeta, 1e-12)
        assert max(jres, tres) < 1e-8
        _close(tm.As, jm.As)
        return
    # 10 vectors resolve it in neither (the chi=64 cell of chip_smoke.py
    # with the defaults' 30 is the same regime), and the two packages land
    # on different points.  The restarts differ only in their shifts: with
    # the JAX package's, the port lands on the JAX package's point.
    assert abs(jeta - 1) > 1e-7 and jres > 1e-2
    monkeypatch.setattr(tkrylov, "_small_eig", _jax_shifts)
    sm = timps.InfiniteMPS(torch.from_numpy(critical_cell.copy()))
    seta, _ = sm.canonicalize(krylov)
    _close(seta, jeta)
    _close(sm.check_right_canonical(), jres, 1e-6)


def test_hermitize_removes_the_phase_before_symmetrising():
    # a fixed point returned with phase ~ i: made Hermitian first, it
    # would collapse to ~0
    rng = np.random.default_rng(4)
    g = rng.standard_normal((5, 5))
    r = g @ g.T
    m = torch.from_numpy(r * np.exp(1j * (np.pi / 2 - 1e-3)))
    out = timps._hermitize_psd(m, torch.float64)
    assert out.dtype == torch.float64
    _close(out, r)
    sqrt, inv_sqrt = timps._psd_roots(out)
    _close(sqrt @ sqrt, r)
    _close(inv_sqrt @ out @ inv_sqrt, np.eye(5), 1e-8)


def test_random():
    m = timps.InfiniteMPS.random(2, 4, seed=1, device="cpu")
    assert m.As.shape == (2, 4, 2, 4) and m.num_sites == 2
    m.canonicalize()
    assert m.check_right_canonical() < 1e-10
    listed = timps.InfiniteMPS(list(m.As))
    np.testing.assert_array_equal(listed.As.numpy(), m.As.numpy())
