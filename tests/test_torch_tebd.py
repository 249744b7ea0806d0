"""The port's TEBD against the JAX package's, on the CPU.

Trotter gates, the MPS sweep with its truncated weight, real- and
imaginary-time evolution of a FiniteMPS, the bond energy, and the exact
evolution of a dense state.  Both packages get the same numbers, made with
numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mps as jmps
from tensornetwork_tpu.models import tebd as jtebd
from tensornetwork_tpu_torch.models import mps as tmps
from tensornetwork_tpu_torch.models import tebd as ttebd

# f64/complex128: matrix exponentials and LAPACK SVDs of the same inputs,
# ~1e-14 seen; f32 and complex64 at their rounding
TOL = {"float64": 1e-10, "complex128": 1e-10, "float32": 1e-5,
       "complex64": 1e-5}
N, CHI = 6, 8


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tfi_h2(J=-1.0, h=-1.0):
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    I = np.eye(2)
    return J * np.kron(X, X) + h / 2 * (np.kron(Z, I) + np.kron(I, Z))


def _close(t, j, dtype, scale=1.0):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               atol=TOL[dtype] * scale,
                               rtol=TOL[dtype] * scale)


def _random_pair(seed, dtype, canonicalize=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, CHI, 2, CHI))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(a.shape)
    a = (a / np.sqrt(2 * CHI)).astype(dtype)
    return (jmps.FiniteMPS(jnp.asarray(a), canonicalize=canonicalize),
            tmps.FiniteMPS(torch.from_numpy(a), canonicalize=canonicalize))


def _product_pair(dtype):
    a = np.zeros((N, CHI, 2, CHI), dtype)
    a[:, 0, 0, 0] = 1.0
    return (jmps.FiniteMPS(jnp.asarray(a), canonicalize=False),
            tmps.FiniteMPS(torch.from_numpy(a), canonicalize=False))


@pytest.mark.parametrize("imaginary", [False, True])
@pytest.mark.parametrize("shape4", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_trotter_gate_matches_jax(imaginary, shape4, dtype):
    h2 = _tfi_h2(-1.0, -0.7).astype(dtype)
    if shape4:
        h2 = h2.reshape(2, 2, 2, 2)
    t = ttebd.trotter_gate(h2, 0.1, imaginary=imaginary, device="cpu")
    j = jtebd.trotter_gate(jnp.asarray(h2), 0.1, imaginary=imaginary)
    assert t.shape == (2, 2, 2, 2)
    assert t.dtype == torch.from_numpy(np.array(j)).dtype
    _close(t, j, dtype)
    g = t.reshape(4, 4).to(torch.complex128).numpy()
    if not imaginary:
        np.testing.assert_allclose(g @ g.conj().T, np.eye(4),
                                   atol=10 * TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("kw", [dict(), dict(max_singular_values=3),
                                dict(max_truncation_err=0.02)])
def test_tebd_sweep_matches_jax(dtype, kw):
    jm, tm = _random_pair(0, dtype)
    g = np.array(jtebd.trotter_gate(_tfi_h2(), 0.3, imaginary=True))
    jw = jtebd.tebd_sweep(jm, jnp.asarray(g), **kw)
    tw = ttebd.tebd_sweep(tm, torch.from_numpy(g), **kw)
    assert isinstance(tw, float)
    _close(tw, jw, dtype)
    if kw:
        assert tw > 0
    assert tm.center_position == jm.center_position == 0
    _close(tm.to_dense(), jm.to_dense(), dtype, 10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_evolve_mps_real_time_from_a_product_state(dtype):
    jm, tm = _product_pair(dtype)
    h2 = _tfi_h2()
    je, jw = jtebd.evolve_mps(jm, h2, 0.05, 4, max_singular_values=CHI)
    te, tw = ttebd.evolve_mps(tm, h2, 0.05, 4, max_singular_values=CHI)
    assert te == je == []
    cdt = "complex128" if dtype == "float64" else "complex64"
    assert str(tm.dtype)[6:] == cdt and str(jm.dtype) == cdt
    _close(tw, jw, dtype)
    _close(tm.to_dense(), jm.to_dense(), cdt, 10)
    _close(tm.norm(), jm.norm(), cdt)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_evolve_mps_imaginary_time(dtype):
    jm, tm = _random_pair(1, dtype)
    h2 = _tfi_h2()
    je, jw = jtebd.evolve_mps(jm, h2, 0.1, 5, imaginary=True,
                              max_singular_values=4)
    te, tw = ttebd.evolve_mps(tm, h2, 0.1, 5, imaginary=True,
                              max_singular_values=4)
    assert len(te) == 5 and all(isinstance(e, float) for e in te)
    _close(np.array(te), np.array(je), dtype)
    assert tw > 0
    _close(tw, jw, dtype)
    assert all(b < a for a, b in zip(te, te[1:]))


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
def test_measure_energy_matches_jax(dtype):
    jm, tm = _random_pair(2, dtype, canonicalize=False)
    for h2 in (_tfi_h2(), _tfi_h2(-0.5, 1.3).reshape(2, 2, 2, 2)):
        _close(ttebd.measure_energy(tm, h2), jtebd.measure_energy(jm, h2),
               dtype)


@pytest.mark.parametrize("imaginary", [False, True])
def test_evolve_exact_matches_jax(imaginary):
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((2,) * 7)
    psi /= np.linalg.norm(psi)
    h2 = _tfi_h2(-1.0, -1.2)
    j = jtebd.evolve_exact(jnp.asarray(psi), h2, 0.05, 6,
                           imaginary=imaginary)
    t = ttebd.evolve_exact(torch.from_numpy(psi), h2, 0.05, 6,
                           imaginary=imaginary)
    assert t.dtype == (torch.float64 if imaginary else torch.complex128)
    _close(t, j, "complex128")
    _close(ttebd.inner_exact(t, t), jtebd.inner_exact(j, j), "complex128")
    g = ttebd.trotter_gate(h2, 0.05, device="cpu")
    tp = torch.from_numpy(psi).to(torch.complex128)
    for site in (0, 3, 5):
        _close(ttebd.apply_two_site_gate_exact(tp, g, site),
               jtebd.apply_two_site_gate_exact(jnp.asarray(tp.numpy()),
                                               jnp.asarray(g.numpy()), site),
               "complex128")


def test_tebd_matches_the_exact_evolution():
    # tests/test_mera_tebd_imps.py's bars: MPS and dense Trotter orders are
    # both O(dt^2) integrators of the same hamiltonian
    h2 = _tfi_h2()
    _, tm = _product_pair("float64")
    psi0 = np.zeros((2,) * N)
    psi0[(0,) * N] = 1.0
    _, terr = ttebd.evolve_mps(tm, h2, 0.05, 6, max_singular_values=CHI)
    psi = ttebd.evolve_exact(torch.from_numpy(psi0), h2, 0.05, 6).numpy()
    blk = tm.to_dense().numpy()[0, ..., 0]
    fid = abs(np.vdot(blk.ravel() / np.linalg.norm(blk), psi.ravel()))
    assert fid > 0.995 and terr < 1e-6
