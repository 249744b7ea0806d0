"""The port's FiniteMPS gates against the JAX package's, on the CPU.

One- and two-site gates with the masked-SVD truncation (by
``max_singular_values`` and by ``max_truncation_err``), the center moved
into the gate window, and complex64 product states (rank-deficient
panels).  Both packages get the same numbers, made with numpy from a seed;
the results are compared through the dense state and the truncated
weights.  The rest of FiniteMPS is in tests/test_torch_mps.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mps as jmps
from tensornetwork_tpu_torch.models import mps as tmps

# f64/complex128 against the same LAPACK factorizations: ~1e-14 seen;
# f32: the dtype's rounding over a few sweeps of chi=8 products
TOL = {"float64": 1e-10, "complex128": 1e-10, "float32": 1e-5,
       "complex64": 1e-5}
DTYPES = ["float64", "complex128", "float32"]
N, CHI, D = 6, 8, 2


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _stack(seed, dtype, n=N, chi=CHI):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, chi, D, chi))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, chi, D, chi))
    return (a / np.sqrt(chi * D)).astype(dtype)


def _pair(seed, dtype, canonicalize=True, **kw):
    a = _stack(seed, dtype, **kw)
    return (jmps.FiniteMPS(jnp.asarray(a), canonicalize=canonicalize),
            tmps.FiniteMPS(torch.from_numpy(a), canonicalize=canonicalize))


def _product_state(dtype, n=N, chi=CHI):
    v = np.array([1.0, 0.6 + 0.3j]) / np.hypot(np.hypot(1.0, 0.6), 0.3)
    a = np.zeros((n, chi, D, chi), dtype)
    a[:, 0, :, 0] = v.astype(dtype)
    return a


def _close(t, j, dtype, scale=1.0):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               atol=TOL[dtype] * scale,
                               rtol=TOL[dtype] * scale)


def _dense(m):
    return m.to_dense().numpy() if isinstance(m, tmps.FiniteMPS) else \
        np.asarray(m.to_dense())


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_one_site_gate(dtype):
    jm, tm = _pair(8, dtype)
    g = np.array([[0.3, 1.0], [0.7, -0.2]])
    jm.apply_one_site_gate(g, 2)
    tm.apply_one_site_gate(g, 2)
    _close(tm.As, jm.As, dtype, 10)
    _close(tm.to_dense(), jm.to_dense(), dtype)


def _gate(seed, dtype):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((D, D, D, D))
    if np.dtype(dtype).kind == "c":
        g = g + 1j * rng.standard_normal((D, D, D, D))
    return g.astype(dtype)


TRUNCATIONS = [dict(), dict(max_singular_values=3),
               dict(max_truncation_err=0.05),
               dict(max_singular_values=5, max_truncation_err=0.01)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trunc", range(len(TRUNCATIONS)))
@pytest.mark.parametrize("bond,center", [((2, 3), None), ((0, 1), 0),
                                         ((4, 5), 5)])
def test_apply_two_site_gate(dtype, trunc, bond, center):
    kw = TRUNCATIONS[trunc]
    jm, tm = _pair(9, dtype)
    jm.position(3)
    tm.position(3)
    g = _gate(10, dtype)
    jw = jm.apply_two_site_gate(g, *bond, center_position=center, **kw)
    tw = tm.apply_two_site_gate(g, *bond, center_position=center, **kw)
    _close(tw, jw, dtype)
    if kw:
        assert float(tw) > 0
    assert tm.center_position == jm.center_position
    assert tm.As.shape == (N, CHI, D, CHI)
    _close(tm.to_dense(), jm.to_dense(), dtype, 10)
    _close(tm.check_canonical(), jm.check_canonical(), dtype, 10)
    with pytest.raises(ValueError, match="neighboring"):
        tm.apply_two_site_gate(g, 1, 3)


@pytest.mark.parametrize("max_sv", [None, 2])
def test_apply_two_site_gate_complex64_product_state(max_sv):
    # the masked SVD of a rank-deficient complex64 panel (one nonzero
    # singular value): LAPACK's complex64 SVD on the CPU fails to converge
    # on some such panels, so it is factored in complex128
    a = _product_state("complex64")
    jm = jmps.FiniteMPS(jnp.asarray(a), canonicalize=False, center_position=0)
    tm = tmps.FiniteMPS(torch.from_numpy(a), canonicalize=False,
                        center_position=0)
    for b in range(N - 1):
        g = _gate(20 + b, "complex64")
        jw = jm.apply_two_site_gate(g, b, max_singular_values=max_sv)
        tw = tm.apply_two_site_gate(g, b, max_singular_values=max_sv)
        _close(tw, jw, "complex64", 10)
    assert bool(torch.isfinite(torch.view_as_real(tm.As)).all())
    dense_t, dense_j = _dense(tm), _dense(jm)
    _close(dense_t, dense_j, "complex64",
           10 * np.abs(dense_j).max())
