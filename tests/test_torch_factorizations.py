"""The host-level tensor factorizations and the scheduled polar split of
the port against the JAX package's, on the CPU.

``svd``/``rq``/``eigh`` around a pivot axis with their truncation contract,
and ``ns_polar_express`` with its schedule built on the host.  Inputs are
made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.ops import decompositions as JD
from tensornetwork_tpu_torch.ops import decompositions as TD

TOL = {"float64": 1e-10, "complex128": 1e-10, "float32": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _close(t, j, tol):
    t = t.detach().resolve_conj().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=tol)


def _tensor(seed, shape, dtype, decay=None):
    """A random tensor; with ``decay``, its matrix about the last axis has
    singular values decay**k (so that the truncations are well defined)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    if decay is not None:
        m = a.reshape(-1, shape[-1])
        u, _, vh = np.linalg.svd(m, full_matrices=False)
        a = ((u * decay ** np.arange(len(vh))) @ vh).reshape(shape)
    return a.astype(dtype)


def _signed_close(t, j, tol, axis):
    """Columns (axis=-1) or rows (axis=0) equal up to a phase each: an SVD
    or QR leaves one per singular vector."""
    t, j = np.moveaxis(np.asarray(t), axis, 0), np.moveaxis(np.asarray(j),
                                                           axis, 0)
    for x, y in zip(t, j):
        ph = np.vdot(x, y)
        ph = ph / abs(ph) if abs(ph) > 0 else 1.0
        np.testing.assert_allclose(x * ph, y, atol=tol, rtol=tol)


SVD_CASES = [dict(), dict(max_singular_values=3),
             dict(max_truncation_error=0.1),
             dict(max_truncation_error=0.05, relative=True),
             dict(max_singular_values=4, max_truncation_error=1e-3)]


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("case", range(len(SVD_CASES)))
@pytest.mark.parametrize("pivot", [-1, 2])
def test_svd_matches_jax(dtype, case, pivot):
    a = _tensor(0, (3, 2, 4, 6), dtype, decay=0.6)
    kw = SVD_CASES[case]
    tu, ts, tv, tr = TD.svd(torch.from_numpy(a), pivot, **kw)
    ju, js, jv, jr = JD.svd(jnp.asarray(a), pivot, **kw)
    assert tu.shape == ju.shape and tv.shape == jv.shape
    assert ts.shape == js.shape and tr.shape == jr.shape
    _close(ts, js, TOL[dtype])
    _close(tr, jr, TOL[dtype])
    k = ts.shape[0]
    _signed_close(tu.reshape(-1, k), np.asarray(ju).reshape(-1, k),
                  10 * TOL[dtype], -1)
    # the truncated product is gauge-free
    low_t = tu.reshape(-1, k) @ (ts.to(tu.dtype)[:, None] * tv.reshape(k, -1))
    low_j = (np.asarray(ju).reshape(-1, k) * np.asarray(js)) @ np.asarray(
        jv).reshape(k, -1)
    _close(low_t, low_j, 10 * TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("pivot", [-1, 1])
def test_rq_matches_jax(dtype, nonneg, pivot):
    a = _tensor(1, (4, 3, 5), dtype)
    tr_, tq = TD.rq(torch.from_numpy(a), pivot, non_negative_diagonal=nonneg)
    jr_, jq = JD.rq(jnp.asarray(a), pivot, non_negative_diagonal=nonneg)
    assert tr_.shape == jr_.shape and tq.shape == jq.shape
    # Householder QR of the same matrix through LAPACK on both sides
    _close(tr_, jr_, 10 * TOL[dtype])
    _close(tq, jq, 10 * TOL[dtype])
    k = tq.shape[0] if pivot == 1 else tq.shape[0]
    q = tq.reshape(k, -1)
    _close(q @ q.mH, np.eye(k), 10 * TOL[dtype])
    _close(torch.tensordot(tr_, tq, dims=1), a, 10 * TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
def test_eigh_matches_jax(dtype):
    a = _tensor(2, (2, 3, 6), dtype).reshape(6, 6)
    h = (a + a.conj().T).reshape(2, 3, 2, 3)
    te, tv = TD.eigh(torch.from_numpy(h), 2)
    je, jv = JD.eigh(jnp.asarray(h), 2)
    assert tv.shape == jv.shape == (2, 3, 6)
    _close(te, je, TOL[dtype] * 10)
    _signed_close(tv.reshape(6, 6), np.asarray(jv).reshape(6, 6),
                  100 * TOL[dtype], -1)


def _panel(seed, dtype, rank=None, shape=(24, 8)):
    rng = np.random.default_rng(seed)
    m, n = shape
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 0.5 ** np.arange(n)
    if rank is not None:
        s[rank:] = 0.0
    return ((u * s) @ v.T).astype(dtype)


# The polar factor on the panel's range, against the JAX package's: f64 is
# ns_polar's fixed schedule in both (~1e-15 seen).  In f32 the LP
# schedule's inflating quintic steps carry each rounding into the next:
# the port's factor sat 3.8e-4 from the exact polar factor, the JAX
# package's 4e-7, numpy's f32 evaluation of the same steps 5e-5, and
# 1e-7 relative perturbations of the panel moved the port's by 2.5e-4 to
# 8.7e-4 -- each an isometry to 1e-6 that reproduces the panel, the
# contract of ns_polar_express.  The hybrid schedule's gentle steps agree
# to 8e-7.
POLAR_TOL = {("float64", "lp"): 1e-10, ("float64", "hybrid"): 1e-10,
             ("float32", "lp"): 1e-3, ("float32", "hybrid"): 1e-5}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rank", [None, 5])
@pytest.mark.parametrize("mode", ["lp", "hybrid"])
def test_ns_polar_express_matches_jax(dtype, rank, mode):
    m = _panel(3, dtype, rank)
    tq, tp = TD.ns_polar_express(torch.from_numpy(m), mode=mode)
    jq, jp = JD.ns_polar_express(jnp.asarray(m), mode=mode)
    # tests/test_decompositions.py's reconstruction bar in f32
    fine = 1e-4 if dtype == "float32" else 1e-10
    # on an exactly rank-deficient panel the null columns are rounding
    # inflated by the steps: only the factor on the panel's row space is
    # determined
    r = 8 if rank is None else rank
    vr = torch.from_numpy(np.linalg.svd(m.astype(np.float64))[2][:r].T
                          ).to(tq.dtype)
    _close(tq @ vr, np.asarray(jq) @ vr.numpy(), POLAR_TOL[dtype, mode])
    _close(tq @ tp, m, fine)
    _close(tq @ tp, np.asarray(jq) @ np.asarray(jp), fine)
    g = (tq.mT @ tq).double().numpy()
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(g))[-r:],
                               np.ones(r), atol=fine)
    if rank is not None and dtype == "float64":  # a partial isometry
        np.testing.assert_allclose(np.linalg.eigvalsh(g)[:8 - r], 0.0,
                                   atol=1e-6)


def test_polar_express_schedule_matches_jax():
    l0 = 1.0 / (1e7 * np.sqrt(8) * 1.01)
    assert TD._polar_express_schedule(l0, 1e-2) == \
        JD._polar_express_schedule(l0, 1e-2)
    assert TD._polar_hybrid_schedule(l0) == JD._polar_hybrid_schedule(l0)
    assert TD.qr(torch.from_numpy(_panel(3, "float32")), "polar_express")[
        0].shape == (24, 8)
