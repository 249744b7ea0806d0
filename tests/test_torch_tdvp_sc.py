"""The ``_sc`` TDVP path (the JAX package's split-complex algorithm on
native complex tensors) and its gauge and truncation: the port against
the JAX package.

The JAX side carries the state as an ``SC`` (real and imaginary parts);
the port takes the same numbers as one complex tensor
(``interop.mps_from_split_complex``).  The port's fused route runs K2's
twin on the realified operands (CPU tensors); the JAX side runs its
``"xla"`` route, whose Lanczos is reorthogonalised, so the two agree to
the Krylov projection error.  States are compared as dense vectors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.models import tdvp as jtdvp
from tensornetwork_tpu.ops import decompositions as jdec
from tensornetwork_tpu.ops import split_complex as jsc
from tensornetwork_tpu.parallel import batch as jbatch
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import tdvp as ttdvp
from tensornetwork_tpu_torch.ops import decompositions as tdec
from tensornetwork_tpu_torch.ops import kernels as TK
from tensornetwork_tpu_torch.parallel import batch as tbatch
from tests.test_torch_tdvp import (FIDELITY_TOL, _product_state,  # noqa: F401
                                   infidelity, one_intra_op_thread)


def _mpo(N):
    jm = jmpo.FiniteTFI(-1.0, -0.9, N=N, dtype=jnp.float64)
    return jm, [np.array(t) for t in (jm.Ws, jm.vL, jm.vR)]


def _to_sc(z):
    return jsc.SC(jnp.asarray(z.real), jnp.asarray(z.imag))


def _from_sc(x):
    return interop.mps_from_split_complex(np.asarray(x.re), np.asarray(x.im),
                                          device="cpu")


def test_mps_from_split_complex():
    rng = np.random.default_rng(0)
    re, im = rng.standard_normal((2, 3, 2, 3, 2))
    z = interop.mps_from_split_complex(re, im, device="cpu")
    assert z.dtype == torch.complex128
    assert np.array_equal(z.numpy(), re + 1j * im)
    z32 = interop.mps_from_split_complex(re.astype(np.float32),
                                         im.astype(np.float32), device="cpu")
    assert z32.dtype == torch.complex64
    assert interop.mps_from_numpy(re + 1j * im, device="cpu").dtype == (
        torch.complex128)


def _rank_deficient(rng, complex_):
    m = rng.standard_normal((3, 8, 4))
    if complex_:
        m = m + 1j * rng.standard_normal((3, 8, 4))
    m[:, :, 2:] = 0.0        # a product state's panel: two null columns
    m[1] = 0.0               # and a zero one
    return m


@pytest.mark.parametrize("complex_", [True, False], ids=["sc", "real"])
def test_polar_complete_matches_jax(complex_):
    # the JAX package's split-complex polar_complete, and its real twin
    # ns_polar_complete: the same steps in the same order (f64)
    m = _rank_deficient(np.random.default_rng(1), complex_)
    Q, P = tdec.polar_complete(torch.as_tensor(m))
    eye = torch.eye(4, dtype=Q.dtype)
    assert float((Q.mH @ Q - eye).abs().max()) < 1e-12
    assert float((Q @ P - torch.as_tensor(m)).abs().max()) < 1e-12
    for b in range(m.shape[0]):
        if complex_:
            Qj, Pj = jsc.polar_complete(_to_sc(m[b]))
            Qj = np.asarray(Qj.re) + 1j * np.asarray(Qj.im)
            Pj = np.asarray(Pj.re) + 1j * np.asarray(Pj.im)
        else:
            Qj, Pj = (np.asarray(t) for t in
                      jdec.ns_polar_complete(jnp.asarray(m[b])))
        np.testing.assert_allclose(Q[b].numpy(), Qj, atol=1e-12)
        np.testing.assert_allclose(P[b].numpy(), Pj, atol=1e-12)


def test_svd_masked_complex_matches_jax_sc():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((8, 6)) + 1j * rng.standard_normal((8, 6))
    res = tdec.svd_masked(torch.as_tensor(m)[None], max_singular_values=4,
                          max_truncation_error=0.5)
    want = jdec.svd_masked_sc(_to_sc(m), max_singular_values=4,
                              max_truncation_error=0.5)
    np.testing.assert_allclose(res.s[0].numpy(), want.s, atol=1e-12)
    assert int(res.num_kept[0]) == int(want.num_kept)
    assert abs(float(res.trunc_sq_norm[0]) - float(want.trunc_sq_norm)) < 1e-12
    # singular vectors up to a phase each: compare the kept product
    uj = np.asarray(want.u.re) + 1j * np.asarray(want.u.im)
    vj = np.asarray(want.vh.re) + 1j * np.asarray(want.vh.im)
    got = (res.u[0] * res.s[0]) @ res.vh[0]
    np.testing.assert_allclose(got.numpy(), (uj * np.asarray(want.s)) @ vj,
                               atol=1e-12)


def _sc_start(N, chi, v):
    As = _product_state(N, chi, np.asarray(v) / np.linalg.norm(v),
                        np.complex128)
    return As, _to_sc(As)


@pytest.mark.parametrize("lanczos_impl", ["fused", "plain"])
def test_one_site_sweep_sc_matches_jax(lanczos_impl):
    N, chi = 4, 4
    _, mpo = _mpo(N)
    As, As_sc = _sc_start(N, chi, [1.0, 0.3])
    want = jtdvp.tdvp_one_site_sweep_sc(As_sc, *map(jnp.asarray, mpo), 0.02,
                                        num_krylov_vecs=10,
                                        lanczos_impl="xla")
    TK.reset_launch_counts()
    got = ttdvp.tdvp_one_site_sweep_sc(_from_sc(As_sc),
                                       *map(torch.as_tensor, mpo), 0.02,
                                       num_krylov_vecs=10,
                                       lanczos_impl=lanczos_impl)
    assert TK.launch_counts["fused_lanczos"] == 0   # twins on the CPU
    w = np.asarray(want.re) + 1j * np.asarray(want.im)
    assert infidelity(got.numpy(), w) < FIDELITY_TOL
    assert abs(float(ttdvp.mps_mpo_expectation_sc(
        got, *map(torch.as_tensor, mpo)).real) - float(
        jtdvp.mps_mpo_expectation_sc(want, *map(jnp.asarray, mpo)).re)) < 1e-10


def test_batched_sweep_sc_matches_jax_with_per_instance_dt():
    N, chi, d, B = 4, 4, 2, 3
    _, mpo = _mpo(N)
    rng = np.random.default_rng(3)
    vs = rng.standard_normal((B, d))
    vs /= np.linalg.norm(vs, axis=1, keepdims=True)
    As = np.zeros((B, N, chi, d, chi))
    for b in range(B):
        As[b, :, 0, :, 0] = vs[b]
    dts = np.array([0.02, 0.05, 0.01])
    want = jbatch.batched_tdvp_one_site_sweep_sc(
        jsc.SC(jnp.asarray(As), jnp.zeros(As.shape)),
        *map(jnp.asarray, mpo), jnp.asarray(dts), num_krylov_vecs=10)
    got = tbatch.batched_tdvp_one_site_sweep_sc(
        torch.as_tensor(As + 0j), *map(torch.as_tensor, mpo),
        torch.as_tensor(dts), num_krylov_vecs=10)
    for b in range(B):
        w = np.asarray(want.re[b]) + 1j * np.asarray(want.im[b])
        assert infidelity(got[b].numpy(), w) < FIDELITY_TOL


def test_two_site_sweep_sc_matches_jax():
    N, chi = 5, 2
    jm = jmpo.FiniteTFI(-1.0, -1.5, N=N, dtype=jnp.float64)
    mpo = [np.array(t) for t in (jm.Ws, jm.vL, jm.vR)]
    _, As_sc = _sc_start(N, chi, [1.0, 0.2])
    want, wterr = jtdvp.tdvp_two_site_sweep_sc(
        As_sc, *map(jnp.asarray, mpo), 0.5, num_krylov_vecs=10)
    got, terr = ttdvp.tdvp_two_site_sweep_sc(
        _from_sc(As_sc), *map(torch.as_tensor, mpo), 0.5,
        num_krylov_vecs=10)
    assert float(wterr) > 1e-4
    assert abs(float(terr) - float(wterr)) < 1e-10
    w = np.asarray(want.re) + 1j * np.asarray(want.im)
    assert infidelity(got.numpy(), w) < FIDELITY_TOL
