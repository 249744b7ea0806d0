"""The port's one-site DMRG against the JAX package, on the CPU.

Both packages start from the same numpy MPS stack and MPO and run with the
same explicit knobs.  The port's fused route runs the fused-Lanczos twin
(CPU tensors), the JAX package's runs its Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import dmrg as jdmrg
from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.parallel import batch as jbatch
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.ops import kernels as TK
from tensornetwork_tpu_torch.parallel import batch as tbatch


def _start(rng, shape):
    chi, d = shape[-1], shape[-2]
    return rng.standard_normal(shape) / np.sqrt(chi * d)


def _both_mpos(N, Bz=0.8):
    j = jmpo.FiniteTFI(1.0, Bz, N=N, dtype=jnp.float64)
    t = interop.mpo_from_numpy(np.asarray(j.Ws), np.asarray(j.vL),
                               np.asarray(j.vR), device="cpu")
    return j, t


def _signed_close(a, b, tol, site_axis):
    """a == +-b site by site (a site tensor's sign is a gauge freedom of
    the eigensolvers and of Householder QR)."""
    a, b = np.moveaxis(np.asarray(a), site_axis, 0), np.moveaxis(np.asarray(b), site_axis, 0)
    for x, y in zip(a, b):
        s = np.sign(np.sum(x * y))
        np.testing.assert_allclose(s * x, y, atol=tol, rtol=0)


# (JAX lanczos_impl, port lanczos_impl, qr_impl, ritz_impl, reorth)
ROUTES = {
    "fused-polar-eigh": ("fused", "fused", "polar", "eigh", False),
    "plain-householder-eigh": ("xla", "plain", "householder", "eigh", True),
}
# f64 with exact Ritz pairs: the two sides differ only in summation order,
# ~1e-12 on the site tensors after a sweep (measured), 1e-9 allowed.
SWEEP_TOL = 1e-9
# The power Ritz solve (the batched default: 60 steps from e1) is not
# converged on the first sweep from a random start and freezes where its
# residual drops below 1e-14, a point set by the last bits of T.  So the
# same sweep with "power" in place of "eigh" leaves ~1e-7 between the
# per-site energies and ~1e-4 between site tensors (measured 9.7e-8 and
# 8.6e-5 with the polar gauge); the Lanczos itself agrees to ~1e-12.
POWER_ENERGY_RTOL, POWER_SITE_TOL = 1e-6, 5e-4


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_site_sweep_matches_jax(rng, route):
    j_impl, t_impl, qr_impl, ritz_impl, reorth = ROUTES[route]
    N, chi, d, m = 5, 8, 2, 5
    As0 = _start(rng, (N, chi, d, chi))
    jm, tm = _both_mpos(N)
    kw = dict(num_krylov_vecs=m, qr_impl=qr_impl, ritz_impl=ritz_impl,
              reorth=reorth)
    jres = jdmrg.one_site_sweep(jnp.asarray(As0), jm.Ws, jm.vL, jm.vR,
                                lanczos_impl=j_impl, **kw)
    TK.reset_launch_counts()
    tres = tdmrg.one_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR,
                                lanczos_impl=t_impl, **kw)
    assert sum(TK.launch_counts.values()) == 0  # CPU tensors: twins only
    assert tres.As.shape == (N, chi, d, chi) and tres.energies.shape == (N,)
    assert tres.renvs.shape == (N, chi, 3, chi)
    np.testing.assert_allclose(tres.energies.numpy(), np.asarray(jres.energies),
                               rtol=SWEEP_TOL)
    _signed_close(tres.As, jres.As, SWEEP_TOL, 0)
    np.testing.assert_allclose(tres.renvs.numpy(), np.asarray(jres.renvs),
                               atol=SWEEP_TOL)

    # chained second sweep through renvs
    jres2 = jdmrg.one_site_sweep(jres.As, jm.Ws, jm.vL, jm.vR,
                                 lanczos_impl=j_impl, renvs=jres.renvs, **kw)
    tres2 = tdmrg.one_site_sweep(tres.As, tm.Ws, tm.vL, tm.vR,
                                 lanczos_impl=t_impl, renvs=tres.renvs, **kw)
    np.testing.assert_allclose(tres2.energies.numpy(), np.asarray(jres2.energies),
                               rtol=SWEEP_TOL)
    _signed_close(tres2.As, jres2.As, SWEEP_TOL, 0)


def test_explicit_open_boundary_envs_equal_the_default(rng):
    N, chi, m = 4, 4, 4
    As0 = torch.from_numpy(_start(rng, (N, chi, 2, chi)))
    mpo = tmpo.FiniteTFI(1.0, 0.8, N=N, device="cpu")
    eye = torch.eye(chi, dtype=torch.float64)
    benvs = (torch.einsum("ac,w->awc", eye, mpo.vL),
             torch.einsum("bd,v->bvd", eye, mpo.vR))
    a = tdmrg.one_site_sweep(As0, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=m)
    b = tdmrg.one_site_sweep(As0, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=m,
                             boundary_envs=benvs)
    torch.testing.assert_close(a.As, b.As, rtol=0, atol=0)
    torch.testing.assert_close(a.energies, b.energies, rtol=0, atol=0)


def test_right_canonicalize_and_envs_matches_jax(rng):
    N, chi, d = 5, 6, 2
    As0 = _start(rng, (N, chi, d, chi))
    jm, tm = _both_mpos(N)
    jQ, jR = jdmrg.right_canonicalize_and_envs(jnp.asarray(As0), jm.Ws, jm.vL,
                                               jm.vR, qr_impl="householder")
    tQ, tR = tdmrg.right_canonicalize_and_envs(torch.from_numpy(As0), tm.Ws,
                                               tm.vL, tm.vR,
                                               qr_impl="householder")
    _signed_close(tQ, jQ, 1e-10, 0)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-10)
    np.testing.assert_allclose(
        float(tdmrg.mps_mpo_expectation(tQ, tm.Ws, tm.vL, tm.vR)),
        float(jdmrg.mps_mpo_expectation(jQ, jm.Ws, jm.vL, jm.vR)), rtol=1e-10)


def test_batched_one_site_sweep_matches_jax(rng):
    # the JAX side runs its plain Lanczos with the fused kernel's semantics
    # (reorth=False, power Ritz): the port's fused route is held against
    # it, and the interpret-mode kernel is left to the single-instance test
    B, N, chi, d, m = 4, 6, 8, 2, 6
    As0 = _start(rng, (B, N, chi, d, chi))
    jm, tm = _both_mpos(N)
    jres = jbatch.batched_one_site_sweep(jnp.asarray(As0), jm.Ws, jm.vL, jm.vR,
                                         num_krylov_vecs=m,
                                         lanczos_impl="xla", paired=False)
    tres = tbatch.batched_one_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL,
                                         tm.vR, num_krylov_vecs=m)
    assert tres.energy.shape == (B,) and tres.energies.shape == (B, N)
    # the batched defaults: polar gauge, power Ritz, fused Lanczos
    np.testing.assert_allclose(tres.energies.numpy(), np.asarray(jres.energies),
                               rtol=POWER_ENERGY_RTOL)
    _signed_close(tres.As, jres.As, POWER_SITE_TOL, 1)
    jres2 = jbatch.batched_one_site_sweep(jres.As, jm.Ws, jm.vL, jm.vR,
                                          num_krylov_vecs=m,
                                          lanczos_impl="xla", paired=False,
                                          renvs=jres.renvs)
    tres2 = tbatch.batched_one_site_sweep(tres.As, tm.Ws, tm.vL, tm.vR,
                                          num_krylov_vecs=m, renvs=tres.renvs)
    np.testing.assert_allclose(tres2.energy.numpy(), np.asarray(jres2.energy),
                               rtol=POWER_ENERGY_RTOL)


def test_multi_mpo_batch_equals_per_instance_sweeps(rng):
    B, N, chi, m = 2, 4, 4, 4
    As0 = torch.from_numpy(_start(rng, (B, N, chi, 2, chi)))
    mpos = [tmpo.FiniteTFI(1.0, bz, N=N, device="cpu") for bz in (0.5, 1.5)]
    res = tbatch.batched_one_site_sweep_multi_mpo(
        As0, torch.stack([p.Ws for p in mpos]), mpos[0].vL, mpos[0].vR,
        num_krylov_vecs=m)
    for b, p in enumerate(mpos):
        one = tbatch.batched_one_site_sweep(As0[b:b + 1], p.Ws, p.vL, p.vR,
                                            num_krylov_vecs=m)
        torch.testing.assert_close(res.energies[b:b + 1], one.energies,
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-8), (torch.float32, 2e-4)])
def test_variational_against_exact_diagonalisation(dtype, tol):
    # N=8 TFI: 256-dim exact ground state; chi=8 holds it to ~1e-10.  The
    # energy must not fall below exact (a Rayleigh quotient) beyond the
    # dtype's rounding, and must converge: tol is ~1e-9 relative in f64,
    # the f32 floor of |E|~10 sums in f32.
    N, chi = 8, 8
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=dtype, device="cpu")
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(
        tmpo.FiniteTFI(1.0, 1.0, N=N, device="cpu")))[0]
    As = tdmrg.random_mps_stack(3, N, chi, 2, dtype=dtype, device="cpu")
    dm = tdmrg.FiniteDMRG(As, mpo)
    e = dm.run_one_site(num_sweeps=4, num_krylov_vecs=8)
    assert e >= exact - tol
    assert abs(e - exact) < tol
    assert abs(dm.compute_energy() - exact) < tol

    bd = tbatch.BatchedDMRG(torch.stack([As, -As]), mpo)
    es = bd.run_one_site(num_sweeps=4, num_krylov_vecs=8)
    assert es.shape == (2,)
    assert np.all(es.numpy() >= exact - tol)
    assert np.all(np.abs(es.numpy() - exact) < tol)
