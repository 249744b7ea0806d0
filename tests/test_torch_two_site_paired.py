"""The port's batched two-site sweep against the JAX package's paired route.

The JAX package's batched accelerator route packs two instances into each
program of its fused two-site Lanczos kernel (``batched_two_site_sweep_
paired``, pair=2); here it runs with that kernel in interpret mode, which
compiles for ~40 s, hence a file of its own, and a module fixture that
both tests share.  The port has one route, the batch on K2's grid, run here
through the kernel's plain-PyTorch twin; its paired name computes on it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.parallel import batch as jbatch
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.parallel import batch as tbatch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# The power Ritz solve freezes at a point set by the last bits of T on the
# first sweep from a random start (tests/test_torch_dmrg.py): 1e-6 relative
# on the energies; the polar gauge and truncation carry ~1e-6 into the
# discarded weight and the site tensors' products.
POWER_ENERGY_RTOL, POWER_TERR_TOL = 1e-6, 1e-6


B, N, CHI, M_KRYLOV = 4, 6, 8, 6


@pytest.fixture(scope="module")
def paired():
    """The JAX package's paired sweep (its one slow call), shared."""
    As0 = np.random.default_rng(42).standard_normal(
        (B, N, CHI, 2, CHI)) / np.sqrt(2 * CHI)
    jm = jmpo.FiniteTFI(1.0, 0.9, N=N, dtype=jnp.float64)
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    jres = jbatch.batched_two_site_sweep_paired(
        jnp.asarray(As0), jm.Ws, jm.vL, jm.vR, num_krylov_vecs=M_KRYLOV,
        pair=2)
    return As0, tm, jres


def test_batched_two_site_sweep_paired_matches_the_jax_paired_route(paired):
    As0, tm, jres = paired
    tres = tbatch.batched_two_site_sweep_paired(
        torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR, num_krylov_vecs=M_KRYLOV,
        pair=2)
    np.testing.assert_allclose(tres.energy.numpy(), np.asarray(jres.energy),
                               rtol=POWER_ENERGY_RTOL)
    np.testing.assert_allclose(tres.trunc_err.numpy(),
                               np.asarray(jres.trunc_err), atol=POWER_TERR_TOL)
    assert tres.renvs.shape == jres.renvs.shape


def test_batched_two_site_sweep_matches_the_paired_route(paired):
    As0, tm, jres = paired
    chi, m = CHI, M_KRYLOV
    tres = tbatch.batched_two_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL,
                                         tm.vR, num_krylov_vecs=m)
    # the paired route's defaults are the port's batched ones
    np.testing.assert_allclose(tres.energy.numpy(), np.asarray(jres.energy),
                               rtol=POWER_ENERGY_RTOL)
    np.testing.assert_allclose(tres.trunc_err.numpy(), np.asarray(jres.trunc_err),
                               atol=POWER_TERR_TOL)
    assert tres.renvs.shape == jres.renvs.shape == (B, N - 1, chi, 3, chi)
    # bond (0, 1) of the returned state: the product of its first two sites
    # is free of the gauge between them
    th = np.einsum("pasb,pbtc->pastc", tres.As[:, 0].numpy(),
                   tres.As[:, 1].numpy())
    th_j = np.einsum("pasb,pbtc->pastc", np.asarray(jres.As[:, 0]),
                     np.asarray(jres.As[:, 1]))
    for b in range(B):
        s = np.sign(np.sum(th[b] * th_j[b]))
        np.testing.assert_allclose(s * th[b], th_j[b], atol=1e-5)
