"""The paired batched entry points against the JAX package's.

``batched_one_site_sweep_paired`` and ``batched_two_site_sweep_paired``
keep the JAX package's names, defaults and check that ``pair`` divides the
batch, and compute on the port's one route.  The JAX package's paired
one-site route runs its fused kernel in interpret mode (~17 s of compile),
hence a file of its own; its paired two-site route is compared in
tests/test_torch_two_site_paired.py.
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


def test_batched_one_site_sweep_paired_matches_jax():
    # the JAX package's paired route, its fused kernel in interpret mode
    B, N, chi, m = 4, 6, 8, 6
    rng = np.random.default_rng(6)
    As0 = rng.standard_normal((B, N, chi, 2, chi)) / np.sqrt(2 * chi)
    jm = jmpo.FiniteTFI(1.0, 0.9, N=N, dtype=jnp.float64)
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    jres = jbatch.batched_one_site_sweep_paired(
        jnp.asarray(As0), jm.Ws, jm.vL, jm.vR, num_krylov_vecs=m, pair=2)
    tres = tbatch.batched_one_site_sweep_paired(
        torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR, num_krylov_vecs=m, pair=2)
    # the power Ritz solve freezes at a point set by the last bits of T on
    # the first sweep (tests/test_torch_dmrg.py)
    np.testing.assert_allclose(tres.energy.numpy(), np.asarray(jres.energy),
                               rtol=1e-6)
    assert tres.renvs.shape == jres.renvs.shape == (B, N, chi, 3, chi)
    # one route: the unpaired sweep with the paired defaults, bit for bit
    same = tbatch.batched_one_site_sweep(
        torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR, num_krylov_vecs=m,
        qr_impl="polar", ritz_impl="power", reorth=False,
        lanczos_impl="fused", epilogue_impl="xla")
    for a, b in zip(tres, same):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("two_site", [False, True])
def test_paired_names_raise_when_pair_does_not_divide_the_batch(two_site):
    fn = (tbatch.batched_two_site_sweep_paired if two_site
          else tbatch.batched_one_site_sweep_paired)
    jfn = (jbatch.batched_two_site_sweep_paired if two_site
           else jbatch.batched_one_site_sweep_paired)
    As = torch.zeros((3, 4, 2, 2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="not divisible by pair=2"):
        fn(As, None, None, None)
    with pytest.raises(ValueError, match="not divisible by pair=2"):
        jfn(jnp.zeros((3, 4, 2, 2, 2)), None, None, None)


def test_batched_two_site_sweep_paired_is_the_one_route():
    B, N, chi, m = 4, 4, 4, 4
    rng = np.random.default_rng(7)
    As0 = torch.from_numpy(rng.standard_normal((B, N, chi, 2, chi)) / 3)
    jm = jmpo.FiniteTFI(1.0, 0.9, N=N)
    mpo = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                 np.asarray(jm.vR), device="cpu")
    a = tbatch.batched_two_site_sweep_paired(As0, mpo.Ws, mpo.vL, mpo.vR,
                                             num_krylov_vecs=m, pair=4)
    b = tbatch.batched_two_site_sweep(As0, mpo.Ws, mpo.vL, mpo.vR,
                                      num_krylov_vecs=m, qr_impl="polar",
                                      ritz_impl="power", trunc_iters=2,
                                      trunc_orth="polar")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
