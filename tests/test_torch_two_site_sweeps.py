"""The port's two-site DMRG sweeps against the JAX package, on the CPU.

``two_site_sweep`` (both Lanczos routes, both truncations, each tier of
the two-site router, chained through ``renvs``), the batched two-site
sweep, and ``FiniteDMRG.run_two_site``/``BatchedDMRG.run_two_site``
against exact diagonalisation.  Every wrapper is handed CPU tensors here
and so runs its plain-PyTorch twin.  Inputs are made with numpy from a seed
and handed to both packages.  The bond truncations, the routers and the
kernel twins are in tests/test_torch_two_site.py.
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


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# The sweeps against the JAX sweeps
# ---------------------------------------------------------------------------

# f64 with eigh Ritz pairs on both sides: the JAX package's plain Lanczos
# without reorthogonalisation is the fused route's recurrence, and with it
# the plain route's; the two differ in summation order only.  The
# truncations are the same algorithm (LAPACK SVD, or subspace iteration
# with Householder QR), so per-bond energies agree to ~1e-12 (1e-9
# relative allowed) and the accumulated discarded weight to 1e-9.
SWEEP_TOL = 1e-9
_SWEEP = dict(N=6, chi=8, d=2, m=6)


def _jax_two_site(As, jm, trunc_impl, reorth, renvs=None):
    return jdmrg.two_site_sweep(
        jnp.asarray(As), jm.Ws, jm.vL, jm.vR, num_krylov_vecs=_SWEEP["m"],
        qr_impl="householder", ritz_impl="eigh", reorth=reorth,
        lanczos_impl="xla", trunc_impl=trunc_impl, renvs=renvs)


@pytest.fixture(scope="module")
def tfi():
    N = _SWEEP["N"]
    rng = np.random.default_rng(11)
    As0 = rng.standard_normal((N, _SWEEP["chi"], 2, _SWEEP["chi"])) / np.sqrt(16)
    jm = jmpo.FiniteTFI(1.0, 0.9, N=N, dtype=jnp.float64)
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    return As0, jm, tm


def _check_sweep(tres, jres, tm, jm):
    N, chi = _SWEEP["N"], _SWEEP["chi"]
    assert tres.As.shape == (N, chi, 2, chi) and tres.energies.shape == (N - 1,)
    assert tres.renvs.shape == (N - 1, chi, 3, chi)
    np.testing.assert_allclose(tres.energies.numpy(), np.asarray(jres.energies),
                               rtol=SWEEP_TOL)
    np.testing.assert_allclose(float(tres.trunc_err), float(jres.trunc_err),
                               atol=SWEEP_TOL)
    np.testing.assert_allclose(
        float(tdmrg.mps_mpo_expectation(tres.As, tm.Ws, tm.vL, tm.vR)),
        float(jdmrg.mps_mpo_expectation(jres.As, jm.Ws, jm.vL, jm.vR)),
        rtol=SWEEP_TOL)


@pytest.mark.parametrize("trunc_impl", ["svd", "subspace"])
@pytest.mark.parametrize("lanczos_impl", ["fused", "plain"])
def test_two_site_sweep_matches_jax(tfi, trunc_impl, lanczos_impl):
    As0, jm, tm = tfi
    reorth = lanczos_impl == "plain"
    jres = _jax_two_site(As0, jm, trunc_impl, reorth)
    kw = dict(num_krylov_vecs=_SWEEP["m"], qr_impl="householder",
              ritz_impl="eigh", reorth=reorth, lanczos_impl=lanczos_impl,
              trunc_impl=trunc_impl)
    TK.reset_launch_counts()
    tres = tdmrg.two_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR,
                                **kw)
    assert sum(TK.launch_counts.values()) == 0  # CPU tensors: twins only
    assert float(tres.trunc_err) > 0  # chi=8 truncates chi*d=16
    _check_sweep(tres, jres, tm, jm)
    # a second sweep chained through renvs
    jres2 = _jax_two_site(jres.As, jm, trunc_impl, reorth, renvs=jres.renvs)
    tres2 = tdmrg.two_site_sweep(tres.As, tm.Ws, tm.vL, tm.vR,
                                 renvs=tres.renvs, **kw)
    _check_sweep(tres2, jres2, tm, jm)


@pytest.mark.parametrize("tier", ["resident", "streamed_matvec",
                                  "streamed_matvec_xl"])
def test_two_site_sweep_through_each_tier_matches_jax(monkeypatch, tfi, tier):
    As0, jm, tm = tfi
    jres = _jax_two_site(As0, jm, "svd", False)
    taken = []
    solve = tdmrg._FUSED_TIERS_2S[tier]

    def spy(*args, **kwargs):
        taken.append(tier)
        return solve(*args, **kwargs)

    monkeypatch.setitem(tdmrg._FUSED_TIERS_2S, tier, spy)
    monkeypatch.setattr(TK, "two_site_tier", lambda chi, d, M, m: tier)
    tres = tdmrg.two_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR,
                                num_krylov_vecs=_SWEEP["m"],
                                qr_impl="householder", ritz_impl="eigh",
                                lanczos_impl="fused", trunc_impl="svd")
    assert taken == [tier] * 2 * (_SWEEP["N"] - 1)
    _check_sweep(tres, jres, tm, jm)


def test_sweep_asks_the_two_site_router(monkeypatch):
    asked = []
    route = TK.two_site_tier
    monkeypatch.setattr(TK, "two_site_tier",
                        lambda *a: asked.append(a) or route(*a))
    N, chi = 4, 4
    As = tdmrg.random_mps_stack(0, N, chi, 2, device="cpu")
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, device="cpu")
    tdmrg.two_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=4)
    assert asked == [(chi, 2, 3, 4)] * 2 * (N - 1)


# the batched defaults: the power Ritz solve (60 steps from e1) freezes at
# a point set by the last bits of T on the first sweep from a random start
# (tests/test_torch_dmrg.py): 1e-6 relative on the energies; the polar
# truncation and gauge carry ~1e-6 into the discarded weight.
POWER_ENERGY_RTOL, POWER_TERR_TOL = 1e-6, 1e-6


def test_batched_two_site_sweep_matches_jax(rng):
    B, N, chi, m = 4, 6, 8, 6
    As0 = rng.standard_normal((B, N, chi, 2, chi)) / np.sqrt(2 * chi)
    jm = jmpo.FiniteTFI(1.0, 0.8, N=N, dtype=jnp.float64)
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    # the JAX package's unpaired batched route with the batched defaults and
    # its plain Lanczos (the fused kernel's recurrence)
    jres = jbatch.batched_two_site_sweep(
        jnp.asarray(As0), jm.Ws, jm.vL, jm.vR, num_krylov_vecs=m,
        lanczos_impl="xla", trunc_impl="subspace", trunc_iters=2,
        trunc_orth="polar")
    tres = tbatch.batched_two_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL,
                                         tm.vR, num_krylov_vecs=m)
    assert tres.energies.shape == (B, N - 1) and tres.trunc_err.shape == (B,)
    assert tres.renvs.shape == (B, N - 1, chi, 3, chi)
    np.testing.assert_allclose(tres.energies.numpy(), np.asarray(jres.energies),
                               rtol=POWER_ENERGY_RTOL)
    np.testing.assert_allclose(tres.trunc_err.numpy(), np.asarray(jres.trunc_err),
                               atol=POWER_TERR_TOL)
    jres2 = jbatch.batched_two_site_sweep(
        jres.As, jm.Ws, jm.vL, jm.vR, num_krylov_vecs=m, lanczos_impl="xla",
        trunc_impl="subspace", trunc_iters=2, trunc_orth="polar",
        renvs=jres.renvs)
    tres2 = tbatch.batched_two_site_sweep(tres.As, tm.Ws, tm.vL, tm.vR,
                                          num_krylov_vecs=m, renvs=tres.renvs)
    np.testing.assert_allclose(tres2.energy.numpy(), np.asarray(jres2.energy),
                               rtol=POWER_ENERGY_RTOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-8),
                                       (torch.float32, 5e-5)])
def test_run_two_site_is_variational(dtype, tol):
    # N=8 TFI: chi=16 holds the 256-dim ground state exactly.  The energy
    # must not fall below exact beyond the dtype's rounding (a Rayleigh
    # quotient) and must converge: 1e-8 in f64, the f32 floor of |E|~10
    # summed in f32 (5e-5).
    N, chi = 8, 16
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, dtype=dtype, device="cpu")
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(
        tmpo.FiniteTFI(1.0, 1.0, N=N, device="cpu")))[0]
    As = tdmrg.random_mps_stack(3, N, chi, 2, dtype=dtype, device="cpu")
    dm = tdmrg.FiniteDMRG(As, mpo)
    e = dm.run_two_site(num_sweeps=4, num_krylov_vecs=8)
    assert e >= exact - tol and abs(e - exact) < tol
    assert abs(dm.compute_energy() - exact) < tol
    assert len(dm.truncation_errors) == len(dm.energies)
    bd = tbatch.BatchedDMRG(torch.stack([As, -As]), mpo)
    es = bd.run_two_site(num_sweeps=4, num_krylov_vecs=8).numpy()
    assert es.shape == (2,)
    assert np.all(es >= exact - tol) and np.all(np.abs(es - exact) < tol)
