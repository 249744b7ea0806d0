"""The fused gauge-and-environment epilogue (K5) against the JAX package.

The port's wrappers get CPU tensors and so run the kernel's plain twin;
the JAX package's run its Pallas kernel in interpret mode.  Inputs are
made with numpy from a seed, with explicit dtypes, and handed to both.
The CUDA kernel itself is held against the twin in tests/test_torch_cuda.py
and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import dmrg as jdmrg
from tensornetwork_tpu.ops import kernels as JK
from tensornetwork_tpu.ops import vmem
from tensornetwork_tpu.parallel import batch as jbatch
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.ops import kernels as TK
from tensornetwork_tpu_torch.parallel import batch as tbatch
from tests.test_torch_dmrg import (POWER_ENERGY_RTOL, SWEEP_TOL, _both_mpos,
                                   _signed_close, _start)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
# The twin runs the TPU kernel's steps in its order; the two sides differ
# in summation order only.  The converged polar factor of a
# well-conditioned panel is a smooth function of it, so that difference
# stays at a few ulp of the 21-30 steps: measured 1.7e-6 (f32) and 2.6e-15
# (f64) relative to the largest entry, on Q, P and the grown env.
EPILOGUE_TOL = {"f32": 2e-5, "f64": 1e-12}
# f64 at chi=8: the interpret-mode Pallas kernel is the slow side
CHI = {"f32": 16, "f64": 8}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _pallas(side, L, W, A, np_dt):
    qi, ci = TK.polar_iters(DTYPES["f32" if np_dt == np.float32 else "f64"][1])
    fn = getattr(JK, f"fused_gauge_env_{side}")
    return [np.asarray(t) for t in fn(
        *(jnp.asarray(a) for a in (L, W, A)), quintic_iters=qi,
        cubic_iters=ci, interpret=True, precision=jax.lax.Precision.HIGHEST)]


def _port(side, L, W, A, t_dt):
    TK.reset_launch_counts()
    fn = getattr(TK, f"fused_gauge_env_{side}")
    out = fn(*(torch.from_numpy(a) for a in (L, W, A)), *TK.polar_iters(t_dt))
    assert TK.launch_counts["fused_gauge_env"] == 0  # CPU tensors: the twin
    return out


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_fused_gauge_env_twin_matches_pallas(rng, kind, side):
    np_dt, t_dt = DTYPES[kind]
    B, chi, d, M = 3, CHI[kind], 2, 3
    L = rng.standard_normal((B, chi, M, chi)).astype(np_dt)
    W = rng.standard_normal((M, M, d, d)).astype(np_dt)
    A = rng.standard_normal((B, chi, d, chi)).astype(np_dt)
    ref = _pallas(side, L, W, A, np_dt)
    out = _port(side, L, W, A, t_dt)
    for t, j in zip(out, ref):
        assert t.dtype == t_dt and tuple(t.shape) == j.shape
        assert _rel(t.numpy(), j) < EPILOGUE_TOL[kind]
    # Q is the isometry of the gauge shift and reproduces A with P
    Q, Pm = out[0].numpy(), out[1].numpy()
    if side == "left":
        Qm = Q.reshape(B, chi * d, chi)
        eye = np.einsum("Bkr,Bkp->Brp", Qm, Qm)
        rebuilt = np.einsum("Basr,Brb->Basb", Q, Pm)
    else:
        Qm = Q.reshape(B, chi, d * chi)
        eye = np.einsum("Blk,Bpk->Blp", Qm, Qm)
        rebuilt = np.einsum("Bal,Blsb->Basb", Pm, Q)
    tol = 100 * EPILOGUE_TOL[kind]
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(chi), eye.shape), atol=tol)
    assert _rel(rebuilt, A) < tol


def _low_rank_sites(rng, B, chi, d, rank, np_dt):
    """(B, chi, d, chi) site tensors whose (chi*d, chi) panels have rank
    ``rank``, and each panel's orthonormal range (B, chi*d, rank)."""
    U = np.linalg.qr(rng.standard_normal((B, chi * d, rank)))[0]
    V = np.linalg.qr(rng.standard_normal((B, chi, rank)))[0]
    S = np.linspace(1.0, 0.2, rank)
    m = np.einsum("Bkr,r,Bcr->Bkc", U, S, V)
    return m.reshape(B, chi, d, chi).astype(np_dt), U


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_fused_gauge_env_rank_deficient_panel(rng, kind):
    # rank 5 of 8 columns: on the range of the panel Q is an isometry and
    # agrees with JAX; the null directions hold rounding noise that the
    # quintic steps inflate (3.44x each), differently on the two sides, so
    # only the range part and P = Q^T A are compared, as for ns_polar.
    np_dt, t_dt = DTYPES[kind]
    B, chi, d, M, rank = 2, 8, 2, 3, 5
    A, U = _low_rank_sites(rng, B, chi, d, rank, np_dt)
    L = rng.standard_normal((B, chi, M, chi)).astype(np_dt)
    W = rng.standard_normal((M, M, d, d)).astype(np_dt)
    Qj, Pj, _ = _pallas("left", L, W, A, np_dt)
    Qt, Pt, _ = _port("left", L, W, A, t_dt)
    Qt = Qt.numpy().astype(np.float64).reshape(B, chi * d, chi)
    Qj = Qj.astype(np.float64).reshape(B, chi * d, chi)
    proj = lambda Q: U @ (U.transpose(0, 2, 1) @ Q)
    tol = EPILOGUE_TOL[kind]
    assert _rel(proj(Qt), proj(Qj)) < tol
    assert _rel(Pt.numpy(), Pj) < tol
    np.testing.assert_allclose(Qt @ Pt.numpy(), A.reshape(B, chi * d, chi),
                               atol=10 * tol)
    # a partial isometry of rank 5: U^T Q Q^T U = I_5
    UQ = U.transpose(0, 2, 1) @ Qt
    np.testing.assert_allclose(UQ @ UQ.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(rank), (B, rank, rank)),
                               atol=10 * tol)


def test_route_rule_is_the_jax_admission():
    for chi in (8, 16, 64, 128, 256, 320, 347, 348, 384, 512, 1024):
        for d in (2, 3, 4):
            for M in (2, 3, 4, 5, 6):
                assert (TK.gauge_epilogue_admitted(chi, d, M)
                        == vmem.admit_gauge_epilogue(chi, d, M)), (chi, d, M)
    assert TK.gauge_epilogue_admitted(347, 2, 3)
    assert not TK.gauge_epilogue_admitted(384, 2, 3)


def test_gauge_env_route_takes_f64_to_the_grid():
    for chi in (8, 16, 64, 128, 256):
        assert TK.gauge_env_route(chi, 2, 3, torch.float64) == "grid"


def test_gauge_env_route_keeps_the_sweep_shape_resident():
    # the batched and single-instance fused sweeps' shape: chi=64, d=2, M=3,
    # 54,688 bytes, two blocks an SM
    assert TK.gauge_env_route(64, 2, 3, torch.float32) == "resident"
    assert TK.gauge_env_resident_bytes(64, 2, 3) == 272 + 4 * (
        2 * 64 * 72 + 64 * 68 + 36)


@pytest.mark.parametrize("d,M", [(2, 3), (3, 3), (4, 2)])
def test_gauge_env_route_limit_is_the_footprint(d, M):
    # chi is padded to a multiple of 32; the last resident chi is the last
    # whose padded panel, G and couplings fit 232,448 bytes, at most 128
    def fits(chi):
        cp = -(-chi // 32) * 32
        nbytes = 272 + 4 * (d * cp * (cp + 8) + cp * (cp + 4) + M * M * d * d)
        return cp <= 128 and nbytes <= 232_448

    last = max(c for c in range(1, 400) if fits(c))
    assert last == {2: 128, 3: 96, 4: 96}[d]
    assert TK.gauge_env_route(last, d, M, torch.float32) == "resident"
    assert TK.gauge_env_route(last + 1, d, M, torch.float32) == "grid"
    for chi in (1, 31, 32, 33, 64, last // 2):
        assert TK.gauge_env_route(chi, d, M, torch.float32) == "resident"
    assert TK.gauge_env_resident_bytes(last, d, M) <= 232_448


def test_gauge_env_route_gives_small_batches_at_large_chi_to_the_grid():
    # one instance is one SM's work on the resident route: at chi padded to
    # 96 and 128 the grid route wins below 8 and 64 instances on the card
    route = lambda chi, B: TK.gauge_env_route(chi, 2, 3, torch.float32, B)
    assert [route(64, B) for B in (1, 2, 256)] == ["resident"] * 3
    assert [route(16, 1), route(33, 1)] == ["resident"] * 2
    assert [route(80, 4), route(96, 4), route(96, 8)] == [
        "grid", "grid", "resident"]
    assert [route(128, 32), route(128, 64), route(97, 256)] == [
        "grid", "resident", "resident"]
    assert route(129, 256) == "grid"
    assert TK.gauge_env_route(128, 2, 3, torch.float32) == "resident"
    assert TK.gauge_env_route(64, 2, 3, torch.float64, 256) == "grid"


def test_fused_gauge_env_validates_inputs():
    W = torch.zeros((3, 3, 2, 2))
    E = torch.zeros((2, 3, 4, 4))
    A = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError):
        TK.fused_gauge_env(torch.zeros((2, 3, 3, 2, 2)), E, A)  # one W per instance
    with pytest.raises(ValueError):
        TK.fused_gauge_env(W, E, torch.zeros((2, 9, 4)))
    with pytest.raises(TypeError):
        TK.fused_gauge_env(W, E, A.double())
    with pytest.raises(ValueError):
        TK.fused_gauge_env(W, E, A.mT.contiguous().mT)
    with pytest.raises(ValueError):
        TK.fused_gauge_env(W, E, A, route="tiled")


# The sweep tests use tests/test_torch_dmrg.py's helpers and gates: f64
# sweeps with exact Ritz pairs held to SWEEP_TOL, the batched power Ritz
# solve to POWER_ENERGY_RTOL.  The JAX side runs its plain Lanczos with
# reorth=False, which is the fused kernel's recurrence, and its fused
# epilogue in interpret mode.


def test_one_site_sweep_with_fused_epilogue_matches_jax(rng):
    N, chi, d, m = 6, 8, 2, 5
    As0 = _start(rng, (N, chi, d, chi))
    jm, tm = _both_mpos(N)
    kw = dict(num_krylov_vecs=m, qr_impl="polar", ritz_impl="eigh",
              reorth=False, epilogue_impl="fused")
    jres = jdmrg.one_site_sweep(jnp.asarray(As0), jm.Ws, jm.vL, jm.vR,
                                lanczos_impl="xla", **kw)
    tres = tdmrg.one_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR,
                                lanczos_impl="fused", **kw)
    np.testing.assert_allclose(tres.energies.numpy(), np.asarray(jres.energies),
                               rtol=SWEEP_TOL)
    _signed_close(tres.As, jres.As, SWEEP_TOL, 0)
    np.testing.assert_allclose(tres.renvs.numpy(), np.asarray(jres.renvs),
                               atol=SWEEP_TOL)


def test_batched_sweep_with_fused_epilogue_matches_jax(rng):
    B, N, chi, d, m = 3, 6, 8, 2, 5
    As0 = _start(rng, (B, N, chi, d, chi))
    jm, tm = _both_mpos(N)
    jres = jbatch.batched_one_site_sweep(jnp.asarray(As0), jm.Ws, jm.vL, jm.vR,
                                         num_krylov_vecs=m, lanczos_impl="xla",
                                         epilogue_impl="fused", paired=False)
    tres = tbatch.batched_one_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL,
                                         tm.vR, num_krylov_vecs=m,
                                         epilogue_impl="fused")
    assert tres.energies.shape == (B, N)
    np.testing.assert_allclose(tres.energies.numpy(), np.asarray(jres.energies),
                               rtol=POWER_ENERGY_RTOL)


def test_sweep_takes_the_fused_epilogue_where_the_rule_admits(rng, monkeypatch):
    N, chi, d, m = 4, 4, 2, 4
    As0 = torch.from_numpy(_start(rng, (2, N, chi, d, chi)))
    _, tm = _both_mpos(N)
    calls = []
    real = TK.fused_gauge_env

    def counted(*a, **k):
        calls.append(a[2].shape)
        return real(*a, **k)

    monkeypatch.setattr(TK, "fused_gauge_env", counted)
    sweep = lambda **kw: tbatch.batched_one_site_sweep(
        As0, tm.Ws, tm.vL, tm.vR, num_krylov_vecs=m, **kw)
    res = sweep(epilogue_impl="fused")
    # N for the prepass, then 2N: one per site and direction
    assert len(calls) == 3 * N
    assert all(s == (2, d * chi, chi) for s in calls)
    calls.clear()
    sweep(epilogue_impl="fused", renvs=res.renvs)
    assert len(calls) == 2 * N
    calls.clear()
    # not with a Householder gauge, the default epilogue, or past the rule
    sweep(epilogue_impl="fused", qr_impl="householder", ritz_impl="eigh")
    sweep()
    monkeypatch.setattr(TK, "gauge_epilogue_admitted", lambda *a: False)
    sweep(epilogue_impl="fused")
    assert calls == []
    with pytest.raises(ValueError):
        sweep(epilogue_impl="pallas")


def test_fused_epilogue_run_is_variational():
    # N=6 TFI against exact diagonalisation, one and a batch of two
    from tensornetwork_tpu_torch.models import mpo as tmpo
    N, chi = 6, 8
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=N, device="cpu")
    exact = np.linalg.eigvalsh(tmpo.mpo_to_dense(mpo))[0]
    As = tdmrg.random_mps_stack(3, N, chi, 2, device="cpu")
    dm = tdmrg.FiniteDMRG(As, mpo)
    e = dm.run_one_site(num_sweeps=3, num_krylov_vecs=8, qr_impl="polar",
                        epilogue_impl="fused")
    assert exact - 1e-9 <= e < exact + 1e-8
    es = tbatch.BatchedDMRG(torch.stack([As, -As]), mpo).run_one_site(
        num_sweeps=3, num_krylov_vecs=8, epilogue_impl="fused")
    assert np.all(es.numpy() >= exact - 1e-9) and np.all(es.numpy() < exact + 1e-8)
