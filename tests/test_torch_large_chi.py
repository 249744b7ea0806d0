"""The port's large-chi one-site tiers against the JAX package, on the CPU.

Three tiers beyond the resident kernel: two-pass (K3, fact and replay),
streamed (K4) and streamed matvec (K7) with the recurrence outside.  Every
wrapper is handed CPU tensors here and so runs its plain-PyTorch twin; the
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them,
with explicit chunk counts (the TPU planners admit no chunking at these
small bond dimensions).  Inputs are made with numpy from a seed and handed
to both packages.  The CUDA kernels are held against the twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import dmrg as jdmrg
from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.ops import kernels as JK
from tensornetwork_tpu.ops import vmem
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.ops import kernels as TK


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


HIGHEST = jax.lax.Precision.HIGHEST
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
# One matvec: both sides sum the same products in other orders, a few ulp
# of chi*M*nt-term sums: 1e-5 relative to the largest entry in f32, 1e-12
# in f64.  alpha = <x, y> is a sum of nt*chi^2 such products and may cancel,
# so its error is measured against |x| |y|, with the same tolerances.
MATVEC_TOL = {"f32": 1e-5, "f64": 1e-12}
# The recurrence feeds each step's rounding into the next: over m <= 6
# steps on these well-conditioned Hermitian operators (alpha, beta), the
# basis and a replayed Ritz vector drift apart by ~1e-6 relative in f32 and
# ~1e-13 in f64 (as tests/test_torch_kernels.py measures for K2).
LANCZOS_TOL = {"f32": 5e-5, "f64": 1e-11}
# A Ritz vector moves by (perturbation of T) / (spectral gap): with gaps of
# ~0.1 the drift above grows ~10x; eigh Ritz pairs on both sides.
EVEC_TOL = {"f32": 5e-4, "f64": 1e-9}
# f64 at chi=8: JAX's interpret mode is the slow side.
CHI = {"f32": 16, "f64": 8}
TIERS = ("resident", "two_pass", "streamed", "streamed_matvec",
         "streamed_matvec_xl")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _hermitian(rng, B, chi, d, M, np_dt):
    """Solver-layout L, W, R, x0 with a Hermitian H_eff."""
    L = rng.standard_normal((B, chi, M, chi))
    R = rng.standard_normal((B, chi, M, chi))
    W = rng.standard_normal((M, M, d, d))
    L = (L + L.transpose(0, 3, 2, 1)) / 2
    R = (R + R.transpose(0, 3, 2, 1)) / 2
    W = (W + W.transpose(1, 0, 3, 2)) / 2
    x = rng.standard_normal((B, chi, d, chi))
    return tuple(a.astype(np_dt) for a in (L, W, R, x))


def _breakdown(np_dt, chi=8, d=2):
    """A diagonal operator and two starts: a product state (an eigenvector,
    so step 0 breaks down) and a zero start (dead from step 0)."""
    W = np.eye(d, dtype=np_dt).reshape(1, 1, d, d)
    L = np.diag(np.arange(1.0, chi + 1.0)).astype(np_dt).reshape(1, chi, 1, chi)
    R = np.eye(chi, dtype=np_dt).reshape(1, chi, 1, chi)
    x = np.zeros((2, chi, d, chi), np_dt)
    x[0, 0, 0, 0] = 2.0
    L, R = (np.concatenate([a, a]) for a in (L, R))
    return L, W, R, x


def _kernel_layout(*solver):
    return tuple(np.ascontiguousarray(np.asarray(a))
                 for a in JK.prepare_operands(*_jax(*solver)))


def _check_sentinels(ab, V=None):
    """Instance 0 breaks down after step 0, instance 1 is dead from the
    start: +1e10 alphas, zero betas and zero vectors once dead."""
    np.testing.assert_array_equal(ab[0, 0, 0], 1.0)
    np.testing.assert_array_equal(ab[0, 0, 1:], 1e10)
    np.testing.assert_array_equal(ab[1, 0], 1e10)
    np.testing.assert_array_equal(ab[:, 1], 0.0)
    if V is not None:
        np.testing.assert_array_equal(V[0, 1:], 0.0)
        np.testing.assert_array_equal(V[1], 0.0)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


def _jax_tier(chi, d, M, m):
    """The tier the JAX package's _local_solve_1s takes (models/dmrg.py)."""
    if vmem.admit_resident_lanczos(chi, d, M, m):
        return "resident"
    if vmem.admit_two_pass_lanczos(chi, d, M):
        return "two_pass"
    if vmem.streamed_chunk_count(chi, d, M) is not None:
        return "streamed"
    if vmem.streamed_matvec_plan(chi, d, M) is not None:
        return "streamed_matvec"
    if vmem.streamed_matvec_xl_plan(chi, d, M) is not None:
        return "streamed_matvec_xl"
    return "xla"


@pytest.mark.parametrize("chi", [64, 128, 256, 384, 512, 1024])
def test_router_takes_the_jax_tier(chi):
    tier = TK.one_site_tier(chi, 2, 3, 10)
    assert tier == _jax_tier(chi, 2, 3, 10)
    assert tier == {384: "two_pass", 512: "streamed",
                    1024: "streamed_matvec"}.get(chi, "resident")


@pytest.mark.parametrize("d,M,m", [(2, 5, 6), (3, 3, 10), (4, 2, 4)])
def test_router_agrees_with_jax_at_other_widths(d, M, m):
    for chi in (16, 64, 96, 128, 192, 256, 320, 384, 512, 768, 1024, 2048):
        want = _jax_tier(chi, d, M, m)
        if want == "xla":
            with pytest.raises(NotImplementedError):
                TK.one_site_tier(chi, d, M, m)
        else:
            assert TK.one_site_tier(chi, d, M, m) == want, chi


def test_router_raises_at_the_xl_tier():
    # one-site chi=2048 takes the XL tier (K8); beyond it (chi=4096, no XL
    # plan) the JAX package takes its plain Lanczos and the router raises
    assert _jax_tier(2048, 2, 3, 10) == "streamed_matvec_xl"
    assert TK.one_site_tier(2048, 2, 3, 10) == "streamed_matvec_xl"
    assert _jax_tier(4096, 2, 3, 10) == "xla"
    with pytest.raises(NotImplementedError, match="XL tier"):
        TK.one_site_tier(4096, 2, 3, 10)


# ---------------------------------------------------------------------------
# K7: the streamed matvec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "f64"])
@pytest.mark.parametrize("nt", [2, 4])
def test_streamed_matvec_twin_matches_pallas(rng, kind, nt):
    np_dt, t_dt = DTYPES[kind]
    B, chi, M = 2, CHI[kind], 3
    Lt = rng.standard_normal((B, M, chi, chi)).astype(np_dt)
    Rt = rng.standard_normal((B, M, chi, chi)).astype(np_dt)
    C = rng.standard_normal((M, M, nt, nt)).astype(np_dt)
    x = rng.standard_normal((B, nt, chi, chi)).astype(np_dt)
    f = JK.make_streamed_matvec(chi, nt, M, 2, 2, accum_dtype=jnp.dtype(np_dt),
                                interpret=True, precision=HIGHEST)
    y_j, alpha_j = (np.asarray(a) for a in f(*_jax(Lt, C, Rt, x)))

    TK.reset_launch_counts()
    y, alpha = TK.streamed_matvec(*_torch(Lt, C, Rt, x))
    assert TK.launch_counts["streamed_matvec"] == 0  # the twin is no launch
    assert y.dtype == alpha.dtype == t_dt
    assert y.shape == (B, nt, chi, chi) and alpha.shape == (B,)
    assert _rel(y, y_j) < MATVEC_TOL[kind]
    scale = np.linalg.norm(x.reshape(B, -1), axis=1) * np.linalg.norm(
        y_j.reshape(B, -1), axis=1)
    assert np.all(np.abs(alpha.numpy() - alpha_j) < MATVEC_TOL[kind] * scale)
    # alpha is <x, y> of the returned y
    np.testing.assert_allclose(
        alpha.numpy(), np.einsum("bsij,bsij->b", x, y.numpy()),
        rtol=0, atol=MATVEC_TOL[kind] * scale.max())


def test_streamed_matvec_per_instance_couplings(rng):
    B, chi, M, nt = 2, 8, 3, 2
    Lt, Rt = (rng.standard_normal((B, M, chi, chi)) for _ in range(2))
    x = rng.standard_normal((B, nt, chi, chi))
    Cb = rng.standard_normal((B, M, M, nt, nt))
    y, alpha = TK.streamed_matvec(*_torch(Lt, Cb, Rt, x))
    for b in range(B):
        yb, ab = TK.streamed_matvec(*_torch(Lt[b:b + 1], Cb[b], Rt[b:b + 1],
                                            x[b:b + 1]))
        torch.testing.assert_close(y[b:b + 1], yb, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(alpha[b:b + 1], ab, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# K4: the streamed whole-Lanczos kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_streamed_lanczos_twin_matches_pallas(rng, kind):
    np_dt, _ = DTYPES[kind]
    B, chi, d, M, m = 2, CHI[kind], 2, 3, 5
    Lt, W, Rt, xt = _kernel_layout(*_hermitian(rng, B, chi, d, M, np_dt))
    f = JK.make_fused_lanczos_streamed(chi, d, M, m, n_chunks=2,
                                       accum_dtype=jnp.dtype(np_dt),
                                       interpret=True, precision=HIGHEST)
    V_j, ab_j = (np.asarray(a) for a in f(*_jax(Lt, W, Rt, xt)))
    TK.reset_launch_counts()
    V, ab = (a.numpy() for a in TK.fused_lanczos_streamed(
        *_torch(Lt, W, Rt, xt), m))
    assert TK.launch_counts["fused_lanczos_streamed"] == 0
    assert V.shape == V_j.shape == (B, m, d, chi, chi)
    assert ab.shape == ab_j.shape == (B, 2, m) and ab.dtype == np_dt
    assert _rel(ab, ab_j) < LANCZOS_TOL[kind]
    assert _rel(V, V_j) < LANCZOS_TOL[kind]
    assert np.all(ab[:, 1, -1] == 0)


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_streamed_lanczos_breakdown(kind):
    np_dt, _ = DTYPES[kind]
    chi, m = 8, 4
    Lt, W, Rt, xt = _kernel_layout(*_breakdown(np_dt, chi))
    f = JK.make_fused_lanczos_streamed(chi, 2, 1, m, n_chunks=2,
                                       accum_dtype=jnp.dtype(np_dt),
                                       interpret=True, precision=HIGHEST)
    V_j, ab_j = (np.asarray(a) for a in f(*_jax(Lt, W, Rt, xt)))
    V, ab = (a.numpy() for a in TK.fused_lanczos_streamed(
        *_torch(Lt, W, Rt, xt), m))
    _check_sentinels(ab, V)
    np.testing.assert_array_equal(ab, ab_j)
    np.testing.assert_array_equal(V, V_j)


# ---------------------------------------------------------------------------
# K3: the two-pass Lanczos
# ---------------------------------------------------------------------------


def _pallas_2pass(chi, d, M, m, np_dt):
    return JK.make_fused_lanczos_2pass(chi, d, M, m,
                                       accum_dtype=jnp.dtype(np_dt),
                                       interpret=True, precision=HIGHEST)


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_two_pass_twins_match_pallas(rng, kind):
    # M=2: the interpret-mode trace of both passes grows with m*M*M*d*d
    np_dt, _ = DTYPES[kind]
    B, chi, d, M, m = 2, CHI[kind], 2, 2, 5
    Lt, W, Rt, xt = _kernel_layout(*_hermitian(rng, B, chi, d, M, np_dt))
    fact, replay = _pallas_2pass(chi, d, M, m, np_dt)
    ab_j = np.asarray(fact(*_jax(Lt, W, Rt, xt)))
    TK.reset_launch_counts()
    ab = TK.fused_lanczos_fact(*_torch(Lt, W, Rt, xt), m).numpy()
    assert ab.shape == (B, 2, m) and ab.dtype == np_dt
    assert _rel(ab, ab_j) < LANCZOS_TOL[kind]
    # fact is the resident factorization without its basis
    _, ab_res = TK.fused_lanczos(*_torch(Lt, W, Rt, xt), m)
    np.testing.assert_array_equal(ab, ab_res.numpy())

    # replay: the same ab and weights into both sides
    weights = rng.standard_normal((B, m)).astype(np_dt)
    y_j = np.asarray(replay(*_jax(Lt, W, Rt, xt, weights, ab_j)))
    y = TK.fused_lanczos_replay(*_torch(Lt, W, Rt, xt, weights, ab_j)).numpy()
    assert sum(TK.launch_counts.values()) == 0
    assert y.shape == (B, d, chi, chi)
    assert _rel(y, y_j) < LANCZOS_TOL[kind]
    # replay regenerates the basis of the one-pass factorization
    V, _ = TK.fused_lanczos(*_torch(Lt, W, Rt, xt), m)
    y_basis = np.einsum("bm,bmtij->btij", weights, V.numpy())
    assert _rel(y, y_basis) < LANCZOS_TOL[kind]


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_two_pass_breakdown(kind):
    np_dt, _ = DTYPES[kind]
    chi, m = 8, 4
    Lt, W, Rt, xt = _kernel_layout(*_breakdown(np_dt, chi))
    fact, replay = _pallas_2pass(chi, 2, 1, m, np_dt)
    ab_j = np.asarray(fact(*_jax(Lt, W, Rt, xt)))
    ab = TK.fused_lanczos_fact(*_torch(Lt, W, Rt, xt), m).numpy()
    _check_sentinels(ab)
    np.testing.assert_array_equal(ab, ab_j)
    weights = np.ones((2, m), np_dt)  # every dead v_j must add nothing
    y_j = np.asarray(replay(*_jax(Lt, W, Rt, xt, weights, ab_j)))
    y = TK.fused_lanczos_replay(*_torch(Lt, W, Rt, xt, weights, ab)).numpy()
    np.testing.assert_array_equal(y, y_j)
    np.testing.assert_array_equal(y[0], xt[0] / 2)
    np.testing.assert_array_equal(y[1], 0.0)


# ---------------------------------------------------------------------------
# The recurrence around K7 and the three ground-state wrappers
# ---------------------------------------------------------------------------


def test_streamed_lanczos_recurrence_breakdown():
    chi, m = 8, 4
    Lt, W, Rt, xt = _torch(*_kernel_layout(*_breakdown(np.float64, chi)))
    V, ab = TK.streamed_lanczos(Lt, W, Rt, xt, m)
    _check_sentinels(ab.numpy(), V.numpy())
    V0, ab0 = TK.fused_lanczos(Lt, W, Rt, xt, m)
    torch.testing.assert_close(ab, ab0, rtol=0, atol=0)
    torch.testing.assert_close(V, V0, rtol=0, atol=0)


def _jax_ground_state(tier, solver, m, np_dt):
    args = dict(num_krylov_vecs=m, ritz_method="eigh", interpret=True,
                precision=HIGHEST)
    if tier == "two_pass":
        return JK.fused_lanczos_ground_state(*solver, two_pass=True, **args)
    if tier == "streamed":
        return JK.fused_lanczos_ground_state_streamed(*solver, n_chunks=2,
                                                      **args)
    if tier == "streamed_matvec_xl":
        return JK.fused_lanczos_ground_state_streamed2(*solver, plan=(2, 2, 2),
                                                       **args)
    return JK.fused_lanczos_ground_state_streamed2(*solver, plan=(2, 2), **args)


_PORT_GS = {"two_pass": tdmrg._FUSED_TIERS["two_pass"],
            "streamed": TK.fused_lanczos_ground_state_streamed,
            "streamed_matvec": TK.fused_lanczos_ground_state_streamed2,
            "streamed_matvec_xl": tdmrg._FUSED_TIERS["streamed_matvec_xl"]}


@pytest.mark.parametrize("kind", ["f32", "f64"])
@pytest.mark.parametrize("tier", list(_PORT_GS))
def test_ground_state_wrappers_match_jax(rng, kind, tier):
    np_dt, _ = DTYPES[kind]
    B, chi, d, M, m = 2, CHI[kind], 2, 3, 5
    solver = _hermitian(rng, B, chi, d, M, np_dt)
    ev_j, vec_j = (np.asarray(a) for a in _jax_ground_state(
        tier, _jax(*solver), m, np_dt))
    ev, vec = (a.numpy() for a in _PORT_GS[tier](
        *_torch(*solver), num_krylov_vecs=m, ritz_method="eigh"))
    assert vec.shape == (B, chi, d, chi) and ev.shape == (B,)
    assert _rel(ev, ev_j) < LANCZOS_TOL[kind]
    for b in range(B):  # a Ritz vector's sign is free
        s = np.sign(np.sum(vec[b] * vec_j[b]))
        assert _rel(s * vec[b], vec_j[b]) < EVEC_TOL[kind]
    np.testing.assert_allclose(np.linalg.norm(vec.reshape(B, -1), axis=1), 1.0,
                               rtol=10 * LANCZOS_TOL[kind])


@pytest.mark.parametrize("tier", list(_PORT_GS))
def test_ground_state_wrappers_breakdown(tier):
    solver = _breakdown(np.float64)
    ev_j, vec_j = (np.asarray(a) for a in _jax_ground_state(
        tier, _jax(*solver), 4, np.float64))
    ev, vec = (a.numpy() for a in _PORT_GS[tier](
        *_torch(*solver), num_krylov_vecs=4, ritz_method="eigh"))
    np.testing.assert_array_equal(ev, ev_j)
    np.testing.assert_array_equal(vec, vec_j)
    assert ev[0] == 1.0 and ev[1] == 1e10
    np.testing.assert_array_equal(vec[1], 0.0)


# ---------------------------------------------------------------------------
# The sweep through each tier against the JAX sweep
# ---------------------------------------------------------------------------

# f64 with exact Ritz pairs on both sides: the JAX package's plain Lanczos
# without reorthogonalisation and the port's fused route differ only in
# summation order, ~1e-12 in the per-site energies after a sweep (as
# tests/test_torch_dmrg.py measures); 1e-9 relative allowed.
SWEEP_TOL = 1e-9
_SWEEP = dict(N=6, chi=8, d=2, m=6)


@pytest.fixture(scope="module")
def jax_sweep():
    rng = np.random.default_rng(7)
    N, chi, d, m = (_SWEEP[k] for k in ("N", "chi", "d", "m"))
    As0 = rng.standard_normal((N, chi, d, chi)) / np.sqrt(chi * d)
    jm = jmpo.FiniteTFI(1.0, 0.9, N=N, dtype=jnp.float64)
    res = jdmrg.one_site_sweep(jnp.asarray(As0), jm.Ws, jm.vL, jm.vR,
                               num_krylov_vecs=m, qr_impl="householder",
                               ritz_impl="eigh", reorth=False,
                               lanczos_impl="xla")
    return As0, jm, np.asarray(res.energies), np.asarray(res.energy)


@pytest.mark.parametrize("tier", TIERS)
def test_sweep_through_each_tier_matches_jax(monkeypatch, jax_sweep, tier):
    As0, jm, e_j, energy_j = jax_sweep
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    taken = []

    def spy(*args, **kwargs):
        taken.append(tier)
        return solve(*args, **kwargs)

    solve = tdmrg._FUSED_TIERS[tier]
    monkeypatch.setitem(tdmrg._FUSED_TIERS, tier, spy)
    monkeypatch.setattr(TK, "one_site_tier", lambda chi, d, M, m: tier)
    TK.reset_launch_counts()
    res = tdmrg.one_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR,
                               num_krylov_vecs=_SWEEP["m"],
                               qr_impl="householder", ritz_impl="eigh",
                               lanczos_impl="fused")
    assert taken == [tier] * 2 * _SWEEP["N"]
    assert sum(TK.launch_counts.values()) == 0  # CPU tensors: twins only
    np.testing.assert_allclose(res.energies.numpy(), e_j, rtol=SWEEP_TOL)
    np.testing.assert_allclose(float(res.energy), energy_j, rtol=SWEEP_TOL)


def test_sweep_routes_by_bond_dimension(monkeypatch):
    # the sweep asks the router with the site's (chi, d, M, m)
    asked = []
    route = TK.one_site_tier
    monkeypatch.setattr(TK, "one_site_tier",
                        lambda *a: asked.append(a) or route(*a))
    N, chi = 4, 4
    As = tdmrg.random_mps_stack(0, N, chi, 2, device="cpu")
    from tensornetwork_tpu_torch.models.mpo import FiniteTFI
    mpo = FiniteTFI(1.0, 1.0, N=N, device="cpu")
    tdmrg.one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=4)
    assert asked == [(chi, 2, 3, 4)] * 2 * N
