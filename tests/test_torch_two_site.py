"""The port's two-site DMRG kernels and truncations against the JAX
package, on the CPU.

Bond truncation (cholqr2, svd_masked, subspace_truncate), the two-site and
XL tier routers, K8's twin, the recurrence around it and the two-site
ground-state wrappers.  Every wrapper is handed CPU tensors here and so
runs its plain-PyTorch twin; the Pallas kernels run in interpret mode with
explicit chunk counts, as tests/test_kernels.py runs them.  Inputs are
made with numpy from a seed and handed to both packages.  The CUDA kernels
are held against the twins on the card (tests/test_torch_cuda.py,
chip_smoke.py).  The sweeps are in tests/test_torch_two_site_sweeps.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import dmrg as jdmrg
from tensornetwork_tpu.ops import decompositions as JD
from tensornetwork_tpu.ops import kernels as JK
from tensornetwork_tpu.ops import vmem
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.ops import decompositions as TD
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
# Dense factorizations: LAPACK on both sides, the same algorithm; results
# agree to a few hundred ulp of the panel's scale on these well-conditioned
# (or exactly rank-deficient, where only range quantities are compared)
# 24 x 8 panels.
DECOMP_TOL = {"f32": 2e-5, "f64": 1e-12}
# One matvec: the same products summed in other orders (as in
# tests/test_torch_large_chi.py); alpha against |x| |y|.
MATVEC_TOL = {"f32": 1e-5, "f64": 1e-12}
# The Lanczos recurrence carries each step's rounding into the next
# (tests/test_torch_large_chi.py): eigenvalues 5e-5 / 1e-11, Ritz vectors
# ~10x more through the spectral gap.
LANCZOS_TOL = {"f32": 5e-5, "f64": 1e-11}
EVEC_TOL = {"f32": 5e-4, "f64": 1e-9}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _panel(rng, np_dt, rank=None, shape=(24, 8)):
    """A panel with singular values 1, 0.7, 0.49, ... (or exact rank)."""
    m, n = shape
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 0.7 ** np.arange(n)
    if rank is not None:
        s[rank:] = 0.0
    return ((u * s) @ v.T).astype(np_dt)


# ---------------------------------------------------------------------------
# Bond truncation and the Cholesky QR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "f64"])
@pytest.mark.parametrize("rank", [None, 5])
def test_cholqr2_matches_jax(rng, kind, rank):
    np_dt, t_dt = DTYPES[kind]
    a = _panel(rng, np_dt, rank)
    q_j, r_j = (np.asarray(t) for t in JD.cholqr2(jnp.asarray(a)))
    q, r = (t.numpy() for t in TD.cholqr2(torch.from_numpy(a)))
    assert q.dtype == np_dt and q.shape == (24, 8) and r.shape == (8, 8)
    tol = DECOMP_TOL[kind]
    np.testing.assert_allclose(q @ r, a, atol=tol)
    # on the null space the second pass divides by the jitter's square
    # root, which amplifies rounding there ~100x
    np.testing.assert_allclose(q.T @ q, q_j.T @ q_j,
                               atol=tol if rank is None else 100 * tol)
    np.testing.assert_allclose(r, r_j, atol=tol)
    if rank is None:  # full rank: Q is unique (positive Cholesky diagonal)
        np.testing.assert_allclose(q, q_j, atol=tol)
        np.testing.assert_allclose(q.T @ q, np.eye(8), atol=tol)
    else:  # the range of the panel is spanned alike (in f32 the jitter
        # leaves the null columns short of unit norm on both sides)
        k = rank
        np.testing.assert_allclose(q[:, :k] @ q[:, :k].T, q_j[:, :k] @ q_j[:, :k].T,
                                   atol=tol)
    # the sweep's "cholesky" gauge is cholqr2
    q2, _ = TD.qr(torch.from_numpy(a), "cholesky")
    np.testing.assert_array_equal(q2.numpy(), q)


@pytest.mark.parametrize("kind", ["f32", "f64"])
@pytest.mark.parametrize("err,relative", [(None, False), (0.05, False),
                                          (0.1, True)])
@pytest.mark.parametrize("rank", [None, 5])
def test_svd_masked_matches_jax(rng, kind, err, relative, rank):
    np_dt, _ = DTYPES[kind]
    a = _panel(rng, np_dt, rank)
    k = 6
    j = JD.svd_masked(jnp.asarray(a), k, max_truncation_error=err,
                      relative=relative)
    t = TD.svd_masked(torch.from_numpy(a), k, max_truncation_error=err,
                      relative=relative)
    tol = DECOMP_TOL[kind]
    assert t.u.shape == (24, k) and t.s.shape == (k,) and t.vh.shape == (k, 8)
    np.testing.assert_allclose(t.s.numpy(), np.asarray(j.s), atol=tol)
    # u diag(s) vh is free of the singular vectors' signs
    np.testing.assert_allclose((t.u * t.s) @ t.vh, (j.u * j.s) @ j.vh, atol=tol)
    assert int(t.num_kept) == int(j.num_kept)
    np.testing.assert_allclose(float(t.trunc_sq_norm), float(j.trunc_sq_norm),
                               atol=tol)
    # masked rows and columns are zero
    dropped = t.s.numpy() == 0
    assert not np.any(t.u.numpy()[:, dropped]) and not np.any(t.vh.numpy()[dropped])


def test_svd_masked_batched_equals_per_matrix(rng):
    a = np.stack([_panel(rng, np.float64), _panel(rng, np.float64, 3)])
    t = TD.svd_masked(torch.from_numpy(a), 4, max_truncation_error=0.2)
    for i in range(2):
        one = TD.svd_masked(torch.from_numpy(a[i]), 4, max_truncation_error=0.2)
        np.testing.assert_allclose(t.s[i].numpy(), one.s.numpy(), atol=1e-14)
        assert int(t.num_kept[i]) == int(one.num_kept)
        np.testing.assert_allclose(float(t.trunc_sq_norm[i]),
                                   float(one.trunc_sq_norm), atol=1e-14)


ORTHS = [("qr", None), ("polar", None), ("polar", (5, 2)), ("polar+qr", None),
         ("cholqr2", None)]


@pytest.mark.parametrize("orth,fast", ORTHS)
@pytest.mark.parametrize("warm", [False, True])
def test_subspace_truncate_matches_jax(rng, orth, fast, warm):
    kind = "f64"
    np_dt, _ = DTYPES[kind]
    a = _panel(rng, np_dt, shape=(24, 16))
    k = 8
    q0 = rng.standard_normal((24, k)).astype(np_dt) if warm else None
    j = JD.subspace_truncate(jnp.asarray(a), k,
                             q0=None if q0 is None else jnp.asarray(q0),
                             iters=3, orth=orth, polar_fast=fast)
    t = TD.subspace_truncate(torch.from_numpy(a), k,
                             q0=None if q0 is None else torch.from_numpy(q0),
                             iters=3, orth=orth, polar_fast=fast)
    q, rest = t.q.numpy(), t.rest.numpy()
    qj, restj = np.asarray(j.q), np.asarray(j.rest)
    # the projector and the truncated panel are free of the basis gauge;
    # Newton-Schulz runs ~40 dependent GEMMs, so 1e-10 in f64
    np.testing.assert_allclose(q @ q.T, qj @ qj.T, atol=1e-10)
    np.testing.assert_allclose(q @ rest, qj @ restj, atol=1e-10)
    np.testing.assert_allclose(float(t.trunc_sq_norm), float(j.trunc_sq_norm),
                               atol=1e-10)


@pytest.mark.parametrize("orth", ["qr", "polar"])
def test_subspace_truncate_f32_rank_deficient(rng, orth):
    # f32, a batch with an exactly rank-deficient panel: rank 5 < k = 8
    a = np.stack([_panel(rng, np.float32, shape=(24, 16)),
                  _panel(rng, np.float32, rank=5, shape=(24, 16))])
    q0 = rng.standard_normal((2, 24, 8)).astype(np.float32)
    j = jax.vmap(lambda m, q: JD.subspace_truncate(m, 8, q0=q, iters=2,
                                                   orth=orth))(
        jnp.asarray(a), jnp.asarray(q0))
    t = TD.subspace_truncate(torch.from_numpy(a), 8, q0=torch.from_numpy(q0),
                             iters=2, orth=orth)
    assert t.q.dtype == torch.float32 and t.q.shape == (2, 24, 8)
    np.testing.assert_allclose(t.q.numpy() @ t.rest.numpy(),
                               np.asarray(j.q) @ np.asarray(j.rest), atol=2e-5)
    np.testing.assert_allclose(t.trunc_sq_norm.numpy(),
                               np.asarray(j.trunc_sq_norm), atol=2e-5)


# ---------------------------------------------------------------------------
# The routers
# ---------------------------------------------------------------------------


def _jax_tier_2s(chi, d, M, m):
    """The tier the JAX package's _local_solve_2s takes (models/dmrg.py)."""
    nt = d * d
    if vmem.admit_resident_lanczos(chi, nt, M, m):
        return "resident"
    if vmem.streamed_matvec_plan(chi, nt, M) is not None:
        return "streamed_matvec"
    if vmem.streamed_matvec_xl_plan(chi, nt, M) is not None:
        return "streamed_matvec_xl"
    return "xla"


CHIS = (16, 32, 64, 96, 100, 104, 112, 128, 192, 256, 384, 512, 768, 1024,
        1536, 2048, 4096)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("M", [3, 5])
@pytest.mark.parametrize("m", [6, 10])
def test_two_site_router_takes_the_jax_tier(d, M, m):
    for chi in CHIS:
        want = _jax_tier_2s(chi, d, M, m)
        if want == "xla":
            with pytest.raises(NotImplementedError):
                TK.two_site_tier(chi, d, M, m)
        else:
            assert TK.two_site_tier(chi, d, M, m) == want, chi


def test_two_site_router_ladder_at_tfi_widths():
    tiers = {chi: TK.two_site_tier(chi, 2, 3, 6)
             for chi in (64, 128, 512, 1024, 2048)}
    assert tiers == {64: "resident", 128: "streamed_matvec",
                     512: "streamed_matvec", 1024: "streamed_matvec_xl",
                     2048: "streamed_matvec_xl"}


# ---------------------------------------------------------------------------
# K8: the XL streamed matvec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,nt,plan", [("f32", 4, (2, 2, 2)),
                                          ("f64", 2, (1, 4, 2)),
                                          ("f32", 2, (1, 4, 1))])
def test_streamed_matvec_xl_twin_matches_pallas(rng, kind, nt, plan):
    np_dt, t_dt = DTYPES[kind]
    B, chi, M = 2, 32, 2
    K, K3, K2 = plan
    Lt = rng.standard_normal((B, M, chi, chi)).astype(np_dt)
    Rt = rng.standard_normal((B, M, chi, chi)).astype(np_dt)
    C = rng.standard_normal((M, M, nt, nt)).astype(np_dt)
    x = rng.standard_normal((B, nt, chi, chi)).astype(np_dt)
    f = JK.make_streamed_matvec_xl(chi, nt, M, K, K3, K2,
                                   accum_dtype=jnp.dtype(np_dt),
                                   interpret=True, precision=HIGHEST)
    y_j, alpha_j = (np.asarray(a) for a in f(*_jax(Lt, C, Rt, x)))
    TK.reset_launch_counts()
    y, alpha = TK.streamed_matvec_xl(*_torch(Lt, C, Rt, x), K3=K3)
    assert TK.launch_counts["streamed_matvec_xl"] == 0  # the twin is no launch
    assert y.dtype == alpha.dtype == t_dt
    assert y.shape == (B, nt, chi, chi) and alpha.shape == (B,)
    assert _rel(y, y_j) < MATVEC_TOL[kind]
    scale = np.linalg.norm(x.reshape(B, -1), axis=1) * np.linalg.norm(
        y_j.reshape(B, -1), axis=1)
    assert np.all(np.abs(alpha.numpy() - alpha_j) < MATVEC_TOL[kind] * scale)


@pytest.mark.parametrize("kind", ["f32", "f64"])
@pytest.mark.parametrize("K3", [1, 2, 4])
def test_streamed_matvec_xl_twin_equals_heff_matvec(rng, kind, K3):
    np_dt, _ = DTYPES[kind]
    B, chi, M, nt = 2, 16, 3, 4
    Lt, Rt = (rng.standard_normal((B, M, chi, chi)).astype(np_dt)
              for _ in range(2))
    C = rng.standard_normal((M, M, nt, nt)).astype(np_dt)
    x = rng.standard_normal((B, nt, chi, chi)).astype(np_dt)
    ops = _torch(Lt, C, Rt, x)
    y, alpha = TK.streamed_matvec_xl_plain(*ops, K3)
    y0 = TK.heff_matvec_plain(*ops)
    assert _rel(y, y0) < MATVEC_TOL[kind]
    if K3 == 1:  # one chunk: the same stages, the same bits
        torch.testing.assert_close(y, y0, rtol=0, atol=0)
    np.testing.assert_allclose(alpha.numpy(),
                               np.einsum("bsij,bsij->b", x, y0.numpy()),
                               rtol=MATVEC_TOL[kind])


def test_streamed_matvec_xl_per_instance_couplings_and_k3_rule(rng):
    B, chi, M, nt = 2, 16, 3, 2
    Lt, Rt = (rng.standard_normal((B, M, chi, chi)) for _ in range(2))
    x = rng.standard_normal((B, nt, chi, chi))
    Cb = rng.standard_normal((B, M, M, nt, nt))
    y, alpha = TK.streamed_matvec_xl(*_torch(Lt, Cb, Rt, x), K3=2)
    for b in range(B):
        yb, ab = TK.streamed_matvec_xl(*_torch(Lt[b:b + 1], Cb[b],
                                               Rt[b:b + 1], x[b:b + 1]), K3=2)
        torch.testing.assert_close(y[b:b + 1], yb, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(alpha[b:b + 1], ab, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="K3"):
        TK.streamed_matvec_xl(*_torch(Lt, Cb, Rt, x), K3=3)
    # the K3 rule: two blocks of stage 1 (128 x 128 tiles of the (M chi) x
    # (nt chi) product) per SM of an H100 (132 SMs)
    assert TK.xl_chunk_count(1024, 4, 3, 1, 132) == 1   # 768 blocks
    assert TK.xl_chunk_count(2048, 2, 3, 1, 132) == 1   # 1536 blocks
    assert TK.xl_chunk_count(1024, 4, 3, 4, 132) == 1
    assert TK.xl_chunk_count(512, 2, 3, 1, 132) == 4    # 96 blocks a chunk
    assert TK.xl_chunk_count(64, 4, 3, 1, 132) == 2   # capped: chunks >= 32 rows


# ---------------------------------------------------------------------------
# The recurrence around K8
# ---------------------------------------------------------------------------


def _hermitian(rng, B, chi, nt, M, np_dt):
    """Kernel-layout Lt, C, Rt, x with a Hermitian H_eff."""
    L = rng.standard_normal((B, chi, M, chi))
    R = rng.standard_normal((B, chi, M, chi))
    C = rng.standard_normal((M, M, nt, nt))
    L = (L + L.transpose(0, 3, 2, 1)) / 2
    R = (R + R.transpose(0, 3, 2, 1)) / 2
    C = (C + C.transpose(1, 0, 3, 2)) / 2
    x = rng.standard_normal((B, chi, nt, chi))
    return tuple(np.ascontiguousarray(a.astype(np_dt)) for a in (
        L.transpose(0, 2, 3, 1), C, R.transpose(0, 2, 1, 3),
        x.transpose(0, 2, 1, 3)))


def test_xl_lanczos_matches_jax_core(rng):
    B, chi, nt, M, m, K3 = 2, 16, 2, 2, 5, 2
    Lt, C, Rt, xt = _hermitian(rng, B, chi, nt, M, np.float64)
    ev_j, y_j = (np.asarray(a) for a in JK._streamed_lanczos_core(
        *_jax(Lt, C, Rt, xt), m, 1, 1, 1e-8, "eigh", 60, True, HIGHEST, K3=K3))
    V, ab = TK.streamed_lanczos(*_torch(Lt, C, Rt, xt), m,
                                matvec=functools.partial(TK.streamed_matvec_xl,
                                                         K3=K3))
    ev, _ = TK.krylov.tridiag_ritz(ab[:, 0], ab[:, 1, :m - 1], "eigh")
    y = TK._ritz_pair(V, ab, "eigh", 60, 1e-8)[1].permute(0, 2, 1, 3).numpy()
    assert _rel(ev.numpy(), ev_j) < LANCZOS_TOL["f64"]
    for b in range(B):  # a Ritz vector's sign is free
        s = np.sign(np.sum(y[b] * y_j[b]))
        assert _rel(s * y[b], y_j[b]) < EVEC_TOL["f64"]


def test_xl_lanczos_breakdown_matches_jax_core():
    # a diagonal operator: instance 0 starts on an eigenvector (dies after
    # step 0), instance 1 from zero (dead from the start)
    chi, d, m = 8, 2, 4
    Lt = np.diag(np.arange(1.0, chi + 1.0)).reshape(1, 1, chi, chi)
    Lt = np.concatenate([Lt, Lt])
    Rt = np.concatenate([np.eye(chi).reshape(1, 1, chi, chi)] * 2)
    C = np.eye(d).reshape(1, 1, d, d)
    x = np.zeros((2, d, chi, chi))
    x[0, 0, 0, 0] = 2.0
    ev_j, y_j = (np.asarray(a) for a in JK._streamed_lanczos_core(
        *_jax(Lt, C, Rt, x), m, 1, 1, 1e-8, "eigh", 60, True, HIGHEST, K3=2))
    ops = _torch(Lt, C, Rt, x)
    V, ab = TK.streamed_lanczos(*ops, m, matvec=functools.partial(
        TK.streamed_matvec_xl, K3=2))
    np.testing.assert_array_equal(ab[0, 0].numpy(), [1.0] + [1e10] * 3)
    np.testing.assert_array_equal(ab[1, 0].numpy(), [1e10] * 4)
    np.testing.assert_array_equal(ab[:, 1].numpy(), 0.0)
    np.testing.assert_array_equal(V[0, 1:].numpy(), 0.0)
    np.testing.assert_array_equal(V[1].numpy(), 0.0)
    V0, ab0 = TK.fused_lanczos(*ops, m)
    torch.testing.assert_close(ab, ab0, rtol=0, atol=0)
    torch.testing.assert_close(V, V0, rtol=0, atol=0)
    ev, y = TK._ritz_pair(V, ab, "eigh", 60, 1e-8)
    np.testing.assert_array_equal(ev.numpy(), ev_j)
    np.testing.assert_array_equal(y.permute(0, 2, 1, 3).numpy(), y_j)


# ---------------------------------------------------------------------------
# The two-site ground-state wrappers
# ---------------------------------------------------------------------------


def _solver_2s(rng, B, chi, d, M, np_dt):
    """Solver-layout L, W1, W2, R, x0 with a Hermitian two-site H_eff."""
    L = rng.standard_normal((B, chi, M, chi))
    R = rng.standard_normal((B, chi, M, chi))
    W1 = rng.standard_normal((M, M, d, d))
    W1 = (W1 + W1.transpose(0, 1, 3, 2)) / 2
    L = (L + L.transpose(0, 3, 2, 1)) / 2
    R = (R + R.transpose(0, 3, 2, 1)) / 2
    x = rng.standard_normal((B, chi, d, d, chi))
    # W2 = W1 reversed on the MPO bond keeps C[w,v] = C[v,w]^T
    W2 = W1.transpose(1, 0, 2, 3)
    return tuple(a.astype(np_dt) for a in (L, W1, W2, R, x))


_JAX_2S = {"resident": lambda *a, **k: JK.fused_lanczos_ground_state_2s(*a, **k),
           "streamed_matvec": functools.partial(
               JK.fused_lanczos_ground_state_2s_streamed, plan=(2, 2)),
           "streamed_matvec_xl": functools.partial(
               JK.fused_lanczos_ground_state_2s_streamed, plan=(2, 2, 2))}


@pytest.mark.parametrize("tier,kind", [("resident", "f32"), ("resident", "f64"),
                                       ("streamed_matvec", "f64"),
                                       ("streamed_matvec_xl", "f64")])
def test_two_site_ground_state_wrappers_match_jax(rng, tier, kind):
    # M=2: the interpret-mode trace of the resident kernel grows with
    # m*M*M*nt*nt
    np_dt, _ = DTYPES[kind]
    B, chi, d, M, m = 2, 16, 2, 2, 5
    solver = _solver_2s(rng, B, chi, d, M, np_dt)
    ev_j, vec_j = (np.asarray(a) for a in _JAX_2S[tier](
        *_jax(*solver), num_krylov_vecs=m, ritz_method="eigh", interpret=True,
        precision=HIGHEST))
    TK.reset_launch_counts()
    ev, vec = (a.numpy() for a in tdmrg._FUSED_TIERS_2S[tier](
        *_torch(*solver), num_krylov_vecs=m, ritz_method="eigh"))
    assert sum(TK.launch_counts.values()) == 0
    assert vec.shape == (B, chi, d, d, chi) and ev.shape == (B,)
    assert ev.dtype == np_dt
    assert _rel(ev, ev_j) < LANCZOS_TOL[kind]
    for b in range(B):
        s = np.sign(np.sum(vec[b] * vec_j[b]))
        assert _rel(s * vec[b], vec_j[b]) < EVEC_TOL[kind]


def test_fused_mpo_pair_is_the_two_site_matvec(rng):
    # K1 at nt=d*d with the pre-fused couplings is _matvec_2s
    B, chi, d, M = 2, 6, 2, 3
    L, W1, W2, R, x = _torch(*_solver_2s(rng, B, chi, d, M, np.float64))
    Lt, C, Rt, xt = TK.prepare_operands_2s(L, W1, W2, R, x)
    y = TK.finalize_output(TK.heff_matvec(Lt, C, Rt, xt))
    y_ref = tdmrg._matvec_2s(L, W1, W2, R, x)
    torch.testing.assert_close(y.reshape(y_ref.shape), y_ref, rtol=1e-12,
                               atol=1e-12)
    y_j = jax.vmap(lambda l, r, v: jdmrg._matvec_2s(
        l, jnp.asarray(W1.numpy()), jnp.asarray(W2.numpy()), r, v))(
        *_jax(L.numpy(), R.numpy(), x.numpy()))
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(y_j), atol=1e-12)
