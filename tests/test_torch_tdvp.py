"""TDVP (complex-dtype path), its Lanczos exponential, K2's exponential
callers and FiniteXXZ: the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages as
explicit dtypes.  The port's kernel wrappers get CPU tensors and so run
their plain twins; where the JAX function reaches a Pallas kernel it runs
in interpret mode.  Sweeps are compared by their physical states (dense
vectors at small N): the site tensors of a product state's
rank-deficient centers are gauge, not state.  The ``_sc`` path is in
``test_torch_tdvp_sc.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.models import tdvp as jtdvp
from tensornetwork_tpu.ops import kernels as JK
from tensornetwork_tpu.ops import krylov as jkrylov
from tensornetwork_tpu_torch.models import mpo as tmpo
from tensornetwork_tpu_torch.models import tdvp as ttdvp
from tensornetwork_tpu_torch.ops import kernels as TK
from tensornetwork_tpu_torch.ops import krylov as tkrylov

# Both sides run the same recurrence; f64 differs in summation order only
# (1e-14 measured), f32 by its rounding carried over ~20 steps.
EXPM_RTOL = {np.float64: 1e-11, np.complex128: 1e-11,
             np.float32: 5e-5, np.complex64: 5e-5}
# 1 - |<psi_port|psi_jax>| of one f64 sweep from the same state
FIDELITY_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The sweeps at these sizes are thousands of tiny torch ops; with the
    default intra-op threads they contend with the other test workers'
    (50x slower under the six-worker run), with one they do not."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _product_state(N, chi, v, dtype):
    As = np.zeros((N, chi, len(v), chi), dtype)
    As[:, 0, :, 0] = v
    return As


def dense_from_stack(As):
    """The boundary block [0, :, 0] of a stacked MPS as a state vector."""
    As = np.asarray(As)
    acc = As[0]
    for A in As[1:]:
        acc = np.einsum("a...b,bsc->a...sc", acc, A)
    chi = As.shape[1]
    return acc.reshape(chi, -1, chi)[0, :, 0]


def infidelity(a, b):
    a, b = dense_from_stack(a), dense_from_stack(b)
    return 1 - abs(np.vdot(a / np.linalg.norm(a), b / np.linalg.norm(b)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _hermitian(rng, n, complex_):
    A = rng.standard_normal((n, n))
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    return (A + A.conj().T) / 2


def _cpu(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("coeff", [-0.4, -0.25j, 0.1 - 0.3j])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128,
                                   np.complex64])
def test_expm_multiply_lanczos_matches_jax(dtype, coeff):
    rng = np.random.default_rng(3)
    B, n, m = 3, 40, 20
    As = [_hermitian(rng, n, np.iscomplexobj(dtype(0))).astype(dtype)
          for _ in range(B)]
    vs = rng.standard_normal((B, n)).astype(dtype)
    At = _cpu(np.stack(As))
    got = tkrylov.expm_multiply_lanczos(
        lambda x: torch.einsum("Bij,Bj->Bi", At, x), _cpu(vs), coeff, m)
    for b in range(B):
        want = jkrylov.expm_multiply_lanczos(
            lambda x: jnp.asarray(As[b]) @ x, jnp.asarray(vs[b]), coeff, m)
        assert _rel(got[b].numpy(), want) < EXPM_RTOL[dtype]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_expm_multiply_lanczos_sc_matches_jax(dtype):
    from tensornetwork_tpu.ops import split_complex as jsc
    rng = np.random.default_rng(4)
    B, n, m = 3, 40, 20
    Hs = np.stack([_hermitian(rng, n, True) for _ in range(B)]).astype(dtype)
    vs = (rng.standard_normal((B, n))
          + 1j * rng.standard_normal((B, n))).astype(dtype)
    dts = np.array([0.3, 0.1, 0.2])
    Ht = _cpu(Hs)
    # per-instance coefficients -1j dt_b, as the batched quench passes them
    coeff = torch.complex(torch.zeros(B, dtype=Ht.real.dtype),
                          torch.as_tensor(-dts, dtype=Ht.real.dtype))
    got = tkrylov.expm_multiply_lanczos_sc(
        lambda x: torch.einsum("Bij,Bj->Bi", Ht, x), _cpu(vs), coeff, m)
    for b in range(B):
        Hr, Hi = jnp.asarray(Hs[b].real), jnp.asarray(Hs[b].imag)

        def mv(x):
            return jsc.SC(Hr @ x.re - Hi @ x.im, Hr @ x.im + Hi @ x.re)

        y = jkrylov.expm_multiply_lanczos_sc(
            mv, jsc.SC(jnp.asarray(vs[b].real), jnp.asarray(vs[b].imag)),
            -1j * float(dts[b]), m)
        want = np.asarray(y.re) + 1j * np.asarray(y.im)
        assert _rel(got[b].numpy(), want) < EXPM_RTOL[dtype]
        exact = sla.expm(-1j * dts[b] * Hs[b].astype(np.complex128)) @ vs[b]
        assert _rel(got[b].numpy(), exact) < 10 * EXPM_RTOL[dtype]


def test_finite_xxz_bitwise_and_tdvp_keeps_its_norm():
    args = ([1.0, 0.5, -0.3, 0.8], [0.7, 1.0, 0.2, 0.4],
            [0.1, -0.2, 0.3, 0.0, 0.5])
    j = jmpo.FiniteXXZ(*args, dtype=jnp.float64)
    t = tmpo.FiniteXXZ(*args, dtype=torch.float64, device="cpu")
    for a, b in zip((j.Ws, j.vL, j.vR), (t.Ws, t.vL, t.vR)):
        assert np.array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError):
        tmpo.FiniteXXZ(1.0, 1.0, 0.2, device="cpu")
    # tests/test_tdvp.py's norm check on the port
    N, chi = 5, 4
    mpo = tmpo.FiniteXXZ(1.0, 1.0, 0.2, N=N, device="cpu")
    As = _product_state(N, chi, np.array([1.0, 1.0]) / np.sqrt(2),
                        np.complex128)
    tdvp = ttdvp.TDVP(torch.as_tensor(As), mpo)
    tdvp.evolve(0.3, 10)
    np.testing.assert_allclose(
        np.linalg.norm(dense_from_stack(tdvp.As.numpy())), 1.0, atol=1e-9)


def _complex_operands(rng, B, chi, d, M):
    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    L = c(B, chi, M, chi)
    L = (L + L.transpose(0, 3, 2, 1).conj()) / (2 * chi)
    R = c(B, chi, M, chi)
    R = (R + R.transpose(0, 3, 2, 1).conj()) / (2 * chi)
    W = rng.standard_normal((M, M, d, d))
    W = (W + W.transpose(1, 0, 3, 2)) / 2
    return L, W, R, c(B, chi, d, chi)


def _sc(z):
    from tensornetwork_tpu.ops import split_complex as jsc
    return jsc.SC(jnp.asarray(z.real), jnp.asarray(z.imag))


@pytest.mark.parametrize("d", [2, 1], ids=["site", "bond"])
def test_realified_operands_bitwise(d):
    L, W, R, x = _complex_operands(np.random.default_rng(5), 2, 4, d, 3)
    got = TK.realify_sandwich_operands(*(_cpu(a) for a in (L, W, R, x)))
    want = JK._realify_sandwich_operands(_sc(L), jnp.asarray(W), _sc(R),
                                         _sc(x))
    assert want[4:] == (4, 2 * d, 6)
    for g, w in zip(got, want[:4]):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_expm_multiply_fused_sc_matches_interpret_at_the_bond_shape():
    # the bond step's shape, realified nt'=2, M'=6 (the site shape costs
    # 25 s in interpret mode: its twin is held against the Lanczos below)
    rng = np.random.default_rng(6)
    L, _, R, x = _complex_operands(rng, 1, 4, 1, 3)
    W = np.eye(3).reshape(3, 3, 1, 1)
    got = TK.expm_multiply_fused_sc(*(_cpu(a) for a in (L, W, R, x)),
                                    -0.05j, 4)
    y = JK.expm_multiply_fused_sc(_sc(L), jnp.asarray(W), _sc(R), _sc(x),
                                  -0.05j, 4, interpret=True)
    assert _rel(got.numpy(), np.asarray(y.re) + 1j * np.asarray(y.im)) < 1e-12


@pytest.mark.parametrize("nt", [1, 2])
def test_expm_multiply_fused_matches_interpret(nt):
    rng = np.random.default_rng(7 + nt)
    L, W, R, x = (a.real.copy() for a in _complex_operands(rng, 2, 4, nt, 3))
    got = TK.expm_multiply_fused(*(_cpu(a) for a in (L, W, R, x)), -0.05, 4)
    want = JK.expm_multiply_fused(*(jnp.asarray(a) for a in (L, W, R, x)),
                                  -0.05, 4, interpret=True)
    assert _rel(got.numpy(), want) < 1e-12


def test_site_shape_twin_matches_jax_lanczos():
    # K2's twin on the realified site operands (nt'=4, M'=6) against the
    # JAX package's Lanczos without reorthogonalisation on the same
    # realified matvec: the fused kernel's recurrence
    rng = np.random.default_rng(8)
    B, chi, m = 2, 4, 6
    L, W, R, x = _complex_operands(rng, B, chi, 2, 3)
    Lt, Wp, Rt, xt = TK.realify_sandwich_operands(
        *(_cpu(a) for a in (L, W, R, x)))
    V, ab = TK.fused_lanczos(Lt, Wp, Rt, xt, m, 1e-8)
    Lp, Rp = Lt.permute(0, 3, 1, 2).numpy(), Rt.permute(0, 2, 1, 3).numpy()
    Wj = jnp.asarray(Wp.numpy())
    for b in range(B):
        xb = xt[b].permute(1, 0, 2).numpy()        # (a, t', b)

        def mv(v):
            y = JK.heff_matvec_reference(jnp.asarray(Lp[b:b + 1]), Wj,
                                         jnp.asarray(Rp[b:b + 1]),
                                         v.reshape((1,) + xb.shape))
            return y.reshape(-1)

        Vj, aj, bj = jkrylov.lanczos_factorization(
            mv, jnp.asarray(xb.reshape(-1)), m, reorthogonalize=False)
        assert _rel(ab[b, 0].numpy(), aj) < 1e-12
        assert _rel(ab[b, 1, :m - 1].numpy(), bj) < 1e-12
        Vb = V[b].permute(0, 2, 1, 3).reshape(m, -1).numpy()
        assert _rel(Vb, Vj) < 1e-10


def _tfi(N):
    args = (-1.0, -0.9)
    return (jmpo.FiniteTFI(*args, N=N, dtype=jnp.float64),
            tmpo.FiniteTFI(*args, N=N, dtype=torch.float64, device="cpu"))


def _mpo_args(mpo, dtype):
    return [np.asarray(t, dtype) for t in (mpo.Ws, mpo.vL, mpo.vR)]


@pytest.mark.parametrize("lanczos_impl", ["fused", "plain"])
def test_one_site_sweep_real_time_matches_jax(lanczos_impl):
    N, chi = 4, 4
    jm, _ = _tfi(N)
    As = _product_state(N, chi, np.array([1.0, 0.3]) / np.hypot(1, 0.3),
                        np.complex128)
    mpo = _mpo_args(jm, np.complex128)
    want = jtdvp.tdvp_one_site_sweep(jnp.asarray(As), *map(jnp.asarray, mpo),
                                     0.02, num_krylov_vecs=10,
                                     lanczos_impl="xla")
    got = ttdvp.tdvp_one_site_sweep(_cpu(As), *map(_cpu, mpo), 0.02,
                                    num_krylov_vecs=10,
                                    lanczos_impl=lanczos_impl)
    assert got.dtype == torch.complex128
    assert infidelity(got.numpy(), want) < FIDELITY_TOL


@pytest.mark.parametrize("lanczos_impl", ["fused", "plain"])
def test_one_site_sweep_imaginary_time_matches_jax(lanczos_impl):
    # the fused route's twin at the site (nt=2) and bond (nt=1) steps
    N, chi = 4, 4
    jm, tm = _tfi(N)
    rng = np.random.default_rng(9)
    As = rng.standard_normal((N, chi, 2, chi)) / np.sqrt(2 * chi)
    want = jtdvp.tdvp_one_site_sweep(jnp.asarray(As), jm.Ws, jm.vL, jm.vR,
                                     0.05, num_krylov_vecs=10,
                                     imaginary=True, lanczos_impl="xla")
    TK.reset_launch_counts()
    got = ttdvp.tdvp_one_site_sweep(_cpu(As), tm.Ws, tm.vL, tm.vR, 0.05,
                                    num_krylov_vecs=10, imaginary=True,
                                    lanczos_impl=lanczos_impl)
    assert TK.launch_counts["fused_lanczos"] == 0   # twins on the CPU
    assert got.dtype == torch.float64
    assert infidelity(got.numpy(), want) < FIDELITY_TOL


def test_two_site_sweep_matches_jax():
    # chi=2 < the bond content the block needs: the truncated weight
    # accumulates, on both sides alike
    N, chi = 5, 2
    jm = jmpo.FiniteTFI(-1.0, -1.5, N=N, dtype=jnp.float64)
    As = _product_state(N, chi, np.array([1.0, 0.2]) / np.hypot(1, 0.2),
                        np.complex128)
    mpo = _mpo_args(jm, np.complex128)
    want, wterr = jtdvp.tdvp_two_site_sweep(
        jnp.asarray(As), *map(jnp.asarray, mpo), 0.5, num_krylov_vecs=10)
    got, terr = ttdvp.tdvp_two_site_sweep(_cpu(As), *map(_cpu, mpo), 0.5,
                                          num_krylov_vecs=10)
    assert float(wterr) > 1e-4
    assert abs(float(terr) - float(wterr)) < 1e-10
    assert infidelity(got.numpy(), want) < FIDELITY_TOL


@pytest.mark.parametrize("two_site", [False, True])
@pytest.mark.parametrize("split_complex", [False, True])
def test_tdvp_matches_exact_expm(split_complex, two_site):
    # tests/test_tdvp.py's bars on the port; the _sc one-site path runs
    # K2's twin on the realified operands
    N, chi = 6, 8
    mpo = tmpo.FiniteTFI(-1.0, -1.2, N=N, device="cpu")
    H = tmpo.mpo_to_dense(mpo)
    v = np.array([1.0, 0.6]) / np.hypot(1.0, 0.6)
    psi0 = np.array([1.0])
    for _ in range(N):
        psi0 = np.kron(psi0, v)
    As = _product_state(N, chi, v, np.float64 if split_complex
                        else np.complex128)
    tdvp = ttdvp.TDVP(As, mpo, split_complex=split_complex, device="cpu")
    assert tdvp.As.dtype == torch.complex128
    e0 = tdvp.energy()
    t, steps = 0.5, 10
    tdvp.evolve(t, steps, two_site=two_site)
    assert abs(tdvp.energy() - e0) < 1e-8
    if two_site:
        assert tdvp.truncation_errors[-1] < 1e-20
    psi_t = sla.expm(-1j * t * H) @ psi0
    vec = dense_from_stack(tdvp.As.numpy())
    fidelity = abs(np.vdot(vec / np.linalg.norm(vec), psi_t))
    assert fidelity > 1 - 1e-8
    if split_complex:
        with pytest.raises(NotImplementedError):
            tdvp.step(0.1, imaginary=True)


def test_tdvp_runs_on_the_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mpo = tmpo.FiniteTFI(1.0, 1.0, N=4, device="cpu")
    As = _product_state(4, 2, np.array([1.0, 0.0]), np.complex128)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttdvp.TDVP(As, mpo)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmpo.FiniteXXZ(1.0, 1.0, 0.0, N=4)
    assert ttdvp.TDVP(As, mpo, device="cpu").As.device.type == "cpu"
