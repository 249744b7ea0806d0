"""The API the ported modules had left out, against the JAX package.

The one-site sweep with ``qr_impl="polar_express"``, ``matvec_prec``
(accepted, and without effect), ``eigsh_lanczos(num_restarts=)``, and
``FiniteDMRG``/``TDVP`` taking a ``FiniteMPS`` and writing the result
back; the top-level names (``FiniteMPO``, ``jit``, ``__version__``, the
utils), ``ns_polar_complete`` and ``native.available``.  The paired batched
entry points are in tests/test_torch_paired_names.py; ``svd``/``rq``/
``eigh`` and ``ns_polar_express`` in tests/test_torch_factorizations.py.
Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import dmrg as jdmrg
from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu.models import mps as jmps
from tensornetwork_tpu.models import tdvp as jtdvp
from tensornetwork_tpu.ops import krylov as jkrylov
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.models import mps as tmps
from tensornetwork_tpu_torch.models import tdvp as ttdvp
from tensornetwork_tpu_torch.ops import kernels as TK
from tensornetwork_tpu_torch.ops import krylov as tkrylov


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


def _signed_close(t, j, tol, axis):
    """Columns (axis=-1) or rows (axis=0) equal up to a phase each: an SVD
    or QR leaves one per singular vector."""
    t, j = np.moveaxis(np.asarray(t), axis, 0), np.moveaxis(np.asarray(j),
                                                           axis, 0)
    for x, y in zip(t, j):
        ph = np.vdot(x, y)
        ph = ph / abs(ph) if abs(ph) > 0 else 1.0
        np.testing.assert_allclose(x * ph, y, atol=tol, rtol=tol)


def test_one_site_sweep_with_polar_express_matches_jax():
    N, chi, m = 5, 8, 5
    rng = np.random.default_rng(4)
    As0 = (rng.standard_normal((N, chi, 2, chi)) / np.sqrt(2 * chi)).astype(
        np.float32)
    kw = dict(num_krylov_vecs=m, qr_impl="polar_express", ritz_impl="eigh",
              reorth=False)
    # the JAX package's schedule coefficients are numpy float64 scalars,
    # which promote an f32 panel to f64 under x64: its f32 sweep runs with
    # x64 off
    with jax.enable_x64(False):
        jm = jmpo.FiniteTFI(1.0, 0.8, N=N, dtype=jnp.float32)
        jres = jdmrg.one_site_sweep(jnp.asarray(As0), jm.Ws, jm.vL, jm.vR,
                                    lanczos_impl="xla", **kw)
        jres = jax.tree_util.tree_map(np.asarray, jres)
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    tres = tdmrg.one_site_sweep(torch.from_numpy(As0), tm.Ws, tm.vL, tm.vR,
                                lanczos_impl="fused", **kw)
    _close(tres.energies, jres.energies, 1e-5)
    _close(tdmrg.mps_mpo_expectation(tres.As.double(), tm.Ws.double(),
                                     tm.vL.double(), tm.vR.double()),
           jdmrg.mps_mpo_expectation(jnp.asarray(np.asarray(jres.As),
                                                 jnp.float64),
                                     jm.Ws.astype(jnp.float64),
                                     jm.vL.astype(jnp.float64),
                                     jm.vR.astype(jnp.float64)), 1e-5)


@pytest.mark.parametrize("two_site", [False, True])
def test_matvec_prec_reaches_the_plain_matvec(monkeypatch, two_site):
    seen = []
    matvec = TK.heff_matvec

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return matvec(*args)

    monkeypatch.setattr(TK, "heff_matvec", spy)
    N, chi = 4, 4
    As = tdmrg.random_mps_stack(0, N, chi, 2, dtype=torch.float32,
                                device="cpu")
    jm = jmpo.FiniteTFI(1.0, 1.0, N=N)
    mpo = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                 np.asarray(jm.vR), device="cpu",
                                 dtype=torch.float32)
    sweep = tdmrg.two_site_sweep if two_site else tdmrg.one_site_sweep
    outside = (torch.backends.cuda.matmul.allow_tf32,
               torch.get_float32_matmul_precision())
    # the default leaves TF32 off in every matvec
    a = sweep(As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=4,
              lanczos_impl="plain")
    assert seen and set(seen) == {(False, "highest")}
    # the JAX package's "high" is accepted, as argument and as module
    # setting, and TF32 stays off: the port's matvec keeps its own
    # arithmetic whatever it says
    seen.clear()
    b = sweep(As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=4,
              lanczos_impl="plain", matvec_prec="high")
    assert seen and set(seen) == {(False, "highest")}
    seen.clear()
    monkeypatch.setattr(tdmrg, "MATVEC_PRECISION", "high")
    c = sweep(As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=4,
              lanczos_impl="plain")
    assert seen and set(seen) == {(False, "highest")}
    # the fused kernels do not call it; the caller's settings come back
    seen.clear()
    sweep(As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=4, lanczos_impl="fused")
    assert not seen
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == outside
    # and it changes no result
    torch.testing.assert_close(a.energies, b.energies, rtol=0, atol=0)
    torch.testing.assert_close(a.energies, c.energies, rtol=0, atol=0)


@pytest.mark.parametrize("ritz", ["eigh", "power"])
@pytest.mark.parametrize("restarts", [1, 2, 3])
def test_eigsh_lanczos_num_restarts_matches_jax(ritz, restarts):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 40))
    H = a + a.T
    x0 = rng.standard_normal(40)
    je, jv = jkrylov.eigsh_lanczos(lambda x: jnp.asarray(H) @ x,
                                   jnp.asarray(x0), num_krylov_vecs=8,
                                   num_restarts=restarts, ritz_method=ritz)
    Ht = torch.from_numpy(H)
    te, tv = tkrylov.eigsh_lanczos(lambda x: x @ Ht.T, torch.from_numpy(x0)[None],
                                   num_krylov_vecs=8, num_restarts=restarts,
                                   ritz_method=ritz)
    _close(te[0], je, 1e-10)
    _signed_close(tv[0].T, np.asarray(jv).T, 1e-8, -1)
    if restarts > 1:   # each restart lowers the Ritz value
        e1, _ = tkrylov.eigsh_lanczos(lambda x: x @ Ht.T,
                                      torch.from_numpy(x0)[None],
                                      num_krylov_vecs=8, ritz_method=ritz)
        assert float(te[0, 0]) < float(e1[0, 0])


def test_finite_dmrg_takes_a_finite_mps_and_writes_back(monkeypatch):
    # the JAX package's off-accelerator defaults: plain Lanczos with
    # reorthogonalisation, Householder gauges, exact Ritz pairs
    monkeypatch.setattr(tdmrg, "LANCZOS_IMPL", "plain")
    N, chi = 5, 4
    rng = np.random.default_rng(8)
    As0 = rng.standard_normal((N, chi, 2, chi)) / np.sqrt(2 * chi)
    jm = jmpo.FiniteTFI(1.0, 0.8, N=N, dtype=jnp.float64)
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    jmps_ = jmps.FiniteMPS(jnp.asarray(As0))
    tmps_ = tmps.FiniteMPS(torch.from_numpy(As0))
    je = jdmrg.FiniteDMRG(jmps_, jm).run_one_site(num_sweeps=2,
                                                  num_krylov_vecs=6)
    dm = tdmrg.FiniteDMRG(tmps_, tm)
    te = dm.run_one_site(num_sweeps=2, num_krylov_vecs=6)
    _close(te, je, 1e-9)
    assert tmps_.to_stack() is dm.As and tmps_.center_position is None
    assert jmps_.center_position is None
    _close(tmps_.to_dense(), jmps_.to_dense(), 1e-8)
    Z = np.diag([1.0, -1.0])
    _close(torch.stack(tmps_.measure_local_operator([Z] * N, range(N))),
           np.array(jmps_.measure_local_operator([Z] * N, range(N))), 1e-9)


def test_tdvp_takes_a_finite_mps_and_writes_back():
    N, chi = 4, 4
    rng = np.random.default_rng(9)
    As0 = ((rng.standard_normal((N, chi, 2, chi))
            + 1j * rng.standard_normal((N, chi, 2, chi))) / np.sqrt(4 * chi))
    jm = jmpo.FiniteTFI(1.0, 0.8, N=N, dtype=jnp.float64)
    tm = interop.mpo_from_numpy(np.asarray(jm.Ws), np.asarray(jm.vL),
                                np.asarray(jm.vR), device="cpu")
    jmps_ = jmps.FiniteMPS(jnp.asarray(As0))
    tmps_ = tmps.FiniteMPS(torch.from_numpy(As0))
    jtdvp.TDVP(jmps_, jm).evolve(0.1, 2, num_krylov_vecs=8)
    tdvp = ttdvp.TDVP(tmps_, tm)
    tdvp.evolve(0.1, 2, num_krylov_vecs=8)
    assert tmps_.to_stack() is tdvp.As and tmps_.center_position is None
    _close(tmps_.to_dense(), jmps_.to_dense(), 1e-9)
    # the split-complex path writes back too (the JAX package's does not)
    real = tmps.FiniteMPS(torch.from_numpy(As0.real.copy()))
    sc = ttdvp.TDVP(real, tm, split_complex=True)
    sc.step(0.05, num_krylov_vecs=8)
    assert real.dtype == torch.complex128 and real.to_stack() is sc.As
    plain = ttdvp.TDVP(torch.from_numpy(As0.real.copy()), tm,
                       split_complex=True)
    plain.As = tmps.FiniteMPS(torch.from_numpy(As0.real.copy())).As.to(
        torch.complex128)
    plain.step(0.05, num_krylov_vecs=8)
    torch.testing.assert_close(real.As, plain.As, rtol=0, atol=0)
    _close(real.norm(), 1.0, 1e-9)


def test_new_entry_points_raise_without_cuda(monkeypatch):
    from tensornetwork_tpu_torch.models import infinite_mps, mera, tebd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tmps.FiniteMPS.random(3, 2),
               lambda: tmps.FiniteMPS(np.zeros((3, 2, 2, 2))),
               lambda: infinite_mps.InfiniteMPS.random(1, 2),
               lambda: mera.initialize_mera(2, 1),
               lambda: mera.blocked_ising_hamiltonian(),
               lambda: tebd.trotter_gate(np.eye(4), 0.1),
               lambda: interop.finite_mps_from_numpy(np.zeros((3, 2, 2, 2)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    assert tmps.FiniteMPS.random(3, 2, device="cpu").device.type == "cpu"


# -- the top-level names and leftovers of the application-layer slice ----

def test_top_level_names_of_the_jax_package_exist():
    import tensornetwork_tpu as J
    import tensornetwork_tpu_torch as T

    for name in ("FiniteMPO", "BaseMPO", "jit", "__version__", "models",
                 "quantum", "save_nodes", "load_nodes", "from_topology",
                 "to_graphviz"):
        assert hasattr(T, name), name
    assert T.FiniteMPO is T.MPO and T.BaseMPO is T.MPO
    assert T.__version__ == J.__version__
    assert T.models.FiniteDMRG is T.FiniteDMRG
    from tensornetwork_tpu_torch import nn, utils
    assert {"DenseDecomp", "DenseMPO", "DenseCondenser", "DenseExpander",
            "DenseEntangler", "Conv2DMPO"} <= set(dir(nn))
    assert {"save_nodes", "load_nodes", "from_topology",
            "to_graphviz"} <= set(dir(utils))


def test_jit_returns_the_function_and_takes_the_references_arguments():
    import tensornetwork_tpu_torch as T

    def f(x, y=2):
        return x * y

    assert T.jit(f) is f
    assert T.jit(f, backend="pytorch", backend_argnum=1,
                 static_argnums=(1,), donate_argnums=(0,)) is f
    deco = T.jit(static_argnums=(0,), backend="numpy")
    assert deco(f) is f

    @T.jit
    def g(x):
        return x + 1

    assert g(torch.ones(2)).tolist() == [2.0, 2.0]


@pytest.mark.parametrize("shape", [(8, 4), (3, 8, 4)])
def test_ns_polar_complete_matches_jax(shape):
    from tensornetwork_tpu.ops import decompositions as jdec
    from tensornetwork_tpu_torch.ops import decompositions as tdec

    assert tdec.ns_polar_complete is tdec.polar_complete
    m = np.random.default_rng(5).standard_normal(shape)
    m[..., 3] = 0.0       # rank-deficient: the completion is exercised
    Q, P = tdec.ns_polar_complete(torch.as_tensor(m))
    Qj, Pj = jdec.ns_polar_complete(jnp.asarray(m))
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), atol=1e-12)
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), atol=1e-12)


def test_native_available_builds_or_reports(monkeypatch):
    from tensornetwork_tpu import native as jnative
    from tensornetwork_tpu_torch import native

    assert native.available() is True
    assert native.available() == jnative.available()

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "load", broken)
    assert native.available() is False
