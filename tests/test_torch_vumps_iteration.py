"""One VUMPS iteration of the port against the JAX package's.

Both start from the JAX package's ``random_vumps_state`` carried into
the port by ``interop.vumps_state_from_numpy``, with the inputs of
``tests/test_vumps.py:135-158`` (TFI(-1, -0.8), chi=8, m=12).  The port's
K2 wrapper gets CPU tensors and so runs its plain twin
(``lanczos_impl="fused"``), held against the JAX ``"fused"`` in interpret
mode; ``"plain"`` is held against the JAX ``"xla"``.  The JAX iterations
are computed once per module.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.ops import kernels as TK

JV = importlib.import_module("tensornetwork_tpu.models.vumps")
TV = importlib.import_module("tensornetwork_tpu_torch.models.vumps")

# one iteration from the same state (tests/test_vumps.py:135-158's bars):
# energy densities and 1 - |<AC_port|AC_jax>|.  f64: rounding of the
# same solves (1e-15 seen); f32: both sides round differently through
# GMRES and Lanczos (3e-8 seen in the energy)
ITER_TOL = {torch.float64: (1e-9, 1e-8), torch.float32: (1e-5, 1e-5)}
CHI, M_KRYLOV = 8, 12
W_ITER = (-1.0, -0.8)     # TFI (J, h)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Thousands of tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tfi_w(J, h, dtype=np.float64):
    return np.array(jmpo.FiniteTFI(J, h, N=3).Ws[1], dtype)


def _port_state(jstate):
    return interop.vumps_state_from_numpy(
        *(np.asarray(x) for x in jstate), device="cpu")


@pytest.fixture(scope="module")
def jax_iterations():
    """The JAX iteration from PRNGKey(0) at chi=8, m=12 (the inputs of
    tests/test_vumps.py:135-158): ``"xla"`` with the default 4 Lanczos
    passes, and ``"fused"`` (interpret mode) with 1, in f64 and f32.  One
    fused pass, because interpret mode compiles each unrolled pass (37 s
    for 4, 10 s for 1)."""
    st = JV.random_vumps_state(jax.random.PRNGKey(0), CHI, 2, jnp.float64)
    out = {}
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        stj = JV.VUMPSState(*(x.astype(jdtype) for x in st))
        W = jnp.asarray(_tfi_w(*W_ITER), jdtype)
        lams = JV.mpo_diagonal_coefficients(W)
        for impl, passes in (("xla", 4), ("fused", 1)):
            s, e, err, LW, RW, _ = JV.vumps_iteration(
                stj, W, lams, num_krylov_vecs=M_KRYLOV, lanczos_impl=impl,
                lanczos_restarts=passes)
            out[dtype, impl] = (stj, np.asarray(s.AC), float(e), float(err),
                                np.asarray(LW), np.asarray(RW))
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("impl,jimpl,passes", [("plain", "xla", 4),
                                               ("fused", "fused", 1)])
def test_vumps_iteration_matches_jax(jax_iterations, dtype, impl, jimpl,
                                     passes):
    stj, ACj, ej, errj, LWj, RWj = jax_iterations[dtype, jimpl]
    W = torch.as_tensor(_tfi_w(*W_ITER), dtype=dtype)
    lams = TV.mpo_diagonal_coefficients(W)
    TV.reset_counts()
    TK.reset_launch_counts()
    s, e, err, LW, RW, _ = TV.vumps_iteration(
        _port_state(stj), W, lams, num_krylov_vecs=M_KRYLOV,
        lanczos_impl=impl, lanczos_restarts=passes)
    assert s.AC.dtype == dtype
    e_tol, fid_tol = ITER_TOL[dtype]
    assert abs(float(e) - ej) < e_tol
    a, b = s.AC.double().numpy().ravel(), ACj.astype(np.float64).ravel()
    fid = abs(np.dot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
    assert fid > 1 - fid_tol
    assert abs(float(err) - errj) < 1e3 * e_tol
    np.testing.assert_allclose(LW.double().numpy(), LWj, atol=1e2 * e_tol)
    np.testing.assert_allclose(RW.double().numpy(), RWj, atol=1e2 * e_tol)
    # the passes ran as asked, and the twin (not the kernel) on the CPU
    assert TV.counts == {"ac_passes": passes, "c_passes": passes,
                         "ritz_checks": 0}
    assert TK.launch_counts["fused_lanczos"] == 0
