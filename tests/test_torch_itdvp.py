"""iTDVP of the uniform MPS: the port against the JAX package.

One step from the same state (the JAX package's ``random_vumps_state``
carried into the port by ``interop.vumps_state_from_numpy``) is held to
the JAX step; the physics tests mirror ``tests/test_vumps.py:88-133``
with the port alone.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mpo as jmpo
from tensornetwork_tpu_torch import interop

JV = importlib.import_module("tensornetwork_tpu.models.vumps")
TV = importlib.import_module("tensornetwork_tpu_torch.models.vumps")

# one iTDVP step from the same complex128 state (1e-14 seen)
ITDVP_TOL = 1e-10
CHI = 8


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


@pytest.mark.parametrize("imaginary", [False, True], ids=["real", "imag"])
def test_itdvp_step_matches_jax(imaginary):
    W = _tfi_w(-1.0, -1.2)
    lams = JV.mpo_diagonal_coefficients(W)
    js = JV.random_vumps_state(jax.random.PRNGKey(3), CHI, 2, jnp.float64)
    if not imaginary:
        js = JV.VUMPSState(*(x.astype(jnp.complex128) for x in js))
    sj, ej, errj = JV.itdvp_step(js, jnp.asarray(W), lams, 0.05,
                                 imaginary=imaginary)
    st, et, errt = TV.itdvp_step(_port_state(js), torch.as_tensor(W), lams,
                                 0.05, imaginary=imaginary)
    assert st.AC.dtype == (torch.float64 if imaginary else torch.complex128)
    for got, ref in zip(st, sj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ITDVP_TOL)
    assert abs(float(et) - float(ej)) < ITDVP_TOL
    assert abs(float(errt) - float(errj)) < ITDVP_TOL


@pytest.fixture(scope="module")
def critical_ground_state():
    W = _tfi_w(-1.0, -1.0)
    res = TV.vumps(torch.as_tensor(W), chi=12, num_iterations=50)
    return TV.VUMPSState(*(x.to(torch.complex128) for x in res.state))


_Z = np.diag([1.0, -1.0])


def _z(state):
    return TV.uniform_expectation_1site(state, _Z).real


def test_itdvp_ground_state_stationary(critical_ground_state):
    # tests/test_vumps.py:88-103's bars
    st = critical_ground_state
    m0 = _z(st)
    _, es, obs = TV.itdvp(st, _tfi_w(-1.0, -1.0), t=0.3, num_steps=6,
                          observable=_z)
    assert max(abs(np.array(es) - es[0])) < 1e-6
    assert max(abs(np.array(obs) - m0)) < 1e-3


def test_itdvp_quench_conserves_new_energy(critical_ground_state):
    # tests/test_vumps.py:106-121's bars: E of the new H is conserved, <Z>
    # moves
    _, es, obs = TV.itdvp(critical_ground_state, _tfi_w(-1.0, -1.5), t=0.3,
                          num_steps=15, observable=_z)
    es = np.array(es)
    assert abs(es - es[0]).max() < 1e-4
    assert abs(obs[-1] - obs[0]) > 1e-2


def test_itdvp_imaginary_time_projects_to_ground_state():
    # tests/test_vumps.py:124-133's bar
    st = TV.random_vumps_state(7, 12, device="cpu")
    _, es, _ = TV.itdvp(st, _tfi_w(-1.0, -1.0), t=6.0, num_steps=60,
                        imaginary=True)
    assert abs(es[-1] - TV.tfi_exact_energy_density(1.0, 1.0)) < 5e-3
