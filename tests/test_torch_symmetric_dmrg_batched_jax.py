"""The port's ``BatchedSymmetricDMRG`` against the JAX package's, on the
CPU: the one test of this slice that runs the JAX batched programs (XLA
compiles one program per site structure and direction, ~1-2 s each), at
N = 4, chi = 8, B = 2, float64, with the defaults of both classes (m = 10
Krylov vectors, the power Ritz step).  Energies of every sweep within
1e-9 relative; the sites' data within 1e-8 after the sweeps (both gauge
by the completed polar, whose factors are unique)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.blocksparse import batched as JBt
from tensornetwork_tpu.models import symmetric_dmrg as JS
from tensornetwork_tpu.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG as JBatched)
from tensornetwork_tpu_torch.blocksparse import batched as TBt
from tensornetwork_tpu_torch.models import symmetric_dmrg as TS
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_batched_one_site_matches_the_jax_batched_programs():
    N, chi, B = 4, 8, 2
    jskel = JBt.uniform_skeleton_mps(N, chi, dtype=np.float64)
    tskel = TBt.uniform_skeleton_mps(N, chi, dtype=torch.float64,
                                     device="cpu")
    jd = JBt.random_data_batch(jskel, B, seed=9)
    td = TBt.random_data_batch(tskel, B, seed=9, device="cpu")
    j = JBatched(jskel, jd, JS.u1_xxz_mpo(0.8, 1.0, 0.1, N))
    t = BatchedSymmetricDMRG(tskel, td,
                             TS.u1_xxz_mpo(0.8, 1.0, 0.1, N, device="cpu"))
    j.run_one_site(num_sweeps=2)
    t.run_one_site(num_sweeps=2)
    np.testing.assert_allclose(np.stack(t.energies), np.stack(j.energies),
                               rtol=1e-9)
    for a, b in zip(t.data, j.data):
        np.testing.assert_allclose(a.numpy(), np.asarray(jnp.asarray(b)),
                                   rtol=0, atol=1e-8)
