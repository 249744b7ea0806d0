"""The port's batched-realization U(1) DMRG (``BatchedSymmetricDMRG``)
against the JAX package's single-instance numpy engine, on the CPU at
N = 6, chi <= 16, B = 2.

As the JAX package's own test does (``tests/test_symmetric_dmrg_batched.py``
``test_batched_dmrg_matches_per_instance``), each realization of the
batched run is held against ``SymmetricFiniteDMRG`` (JAX, engine "numpy")
started from the same data: one-site with per-realization MPO disorder,
and two-site with a bond profile wide enough that its static per-sector
ranks truncate nothing; energies within 1e-9 relative in float64.  A
float32 run after ``precompile`` stays above the sector's exact energy
less 1e-5 and builds no plan of its own.
"""
import numpy as np
import pytest
import torch

from tensornetwork_tpu.blocksparse import U1Charge as JU1
from tensornetwork_tpu.blocksparse.tensor import BlockSparseTensor as JB
from tensornetwork_tpu.models import symmetric_dmrg as JS
from tensornetwork_tpu_torch.blocksparse import batched as TBt
from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
from tensornetwork_tpu_torch.models import symmetric_dmrg as TS
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)

from tests.test_torch_symmetric_dmrg import sector_ground_energy

N, B = 6, 2


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _skeleton(chi, seed, dtype=torch.float64):
    skel = TBt.uniform_skeleton_mps(N, chi, dtype=dtype, device="cpu")
    return skel, TBt.random_data_batch(skel, B, seed=seed, device="cpu")


def _jax_instance(skel, data, b):
    """Realization b as the JAX package's tensors (its own charges)."""
    return [JB(data[i][b].numpy(),
               [JU1(c.charges[:, 0]) for c in skel[i].flat_charges],
               skel[i].flat_flows, [list(g) for g in skel[i]._order])
            for i in range(N)]


def test_one_site_with_mpo_disorder_matches_jax_per_instance():
    Jzs = (0.6, 1.7)
    skel, data = _skeleton(12, 4)
    mpos = [TS.u1_xxz_mpo(Jz, 1.0, 0.0, N, device="cpu") for Jz in Jzs]
    mpo_data = [torch.stack([mpos[b][i].data for b in range(B)])
                for i in range(N)]
    d = BatchedSymmetricDMRG(skel, [x.clone() for x in data], mpos[0],
                             mpo_data=mpo_data, num_krylov_vecs=20,
                             ritz_method="eigh")
    es = d.run_one_site(num_sweeps=4)
    assert len(set(np.round(es, 6))) == B  # distinct disorder energies
    for b, Jz in enumerate(Jzs):
        solo = JS.SymmetricFiniteDMRG(_jax_instance(skel, data, b),
                                      JS.u1_xxz_mpo(Jz, 1.0, 0.0, N))
        e_solo = solo.run_one_site(num_sweeps=4, num_krylov_vecs=20)
        np.testing.assert_allclose(es[b], e_solo, rtol=1e-9)


def test_two_site_matches_jax_per_instance():
    skel, data = _skeleton(16, 7)
    d = BatchedSymmetricDMRG(skel, [x.clone() for x in data],
                             TS.u1_xxz_mpo(1.0, 1.0, 0.1, N, device="cpu"),
                             num_krylov_vecs=20, ritz_method="eigh")
    es = d.run_two_site(num_sweeps=4)
    assert np.all(d.truncation_errors[-1] < 1e-8)
    for b in range(B):
        solo = JS.SymmetricFiniteDMRG(_jax_instance(skel, data, b),
                                      JS.u1_xxz_mpo(1.0, 1.0, 0.1, N))
        e_solo = solo.run_two_site(max_bond_dim=16, num_sweeps=4,
                                   num_krylov_vecs=20)
        np.testing.assert_allclose(es[b], e_solo, rtol=1e-9)


def test_float32_after_precompile_is_variational():
    skel, data = _skeleton(12, 5, torch.float32)
    mpo = TS.u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float32,
                        device="cpu")
    d = BatchedSymmetricDMRG(skel, data, mpo)
    assert d.precompile() > 0
    plans = len(TE._PLAN_CACHE)
    es = d.run_one_site(num_sweeps=3)
    assert len(TE._PLAN_CACHE) == plans
    assert d.data[0].dtype == torch.float32 and es.dtype == np.float32
    exact = sector_ground_energy(N, 1.0, 1.0, 0.0, N // 2)
    assert np.all(es >= exact - 1e-5) and np.all(es <= exact + 1e-2)


def test_multi_device_options_name_their_queue_item():
    skel, data = _skeleton(8, 6)
    mpo = TS.u1_xxz_mpo(1.0, 1.0, 0.0, N, device="cpu")
    # the multi-device options run on a process group (none here) and keep
    # the JAX class's checks
    for kw in (dict(mesh=object()), dict(ep_mesh=object()),
               dict(ep_mesh=object(), ep_capacity=True)):
        with pytest.raises(RuntimeError, match="process group"):
            BatchedSymmetricDMRG(skel, data, mpo, **kw)
    with pytest.raises(ValueError, match="requires ep_mesh"):
        BatchedSymmetricDMRG(skel, data, mpo, ep_capacity=True)
    with pytest.raises(ValueError, match="not both"):
        BatchedSymmetricDMRG(skel, data, mpo, mesh=object(),
                             ep_mesh=object())


def test_power_ritz_keeps_a_converged_vector():
    # the first local solve of the float32 run above: on this 2x2
    # projection the steepest-descent step's residual is rounding noise
    # with h = 0 and mu = lam exactly, a zero step (the JAX package's
    # rounding misses it); the vector must stay put, not become zero
    import jax.numpy as jnp
    from tensornetwork_tpu.ops import krylov as JK
    from tensornetwork_tpu_torch.ops import krylov as TK
    a = np.array([-0.7061787843704224, -1.6161364316940308], np.float32)
    b = np.array([0.1387786865234375], np.float32)
    lam, w = TK.tridiag_ritz(torch.from_numpy(a)[None],
                             torch.from_numpy(b)[None], "power")
    jlam, jw = JK.tridiag_ritz(jnp.asarray(a), jnp.asarray(b), "power")
    np.testing.assert_allclose(lam.numpy()[0], np.asarray(jlam), rtol=1e-6)
    np.testing.assert_allclose(np.abs(w.numpy()[0]), np.abs(np.asarray(jw)),
                               atol=1e-6)
    exact = np.linalg.eigvalsh(np.diag(a.astype(np.float64))
                               + np.diag(b, 1) + np.diag(b, -1))[0]
    assert abs(float(lam[0]) - exact) < 1e-6
