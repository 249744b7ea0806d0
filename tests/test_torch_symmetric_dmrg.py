"""The port's U(1)-symmetric DMRG (``SymmetricFiniteDMRG``) against the JAX
package's numpy engine, on the CPU at N = 6, chi = 8.

Both packages get the same MPO and the same seeded random MPS (their
constructors draw from one numpy generator).  The JAX numpy engine is the
witness: every sweep's energy of the port's two engines ("numpy", the
per-sector loop, and "device", the bucketed executor) agrees with it to
1e-9 relative in float64, one- and two-site; a float32 run stays above the
sector's exact ground energy less 1e-5.
"""
import itertools

import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import symmetric_dmrg as JS
from tensornetwork_tpu_torch.models import symmetric_dmrg as TS

N, CHI = 6, 8


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def sector_ground_energy(n, Jz, Jxy, Bz, n_up):
    """Exact ground energy of the XXZ chain in the sector of n_up up
    spins, from the dense Hamiltonian."""
    from tensornetwork_tpu_torch.models.mpo import FiniteXXZ, mpo_to_dense
    H = np.asarray(mpo_to_dense(FiniteXXZ(Jz, Jxy, Bz, n, device="cpu")))
    idx = [i for i in range(2 ** n) if bin(i).count("1") == n_up]
    return float(np.linalg.eigvalsh(H[np.ix_(idx, idx)])[0])


def test_u1_xxz_mpo_matches_jax_bit_for_bit():
    for j, t in zip(JS.u1_xxz_mpo(1.0, 0.7, 0.2, 5),
                    TS.u1_xxz_mpo(1.0, 0.7, 0.2, 5, device="cpu")):
        np.testing.assert_array_equal(j.data, t.data.numpy())
        assert t.flat_flows == j.flat_flows
        for a, b in zip(j.flat_charges, t.flat_charges):
            np.testing.assert_array_equal(a.charges, b.charges)
    w = TS.u1_xxz_mpo(1.0, 1.0, 0.0, 4, dtype=torch.float32, device="cpu")
    assert all(t.dtype == torch.float32 for t in w)


def test_half_filled_mps_matches_jax_bit_for_bit():
    for j, t in zip(JS.half_filled_mps(N, CHI, seed=3),
                    TS.half_filled_mps(N, CHI, seed=3, device="cpu")):
        np.testing.assert_array_equal(j.data, t.data.numpy())
        np.testing.assert_array_equal(j.flat_charges[2].charges,
                                      t.flat_charges[2].charges)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX numpy engine's sweeps: one-site (XXZ, seed 1) and two-site
    (Bz = 0.1, seed 2, bond cap 12)."""
    one = JS.SymmetricFiniteDMRG(JS.half_filled_mps(N, CHI, seed=1),
                                 JS.u1_xxz_mpo(1.0, 1.0, 0.0, N))
    one.run_one_site(num_sweeps=3, num_krylov_vecs=20)
    two = JS.SymmetricFiniteDMRG(JS.half_filled_mps(N, CHI, seed=2),
                                 JS.u1_xxz_mpo(1.0, 1.0, 0.1, N))
    two.run_two_site(max_bond_dim=12, num_sweeps=3, num_krylov_vecs=20)
    return dict(one=one.energies, two=two.energies)


@pytest.mark.parametrize("engine,sites", itertools.product(
    ("numpy", "device"), ("one", "two")))
def test_energies_match_the_jax_numpy_engine(jax_runs, engine, sites):
    if sites == "one":
        d = TS.SymmetricFiniteDMRG(
            TS.half_filled_mps(N, CHI, seed=1, device="cpu"),
            TS.u1_xxz_mpo(1.0, 1.0, 0.0, N, device="cpu"), engine=engine)
        d.run_one_site(num_sweeps=3, num_krylov_vecs=20)
    else:
        d = TS.SymmetricFiniteDMRG(
            TS.half_filled_mps(N, CHI, seed=2, device="cpu"),
            TS.u1_xxz_mpo(1.0, 1.0, 0.1, N, device="cpu"), engine=engine)
        d.run_two_site(max_bond_dim=12, num_sweeps=3, num_krylov_vecs=20)
    want = jax_runs[sites]
    assert len(d.energies) == len(want)
    np.testing.assert_allclose(d.energies, want, rtol=1e-9)
    assert all(t.device.type == "cpu" for t in d.mps)
    if sites == "two":
        # converged two-site: the sector's exact ground energy
        exact = sector_ground_energy(N, 1.0, 1.0, 0.1, N // 2)
        assert abs(d.energies[-1] - exact) < 1e-8


def test_float32_stays_variational():
    d = TS.SymmetricFiniteDMRG(
        TS.half_filled_mps(N, CHI, seed=2, dtype=torch.float32,
                           device="cpu"),
        TS.u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float32, device="cpu"),
        engine="device")
    e = d.run_two_site(max_bond_dim=12, num_sweeps=3)
    exact = sector_ground_energy(N, 1.0, 1.0, 0.0, N // 2)
    assert d.mps[0].dtype == torch.float32
    assert exact - 1e-5 <= e <= exact + 1e-4


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        TS.SymmetricFiniteDMRG(
            TS.half_filled_mps(4, 4, device="cpu"),
            TS.u1_xxz_mpo(1.0, 1.0, 0.0, 4, device="cpu"), engine="jax")
