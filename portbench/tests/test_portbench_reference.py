"""The reference: the Hamiltonian files' MPOs and exact energies, float64
MPS energies, the plain sweep, and the frozen operation count."""
import numpy as np
import pytest
import torch

from portbench.core import work
from portbench.reference import models, mps, sweep
from portbench.reference.hamiltonians import ff2d, tfi, xxz


def test_exact_open_tfi_energy_n32():
    assert abs(tfi.tfi_exact_energy(32, 1.0, 1.0)
               - (-40.384313161218486)) < 1e-9


@pytest.mark.parametrize("N,Jx,Bz", [(10, 1.0, 1.0), (9, 0.7, 1.3)])
def test_free_fermions_equal_dense_diagonalisation(N, Jx, Bz):
    Ws, vL, vR = tfi.tfi_mpo(N, Jx, Bz)
    assert abs(models.ground_energy(Ws, vL, vR)
               - tfi.tfi_exact_energy(N, Jx, Bz)) < 1e-9


@pytest.mark.parametrize("N1,N2,particles", [(2, 3, None), (3, 2, None),
                                              (2, 3, 2), (3, 2, 4)])
def test_ff2d_exact_energy_equals_dense_diagonalisation(N1, N2, particles):
    """The closed-form band's negative (or ``particles`` lowest) energies
    against the MPO's dense matrix, in all of Fock space or in the sector
    with that many fermions; and the band against the eigenvalues of the
    single-particle matrix built from the MPO's bond list."""
    t1, t2, mu = 1.0, 0.7, 0.2
    Ws, vL, vR = ff2d.ff2d_mpo(N1, N2, t1, t2, mu)
    eps = ff2d.band(N1, N2, t1, t2, mu)
    exact = ff2d.filled_energy(eps, particles)
    assert abs(models.ground_energy(Ws, vL, vR, sector=particles)
               - exact) < 1e-12
    h = -mu * np.eye(N1 * N2)
    for i, j, amp in ff2d.hoppings(N1, N2, t1, t2):
        h[i, j] += amp
        h[j, i] += amp
    assert np.abs(np.linalg.eigvalsh(h) - eps).max() < 1e-12
    if particles is None:
        cfg = {"N1": N1, "N2": N2, "N": N1 * N2, "t1": t1, "t2": t2,
               "mu": mu}
        assert ff2d.exact_energy(cfg) == exact


@pytest.mark.parametrize("N1,N2", [(2, 3), (3, 2), (1, 4), (2, 2)])
def test_ff2d_equals_the_ports_free_fermion_mpo(N1, N2):
    """The reference's MPO, written with its own channel layout, and the
    port's ``FiniteFreeFermion2D`` give one dense Hamiltonian; both carry
    M = 4 N2 channels on a strip of two rows or more."""
    from tensornetwork_tpu_torch import FiniteFreeFermion2D
    t1, t2, mu = 1.0, 0.7, 0.2
    Ws, vL, vR = ff2d.ff2d_mpo(N1, N2, t1, t2, mu)
    port = FiniteFreeFermion2D(t1, t2, mu, N1, N2, dtype=torch.float64,
                               device="cpu")
    assert Ws.shape == tuple(port.Ws.shape)
    if N1 > 1:
        assert Ws.shape[1] == 4 * N2
    H = models.dense_hamiltonian(Ws, vL, vR)
    Hp = models.dense_hamiltonian(*(a.numpy() for a in (port.Ws, port.vL,
                                                        port.vR)))
    assert np.abs(H - Hp).max() < 1e-12
    assert ff2d.ff2d_mpo(2, 6, t1, t2, mu)[0].shape[1] == 24


def _dense_state(sites):
    """The 2^N amplitudes of one instance, trace boundaries summed
    (returned as the density's diagonal blocks: the list of psi_{ab})."""
    cur = sites[0][0]                          # (l, d, r)
    for A in sites[1:]:
        cur = torch.einsum("lxr,rds->lxds", cur, A[0])
        cur = cur.reshape(cur.shape[0], -1, cur.shape[-1])
    return cur                                 # (l, 2^N, r)


@pytest.mark.parametrize("model", ["tfi", "xxz", "ff2d"])
def test_mps_energy_equals_dense_expectation(model):
    N, chi = 6, 3
    g = torch.Generator().manual_seed(4)
    sites = [torch.randn((1, chi, 2, chi), generator=g, dtype=torch.float64)
             for _ in range(N)]
    if model == "tfi":
        Ws, vL, vR = tfi.tfi_mpo(N, 0.9, 1.1)
    elif model == "xxz":
        Ws, vL, vR = xxz.xxz_mpo(N, 1.1, 1.0, 0.3)
    else:
        Ws, vL, vR = ff2d.ff2d_mpo(2, 3, 1.0, 0.7, 0.2)
    H = torch.as_tensor(models.dense_hamiltonian(Ws, vL, vR))
    psi = _dense_state(sites)                  # (l, n, r)
    num = torch.einsum("lnr,nm,lmr->", psi, H, psi)
    den = torch.einsum("lnr,lnr->", psi, psi)
    e = mps.energies(sites, Ws, vL, vR)
    assert abs(float(e[0]) - float(num / den)) < 1e-10


def test_plain_sweep_reaches_the_ground_energy():
    N, chi, B = 8, 16, 2
    g = torch.Generator().manual_seed(7)
    sites = [torch.randn((B, 1 if i == 0 else chi, 2, 1 if i == N - 1
                          else chi), generator=g, dtype=torch.float64)
             for i in range(N)]
    # open-chain bond dims 1, 2, 4, 8, 16, 8, 4, 2, 1
    dims = [min(2 ** k, 2 ** (N - k), chi) for k in range(N + 1)]
    sites = [torch.randn((B, dims[i], 2, dims[i + 1]), generator=g,
                         dtype=torch.float64) for i in range(N)]
    Ws, vL, vR = (torch.as_tensor(a) for a in tfi.tfi_mpo(N, 1.0, 1.0))
    R = None
    for _ in range(4):
        sites, e, R = sweep.one_site_sweep(sites, Ws, vL, vR, 10, R)
    exact = tfi.tfi_exact_energy(N, 1.0, 1.0)
    assert torch.allclose(e, torch.full_like(e, exact), atol=1e-9)
    assert torch.allclose(mps.energies(sites, Ws, vL, vR), e, atol=1e-9)
    assert float(mps.right_canonical_error(sites).max()) < 1e-12


@pytest.mark.parametrize("jzs", [(1.0, 0.5, 1.5)])
def test_reference_ground_energies_equal_the_half_filled_sector(jzs):
    """The float64 ground energies that the XXZ cell is held to: per
    instance, exact at a bond that holds the whole chain, the ground
    energy of the half-filled sector that the program works in."""
    N = 10
    mpos = [xxz.xxz_mpo(N, jz, 1.0, 0.0) for jz in jzs]
    Ws = torch.as_tensor(np.stack([m[0] for m in mpos]))
    vL, vR = (torch.as_tensor(a) for a in mpos[0][1:])
    e = sweep.ground_energies(Ws, vL, vR, len(jzs), 2, 32, 5, 10)
    for (W, l, r), got in zip(mpos, e.tolist()):
        assert abs(got - models.ground_energy(W, l, r, sector=N // 2)) < 1e-9
        assert abs(got - models.ground_energy(W, l, r)) < 1e-9
    # a smaller bond gives an upper bound
    e8 = sweep.ground_energies(Ws, vL, vR, len(jzs), 2, 8, 5, 10)
    assert bool((e8 >= e - 1e-12).all()) and float((e8 - e).max()) > 0


def test_frozen_sweep_count_by_hand():
    # N=32, chi=64, d=2, M=3, m=10: a matvec 2 (2 64^3 2 3 + 64^2 4 9)
    mv = 2 * (2 * 262144 * 6 + 4096 * 36)
    assert work.matvec_flops(64, 2, 3) == mv == 6586368
    per_site = 10 * mv + mv + 4 * 128 * 4096
    assert work.sweep_flops(32, 64, 2, 3, 10) == 64 * per_site == 4771020800
    f, b = work.solve_work(1, 64, 2, 3, 10)
    assert f == 10 * (mv + 10 * 8192)
    assert b == 4 * (6 * 4096 + 8192 * 2 + 36)
    assert work.least_seconds(f, b, 495e12, 3.35e12)[1] == "operations"
