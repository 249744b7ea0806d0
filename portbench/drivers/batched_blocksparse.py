"""Batched U(1) block-sparse one-site DMRG:
``models.symmetric_dmrg_batched.BatchedSymmetricDMRG(...).sweep_one_site``
after ``precompile()`` and ``right_canonicalize()``, B realizations of the
XXZ chain on one charge skeleton, each with its own Jz."""
from __future__ import annotations

import torch

from portbench.core import inputs as gen


def _skeleton(cfg: dict, wl: dict, device):
    from tensornetwork_tpu_torch.blocksparse import batched
    return batched.uniform_skeleton_mps(cfg["N"], wl["chi"],
                                        dtype=getattr(torch, cfg["dtype"]),
                                        device=device)


def _positions(skel):
    """Row-major dense position of each stored entry of a site."""
    from tensornetwork_tpu_torch.blocksparse.tensor import BlockSparseTensor
    n = skel.data.shape[0]
    probe = BlockSparseTensor(
        torch.arange(1, n + 1, dtype=torch.float64, device=skel.data.device),
        skel.flat_charges, skel.flat_flows, [[i] for i in range(skel.ndim)])
    flat = probe.todense().reshape(-1)
    pos = torch.nonzero(flat).reshape(-1)
    lin = torch.empty(n, dtype=torch.long, device=flat.device)
    lin[flat[pos].long() - 1] = pos
    return lin, tuple(skel.shape)


def dense_sites(skeleton, data):
    """The program's (B, nnz) stacks as dense (B, chi_l, d, chi_r)."""
    out = []
    for skel, d in zip(skeleton, data):
        lin, shape = _positions(skel)
        x = torch.zeros((d.shape[0], int(torch.tensor(shape).prod())),
                        dtype=d.dtype, device=d.device)
        x[:, lin] = d
        out.append(x.reshape((d.shape[0],) + shape))
    return out


def _data(cfg: dict, wl: dict, seed: int, skel):
    dtype = getattr(torch, cfg["dtype"])
    dev = skel[0].data.device
    data = gen.random_flat(seed, wl["batch"],
                           [s.data.shape[0] for s in skel], dtype, dev)
    lo, hi = cfg["Jz_range"]
    jz = gen.couplings(seed, wl["batch"], lo, hi, cfg["Jz"])
    return data, jz


def inputs(cfg: dict, wl: dict, seed: int, device) -> dict:
    """The random start of every realization, dense, and its Jz."""
    skel = _skeleton(cfg, wl, device)
    data, jz = _data(cfg, wl, seed, skel)
    return {"sites": dense_sites(skel, data), "params": {"Jz": jz}}


class State:
    pass


def setup(cfg: dict, wl: dict, seed: int, device) -> State:
    """Inputs and per-realization MPO data, the solver, its plan build,
    the right-canonicalising prepass and one warm sweep."""
    from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    st = State()
    st.skeleton = _skeleton(cfg, wl, device)
    data, st.jz = _data(cfg, wl, seed, st.skeleton)
    N, dtype = cfg["N"], getattr(torch, cfg["dtype"])
    # the MPO's data is linear in Jz: W(Jz) = W(0) + Jz (W(1) - W(0))
    w0, w1 = (u1_xxz_mpo(j, cfg["Jxy"], cfg["Bz"], N, dtype=torch.float64,
                         device=device) for j in (0.0, 1.0))
    jz = torch.as_tensor(st.jz, dtype=torch.float64, device=device)[:, None]
    mpo_data = [(a.data[None] + jz * (b.data - a.data)[None]).to(dtype)
                for a, b in zip(w0, w1)]
    mpo = u1_xxz_mpo(cfg["Jz"], cfg["Jxy"], cfg["Bz"], N, dtype=dtype,
                     device=device)
    st.solver = BatchedSymmetricDMRG(st.skeleton, data, mpo,
                                     mpo_data=mpo_data,
                                     num_krylov_vecs=wl["krylov"])
    st.plan_s = st.solver.precompile()
    st.R = st.solver.right_canonicalize()
    st.energy = st.solver.sweep_one_site(st.R)
    return st


def sweep(st: State) -> None:
    """One chained sweep of the window."""
    st.energy = st.solver.sweep_one_site(st.R)


def outputs(st: State) -> dict:
    """The returned state (dense) and energies of the last sweep; the
    solver is dropped."""
    st.R = None
    out = {"sites": dense_sites(st.skeleton, st.solver.data),
           "energy": st.energy, "params": {"Jz": st.jz}}
    st.solver = st.energy = None
    return out
