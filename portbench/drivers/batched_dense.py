"""Batched dense one-site DMRG: ``parallel.batch.batched_one_site_sweep``
with its defaults (polar gauge, power Ritz, the default epilogue), B
instances of one MPO, chained sweeps from the returned environments.  The
MPO is the one the configuration's ``program_mpo`` names: a public builder
of the port, called with the configuration's values of the keys it
lists."""
from __future__ import annotations

import torch

from portbench.core import inputs as gen
from portbench.core import work


def _mpo(cfg: dict, dtype, device):
    import tensornetwork_tpu_torch
    spec = cfg["program_mpo"]
    builder = getattr(tensornetwork_tpu_torch, spec["builder"])
    mpo = builder(**{k: cfg[k] for k in spec["args"]}, dtype=dtype,
                  device=device)
    if mpo.Ws.shape[0] != cfg["N"]:
        raise ValueError(f"{spec['builder']} gave {mpo.Ws.shape[0]} sites "
                         f"for a state of N = {cfg['N']}")
    return mpo


def inputs(cfg: dict, wl: dict, seed: int, device) -> dict:
    """The random start of every instance, and no per-instance
    couplings."""
    dtype = getattr(torch, cfg["dtype"])
    sites = gen.random_stack(seed, wl["batch"], cfg["N"], wl["chi"],
                             cfg["d"], dtype, device)
    return {"sites": sites, "params": {}}


class State:
    def __init__(self, As, mpo, m):
        self.As, self.mpo, self.m = As, mpo, m
        self.renvs = None
        self.energy = None


def _sweep(st: State) -> None:
    from tensornetwork_tpu_torch.parallel.batch import batched_one_site_sweep
    res = batched_one_site_sweep(st.As, st.mpo.Ws, st.mpo.vL, st.mpo.vR,
                                 num_krylov_vecs=st.m, renvs=st.renvs)
    st.As, st.renvs, st.energy = res.As, res.renvs, res.energy


def setup(cfg: dict, wl: dict, seed: int, device) -> State:
    """Inputs, the MPO, then the right-canonicalising first sweep (the
    warm sweep), synchronised."""
    inp = inputs(cfg, wl, seed, device)
    st = State(inp["sites"], _mpo(cfg, inp["sites"].dtype, device),
               wl["krylov"])
    _sweep(st)
    return st


def sweep(st: State) -> None:
    """One chained sweep of the window."""
    _sweep(st)


def outputs(st: State) -> dict:
    """The returned state and energies of the last sweep; the rest of the
    program's state is dropped."""
    out = {"sites": st.As, "energy": st.energy, "params": {}}
    st.As = st.renvs = st.energy = st.mpo = None
    return out


def flops_per_sweep(cfg: dict, wl: dict) -> float:
    return float(wl["batch"] * work.sweep_flops(
        cfg["N"], wl["chi"], cfg["d"], cfg["mpo_bond"], wl["krylov"]))


def solve_work_per_sweep(cfg: dict, wl: dict):
    """(flops, bytes) of a sweep's 2N local solves."""
    f, b = work.solve_work(wl["batch"], wl["chi"], cfg["d"],
                           cfg["mpo_bond"], wl["krylov"])
    return 2 * cfg["N"] * f, 2 * cfg["N"] * b
