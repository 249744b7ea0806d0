"""The comparison that decides ``correct``.

From the program's outputs of the window's last sweep -- the returned
state and the energies it returned -- the reference works out in float64,
with its own MPO of the configuration's Hamiltonian:

  ritz_gap   |E_returned - <psi|H|psi>/<psi|psi>| of the returned state:
             the last local solve's energy is the returned state's only
             when the solve, the environments it used and the gauge that
             left the other sites canonical are all right;
  excess     <psi|H|psi>/<psi|psi> - E_ground of each instance: the sweeps
             reached the ground state.  E_ground is exact where the
             model's Hamiltonian file gives a closed form; else, where
             the workload names a ``reference`` (bond ``chi``, ``sweeps``,
             ``krylov``), the float64 energy of the plain sweep on the
             instance's own Hamiltonian from its own start, an upper
             bound on the exact one that takes nothing from the program;
  gauge_err  max |sum_s A_s A_s^T - I| over sites 1..N-1 (printed; it is
             compared only where the workload gives it a limit).

Each is the widest over the instances.  A number is compared where the
workload's ``limits`` gives it a limit; an instance fails when one of its
compared numbers is above its limit or not a number.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import models, mps, sweep


def instance_mpos(cfg: dict, params: dict, B: int, device):
    """(Ws, vL, vR) float64 on ``device``: shared (N, ...) where every
    instance has the same couplings, else (B, N, ...)."""
    if not params:
        Ws, vL, vR = models.mpo(cfg)
    else:
        mpos = [models.mpo(cfg, params, b) for b in range(B)]
        Ws = np.stack([w for w, _, _ in mpos])
        vL, vR = mpos[0][1], mpos[0][2]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return as_t(Ws), as_t(vL), as_t(vR)


def ground(cfg: dict, wl: dict, Ws, vL, vR, B: int):
    """E_ground: a float, (B,) float64, or None where neither a closed
    form nor a ``reference`` gives one."""
    exact = models.exact_energy(cfg)
    if exact is not None or "reference" not in wl:
        return exact
    r = wl["reference"]
    return sweep.ground_energies(Ws, vL, vR, B, cfg["d"], r["chi"],
                                 r["sweeps"], r["krylov"])


def numbers(cfg: dict, wl: dict, outputs: dict) -> Dict[str, torch.Tensor]:
    """Per-instance numbers (B,) of the program's outputs."""
    sites = mps.sites_of(outputs["sites"])
    B, dev = sites[0].shape[0], sites[0].device
    Ws, vL, vR = instance_mpos(cfg, outputs.get("params", {}), B, dev)
    E = mps.energies(sites, Ws, vL, vR)
    out = {"ritz_gap": (outputs["energy"].to(torch.float64) - E).abs()}
    e0 = ground(cfg, wl, Ws, vL, vR, B)
    if e0 is not None:
        out["excess"] = E - e0
        out["ground"] = torch.as_tensor(e0, dtype=torch.float64,
                                        device=dev).expand(B)
    out["gauge_err"] = mps.right_canonical_error(sites)
    out["energy"] = E
    return out


def judge(cfg: dict, wl: dict, outputs: dict
          ) -> Tuple[List[Tuple[str, float, float]], int, int, dict]:
    """(checks [(name, widest value, limit)], instances attempted,
    instances failed, the numbers not compared)."""
    nums = numbers(cfg, wl, outputs)
    limits = wl.get("limits", {})
    B = int(nums["ritz_gap"].shape[0])
    bad = torch.zeros(B, dtype=torch.bool, device=nums["ritz_gap"].device)
    checks = []
    for name, limit in limits.items():
        v = nums[name]
        bad |= ~(v <= limit)
        checks.append((name, float(v.max()), float(limit)))
    info = {k: float(v.max()) for k, v in nums.items()
            if k not in limits and k not in ("energy", "ground")}
    for k in ("energy", "ground"):
        if k in nums:
            info[k + "_min"] = float(nums[k].min())
            info[k + "_max"] = float(nums[k].max())
    return checks, B, int(bad.sum()), info
