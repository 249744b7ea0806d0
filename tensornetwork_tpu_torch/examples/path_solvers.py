"""Contraction-order solving on the port (counterpart of
``examples/path_solvers.py``; reference analog:
``examples/custom_path_solvers/example.py``): greedy-size, greedy-cost
and branch-and-bound orders of a random ladder network, then the network
contracted in the solved order.

    python -m tensornetwork_tpu_torch.examples.path_solvers [--cpu]
"""
import argparse
from typing import Optional

import numpy as np
import torch

import tensornetwork_tpu_torch as tn
from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.contractors import custom_path_solvers as cps


def ladder_network(rng, rungs=4, chi=8, d=4):
    """Two rails of ``rungs`` tensors with rung couplings (numpy arrays
    drawn from ``rng``, and their ncon labels)."""
    tensors, labels = [], []
    lab = 1
    top_bonds = [lab + i for i in range(rungs - 1)]
    bot_bonds = [lab + 100 + i for i in range(rungs - 1)]
    rung_bonds = [lab + 200 + i for i in range(rungs)]
    for i in range(rungs):
        l = [top_bonds[i - 1]] if i > 0 else [-(i + 1)]
        r = [top_bonds[i]] if i < rungs - 1 else [-(rungs + 1)]
        labels.append(tuple(l + r + [rung_bonds[i]]))
        tensors.append(rng.standard_normal(
            tuple([chi if x > 0 else d for x in labels[-1][:-1]] + [d])))
    for i in range(rungs):
        l = [bot_bonds[i - 1]] if i > 0 else [-(2 * rungs + 2 + i)]
        r = [bot_bonds[i]] if i < rungs - 1 else [-(3 * rungs + 3)]
        labels.append(tuple(l + r + [rung_bonds[i]]))
        tensors.append(rng.standard_normal(
            tuple([chi if x > 0 else d for x in labels[-1][:-1]] + [d])))
    return tensors, labels


def main(device: Optional[Device] = None):
    """The three solvers on the seed-0 ladder, and its contraction in the
    branch-and-bound order on ``device`` (float64); returns that order's
    log10 cost."""
    device = default_device(device)
    rng = np.random.default_rng(0)
    tensors, labels = ladder_network(rng)
    adj = cps.ncon_to_adj(tensors, labels)
    for name, solver in (("greedy-size", cps.greedy_size_solve),
                         ("greedy-cost", cps.greedy_cost_solve)):
        order, cost = solver(adj)
        print(f"{name:12s}: log10 cost = {cost:.3f}")
    order, cost, is_optimal = cps.full_solve_complete(adj)
    print(f"{'optimal':12s}: log10 cost = {cost:.3f} "
          f"(proven optimal: {is_optimal})")
    con_order, cost2, _ = cps.ncon_solver(tensors, labels)
    result = tn.ncon([torch.as_tensor(t, device=device) for t in tensors],
                     labels, con_order=con_order.tolist())
    print(f"contracted with solved order: output shape "
          f"{tuple(result.shape)}")
    return cost


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    main(device="cpu" if ap.parse_args().cpu else None)
