"""#SAT model counting as a tensor network of COPY tensors, on the port's
graph core (counterpart of ``examples/sat.py``; reference
``examples/sat/sat_tensornetwork.py:46-110``): each variable is a COPY
node over its occurrences, each 3-SAT clause a (2,2,2) tensor that is 0
only on its single violating assignment; the full contraction counts the
satisfying assignments.

    python -m tensornetwork_tpu_torch.examples.sat [--cpu]
"""
import argparse
from typing import Optional

import numpy as np
import torch

import tensornetwork_tpu_torch as tn
from tensornetwork_tpu_torch.config import Device, default_device


def sat_count(clauses, device: Optional[Device] = None) -> int:
    """Count satisfying assignments of a 3-SAT formula (float64 on
    ``device``).

    ``clauses``: list of 3-tuples of nonzero ints; positive k means
    variable k, negative means its negation (DIMACS-style).
    """
    device = default_device(device)
    variables = sorted({abs(l) for c in clauses for l in c})
    occurrences = {v: 0 for v in variables}
    for c in clauses:
        for l in c:
            occurrences[abs(l)] += 1
    copy_nodes = {}
    next_axis = {}
    for v in variables:
        rank = max(occurrences[v], 1)
        if rank == 1:
            # single occurrence: a vector of ones acts as the sum over
            # the variable
            copy_nodes[v] = tn.Node(torch.ones(2, dtype=torch.float64,
                                               device=device), name=f"x{v}")
        else:
            copy_nodes[v] = tn.CopyNode(rank=rank, dimension=2,
                                        name=f"x{v}", device=device)
        next_axis[v] = 0
    clause_nodes = []
    for i, c in enumerate(clauses):
        t = np.ones((2, 2, 2))
        # the single violating assignment: every literal false
        idx = tuple(0 if l > 0 else 1 for l in c)
        t[idx] = 0.0
        node = tn.Node(torch.as_tensor(t, device=device), name=f"clause{i}")
        clause_nodes.append(node)
        for axis, l in enumerate(c):
            v = abs(l)
            node[axis] ^ copy_nodes[v][next_axis[v]]
            next_axis[v] += 1
    # free variables appearing in no clause each contribute a factor 2
    free_factor = 1
    all_nodes = list(copy_nodes.values()) + clause_nodes
    result = tn.contractors.greedy(all_nodes, ignore_edge_order=True)
    return int(round(float(result.tensor.real))) * free_factor


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    dev = "cpu" if ap.parse_args().cpu else None
    # (x1 or x2 or x3): 7 of 8 assignments satisfy
    assert sat_count([(1, 2, 3)], dev) == 7
    # unsatisfiable pair on overlapping variables
    n = sat_count([(1, 2, 3), (-1, -2, -3)], dev)
    print(f"counts: single clause = 7, pair = {n}")
