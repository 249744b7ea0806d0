"""Standalone netcon-style contraction-order solvers on log-adjacency
matrices.

Counterpart of :mod:`tensornetwork_tpu.contractors.custom_path_solvers`
(reference ``contractors/custom_path_solvers/pathsolvers.py:19-380`` and
``nconinterface.py:21-145``): greedy-by-size, greedy-by-cost, and a
branch-and-bound exhaustive search with cost pruning, plus ncon adapters.
Pure numpy on the host; the exact search of a network of 3 to 22 tensors
runs on the port's native solver (:mod:`tensornetwork_tpu_torch.native`).

Conventions:
  * ``log_adj`` is an (N, N) array; ``log_adj[i, j]`` (i != j) is log10 of
    the total dimension shared between tensors i and j, and
    ``log_adj[i, i]`` is log10 of the total open (free) dimension of
    tensor i.
  * An order is a (2, N-1) integer array of *current-list* index pairs
    (i < j): the contraction replaces position i and deletes position j.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _contract_rows(log_adj: np.ndarray, i: int, j: int) -> np.ndarray:
    """Merge tensors i and j of a log-adjacency matrix (i < j)."""
    n = log_adj.shape[0]
    keep = [k for k in range(n) if k != j]
    new = log_adj[np.ix_(keep, keep)].copy()
    # row/col i becomes the merged tensor: sums of connections
    for idx, k in enumerate(keep):
        if k in (i, j):
            continue
        new[keep.index(i), idx] = log_adj[i, k] + log_adj[j, k]
        new[idx, keep.index(i)] = new[keep.index(i), idx]
    # open dims of the merged tensor: both open dims stay open
    new[keep.index(i), keep.index(i)] = log_adj[i, i] + log_adj[j, j]
    return new


def _pair_cost(log_adj: np.ndarray, i: int, j: int) -> float:
    """log10 cost of contracting pair (i, j): product of all involved dims."""
    n = log_adj.shape[0]
    ti = log_adj[i, i] + sum(log_adj[i, k] for k in range(n) if k != i)
    tj = log_adj[j, j] + sum(log_adj[j, k] for k in range(n) if k != j)
    return ti + tj - log_adj[i, j]


def _result_size(log_adj: np.ndarray, i: int, j: int) -> float:
    n = log_adj.shape[0]
    ti = log_adj[i, i] + sum(log_adj[i, k] for k in range(n) if k != i)
    tj = log_adj[j, j] + sum(log_adj[j, k] for k in range(n) if k != j)
    return ti + tj - 2 * log_adj[i, j]


def _log10_sum(costs: Sequence[float]) -> float:
    """log10 of a sum of 10**cost terms, stably."""
    if not costs:
        return 0.0
    m = max(costs)
    return m + np.log10(sum(10.0 ** (c - m) for c in costs))


def greedy_size_solve(log_adj: np.ndarray) -> Tuple[np.ndarray, float]:
    """Greedily contract the pair with the smallest result tensor
    (reference ``pathsolvers.py:19``).  Returns (order, log10 total cost)."""
    log_adj = np.asarray(log_adj, dtype=float).copy()
    n = log_adj.shape[0]
    order = []
    costs = []
    while log_adj.shape[0] > 1:
        m = log_adj.shape[0]
        best = None
        for i, j in itertools.combinations(range(m), 2):
            connected = log_adj[i, j] > 0
            key = (not connected, _result_size(log_adj, i, j),
                   _pair_cost(log_adj, i, j))
            if best is None or key < best[0]:
                best = (key, (i, j))
        (i, j) = best[1]
        costs.append(_pair_cost(log_adj, i, j))
        order.append((i, j))
        log_adj = _contract_rows(log_adj, i, j)
    return np.array(order, dtype=int).T.reshape(2, -1), _log10_sum(costs)


def greedy_cost_solve(log_adj: np.ndarray) -> Tuple[np.ndarray, float]:
    """Greedily contract the cheapest pair (reference
    ``pathsolvers.py:91``)."""
    log_adj = np.asarray(log_adj, dtype=float).copy()
    order = []
    costs = []
    while log_adj.shape[0] > 1:
        m = log_adj.shape[0]
        best = None
        for i, j in itertools.combinations(range(m), 2):
            connected = log_adj[i, j] > 0
            key = (not connected, _pair_cost(log_adj, i, j),
                   _result_size(log_adj, i, j))
            if best is None or key < best[0]:
                best = (key, (i, j))
        (i, j) = best[1]
        costs.append(_pair_cost(log_adj, i, j))
        order.append((i, j))
        log_adj = _contract_rows(log_adj, i, j)
    return np.array(order, dtype=int).T.reshape(2, -1), _log10_sum(costs)


def full_solve_complete(
    log_adj: np.ndarray,
    cost_bound: Optional[float] = None,
    max_branch: Optional[int] = None,
) -> Tuple[np.ndarray, float, bool]:
    """Branch-and-bound exhaustive search with cost pruning and an optional
    beam width (reference ``pathsolvers.py:146-380``).

    Returns ``(order, log10 cost, is_optimal)``; ``is_optimal`` is False
    when the beam (``max_branch``) may have pruned the optimum.
    """
    log_adj0 = np.asarray(log_adj, dtype=float)
    n = log_adj0.shape[0]
    if n == 1:
        return np.zeros((2, 0), dtype=int), 0.0, True
    if max_branch is None and cost_bound is None and 2 < n <= 22:
        # exact optimum from the native DP scheduler (C++, subsets DP —
        # reaches n~20 where the Python branch-and-bound stops at ~8)
        from tensornetwork_tpu_torch import native
        merges, cost = native.optimal_order_masks(log_adj0)
        return native.masks_to_index_pairs(merges, n), cost, True
    # initial upper bound from greedy
    g_order, g_cost = greedy_cost_solve(log_adj0)
    best_cost = g_cost if cost_bound is None else min(g_cost, cost_bound)
    best_order = g_order
    is_optimal = True

    # frontier: list of (costs_so_far(list), order_so_far, log_adj)
    frontier = [([], [], log_adj0)]
    for step in range(n - 1):
        new_frontier = []
        for costs, order, adj in frontier:
            m = adj.shape[0]
            for i, j in itertools.combinations(range(m), 2):
                if m > 2 and adj[i, j] <= 0:
                    continue  # skip outer products unless forced
                c = costs + [_pair_cost(adj, i, j)]
                total = _log10_sum(c)
                if total > best_cost + 1e-12:
                    continue
                new_frontier.append((c, order + [(i, j)],
                                     _contract_rows(adj, i, j)))
        if not new_frontier:
            break
        if max_branch is not None and len(new_frontier) > max_branch:
            new_frontier.sort(key=lambda t: _log10_sum(t[0]))
            new_frontier = new_frontier[:max_branch]
            is_optimal = False
        frontier = new_frontier
        for costs, order, adj in frontier:
            if adj.shape[0] == 1:
                total = _log10_sum(costs)
                if total < best_cost:
                    best_cost = total
                    best_order = np.array(order, dtype=int).T.reshape(2, -1)
    return best_order, best_cost, is_optimal


# ---------------------------------------------------------------------------
# ncon adapters (reference ``custom_path_solvers/nconinterface.py``)
# ---------------------------------------------------------------------------


def ncon_to_adj(tensors: Sequence, labels: Sequence[Sequence[int]]
                ) -> np.ndarray:
    """Network → log10 adjacency matrix (reference
    ``nconinterface.py:48``)."""
    n = len(tensors)
    log_adj = np.zeros((n, n))
    dims = {}
    for t, labs in zip(tensors, labels):
        for l, d in zip(labs, np.shape(t)):
            dims[l] = d
    for i in range(n):
        for l in labels[i]:
            if l < 0:
                log_adj[i, i] += np.log10(dims[l])
            else:
                holders = [k for k in range(n) if l in labels[k]]
                for k in holders:
                    if k != i:
                        log_adj[i, k] += np.log10(dims[l])
    # each shared label was added once per (i, k) directed pair -> symmetric
    return log_adj


def ord_to_ncon(labels: Sequence[Sequence[int]],
                orders: np.ndarray) -> np.ndarray:
    """Pair order → ncon con_order (reference ``nconinterface.py:84``)."""
    pools = [set(l) for l in labels]
    con_order: List[int] = []
    orders = np.asarray(orders, dtype=int).reshape(2, -1)
    for (i, j) in orders.T:
        shared = {l for l in (pools[i] & pools[j]) if l > 0}
        rest = set().union(*(p for k, p in enumerate(pools)
                             if k not in (i, j))) if len(pools) > 2 else set()
        contracted = sorted(shared - rest)
        con_order.extend(contracted)
        new_pool = (pools[i] | pools[j]) - set(contracted)
        pools = [p for k, p in enumerate(pools) if k not in (i, j)]
        pools.insert(min(i, j), new_pool)
    all_pos = sorted({l for labs in labels for l in labs if l > 0})
    for l in all_pos:
        if l not in con_order:
            con_order.append(l)
    return np.array(con_order, dtype=int)


def ncon_solver(tensors: Sequence, labels: Sequence[Sequence[int]],
                max_branch: Optional[int] = None):
    """Solve for an optimal-ish ncon contraction order (reference
    ``nconinterface.py:21``).  Returns (con_order, log10 cost, is_optimal)."""
    log_adj = ncon_to_adj(tensors, labels)
    order, cost, is_optimal = full_solve_complete(log_adj,
                                                  max_branch=max_branch)
    con_order = ord_to_ncon(labels, order)
    return con_order, cost, is_optimal


def ncon_cost_check(tensors: Sequence, labels: Sequence[Sequence[int]],
                    con_order: Sequence[int]) -> float:
    """log10 FLOP cost of a given con_order (reference
    ``nconinterface.py:124``)."""
    from tensornetwork_tpu_torch.ops.ncon import compile_plan
    structure = tuple(tuple(int(x) for x in l) for l in labels)
    plan = compile_plan(structure, tuple(int(x) for x in con_order), None)
    shapes = [tuple(np.shape(t)) for t in tensors]
    flops = plan.flops(shapes)
    return float(np.log10(max(flops / 2.0, 1.0)))
