"""Contraction-order driven contractors over Node networks.

Counterpart of :mod:`tensornetwork_tpu.contractors.path_contractors`
(reference ``contractors/opt_einsum_paths/path_contractors.py:36-403``):
``auto/greedy/optimal/branch/custom`` plus path-as-data
``path_solver``/``contract_path``.  Paths are solved on the host by the
port's own solvers (:mod:`tensornetwork_tpu_torch.ops.paths`); then each
pair is one ``contract_between``.  ``custom`` takes any callable with
opt_einsum's path-function signature, an opt_einsum ``PathOptimizer``
included where that package is installed; the port never imports it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from tensornetwork_tpu_torch.core.network import (
    AbstractNode, Edge, contract_between, get_all_edges)
from tensornetwork_tpu_torch.core.operations import get_subgraph_dangling
from tensornetwork_tpu_torch.ops import paths as _paths


def _sanitize(nodes, output_edge_order, ignore_edge_order):
    nodes = list(nodes)
    dangling = get_subgraph_dangling(nodes)
    if not ignore_edge_order:
        if output_edge_order is None:
            if len(dangling) > 1:
                raise ValueError(
                    "The final node after contraction has more than one "
                    "dangling edge; output_edge_order is required")
            output_edge_order = list(dangling)
        if set(output_edge_order) != set(dangling):
            raise ValueError("output_edge_order must match the subgraph's "
                             "dangling edges")
    return nodes, output_edge_order


def _contract_trace_edges(nodes: List[AbstractNode]) -> List[AbstractNode]:
    done = False
    while not done:
        done = True
        for n in nodes:
            if any(e.is_trace() for e in n.edges):
                new_node = contract_between(n, n)
                nodes = [x for x in nodes if x is not n] + [new_node]
                done = False
                break
    return nodes


def base(
    nodes: Sequence[AbstractNode],
    algorithm,
    output_edge_order: Optional[Sequence[Edge]] = None,
    ignore_edge_order: bool = False,
) -> AbstractNode:
    """Contract along an opt_einsum-style path (reference
    ``path_contractors.py:36``)."""
    nodes, output_edge_order = _sanitize(nodes, output_edge_order,
                                         ignore_edge_order)
    nodes = _contract_trace_edges(nodes)
    if len(nodes) == 1:
        node = nodes[0]
        if output_edge_order:
            node.reorder_edges(list(output_edge_order))
        return node
    input_sets = [{id(e) for e in n.edges} for n in nodes]
    output_set = {id(e) for e in get_subgraph_dangling(nodes)}
    size_dict = {id(e): e.dimension for e in get_all_edges(nodes)}
    path = _paths.get_pair_path(input_sets, output_set, size_dict, algorithm)
    for (i, j) in path:
        if i == j:
            continue
        a, b = nodes[i], nodes[j]
        new_node = contract_between(a, b, allow_outer_product=True)
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)]
        nodes.append(new_node)
    node = nodes[0]
    if output_edge_order:
        node.reorder_edges(list(output_edge_order))
    return node


def optimal(nodes, output_edge_order=None, memory_limit=None,
            ignore_edge_order=False):
    """(reference ``path_contractors.py:100``)"""
    return base(nodes, _paths.optimal, output_edge_order,
                ignore_edge_order)


def branch(nodes, output_edge_order=None, memory_limit=None, nbranch=None,
           ignore_edge_order=False):
    """(reference ``path_contractors.py:129``)"""
    if nbranch == 1:
        alg = _paths.branch_1
    elif nbranch == 2:
        alg = _paths.branch_2
    else:
        alg = _paths.branch_all
    return base(nodes, alg, output_edge_order, ignore_edge_order)


def greedy(nodes, output_edge_order=None, memory_limit=None,
           ignore_edge_order=False):
    """(reference ``path_contractors.py:165``)"""
    return base(nodes, _paths.greedy, output_edge_order,
                ignore_edge_order)


def auto(nodes, output_edge_order=None, memory_limit=None,
         ignore_edge_order=False):
    """Size-based policy (reference ``path_contractors.py:197-265``)."""
    n = len(list(nodes))
    if n <= 1:
        nodes = list(nodes)
        if not nodes:
            raise ValueError("cannot contract empty node list")
        nodes = _contract_trace_edges(nodes)
        node = nodes[0]
        if output_edge_order:
            node.reorder_edges(list(output_edge_order))
        return node
    return base(nodes, _paths.auto_algorithm(n), output_edge_order,
                ignore_edge_order)


def custom(nodes, optimizer, output_edge_order=None, memory_limit=None,
           ignore_edge_order=False):
    """A user-supplied path function ``optimizer(inputs, output, size_dict,
    memory_limit=None)``, such as an opt_einsum ``PathOptimizer``
    (reference ``path_contractors.py:268``)."""
    return base(nodes, optimizer, output_edge_order, ignore_edge_order)


def path_solver(
    algorithm,
    nodes: Sequence[AbstractNode],
) -> List[Tuple[int, int]]:
    """Return the contraction path as data (reference
    ``path_contractors.py:299``)."""
    nodes = list(nodes)
    if isinstance(algorithm, str):
        table = {"optimal": _paths.optimal,
                 "branch": _paths.branch_all,
                 "greedy": _paths.greedy,
                 "auto": _paths.auto_algorithm(len(nodes))}
        algorithm = table[algorithm]
    input_sets = [{id(e) for e in n.edges} for n in nodes]
    output_set = {id(e) for e in get_subgraph_dangling(nodes)}
    size_dict = {id(e): e.dimension for e in get_all_edges(nodes)}
    return _paths.get_pair_path(input_sets, output_set, size_dict, algorithm)


def contract_path(
    path: Sequence[Tuple[int, int]],
    nodes: Sequence[AbstractNode],
    output_edge_order: Optional[Sequence[Edge]] = None,
) -> AbstractNode:
    """Contract along an explicit path (reference
    ``path_contractors.py:354``)."""
    nodes = list(nodes)
    for (i, j) in path:
        if i == j:
            continue
        a, b = nodes[i], nodes[j]
        new_node = contract_between(a, b, allow_outer_product=True)
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)]
        nodes.append(new_node)
    node = nodes[0]
    if output_edge_order:
        node.reorder_edges(list(output_edge_order))
    return node
