"""Node-level linear algebra and initializers.

Counterpart of :mod:`tensornetwork_tpu.core.node_linalg` (reference
``linalg/node_linalg.py:32-331``): initializers that return graph Nodes
(float32 by default, as the JAX package's; made on ``device``, default
the card), plus ``norm``/``conj``/``transpose`` and the operator Kronecker
product over Nodes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from tensornetwork_tpu_torch.config import Device
from tensornetwork_tpu_torch.core import linalg as _linalg
from tensornetwork_tpu_torch.core.network import (
    AbstractNode, Node, conj as _conj, outer_product_final_nodes)


def eye(N: int, dtype: torch.dtype = torch.float32, M: Optional[int] = None,
        name: Optional[str] = None, axis_names: Optional[List[str]] = None,
        device: Optional[Device] = None) -> Node:
    """Identity-matrix Node (reference ``linalg/node_linalg.py:67``)."""
    return Node(_linalg.eye(N, dtype, M, device).array, name=name,
                axis_names=axis_names)


def zeros(shape: Sequence[int], dtype: torch.dtype = torch.float32,
          name: Optional[str] = None,
          axis_names: Optional[List[str]] = None,
          device: Optional[Device] = None) -> Node:
    """(reference ``linalg/node_linalg.py:99``)"""
    return Node(_linalg.zeros(shape, dtype, device).array, name=name,
                axis_names=axis_names)


def ones(shape: Sequence[int], dtype: torch.dtype = torch.float32,
         name: Optional[str] = None,
         axis_names: Optional[List[str]] = None,
         device: Optional[Device] = None) -> Node:
    """(reference ``linalg/node_linalg.py:125``)"""
    return Node(_linalg.ones(shape, dtype, device).array, name=name,
                axis_names=axis_names)


def randn(shape: Sequence[int], dtype: torch.dtype = torch.float32,
          seed: Optional[int] = None, name: Optional[str] = None,
          axis_names: Optional[List[str]] = None,
          device: Optional[Device] = None) -> Node:
    """Gaussian-random Node (reference ``linalg/node_linalg.py:152``)."""
    t = _linalg.randn(tuple(shape), dtype=dtype, seed=seed, device=device)
    return Node(t.array, name=name, axis_names=axis_names)


def random_uniform(shape: Sequence[int], dtype: torch.dtype = torch.float32,
                   seed: Optional[int] = None,
                   boundaries=(0.0, 1.0), name: Optional[str] = None,
                   axis_names: Optional[List[str]] = None,
                   device: Optional[Device] = None) -> Node:
    """(reference ``linalg/node_linalg.py:181``)"""
    t = _linalg.random_uniform(tuple(shape), dtype=dtype, seed=seed,
                               boundaries=boundaries, device=device)
    return Node(t.array, name=name, axis_names=axis_names)


def norm(node: AbstractNode) -> torch.Tensor:
    """L2 norm of a node's tensor (reference
    ``linalg/node_linalg.py:214``)."""
    return torch.linalg.vector_norm(node.tensor.reshape(-1))


def conj(node: AbstractNode, name: Optional[str] = None,
         axis_names: Optional[List[str]] = None) -> Node:
    """Conjugated copy of a node (reference
    ``linalg/node_linalg.py:232``)."""
    if not axis_names:
        axis_names = node.axis_names
    return Node(_conj(node.tensor), name=name, axis_names=axis_names)


def transpose(node: AbstractNode,
              permutation: Sequence[Union[str, int]],
              name: Optional[str] = None,
              axis_names: Optional[List[str]] = None) -> Node:
    """Transposed copy of a node (reference
    ``linalg/node_linalg.py:262``): a fresh Node whose axes are reordered
    by ``permutation`` (names or indices)."""
    perm = [node.get_axis_number(p) for p in permutation]
    new_node = Node(node.tensor, name=name, axis_names=node.axis_names)
    return new_node.reorder_axes(perm)


def kron(nodes: Sequence[AbstractNode]) -> AbstractNode:
    """Operator Kronecker product of even-order nodes: the first halves of
    every node's edges become the result's first half (reference
    ``linalg/node_linalg.py:297``)."""
    input_edges = []
    output_edges = []
    for node in nodes:
        order = len(node.shape)
        if order % 2 != 0:
            raise ValueError(
                f"All operator tensors must have an even order. "
                f"Found tensor with order {order}")
        input_edges += node.edges[:order // 2]
        output_edges += node.edges[order // 2:]
    return outer_product_final_nodes(nodes, input_edges + output_edges)
