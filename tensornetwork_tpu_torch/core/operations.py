"""Whole-graph utilities and node splitting.

Counterpart of :mod:`tensornetwork_tpu.core.operations` (reference
``network_operations.py:32-1010``): deep copy, replication, reachability,
invariants, node splitting by the port's truncated SVD, QR and RQ
(:mod:`tensornetwork_tpu_torch.ops.decompositions`), reduced density
networks, and JSON serialization in the JAX package's format (base64 of
the array bytes and the numpy dtype name), so that either package reads
what the other wrote.  A block-sparse node splits by the sector
factorizations of :mod:`tensornetwork_tpu_torch.blocksparse.linalg` (the
SVD with global cross-sector truncation, QR, and RQ by QR of the
transpose).
"""
from __future__ import annotations

import base64
import json
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, as_tensor
from tensornetwork_tpu_torch.core.network import (
    AbstractNode, Edge, Node, _is_blocksparse, connect, contract_parallel,
    get_all_edges)
from tensornetwork_tpu_torch.ops import decompositions as _decomp


def get_all_nodes(edges) -> Set[AbstractNode]:
    """The set of nodes touched by ``edges`` (reference
    ``network_operations.py:697``)."""
    nodes: Set[AbstractNode] = set()
    for edge in edges:
        if edge.node1 is not None:
            nodes.add(edge.node1)
        if edge.node2 is not None:
            nodes.add(edge.node2)
    return nodes


def contract_trace_edges(node: AbstractNode) -> AbstractNode:
    """Contract all trace edges of ``node`` (reference
    ``network_operations.py:737``; one ``contract_parallel`` collapses all
    parallel trace edges at once)."""
    for edge in node.edges:
        if edge.is_trace():
            return contract_parallel(edge)
    return node


def copy(nodes: Sequence[AbstractNode], conjugate: bool = False
         ) -> Tuple[Dict[AbstractNode, AbstractNode], Dict[Edge, Edge]]:
    """Deep-copy a subnetwork (reference ``network_operations.py:32``)."""
    node_map: Dict[AbstractNode, AbstractNode] = {}
    for node in nodes:
        node_map[node] = node.copy(conjugate=conjugate)
    edge_map: Dict[Edge, Edge] = {}
    for node in nodes:
        for axis, e in enumerate(node.edges):
            if e in edge_map:
                continue
            if e.is_dangling() or e.node2 not in node_map or \
                    e.node1 not in node_map:
                # dangling, or crossing the boundary of the copied set
                this = node_map[node]
                new_e = Edge(node1=this, axis1=axis, name=e.name)
                this.edges[axis] = new_e
                edge_map[e] = new_e
            else:
                n1, n2 = node_map[e.node1], node_map[e.node2]
                new_e = Edge(node1=n1, axis1=e.axis1, node2=n2,
                             axis2=e.axis2, name=e.name)
                n1.edges[e.axis1] = new_e
                n2.edges[e.axis2] = new_e
                edge_map[e] = new_e
    return node_map, edge_map


def replicate_nodes(nodes: Sequence[AbstractNode],
                    conjugate: bool = False) -> List[AbstractNode]:
    """(reference ``network_operations.py:86``)"""
    node_map, _ = copy(nodes, conjugate)
    return [node_map[n] for n in nodes]


def remove_node(node: AbstractNode
                ) -> Tuple[Dict[str, Edge], Dict[int, Edge]]:
    """Disconnect a node from the network (reference
    ``network_operations.py:106``)."""
    broken_edges_by_name: Dict[str, Edge] = {}
    broken_edges_by_axis: Dict[int, Edge] = {}
    for axis, e in enumerate(list(node.edges)):
        if not e.is_dangling() and not e.is_trace():
            other = e.node2 if e.node1 is node else e.node1
            other_axis = e.axis2 if e.node1 is node else e.axis1
            new_e = Edge(node1=other, axis1=other_axis, name=e.name)
            other.edges[other_axis] = new_e
            broken_edges_by_name[e.name] = new_e
            broken_edges_by_axis[axis] = new_e
    return broken_edges_by_name, broken_edges_by_axis


def reachable(inputs: Union[AbstractNode, Sequence[AbstractNode], Edge]
              ) -> Set[AbstractNode]:
    """BFS over the graph (reference ``network_operations.py:591``)."""
    if isinstance(inputs, AbstractNode):
        frontier = [inputs]
    elif isinstance(inputs, Edge):
        frontier = [n for n in inputs.get_nodes() if n is not None]
    else:
        frontier = list(inputs)
    seen: Set[AbstractNode] = set()
    while frontier:
        node = frontier.pop()
        if node in seen:
            continue
        seen.add(node)
        for e in node.edges:
            for n in (e.node1, e.node2):
                if n is not None and n not in seen:
                    frontier.append(n)
    return seen


def check_correct(nodes: Sequence[AbstractNode],
                  check_connections: bool = True) -> None:
    """Graph invariants (reference ``network_operations.py:641``)."""
    for node in nodes:
        for axis, e in enumerate(node.edges):
            if (e.node2 is None) != (e.axis2 is None):
                raise ValueError(
                    f"edge {e.name} is malformed: node2/axis2 must both "
                    f"be set or both be None")
            if e.node1 is not node and e.node2 is not node:
                raise ValueError(
                    f"edge {e.name} at axis {axis} of node {node.name} "
                    f"does not point back at the node")
            if not e.is_being_used():
                raise ValueError(f"edge {e.name} is not being used by its "
                                 f"own nodes")
    if check_connections:
        check_connected(nodes)


def check_connected(nodes: Sequence[AbstractNode]) -> None:
    """(reference ``network_operations.py:680``)"""
    nodes = list(nodes)
    if not nodes:
        return
    if set(nodes) - reachable(nodes[0]):
        raise ValueError("nodes are not connected")


def get_subgraph_dangling(nodes: Sequence[AbstractNode]) -> Set[Edge]:
    """Edges with at least one endpoint outside ``nodes`` or dangling
    (reference ``network_operations.py:717``)."""
    nodes_set = set(nodes)
    out: Set[Edge] = set()
    for e in get_all_edges(nodes):
        if e.is_dangling():
            out.add(e)
        elif (e.node1 not in nodes_set) != (e.node2 not in nodes_set):
            out.add(e)
    return out


def switch_backend(nodes, new_backend: str = "pytorch") -> None:
    """Reference-compatible shim (reference
    ``network_operations.py:794``): the reference re-wraps node tensors in
    another backend; here PyTorch is the only execution layer, so tensors
    are normalized to torch tensors in place (:func:`config.as_tensor`)."""
    for node in nodes:
        node.tensor = as_tensor(node.tensor)


def redirect_edge(edge: Edge, new_node: AbstractNode,
                  old_node: AbstractNode) -> None:
    """Move one endpoint of an edge to another node with matching dimension
    (reference ``network_operations.py:986``)."""
    if edge.node1 is old_node:
        axis = edge.axis1
    elif edge.node2 is old_node:
        axis = edge.axis2
    else:
        raise ValueError(f"edge {edge.name} not connected to {old_node.name}")
    # find a free (dangling) axis on new_node with the right dimension
    for new_axis, e in enumerate(new_node.edges):
        if e.is_dangling() and new_node.shape[new_axis] == edge.dimension:
            edge.update_axis(axis, old_node, new_axis, new_node)
            new_node.edges[new_axis] = edge
            # give old node a fresh dangling edge
            old_node.edges[axis] = Edge(node1=old_node, axis1=axis)
            return
    raise ValueError(f"no free axis of dimension {edge.dimension} on node "
                     f"{new_node.name}")


# ---------------------------------------------------------------------------
# Node splitting (reference ``network_operations.py:130-540``)
# ---------------------------------------------------------------------------


def _bst_matrix(t, n_left):
    """A block-sparse tensor as the (left legs) x (right legs) matrix;
    also the two sides' dims."""
    left_dims, right_dims = t.shape[:n_left], t.shape[n_left:]
    return (t.reshape((int(np.prod(left_dims)), int(np.prod(right_dims)))),
            tuple(left_dims), tuple(right_dims))


def _bst_split_svd(t, n_left, max_singular_values=None,
                   max_truncation_err=None, relative=False):
    """Truncated SVD of a BlockSparseTensor split into (left, right) leg
    groups through the graph API (reference
    ``tests/split_node_symmetric_test.py`` scenarios): fuse each side,
    run the sector SVD with global cross-sector truncation, unfuse."""
    from tensornetwork_tpu_torch.blocksparse import linalg as bsl
    m, left_dims, right_dims = _bst_matrix(t, n_left)
    U, S, V, s_rest = bsl.truncated_svd(
        m, max_singular_values=max_singular_values,
        max_truncation_error=max_truncation_err, relative=relative)
    k = U.shape[1]
    return (U.reshape(left_dims + (k,)), S, V.reshape((k,) + right_dims),
            s_rest)


def _bst_sqrt_diag(S):
    """diag(sqrt(S)) for a singular-value ChargeArray."""
    from tensornetwork_tpu_torch.blocksparse import linalg as bsl
    return bsl.diag(type(S)(torch.sqrt(S.data), S._charges, S._flows))


def _bst_split_qr(t, n_left):
    from tensornetwork_tpu_torch.blocksparse import linalg as bsl
    m, left_dims, right_dims = _bst_matrix(t, n_left)
    Q, R = bsl.qr(m)
    k = Q.shape[1]
    return Q.reshape(left_dims + (k,)), R.reshape((k,) + right_dims)


def _bst_split_rq(t, n_left):
    """RQ via QR of the transpose: m^T = Q_t R_t  =>  m = R_t^T Q_t^T,
    with Q_t^T row-isometric (the block-sparse layer ships QR only)."""
    from tensornetwork_tpu_torch.blocksparse import linalg as bsl
    m, left_dims, right_dims = _bst_matrix(t, n_left)
    Qt, Rt = bsl.qr(m.transpose((1, 0)))
    r, q = Rt.transpose((1, 0)), Qt.transpose((1, 0))
    k = q.shape[0]
    return r.reshape(left_dims + (k,)), q.reshape((k,) + right_dims)


def _prepare_split(node: AbstractNode, left_edges: Sequence[Edge],
                   right_edges: Sequence[Edge]):
    if set(left_edges) | set(right_edges) != set(node.edges) or \
            len(left_edges) + len(right_edges) != len(node.edges):
        raise ValueError("left_edges + right_edges must be exactly the "
                         "node's edges")
    t = node.tensor_from_edge_order(list(left_edges) + list(right_edges))
    return t


def _finish_split(node, left_edges, right_edges, left_t, right_t,
                  left_name, right_name, edge_name):
    left = Node(left_t, name=left_name)
    right = Node(right_t, name=right_name)
    for i, e in enumerate(left_edges):
        old_axis = e.axis1 if e.node1 is node else e.axis2
        e.update_axis(old_axis, node, i, left)
        left.edges[i] = e
    for i, e in enumerate(right_edges):
        old_axis = e.axis1 if e.node1 is node else e.axis2
        e.update_axis(old_axis, node, i + 1, right)
        right.edges[i + 1] = e
    new_edge = connect(left.edges[len(left_edges)], right.edges[0],
                       name=edge_name)
    node.fresh_edges()
    return left, right, new_edge


def split_node(
    node: AbstractNode,
    left_edges: Sequence[Edge],
    right_edges: Sequence[Edge],
    max_singular_values: Optional[int] = None,
    max_truncation_err: Optional[float] = None,
    relative: bool = False,
    left_name: Optional[str] = None,
    right_name: Optional[str] = None,
    edge_name: Optional[str] = None,
) -> Tuple[Node, Node, torch.Tensor]:
    """Truncated-SVD split: returns ``(U·sqrt(S), sqrt(S)·V†, s_rest)``
    (reference ``network_operations.py:130``)."""
    t = _prepare_split(node, left_edges, right_edges)
    if _is_blocksparse(t):
        from tensornetwork_tpu_torch.blocksparse.tensor import tensordot
        u0, S, vh0, s_rest = _bst_split_svd(
            t, len(left_edges), max_singular_values, max_truncation_err,
            relative)
        D = _bst_sqrt_diag(S)
        u = tensordot(u0, D, [[u0.ndim - 1], [0]])
        vh = tensordot(D, vh0, [[1], [0]])
    else:
        u, s, vh, s_rest = _decomp.svd(
            t, pivot_axis=len(left_edges),
            max_singular_values=max_singular_values,
            max_truncation_error=max_truncation_err, relative=relative)
        sqrt_s = torch.sqrt(s)
        u = u * sqrt_s
        vh = vh * sqrt_s.reshape((-1,) + (1,) * (vh.ndim - 1))
    left, right, _ = _finish_split(node, left_edges, right_edges, u, vh,
                                   left_name, right_name, edge_name)
    return left, right, s_rest


def split_node_full_svd(
    node: AbstractNode,
    left_edges: Sequence[Edge],
    right_edges: Sequence[Edge],
    max_singular_values: Optional[int] = None,
    max_truncation_err: Optional[float] = None,
    relative: bool = False,
    left_name: Optional[str] = None,
    middle_name: Optional[str] = None,
    right_name: Optional[str] = None,
    left_edge_name: Optional[str] = None,
    right_edge_name: Optional[str] = None,
) -> Tuple[Node, Node, Node, torch.Tensor]:
    """Returns ``(U, S-node, V†, s_rest)`` (reference
    ``network_operations.py:446``)."""
    t = _prepare_split(node, left_edges, right_edges)
    if _is_blocksparse(t):
        from tensornetwork_tpu_torch.blocksparse import linalg as bsl
        u, S, vh, s_rest = _bst_split_svd(
            t, len(left_edges), max_singular_values, max_truncation_err,
            relative)
        middle_t = bsl.diag(S)
    else:
        u, s, vh, s_rest = _decomp.svd(
            t, pivot_axis=len(left_edges),
            max_singular_values=max_singular_values,
            max_truncation_error=max_truncation_err, relative=relative)
        middle_t = torch.diag(s)
    left = Node(u, name=left_name)
    middle = Node(middle_t, name=middle_name)
    right = Node(vh, name=right_name)
    for i, e in enumerate(left_edges):
        old_axis = e.axis1 if e.node1 is node else e.axis2
        e.update_axis(old_axis, node, i, left)
        left.edges[i] = e
    for i, e in enumerate(right_edges):
        old_axis = e.axis1 if e.node1 is node else e.axis2
        e.update_axis(old_axis, node, i + 1, right)
        right.edges[i + 1] = e
    connect(left.edges[len(left_edges)], middle.edges[0],
            name=left_edge_name)
    connect(middle.edges[1], right.edges[0], name=right_edge_name)
    node.fresh_edges()
    return left, middle, right, s_rest


def split_node_qr(
    node: AbstractNode,
    left_edges: Sequence[Edge],
    right_edges: Sequence[Edge],
    left_name: Optional[str] = None,
    right_name: Optional[str] = None,
    edge_name: Optional[str] = None,
) -> Tuple[Node, Node]:
    """(reference ``network_operations.py:258``)"""
    t = _prepare_split(node, left_edges, right_edges)
    if _is_blocksparse(t):
        q, r = _bst_split_qr(t, len(left_edges))
    else:
        q, r = _decomp.tensor_qr(t, pivot_axis=len(left_edges))
    left, right, _ = _finish_split(node, left_edges, right_edges, q, r,
                                   left_name, right_name, edge_name)
    return left, right


def split_node_rq(
    node: AbstractNode,
    left_edges: Sequence[Edge],
    right_edges: Sequence[Edge],
    left_name: Optional[str] = None,
    right_name: Optional[str] = None,
    edge_name: Optional[str] = None,
) -> Tuple[Node, Node]:
    """(reference ``network_operations.py:351``)"""
    t = _prepare_split(node, left_edges, right_edges)
    if _is_blocksparse(t):
        r, q = _bst_split_rq(t, len(left_edges))
    else:
        r, q = _decomp.rq(t, pivot_axis=len(left_edges))
    left, right, _ = _finish_split(node, left_edges, right_edges, r, q,
                                   left_name, right_name, edge_name)
    return left, right


def reduced_density(traced_out_edges: Sequence[Edge]
                    ) -> Tuple[dict, dict]:
    """Partial trace by doubling the network (reference
    ``network_operations.py:754``)."""
    if any(e.is_dangling() is False for e in traced_out_edges):
        raise ValueError("traced_out_edges must all be dangling")
    nodes = reachable([e.node1 for e in traced_out_edges])
    node_map, edge_map = copy(nodes, conjugate=True)
    for e in traced_out_edges:
        connect(e, edge_map[e])  # e was dangling; edge_map[e] too
    return node_map, edge_map


# ---------------------------------------------------------------------------
# JSON serialization (reference ``network_operations.py:849-984``)
# ---------------------------------------------------------------------------


def nodes_to_json(nodes: Sequence[AbstractNode],
                  edge_binding: Optional[Dict[str, Union[Edge, Sequence[Edge]]]] = None
                  ) -> str:
    """The nodes, their edges and ``edge_binding`` (names to edges) as
    JSON; each tensor is copied to the host and stored as base64 of its
    bytes with its numpy dtype name."""
    nodes = list(nodes)
    index = {n: i for i, n in enumerate(nodes)}
    node_dicts = []
    for n in nodes:
        arr = n.tensor.detach().resolve_conj().cpu().numpy()
        node_dicts.append({
            "name": n.name,
            "axis_names": n.axis_names,
            "shape": list(arr.shape),
            "dtype": arr.dtype.name,
            "tensor": base64.b64encode(arr.tobytes()).decode("ascii"),
        })
    edges = []
    seen = set()
    for n in nodes:
        for axis, e in enumerate(n.edges):
            if id(e) in seen:
                continue
            seen.add(id(e))
            # record from the perspective of whichever endpoint is inside
            # the serialized set; a cross-boundary edge becomes dangling
            if e.node1 in index:
                n1_idx, a1 = index[e.node1], e.axis1
                n2_in = e.node2 in index if e.node2 is not None else False
                d = {"name": e.name, "node1": n1_idx, "axis1": a1,
                     "node2": index[e.node2] if n2_in else None,
                     "axis2": e.axis2 if n2_in else None}
            else:
                d = {"name": e.name, "node1": index[e.node2],
                     "axis1": e.axis2, "node2": None, "axis2": None}
            edges.append(d)
    bindings = {}
    if edge_binding:
        edge_names = {}
        for n in nodes:
            for e in n.edges:
                edge_names[id(e)] = e.name
        for key, val in edge_binding.items():
            if not isinstance(key, str):
                raise TypeError(
                    f"edge_binding keys must be strings, got {type(key)}")
            es = val if isinstance(val, (list, tuple, set)) else [val]
            for e in es:
                if not isinstance(e, Edge):
                    raise TypeError(
                        f"edge_binding values must be Edges, got {type(e)}")
            bindings[key] = [e.name for e in es if id(e) in edge_names]
    return json.dumps({"nodes": node_dicts, "edges": edges,
                       "edge_binding": bindings})


def nodes_from_json(s: str, device: Optional[Device] = None
                    ) -> Tuple[List[Node], Dict[str, List[Edge]]]:
    """Nodes and edge bindings from :func:`nodes_to_json`'s JSON (or the
    JAX package's); the tensors go to ``device`` (default: the card)."""
    data = json.loads(s)
    nodes = []
    for nd in data["nodes"]:
        arr = np.frombuffer(base64.b64decode(nd["tensor"]),
                            dtype=np.dtype(nd["dtype"]))
        arr = arr.reshape(nd["shape"]).copy()
        nodes.append(Node(as_tensor(arr, device), name=nd["name"],
                          axis_names=nd["axis_names"] or None))
    name_to_edges: Dict[str, List[Edge]] = {}
    for ed in data["edges"]:
        n1 = nodes[ed["node1"]]
        if ed["node2"] is not None:
            n2 = nodes[ed["node2"]]
            e = Edge(node1=n1, axis1=ed["axis1"], node2=n2,
                     axis2=ed["axis2"], name=ed["name"])
            n1.edges[ed["axis1"]] = e
            n2.edges[ed["axis2"]] = e
        else:
            e = n1.edges[ed["axis1"]]
            e.set_name(ed["name"])
        name_to_edges.setdefault(e.name, []).append(e)
    bindings = {
        k: [e for name in v for e in name_to_edges.get(name, [])]
        for k, v in data.get("edge_binding", {}).items()}
    return nodes, bindings
