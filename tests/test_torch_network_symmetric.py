"""Block-sparse tensors through the port's ``ncon`` and Node/Edge graph
core, against the JAX package's, on the CPU.

The scenarios of ``tests/test_network_symmetric.py`` and the block-sparse
``ncon`` tests of ``tests/test_blocksparse.py``, each written once against
a package's public API and run on both (``tensornetwork_tpu`` and
``tensornetwork_tpu_torch``) with the same charges and seeded data: what
they compute (dense views of the results, singular values, discarded
weights) agrees within 1e-12 of the largest entry in float64.  Splits are
compared by what is unique: reconstructions and spectra.
"""
import numpy as np
import pytest
import torch

import tensornetwork_tpu as J
import tensornetwork_tpu_torch as T


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


KINDS = ("u1", "z2", "u1xu1")


def _charge(P, kind, seed, d):
    rng = np.random.default_rng(seed)
    if kind == "u1":
        return P.U1Charge(rng.integers(-2, 3, d))
    if kind == "z2":
        return P.Z2Charge(rng.integers(0, 2, d))
    return P.U1Charge(rng.integers(-1, 2, d)) @ \
        P.U1Charge(rng.integers(-1, 2, d))


def _bst(P, legs, seed):
    """A random tensor of ``legs``: (charge, flow) pairs."""
    idx = [P.Index(c, f) for c, f in legs]
    kw = dict(device="cpu") if P is T else {}
    return P.blocksparse.randn(idx, seed=seed, **kw)


def _dense(x):
    if hasattr(x, "todense"):
        x = x.todense()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def s_matmul(P, kind):
    c0, c1, c2 = (_charge(P, kind, s, d) for s, d in ((1, 6), (2, 5),
                                                       (3, 4)))
    a = _bst(P, [(c0, False), (c1, True)], 4)
    b = _bst(P, [(c1, False), (c2, True)], 5)
    na, nb = P.Node(a, name="a", axis_names=["l", "r"]), P.Node(b)
    assert isinstance(na.tensor, P.BlockSparseTensor)
    na[1] ^ nb[0]
    return [(na @ nb).tensor]


def s_two_edges(P, kind):
    c0, c1 = _charge(P, kind, 6, 7), _charge(P, kind, 7, 6)
    a = _bst(P, [(c0, False), (c1, True)], 8)
    b = _bst(P, [(c1, False), (c0, True)], 9)
    na, nb = P.Node(a), P.Node(b)
    na[1] ^ nb[0]
    na[0] ^ nb[1]
    return [P.contract_between(na, nb).tensor]


def s_traces(P, kind):
    c1, c2 = _charge(P, kind, 10, 4), _charge(P, kind, 11, 5)
    t = _bst(P, [(c1, False), (c2, False), (c1, True), (c2, True)], 12)
    node = P.Node(t)
    node[0] ^ node[2]
    node[1] ^ node[3]
    out = [P.contract_trace_edges(node).tensor]
    a = _bst(P, [(c1, False), (c1, True), (c2, False)], 13)
    b = _bst(P, [(c2, True)], 14)
    na, nb = P.Node(a), P.Node(b)
    na[0] ^ na[1]
    na[2] ^ nb[0]
    out.append((P.contract_trace_edges(na) @ nb).tensor)
    return out


def s_copy_reorder_flatten(P, kind):
    cs = [_charge(P, kind, 15 + i, d) for i, d in enumerate((5, 6, 4))]
    a = _bst(P, [(cs[0], False), (cs[1], True), (cs[2], False)], 18)
    b = _bst(P, [(cs[1], False), (cs[2], True), (cs[0], True)], 19)
    na, nb = P.Node(a), P.Node(b)
    na[1] ^ nb[0]
    na[2] ^ nb[1]
    na[0] ^ nb[2]
    mapping, _ = P.copy([na, nb])
    out = [(mapping[na] @ mapping[nb]).tensor]
    node = P.Node(a)
    node.reorder_axes([2, 0, 1])
    out.append(node.tensor)
    c = _bst(P, [(cs[0], True), (cs[1], False), (cs[2], True)], 20)
    na, nc = P.Node(a), P.Node(c)
    for i in range(3):
        na[i] ^ nc[i]
    P.flatten_edges_between(na, nc)
    assert len(P.get_shared_edges(na, nc)) == 1
    out.append((na @ nc).tensor)
    out.append(P.outer_product(P.Node(_bst(P, [(cs[0], False)], 21)),
                               P.Node(_bst(P, [(cs[0], True)], 22))).tensor)
    out.append(P.Node(a).copy(conjugate=True).tensor)
    return out


def s_split_node(P, kind):
    cs = [_charge(P, kind, 23 + i, d) for i, d in enumerate((5, 4, 6, 4))]
    t = _bst(P, [(cs[0], False), (cs[1], True), (cs[2], False)], 27)
    node = P.Node(t)
    left, right, s_rest = P.split_node(node, node.edges[:2], node.edges[2:])
    out = [P.contract_between(left, right).tensor, s_rest]
    t4 = _bst(P, [(cs[0], False), (cs[1], True), (cs[2], False),
                  (cs[3], True)], 28)
    node = P.Node(t4)
    left, right, _ = P.split_node(node, [node.edges[0], node.edges[2]],
                                  [node.edges[1], node.edges[3]])
    out.append(P.contract_between(
        left, right, output_edge_order=[left.edges[0], right.edges[1],
                                        left.edges[1], right.edges[2]]
    ).tensor)
    m = _bst(P, [(cs[2], False), (cs[2], True)], 29)
    node = P.Node(m)
    left, right, s_rest = P.split_node(node, node.edges[:1], node.edges[1:],
                                       max_singular_values=4)
    out += [P.contract_between(left, right).tensor, np.sort(_dense(s_rest))]
    node = P.Node(m)
    u, s, vh, _ = P.split_node_full_svd(node, node.edges[:1],
                                        node.edges[1:])
    out.append(P.contract_between(P.contract_between(u, s), vh).tensor)
    node = P.Node(t)
    q, r = P.split_node_qr(node, node.edges[:2], node.edges[2:])
    out.append(P.contract_between(q, r).tensor)
    qm = _dense(q.tensor.reshape((20, q.tensor.shape[-1])))
    np.testing.assert_allclose(qm.T @ qm, np.eye(qm.shape[1]), atol=1e-12)
    node = P.Node(t)
    r, q = P.split_node_rq(node, node.edges[:1], node.edges[1:])
    out.append(P.contract_between(r, q).tensor)
    return out


def s_ncon(P, kind):
    cs = [_charge(P, kind, 30 + i, d) for i, d in enumerate((4, 5, 3, 6))]
    a = _bst(P, [(cs[0], False), (cs[1], True)], 34)
    b = _bst(P, [(cs[1], False), (cs[2], True)], 35)
    out = [P.ncon([a, b], [(-1, 1), (1, -2)]),
           P.ncon([a, a.conj()], [(1, 2), (1, 2)])]
    # partial traces: one pair, then two pairs on one operand
    t = _bst(P, [(cs[0], False), (cs[0], True), (cs[2], True)], 36)
    c = _bst(P, [(cs[2], False), (cs[3], True)], 37)
    out.append(P.ncon([t, c], [(1, 1, 2), (2, -1)]))
    t5 = _bst(P, [(cs[0], False), (cs[2], False), (cs[0], True),
                  (cs[2], True), (cs[3], True)], 38)
    out.append(P.ncon([t5], [(1, 2, 1, 2, -1)]))
    # an open batch label on two operands
    A = _bst(P, [(cs[1], False), (cs[0], True), (cs[3], False)], 39)
    B = _bst(P, [(cs[1], True), (cs[3], True), (cs[0], False)], 40)
    out.append(P.ncon([A, B], [[-1, -2, 1], [-1, 1, -3]]))
    # a positive label on three operands, then lone-label sums: dense
    A3 = _bst(P, [(cs[0], False), (cs[2], True)], 41)
    B3 = _bst(P, [(cs[0], True), (cs[2], False), (cs[2], False)], 42)
    C3 = _bst(P, [(cs[0], False), (cs[2], True), (cs[0], True)], 43)
    out.append(P.ncon([A3, B3, C3], [[1, 2], [1, 2, 3], [1, 3, -1]]))
    out.append(P.ncon([a], [[1, -1]]))
    out.append(P.ncon([a, b], [[2, 1], [1, 3]]))
    # the ncon path and the graph path agree
    na, nb = P.Node(a), P.Node(b)
    na[1] ^ nb[0]
    out.append((na @ nb).tensor)
    return out


SCENARIOS = [s_matmul, s_two_edges, s_traces, s_copy_reorder_flatten,
             s_split_node, s_ncon]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario, kind):
    got = scenario(T, kind)
    want = scenario(J, kind)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _dense(g), _dense(w)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * scale)


def test_dense_and_blocksparse_do_not_mix():
    c = _charge(T, "u1", 44, 5)
    a = T.Node(_bst(T, [(c, False), (c, True)], 45))
    b = T.Node(torch.ones((5, 4), dtype=torch.float64))
    a[1] ^ b[0]
    with pytest.raises(TypeError):
        a @ b
