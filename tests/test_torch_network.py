"""The port's Node/Edge graph core and its contractors against the JAX
package's, on the CPU.

Every scenario is one function that builds a network from seeded numpy
arrays through a package's public API (``tensornetwork_tpu`` or
``tensornetwork_tpu_torch``) and returns what it computed; the test runs
it on both packages and compares: values within 1e-12 relative in
float64, the same shapes, edge structure and names.
"""
import numpy as np
import opt_einsum
import pytest
import torch

import tensornetwork_tpu as J
import tensornetwork_tpu_torch as T
from tensornetwork_tpu_torch import interop


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arr(seed, *shape, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if complex_ else a


def _node(P, a, **kw):
    return P.Node(torch.from_numpy(np.array(a)) if P is T else a, **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _compare(scenario):
    """Run ``scenario(P)`` on both packages; every returned array agrees
    within 1e-12 of the largest entry, everything else exactly."""
    got, want = scenario(T), scenario(J)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (tuple, list, str, bool, int, type(None))):
            assert g == w
            continue
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        scale = max(np.abs(w).max(initial=0.0), 1e-300)
        assert np.abs(g - w).max(initial=0.0) <= 1e-12 * scale


def _contract_edge(P):
    a, b = _node(P, _arr(0, 3, 4), name="a"), _node(P, _arr(1, 4, 5))
    c = P.contract(a[1] ^ b[0], name="c", axis_names=["x", "y"])
    return c.tensor, c.name, c.axis_names, len(c.edges)


def _matmul_operator(P):
    a, b = _node(P, _arr(2, 3, 4)), _node(P, _arr(3, 4, 5))
    a[1] ^ b[0]
    return ((a @ b).tensor,)


def _trace_edge(P):
    a = _node(P, _arr(4, 4, 3, 4))
    c = P.contract(a[0] ^ a[2])
    return c.tensor, c.shape


def _contract_between_shared(P):
    a, b = _node(P, _arr(5, 3, 4, 5)), _node(P, _arr(6, 4, 3, 6))
    a[0] ^ b[1]
    a[1] ^ b[0]
    c = P.contract_between(a, b, output_edge_order=[b[2], a[2]])
    return c.tensor, c.shape


def _single_edge_leaves_trace(P):
    a, b = _node(P, _arr(7, 3, 4)), _node(P, _arr(8, 4, 3))
    a[1] ^ b[0]
    a[0] ^ b[1]
    c = P.contract(a[1])
    traced = any(e.is_trace() for e in c.edges)
    return P.contract_between(c, c).tensor, traced


def _outer_products(P):
    a, b = _node(P, _arr(9, 2, 3)), _node(P, _arr(10, 4))
    c = P.outer_product(a, b)
    d, e = _node(P, _arr(11, 2)), _node(P, _arr(12, 3, 2))
    f = P.outer_product_final_nodes([d, e], [e[1], d[0], e[0]])
    g, h = _node(P, _arr(13, 2)), _node(P, _arr(14, 3))
    k = P.contract_between(g, h, allow_outer_product=True)
    return c.tensor, f.tensor, k.tensor


def _flatten(P):
    a, b = _node(P, _arr(15, 3, 4, 5)), _node(P, _arr(16, 4, 3, 6))
    a[0] ^ b[1]
    a[1] ^ b[0]
    e = P.flatten_edges_between(a, b)
    dim = e.dimension
    c = P.contract(e)
    d = _node(P, _arr(17, 2, 3, 4))
    f = P.flatten_edges([d[0], d[2]])
    g = _node(P, _arr(18, 2, 3, 2, 3))
    g[0] ^ g[2]
    g[1] ^ g[3]
    flat = P.flatten_all_edges([g])
    return c.tensor, dim, d.tensor, f.dimension, g.tensor, len(flat)


def _split_and_slice(P):
    a, b = _node(P, _arr(19, 6, 5)), _node(P, _arr(20, 6, 4))
    edges = P.split_edge(a[0] ^ b[0], (2, 3))
    c = P.contract_between(a, b)
    x, y = _node(P, _arr(21, 6, 5)), _node(P, _arr(22, 6, 4))
    e = P.slice_edge(x[0] ^ y[0], 1, 3, new_edge_name="s")
    z = P.contract(e)
    return c.tensor, len(edges), z.tensor, e.name


def _copy_nodes(P):
    kw = {"device": "cpu"} if P is T else {}
    vs = [_node(P, _arr(23 + i, 4)) for i in range(3)]
    cn = P.CopyNode(rank=3, dimension=4, **kw)
    for k, v in enumerate(vs):
        v[0] ^ cn[k]
    star = P.contract_copy_node(cn)
    mat = _node(P, _arr(26, 4, 3))
    cn2 = P.CopyNode(rank=3, dimension=4, **kw)
    w, u = _node(P, _arr(27, 4)), _node(P, _arr(39, 4))
    mat[0] ^ cn2[0]
    w[0] ^ cn2[1]
    u[0] ^ cn2[2]
    left = P.contractors.bucket([mat, w, u], [cn2])
    dense = P.CopyNode(rank=2, dimension=3, dtype=(torch.float32 if P is T
                                                   else np.float32),
                       **kw).tensor
    lazy = cn.copy()
    return (star.tensor, len(left), left[-1].tensor, dense,
            isinstance(lazy, P.CopyNode))


def _arithmetic(P):
    a, b = _node(P, _arr(28, 3, 3)), _node(P, _arr(29, 3, 3))
    return ((a + b).tensor, (a - b).tensor, (a * b).tensor,
            (a / (b * b + 1.0)).tensor, (a * 2.0).tensor, a[1:, :2].tensor)


def _reorder(P):
    a = _node(P, _arr(30, 2, 3, 4), axis_names=["p", "q", "r"])
    e0, e1, e2 = a[0], a[1], a[2]
    a.reorder_edges([e2, e0, e1])
    names = a.axis_names
    t = a.tensor_from_edge_order([e0, e2, e1])
    a.reorder_axes([2, 0, 1])
    return a.tensor, names, a.axis_names, t, a["q"] is e1


def _graph_utilities(P):
    a = _node(P, _arr(31, 2, 3, complex_=True), name="a")
    b = _node(P, _arr(32, 3, 4), name="b")
    c = _node(P, _arr(33, 4, 2), name="c")
    P.connect(a[1], b[0], name="ab")
    P.connect(b[1], c[0], name="bc")
    node_map, edge_map = P.copy([a, b], conjugate=True)
    conj_a = node_map[a].tensor
    dangling = sorted(e.name for e in P.get_subgraph_dangling([a, b]))
    reach = sorted(n.name for n in P.reachable(a))
    P.check_correct([a, b, c])
    reps = P.replicate_nodes([b, c])
    rep_out = P.contract_between(*reps).tensor
    neighbors = [n.name for n in P.get_neighbors(b)]
    shared = len(P.get_shared_edges(b, c))
    parallel = len(P.get_parallel_edges(b[1]))
    by_name, by_axis = P.remove_node(b)
    free = (len(P.get_all_dangling([a, b, c])),
            len(P.get_all_nondangling([a, b, c])),
            len(P.get_all_edges([a, b, c])))
    with pytest.raises(ValueError):
        P.check_connected([a, c])
    d, e = _node(P, _arr(34, 4)), _node(P, _arr(35, 4))
    edge = d[0] ^ c[0]
    P.redirect_edge(edge, e, d)
    moved = edge.node1 is e or edge.node2 is e
    return (conj_a, dangling, reach, rep_out, neighbors, shared, parallel,
            sorted(by_name), sorted(by_axis), free, moved,
            len(P.get_all_nodes([edge])))


def _reduced_density(P):
    psi = _arr(36, 2, 2, 2)
    node = _node(P, psi / np.linalg.norm(psi))
    node_map, _ = P.reduced_density([node[2]])
    rho = P.contractors.greedy(
        list(P.reachable(node)),
        output_edge_order=[node[0], node[1], node_map[node][0],
                           node_map[node][1]])
    return (rho.tensor,)


def _node_collection(P):
    collected = []
    with P.NodeCollection(collected):
        a = _node(P, _arr(37, 2))
        b = _node(P, _arr(38, 2))
    return (collected == [a, b],)


@pytest.mark.parametrize("scenario", [
    _contract_edge, _matmul_operator, _trace_edge, _contract_between_shared,
    _single_edge_leaves_trace, _outer_products, _flatten, _split_and_slice,
    _copy_nodes, _arithmetic, _reorder, _graph_utilities, _reduced_density,
    _node_collection], ids=lambda f: f.__name__[1:])
def test_graph_core_against_jax(scenario):
    _compare(scenario)


def _chain(P, seed=40):
    """An open chain of four tensors with unequal bonds and two open
    ends, plus a trace edge on the last."""
    dims = [(3, 5), (5, 2, 7), (7, 4), (4, 6, 6)]
    nodes = [_node(P, _arr(seed + i, *s), name=f"n{i}")
             for i, s in enumerate(dims)]
    nodes[0][1] ^ nodes[1][0]
    nodes[1][2] ^ nodes[2][0]
    nodes[2][1] ^ nodes[3][0]
    nodes[3][1] ^ nodes[3][2]
    return nodes


CONTRACTORS = ["optimal", "branch", "greedy", "auto"]


@pytest.mark.parametrize("name", CONTRACTORS)
def test_contractors_against_jax(name):
    def scenario(P):
        nodes = _chain(P)
        order = [nodes[1][1], nodes[0][0]]
        out = getattr(P.contractors, name)(nodes, output_edge_order=order)
        single = _node(P, _arr(50, 2, 3, 2))
        single[0] ^ single[2]
        one = getattr(P.contractors, name)([single])
        free = _chain(P)
        loose = getattr(P.contractors, name)(free, ignore_edge_order=True)
        with pytest.raises(ValueError):
            getattr(P.contractors, name)(_chain(P))
        return out.tensor, one.tensor, sorted(loose.shape)
    _compare(scenario)


def test_path_solver_contract_path_and_custom():
    def scenario(P):
        nodes = _chain(P)
        nodes = [P.contract_between(nodes[3], nodes[3])] + nodes[:3]
        path = P.contractors.path_solver("greedy", nodes)
        out = P.contractors.contract_path(path, nodes,
                                          [nodes[2][1], nodes[1][0]])
        again = [P.contract_between(n, n) if any(e.is_trace()
                                                 for e in n.edges) else n
                 for n in _chain(P)]
        custom = P.contractors.custom(
            again, opt_einsum.paths.optimal,
            output_edge_order=[again[1][1], again[0][0]])
        branch1 = P.contractors.branch(_chain(P)[:3] + [again[3]], nbranch=1,
                                       ignore_edge_order=True)
        return path, out.tensor, custom.tensor, sorted(branch1.shape)
    _compare(scenario)


def _mps_nodes(P, N=8, chi=6, d=2, seed=60):
    As = [_arr(seed + i, 1 if i == 0 else chi, d, 1 if i == N - 1 else chi)
          for i in range(N)]
    if P is T:
        ket = interop.nodes_from_numpy(As, device="cpu")
        bra = interop.nodes_from_numpy([a.conj() for a in As], device="cpu")
    else:
        ket = [J.Node(a) for a in As]
        bra = [J.Node(a.conj()) for a in As]
    for i in range(N - 1):
        ket[i][2] ^ ket[i + 1][0]
        bra[i][2] ^ bra[i + 1][0]
    for i in range(N):
        ket[i][1] ^ bra[i][1]
    ket[0][0] ^ bra[0][0]
    ket[-1][2] ^ bra[-1][2]
    return ket + bra


@pytest.mark.parametrize("name", ["greedy", "auto"])
def test_mps_norm_through_contractors(name):
    """The N=8 version of chip_smoke's graph_core network: 16 nodes, so
    "auto" takes the native solver."""
    _compare(lambda P: (getattr(P.contractors, name)(_mps_nodes(P)).tensor,))


JSON_DTYPES = ["float32", "float64", "complex64", "complex128"]


def _json_network(P, dtype):
    a = _node(P, _arr(70, 3, 4, complex_=dtype.startswith("c")).astype(dtype),
              name="a", axis_names=["x", "y"])
    b = _node(P, _arr(71, 4, 5, complex_=dtype.startswith("c")).astype(dtype),
              name="b")
    outside = _node(P, _arr(72, 5).astype(dtype), name="out")
    e = a[1] ^ b[0]
    e.set_name("bond")
    outside[0] ^ b[1]
    return [a, b], {"the_bond": e, "pair": [a[0], b[1]]}


def _structure(nodes, bindings):
    edges = [(e.name, e.node1.name, e.axis1,
              None if e.node2 is None else e.node2.name, e.axis2)
             for n in nodes for e in n.edges]
    return ([(n.name, n.axis_names, tuple(n.shape)) for n in nodes], edges,
            {k: [e.name for e in v] for k, v in bindings.items()})


@pytest.mark.parametrize("dtype", JSON_DTYPES)
@pytest.mark.parametrize("writer, reader", [(T, J), (J, T), (T, T)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_json_round_trip_across_packages(writer, reader, dtype):
    """JSON written by either package loads in the other bit for bit."""
    nodes, binding = _json_network(writer, dtype)
    s = writer.nodes_to_json(nodes, edge_binding=binding)
    kw = {"device": "cpu"} if reader is T else {}
    loaded, bindings = reader.nodes_from_json(s, **kw)
    for src, dst in zip(nodes, loaded):
        a, b = _np(src.tensor), _np(dst.tensor)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    want = _structure(*writer.nodes_from_json(s, **(
        {"device": "cpu"} if writer is T else {})))
    assert _structure(loaded, bindings) == want
    assert loaded[1].edges[1].is_dangling()
    assert [len(bindings[k]) for k in ("the_bond", "pair")] == [1, 2]


def _svd_input(seed, rank_deficient):
    a = _arr(seed, 4, 3, 6)
    if rank_deficient:
        m = a.reshape(12, 6)
        m[:, 3:] = m[:, :3] @ _arr(seed + 1, 3, 3)  # rank 3
        a = m.reshape(4, 3, 6)
    return a


SPLITS = [("svd", {}), ("svd", {"max_singular_values": 2}),
          ("svd", {"max_truncation_err": 0.5, "relative": True}),
          ("full_svd", {}), ("full_svd", {"max_singular_values": 3}),
          ("qr", {}), ("rq", {})]


@pytest.mark.parametrize("rank_deficient", [False, True],
                         ids=["full_rank", "rank3"])
@pytest.mark.parametrize("kind, kw", SPLITS,
                         ids=[f"{k}-{'-'.join(v) or 'all'}"
                              for k, v in SPLITS])
def test_split_node_family_against_jax(kind, kw, rank_deficient):
    """Each split reconstructs what the JAX package's does (the factors
    themselves differ by a phase per singular vector); the discarded
    singular values agree."""
    def scenario(P):
        node = _node(P, _svd_input(80, rank_deficient), name="t")
        e0, e1, e2 = node[0], node[1], node[2]
        fn = {"svd": P.split_node, "full_svd": P.split_node_full_svd,
              "qr": P.split_node_qr, "rq": P.split_node_rq}[kind]
        out = fn(node, [e0, e1], [e2], left_name="L", right_name="R", **kw)
        parts = [p for p in out if isinstance(p, P.AbstractNode)]
        rest = out[-1] if kind in ("svd", "full_svd") else np.zeros(0)
        if rank_deficient:  # rounding noise: only its size is defined
            rest = bool(np.abs(_np(rest)).max(initial=0.0) < 1e-12)
        merged = parts[0]
        for p in parts[1:]:
            merged = P.contract_between(merged, p)
        merged.reorder_edges([e0, e1, e2])
        shapes = [tuple(p.shape) for p in parts]
        fresh = all(e.is_dangling() for e in node.edges)
        return merged.tensor, shapes, rest, parts[0].name, fresh
    _compare(scenario)


def test_switch_backend_and_serial_dict():
    a = T.Node(torch.zeros(2, 3, dtype=torch.float32), name="a")
    T.switch_backend([a])
    assert a.to_serial_dict() == J.Node(np.zeros((2, 3), np.float32),
                                        name="a").to_serial_dict()


def test_nodes_from_numpy_copies():
    a = np.arange(6.0).reshape(2, 3)
    n, m = interop.nodes_from_numpy([a, a], ["x", "y"], device="cpu",
                                    dtype=torch.float32)
    a[0, 0] = 7.0
    assert (n.name, m.name, n.tensor.dtype) == ("x", "y", torch.float32)
    assert float(n.tensor[0, 0]) == 0.0 and n.tensor.data_ptr() != \
        m.tensor.data_ptr()
    assert all(e.is_dangling() for e in n.edges + m.edges)
