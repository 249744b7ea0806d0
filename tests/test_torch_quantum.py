"""The port's quantum operators against the JAX package's, on the CPU.

Every case of tests/test_quantum.py is one scenario function that builds
its operators from seeded numpy arrays through a package's public API
(``tensornetwork_tpu`` or ``tensornetwork_tpu_torch``) and returns what
it computed; the test runs it on both packages and compares: values
within 1e-12 relative in float64, the same dtypes, flags, spaces and
errors.  The port's tensors are CPU tensors and its identities are made
with ``device="cpu"``.
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


def _t(P, a):
    """A seeded numpy array as the package's tensor type."""
    return torch.from_numpy(np.array(a)) if P is T else a


def _ident(P, space, **kw):
    if P is T:
        kw["device"] = "cpu"
    return P.quantum.identity(space, **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _arr(seed, *shape, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if complex_ else a


def _op(P, a, out_axes=None, in_axes=None):
    return P.quantum.QuOperator.from_tensor(_t(P, a), out_axes, in_axes)


def s_from_tensor_and_eval(P):
    return [_op(P, _arr(0, 2, 2, 2, 2)).eval()]


def s_matmul_composition(P):
    a, b = _arr(1, 2, 2), _arr(2, 2, 2)
    return [(_op(P, a, [0], [1]) @ _op(P, b, [0], [1])).eval()]


def s_adjoint(P):
    op = _op(P, _arr(3, 2, 2, complex_=True), [0], [1])
    return [op.adjoint().eval()]


def s_trace_and_norm(P):
    op = _op(P, _arr(4, 3, 3), [0], [1])
    return [op.trace().eval(), op.norm().eval()]


def s_partial_trace(P):
    return [_op(P, _arr(5, 2, 3, 2, 3), [0, 1], [2, 3]).partial_trace(
        [1]).eval()]


def s_tensor_product(P):
    opa = _op(P, _arr(6, 2, 2), [0], [1])
    opb = _op(P, _arr(7, 3, 3), [0], [1])
    return [(opa | opb).eval(), opa.tensor_product(opb).eval()]


def s_quvector_inner_and_projector(P):
    v = P.quantum.QuVector.from_tensor(_t(P, _arr(8, 2, 2)))
    return [(v.adjoint() @ v).eval(), v.projector().eval()]


def s_reduced_density(P):
    v = P.quantum.QuVector.from_tensor(_t(P, _arr(9, 2, 3)))
    return [v.reduced_density([1]).eval(), v.reduced_density([0]).eval()]


def s_identity_and_elimination(P):
    op = _op(P, _arr(10, 2, 3, 2, 3), [0, 1], [2, 3])
    return [_ident(P, [2, 3]).eval(), (op @ _ident(P, [2, 3])).eval(),
            (_ident(P, [2, 3]) @ op @ _ident(P, [2, 3])).eval(),
            _ident(P, [2], dtype=(torch.float32 if P is T
                                  else np.float32)).eval()]


def s_scalar_multiplication(P):
    op = _op(P, _arr(11, 2, 2), [0], [1])
    return [(op * 2.5).eval(), (2.5 * op).eval(), (op / 4.0).eval(),
            (op * (1 + 2j)).eval()]


def s_scalar_multiplication_f32_keeps_f32(P):
    op = _op(P, _arr(12, 2, 2).astype(np.float32), [0], [1])
    return [(op * 2.5).eval(), (op * 3).eval()]


def s_quscalar(P):
    s = P.quantum.QuScalar.from_tensor(_t(P, np.float64(3.0)))
    return [s.is_scalar(), s.eval()]


def s_vector_spaces(P):
    v = P.quantum.QuVector.from_tensor(_t(P, _arr(13, 2, 3, 4)))
    a = v.adjoint()
    return [v.space, v.is_vector(), a.is_adjoint_vector(), a.space,
            v.is_scalar(), a.in_space, v.out_space]


def s_constructor_edge_signatures(P):
    Q = P.quantum
    psi = P.Node(_t(P, _arr(14, 2, 2)))
    op = Q.quantum_constructor([psi[0]], [psi[1]])
    vec = Q.quantum_constructor([psi[0], psi[1]], [])
    adj = Q.quantum_constructor([], [psi[0], psi[1]])
    out = [type(x).__name__ for x in (op, vec, adj)]
    out += [op.out_edges[0] is psi[0], op.in_edges[0] is psi[1]]
    try:
        Q.quantum_constructor([], [], [psi])
        out.append("no error")
    except ValueError:
        out.append("ValueError")
    psi2 = P.Node(_t(P, _arr(15, 2, 2)))
    psi2[0] ^ psi2[1]
    sc = Q.quantum_constructor([], [], [psi2])
    return out + [type(sc).__name__, sc.eval()]


def s_dangling_edge_checks(P):
    Q = P.quantum
    n1 = P.Node(_t(P, _arr(16, 2, 2)))
    n2 = P.Node(_t(P, _arr(17, 2, 2)))
    n1[1] ^ n2[0]
    out = []
    for make in (lambda: Q.QuVector([n1[0]]),
                 lambda: Q.QuVector([n1[0]], ignore_edges=[n2[1]]),
                 lambda: Q.QuVector([n1[0], n1[1], n2[1]])):
        try:
            out.append(type(make()).__name__)
        except ValueError as e:
            out.append(("ValueError", str(e).split(" ")[0]))
    return out


def s_check_spaces_mismatch(P):
    a = P.Node(_t(P, _arr(18, 2, 3)))
    b = P.Node(_t(P, _arr(19, 4, 5)))
    out = []
    for e1, e2 in (([a[0]], [b[0]]), ([a[0], a[1]], [b[0]]),
                   ([a[0]], [a[0]])):
        try:
            P.quantum.check_spaces(e1, e2)
            out.append("ok")
        except ValueError as e:
            out.append(str(e))
    return out


def s_mul_semantics(P):
    op = _op(P, np.eye(2))
    scal = P.quantum.QuScalar.from_tensor(_t(P, np.float64(0.5)))
    out = [(op * scal).eval(), (scal * op).eval(), (scal * scal).eval(),
           (op * 0.5).eval(), (0.5 * op).eval(), (op / 2.0).eval(),
           (op * np.float64(0.5)).eval(),
           (op * _t(P, np.array(0.25))).eval()]
    for bad in (np.eye(2), _t(P, np.ones(2))):
        try:
            op * bad
            out.append("no error")
        except ValueError:
            out.append("ValueError")
    return out


def s_expectation_via_reduced_density(P):
    psi = P.quantum.QuVector.from_tensor(_t(P, _arr(20, 2, 2, 2)))
    op = _op(P, _arr(21, 2, 2))
    op3 = op.tensor_product(_ident(P, (2, 2)))
    res1 = (psi.adjoint() @ op3 @ psi).eval()
    res2 = (op @ psi.reduced_density([1, 2])).trace().eval()
    return [res1, res2]


def s_from_tensor_out_axes_permutation(P):
    return [_op(P, _arr(22, 2, 3, 2, 3), out_axes=[2, 3],
                in_axes=[0, 1]).eval()]


def s_projector_squares_to_itself(P):
    psi = P.quantum.QuVector.from_tensor(_t(P, _arr(23, 2, 2)))
    nrm = float(np.sqrt(_np((psi.adjoint() @ psi).eval())))
    proj = (psi / nrm).projector()
    return [(proj @ proj).eval(), proj.eval()]


def s_scalar_multiplication_by_node(P):
    op = _op(P, np.diag([1.0, 2.0]), [0], [1])
    s = P.Node(_t(P, np.array(3.0)))
    out = [(op * s).eval(), op.__rmul__(s).eval()]
    try:
        op * P.Node(_t(P, np.ones((2, 2))))
        out.append("no error")
    except ValueError:
        out.append("ValueError")
    return out


def s_eliminate_identities_chain(P):
    """Chained identities collapse transitively onto the operator's edges
    and the contraction drops every CopyNode.  (How many edges the map
    holds depends on the set order in which the rewiring visits the
    nodes, so only what survives is compared.)"""
    def chain():
        op = _op(P, _arr(24, 2, 3), [0], [1])
        return _ident(P, [2]) @ _ident(P, [2]) @ op @ _ident(P, [3])
    nodes = chain().nodes
    nodes_dict, _ = P.quantum.eliminate_identities(nodes)
    return [len(nodes), len(nodes_dict), chain().eval()]


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("s_")]


def _same(t, j):
    if isinstance(j, (list, tuple)) and not isinstance(j, np.ndarray):
        assert type(t) in (list, tuple) and len(t) == len(j)
        for x, y in zip(t, j):
            _same(x, y)
        return
    if isinstance(t, torch.Tensor) or hasattr(j, "dtype") and not \
            isinstance(j, (bool, str, float, int)):
        t, j = _np(t), np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype)
        np.testing.assert_allclose(t, j, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(j).max(), 1e-300))
        return
    assert t == j


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[2:] for s in SCENARIOS])
def test_scenario_matches_jax(scenario):
    _same(scenario(T), scenario(J))


def test_identity_and_scalars_join_the_operands_device():
    """The identity goes to the device asked for, and a scalar factor to
    its operand's device (``meta`` stands in for the card here)."""
    ident = T.quantum.identity([2, 3], dtype=torch.float32, device="meta")
    assert {n.tensor.device.type for n in ident.nodes} == {"meta"}
    assert {n.tensor.dtype for n in ident.nodes} == {torch.float32}
    op = T.quantum.QuOperator.from_tensor(torch.ones(2, 2, device="meta"))
    scaled = op * 2.0
    assert {n.tensor.device.type for n in scaled.nodes} == {"meta"}
    scaled = op * torch.tensor(2.0)
    assert {n.tensor.device.type for n in scaled.nodes} == {"meta"}
