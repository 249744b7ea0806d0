"""The port's ncon against the JAX package's, on the CPU.

The same seeded numpy inputs go through both (the JAX ``ncon`` with
``jit=False``); values agree within 1e-12 relative in float64 and
complex128 and 1e-5 in float32.  Also the host-side plan (labels,
validation, ``ContractionPlan.flops``), the ``Config`` stack and the
ncon-builder sugar.
"""
import importlib

import numpy as np
import pytest
import torch

from tensornetwork_tpu import config as JC
from tensornetwork_tpu_torch import config as TC
from tensornetwork_tpu_torch.core.tensor import Tensor
from tensornetwork_tpu_torch.ops import ncon as TN

# the module, not the function the package exports under its name
JN = importlib.import_module("tensornetwork_tpu.ops.ncon")
TOL = {"float64": 1e-12, "complex128": 1e-12, "float32": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arrays(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.standard_normal(s)
        if np.dtype(dtype).kind == "c":
            a = a + 1j * rng.standard_normal(s)
        out.append(a.astype(dtype))
    return out


def _both(arrays, structure, **kw):
    """(port result as numpy, JAX result as numpy)."""
    t = TN.ncon([torch.from_numpy(a) for a in arrays], structure, **kw)
    j = JN.ncon(arrays, structure, jit=False, **kw)
    return t.numpy(), np.asarray(j)


def _close(t, j, dtype):
    assert t.shape == j.shape and t.dtype == j.dtype
    scale = max(np.abs(j).max(), 1e-300)
    assert np.abs(t - j).max() <= TOL[dtype] * scale


# (shapes, structure, keyword arguments): every kind of plan step
NETWORKS = {
    "matmul": ([(4, 5), (5, 6)], [(-1, 1), (1, -2)], {}),
    "full_trace": ([(5, 5)], [(1, 1)], {}),
    "partial_trace": ([(3, 5, 5, 4)], [(-1, 1, 1, -2)], {}),
    "two_traces": ([(3, 2, 4, 3, 2)], [(1, 2, -1, 1, 2)], {}),
    "outer": ([(3,), (4,), (2, 2)], [(-1,), (-2,), (-3, -4)], {}),
    "lone_sum": ([(3, 4)], [(-1, 1)], {}),
    "out_order": ([(3, 4, 5), (5, 6)], [(-1, -2, 1), (1, -3)],
                  {"out_order": [-3, -1, -2]}),
    "con_order": ([(3, 4), (4, 5), (5, 6)], [(-1, 1), (1, 2), (2, -2)],
                  {"con_order": [2, 1]}),
    "greedy": ([(3, 4, 2), (4, 5), (5, 6, 2), (6, 3)],
               [(1, 2, 4), (2, 3), (3, 5, 4), (5, 1)],
               {"con_order": "greedy"}),
    "optimal": ([(3, 4, 2), (4, 5), (5, 6, 2), (6, 3)],
                [(1, 2, 4), (2, 3), (3, 5, 4), (5, 1)],
                {"con_order": "optimal"}),
    "batch_three": ([(2, 3), (2, 3), (2, 3)], [(1, -1), (1, -2), (1, -3)],
                    {}),
    "open_batch": ([(2, 3, 4), (2, 4, 5)], [(-1, -2, 1), (-1, 1, -3)], {}),
    "batch_with_trace": ([(2, 3, 3), (2, 4)], [(-1, 1, 1), (-1, -2)], {}),
    "disconnected": ([(3, 4), (4, 3), (2, 2)], [(1, 2), (2, 1), (3, 3)], {}),
    "ring": ([(3, 3)] * 6, [(i + 1, (i + 1) % 6 + 1) for i in range(6)], {}),
    "strings": ([(3, 4), (4, 5)], [("-a", "k"), ("k", "-b")],
                {"out_order": ["-b", "-a"]}),
    "mixed": ([(3, 4), (4, 5), (5, 2)], [(-1, "x"), ("x", 1), (1, "-y")],
              {"con_order": [1, "x"]}),
}


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_ncon_against_jax(name, dtype):
    shapes, structure, kw = NETWORKS[name]
    arrays = _arrays(len(name), shapes, dtype)
    _close(*_both(arrays, structure, **kw), dtype)


def test_mps_inner_product_zip_order():
    """<psi|psi> of an N=6 chi=4 MPS with the zip con_order, against the
    JAX package and a numpy loop of transfer matrices."""
    N, chi, d = 6, 4, 2
    rng = np.random.default_rng(7)
    As = [rng.standard_normal((1 if i == 0 else chi, d,
                               1 if i == N - 1 else chi)) for i in range(N)]
    tensors = As + [a.conj() for a in As]
    # ket bonds 1..N+1, bra bonds N+2..2N+2, physical 2N+3..; ends shared
    ket = [(i + 1, 2 * N + 3 + i, i + 2) for i in range(N)]
    bra = [(N + 2 + i, 2 * N + 3 + i, N + 3 + i) for i in range(N)]
    ket[0] = (100, 2 * N + 3, 2)
    bra[0] = (100, 2 * N + 3, N + 3)
    ket[-1] = (N, 3 * N + 2, 101)
    bra[-1] = (2 * N + 1, 3 * N + 2, 101)
    order = [100]
    for i in range(N):
        order += [2 * N + 3 + i]
        if i < N - 1:
            order += [i + 2, N + 3 + i]
    order += [101]
    t, j = _both(tensors, ket + bra, con_order=order)
    E = np.ones((1, 1))
    for a in As:
        E = np.einsum("ac,asb,csd->bd", E, a, a.conj())
    _close(t, j, "float64")
    assert abs(t - E[0, 0]) <= 1e-12 * abs(E[0, 0])


def test_canonicalize_structure_matches_jax():
    net = [("-b", "x", 2), ("x", "-a", "y"), ("y", 2, -1)]
    assert TN.canonicalize_structure(net) == JN.canonicalize_structure(net)
    with pytest.raises(ValueError, match="label 0"):
        TN.canonicalize_structure([(0, 1), (1, -1)])


BAD_NETWORKS = [
    ([(3, 4)], [(1, 2), (2, -1)], None, None, "got 1 tensors"),
    ([(3, 4), (4,)], [(1, 2), (2, -1)], None, None, "rank"),
    ([(3, 4), (5, 2)], [(-1, 1), (1, -2)], None, None, "inconsistent"),
    ([(3,), (3,), (3,)], [(-1,), (-1,), (-1,)], None, None, "max 2"),
    ([(3, 3)], [(-1, -1)], None, None, "appears 2 times on tensor"),
    ([(3, 3, 3)], [(1, 1, 1)], None, None, "max 2"),
    ([(3, 3), (3,)], [(1, 1), (1,)], None, None, "traced label"),
    ([(3, 4), (4, 5)], [(-1, 1), (1, -2)], [1, 1], None, "duplicate"),
    ([(3, 4), (4, 5)], [(-1, 1), (1, -2)], [2], None, "permutation"),
    ([(3, 4), (4, 5)], [(-1, 1), (1, -2)], None, [-1, -1], "duplicate"),
    ([(3, 4), (4, 5)], [(-1, 1), (1, -2)], None, [-1, -3], "permutation"),
]


@pytest.mark.parametrize("shapes, structure, con, out, match", BAD_NETWORKS)
def test_check_network_errors_match_jax(shapes, structure, con, out, match):
    for check in (TN.check_network, JN.check_network):
        with pytest.raises(ValueError, match=match):
            check(structure, shapes, con, out)
    arrays = [torch.zeros(s, dtype=torch.float64) for s in shapes]
    with pytest.raises(ValueError, match=match):
        TN.ncon(arrays, structure, con_order=con, out_order=out)


@pytest.mark.parametrize("name", ["ring", "two_traces", "batch_three",
                                  "open_batch", "greedy", "disconnected"])
def test_plan_steps_and_flops_match_jax(name):
    shapes, structure, _ = NETWORKS[name]
    structure, _ = TN.canonicalize_structure(structure)
    tp = TN.compile_plan(structure)
    jp = JN.compile_plan(structure)
    assert repr(tp.steps) == repr(jp.steps)
    assert tp.out_labels == jp.out_labels
    assert tp.flops(shapes) == jp.flops(shapes) > 0


def test_dot_general_axis_order():
    """A pair step gives dot_general's order: batch, lhs free, rhs free."""
    a, b = _arrays(3, [(4, 2, 3, 5), (5, 6, 2)], "float64")
    t = TN.dot_general(torch.from_numpy(a), torch.from_numpy(b), (3,), (0,),
                       (1,), (2,))
    np.testing.assert_allclose(t.numpy(), np.einsum("xbyk,kzb->bxyz", a, b),
                               rtol=1e-12)


def test_mixed_dtypes_promote():
    a, = _arrays(4, [(3, 4)], "float32")
    b, = _arrays(5, [(4, 2)], "complex128")
    t, j = _both([a, b], [(-1, 1), (1, -2)])
    _close(t, j, "complex128")


def test_config_preferred_element_type_and_precision():
    a, b = _arrays(6, [(5, 6), (6, 3)], "float32")
    cfg = TC.Config(preferred_element_type=torch.float64)
    with TC.config_context(cfg) as c:
        assert TC.get_config() is c
        out = TN.ncon([torch.from_numpy(a), torch.from_numpy(b)],
                      [(-1, 1), (1, -2)])
    assert TC.get_config() == TC.Config()
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b,
                               rtol=1e-12)
    with TC.config_context(TC.Config(dot_precision="default")):
        with TC.get_config().precision():
            pass
    with pytest.raises(ValueError, match="dot_precision"):
        TC.Config(dot_precision="bogus")


@pytest.mark.parametrize("dim", [1, 8, 9, 97, 1024, 1500])
def test_bucket_dim_matches_jax(dim):
    assert TC.bucket_dim(dim) == JC.bucket_dim(dim)


def test_default_backend_shims():
    assert TC.get_default_backend() == "pytorch"
    with pytest.warns(UserWarning, match="PyTorch"):
        with TC.DefaultBackend("numpy"):
            assert TC.get_default_backend() == "numpy"
    assert TC.get_default_backend() == "pytorch"
    with pytest.raises(ValueError):
        TC.set_default_backend("bogus")


def test_ncon_builder_and_finalize():
    a, b = _arrays(8, [(3, 4), (4, 5)], "float64")
    A, B = Tensor(torch.from_numpy(a)), Tensor(torch.from_numpy(b))
    out = TN.finalize(A(-1, 1) @ B(1, -2))
    assert isinstance(out, Tensor)
    np.testing.assert_allclose(out.array.numpy(), a @ b, rtol=1e-12)
    with pytest.raises(ValueError):
        A(1)
    with pytest.raises(ValueError):
        A @ B(1, -2)
    # ncon takes Tensors (and Nodes) as operands; jit and backend are
    # accepted for the signature
    np.testing.assert_allclose(
        TN.ncon([A, B], [(-1, 1), (1, -2)], jit=False, backend="jax").numpy(),
        a @ b, rtol=1e-12)
