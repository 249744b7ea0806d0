"""The port's functional layer (``Tensor``, ``core.linalg``,
``core.node_linalg``) against the JAX package's, on the CPU.

The same seeded numpy inputs go through both; values agree within 1e-12
relative in float64.  The random initializers draw from a
``torch.Generator``, whose numbers differ from ``jax.random``'s: they are
held to shape, dtype, moments and repeatability by seed.
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


def _arr(seed, *shape, complex_=False, positive=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if positive:
        a = np.abs(a) + 0.5
    return a + 1j * rng.standard_normal(shape) if complex_ else a


def _wrap(P, a):
    return P.Tensor(torch.from_numpy(np.array(a)) if P is T else a)


def _np(x):
    if isinstance(x, (T.Tensor, J.Tensor)):
        x = x.array
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _close(got, want, tol=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


# name -> (arguments as numpy arrays or plain values, keyword arguments)
FREE_FUNCTIONS = {
    "tensordot": ((_arr(1, 3, 4, 5), _arr(2, 5, 4, 2), [[1, 2], [1, 0]]), {}),
    "einsum": (("abc,cd,db->a", _arr(3, 2, 3, 4), _arr(4, 4, 5),
                _arr(5, 5, 3)), {}),
    "reshape": ((_arr(6, 2, 6), (3, 4)), {}),
    "transpose": ((_arr(7, 2, 3, 4),), {"perm": (1, 2, 0)}),
    "transpose_default": ((_arr(7, 2, 3, 4),), {}),
    "take_slice": ((_arr(8, 5, 6), (1, 4), (3, 3)), {}),
    "take_slice_clamped": ((_arr(8, 5, 6), (4, -2), (3, 3)), {}),
    "sqrt": ((_arr(9, 3, 4, positive=True),), {}),
    "outer": ((_arr(10, 3), _arr(11, 2, 2)), {}),
    "ncon": (([_arr(12, 3, 4), _arr(13, 4, 5)], [(-1, 1), (1, -2)]), {}),
    "diagonal": ((_arr(14, 3, 4, 4),), {"offset": 1}),
    "diagflat": ((_arr(15, 2, 2),), {"k": -1}),
    "trace": ((_arr(16, 2, 4, 4),), {}),
    "sign": ((_arr(17, 3, 3, complex_=True),), {}),
    "sign_real": ((_arr(17, 3, 3),), {}),
    "abs": ((_arr(18, 3, 3, complex_=True),), {}),
    "conj": ((_arr(19, 3, 3, complex_=True),), {}),
    "hconj": ((_arr(20, 2, 3, 4, complex_=True),), {"perm": (2, 0, 1)}),
    "sin": ((_arr(21, 3, 3),), {}),
    "cos": ((_arr(22, 3, 3),), {}),
    "exp": ((_arr(23, 3, 3, complex_=True),), {}),
    "log": ((_arr(24, 3, 3, positive=True),), {}),
    "pivot": ((_arr(25, 2, 3, 4),), {"pivot_axis": 2}),
    "kron": ((_arr(26, 2, 3), _arr(27, 4, 5)), {}),
    "norm": ((_arr(28, 3, 4, complex_=True),), {}),
    "inv": ((_arr(29, 4, 4) + 4 * np.eye(4),), {}),
    "expm": ((_arr(30, 4, 4),), {}),
}


# cases of one function under other names
ALIASES = {"transpose_default": "transpose", "take_slice_clamped":
           "take_slice", "sign_real": "sign"}


def _call(P, name, args, kw):
    args = [_wrap(P, a) if isinstance(a, np.ndarray) else
            ([_wrap(P, x) for x in a] if isinstance(a, list)
             and isinstance(a[0], np.ndarray) else a) for a in args]
    return getattr(P.linalg, ALIASES.get(name, name))(*args, **kw)


@pytest.mark.parametrize("name", sorted(FREE_FUNCTIONS))
def test_free_functions_against_jax(name):
    args, kw = FREE_FUNCTIONS[name]
    _close(_call(T, name, args, kw), _call(J, name, args, kw))


def test_shape_and_tensor_api():
    a, b = _arr(40, 2, 3, complex_=True), _arr(41, 2, 3)
    for P in (T, J):
        assert P.linalg.shape(_wrap(P, a)) == (2, 3)
    t, j = _wrap(T, a), _wrap(J, a)
    tb, jb = _wrap(T, b), _wrap(J, b)
    assert (t.shape, t.ndim, t.size) == (j.shape, j.ndim, j.size)
    for got, want in [(t.T, j.T), (t.H, j.H), (t.conj(), j.conj()),
                      (t.hconj, j.hconj), (t.reshape((3, 2)),
                                           j.reshape((3, 2))),
                      (t.transpose((1, 0)), j.transpose((1, 0))),
                      (t.flatten(), j.flatten()), (t.ravel(), j.ravel()),
                      (t.reshape((1, 6)).squeeze(), j.reshape((1, 6)).squeeze()),
                      (t + tb, j + jb), (1.5 + t, 1.5 + j), (t - tb, j - jb),
                      (2.0 - t, 2.0 - j), (t * tb, j * jb), (3 * t, 3 * j),
                      (t / (tb * tb + 1), j / (jb * jb + 1)),
                      (1 / (tb * tb + 1), 1 / (jb * jb + 1)), (-t, -j),
                      (tb ** 2, jb ** 2), (t @ tb.T, j @ jb.T), (t[1], j[1])]:
        _close(got, want)
    c = t.copy()
    c.array.zero_()
    assert torch.count_nonzero(t.array) == t.size
    assert repr(T.Tensor(torch.zeros(2))) == "Tensor(shape=(2,), dtype=" \
        "torch.float32)"


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_decompositions_against_jax(dtype):
    a = _arr(50, 4, 3, 5, complex_=dtype == "complex128")
    t, j = _wrap(T, a), _wrap(J, a)
    # QR and RQ with a non-negative diagonal are unique at full rank
    for name in ("qr", "rq"):
        for got, want in zip(getattr(T.linalg, name)(t, 2, True),
                             getattr(J.linalg, name)(j, 2, True)):
            _close(got, want, 1e-10)
    u, s, vh, rest = T.linalg.svd(t, 2, max_singular_values=3)
    ju, js, jvh, jrest = J.linalg.svd(j, 2, max_singular_values=3)
    _close(s, js, 1e-12)
    _close(rest, jrest, 1e-12)
    _close(T.ncon([u, s.array, vh], [(-1, -2, 1), (1,), (1, -3)]),
           J.ncon([ju.array, js.array, jvh.array],
                  [(-1, -2, 1), (1,), (1, -3)]), 1e-12)
    h = _arr(51, 3, 2, 3, 2).reshape(6, 6)
    h = (h + h.T).reshape(3, 2, 3, 2)
    e, v = T.linalg.eigh(_wrap(T, h), 2)
    je, jv = J.linalg.eigh(_wrap(J, h), 2)
    _close(e, je, 1e-12)
    assert v.shape == jv.shape


def test_constant_initializers_against_jax():
    for name, args in (("eye", (3,)), ("zeros", ((2, 3),)),
                       ("ones", ((2, 3),))):
        _close(getattr(T.linalg, name)(*args, device="cpu"),
               getattr(J.linalg, name)(*args))
    _close(T.linalg.eye(3, M=5, device="cpu"), J.linalg.eye(3, M=5))
    for name, args in (("eye", (3,)), ("zeros", ((2, 3),)),
                       ("ones", ((2, 3),))):
        got = getattr(T.node_linalg, name)(*args, name="n", device="cpu")
        want = getattr(J.node_linalg, name)(*args, name="n")
        _close(got.tensor, want.tensor)
        assert got.tensor.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128])
def test_random_initializers(dtype):
    """Shape, dtype, moments, bounds and repeatability by seed."""
    n = 40000
    a = T.linalg.randn((n,), dtype, seed=3, device="cpu").array
    assert a.shape == (n,) and a.dtype == dtype
    assert torch.equal(a, T.linalg.randn((n,), dtype, seed=3,
                                         device="cpu").array)
    assert not torch.equal(a, T.linalg.randn((n,), dtype, seed=4,
                                             device="cpu").array)
    parts = [a.real, a.imag] if dtype.is_complex else [a]
    for p in parts:
        p = p.double()
        assert abs(float(p.mean())) < 0.03 and abs(float(p.var()) - 1) < 0.03
    u = T.linalg.random_uniform((n,), dtype, seed=5, boundaries=(2.0, 3.0),
                                device="cpu").array
    assert u.dtype == dtype and torch.equal(u, T.linalg.random_uniform(
        (n,), dtype, seed=5, boundaries=(2.0, 3.0), device="cpu").array)
    for p in ([u.real, u.imag] if dtype.is_complex else [u]):
        p = p.double()
        assert float(p.min()) >= 2.0 and float(p.max()) <= 3.0
        assert abs(float(p.mean()) - 2.5) < 0.01
        assert abs(float(p.var()) - 1 / 12) < 0.005
    fresh = [T.linalg.randn((8,), dtype, device="cpu").array
             for _ in range(2)]
    assert not torch.equal(*fresh)
    node = T.node_linalg.randn((2, 3), seed=1, device="cpu")
    assert node.tensor.dtype == torch.float32 and node.shape == (2, 3)
    node = T.node_linalg.random_uniform((2, 3), seed=1, device="cpu",
                                        boundaries=(-1.0, 0.0))
    assert float(node.tensor.max()) <= 0.0


def test_node_linalg_against_jax():
    a = _arr(60, 2, 3, 2, 3, complex_=True)
    t, j = T.Node(torch.from_numpy(a), name="x"), J.Node(a, name="x")
    _close(T.node_linalg.norm(t), J.node_linalg.norm(j))
    _close(T.node_linalg.conj(t).tensor, J.node_linalg.conj(j).tensor)
    got = T.node_linalg.transpose(t, [3, 2, "0", 1], name="y")
    want = J.node_linalg.transpose(j, [3, 2, "0", 1], name="y")
    _close(got.tensor, want.tensor)
    assert (got.name, got.axis_names) == (want.name, want.axis_names)
    b = _arr(61, 2, 2)
    kt = T.node_linalg.kron([T.Node(torch.from_numpy(a)),
                             T.Node(torch.from_numpy(b))])
    kj = J.node_linalg.kron([J.Node(a), J.Node(b)])
    _close(kt.tensor, kj.tensor)
    with pytest.raises(ValueError, match="even order"):
        T.node_linalg.kron([T.Node(torch.zeros(2, 2, 2))])


def test_krylov_wrappers_against_exact():
    n = 20
    rng = np.random.default_rng(70)
    H = rng.standard_normal((n, n))
    H = (H + H.T) / 2
    Ht = torch.from_numpy(H)
    x0 = rng.standard_normal(n)
    evals, evecs = T.linalg.eigsh_lanczos(
        lambda x, s: T.Tensor(s.array * (Ht @ x.array)),
        args=[torch.tensor(1.0, dtype=torch.float64)],
        initial_state=T.Tensor(torch.from_numpy(x0)), num_krylov_vecs=20,
        numeig=2)
    je, _ = J.linalg.eigsh_lanczos(
        lambda x: J.Tensor(H @ x.array), initial_state=J.Tensor(x0),
        num_krylov_vecs=20, numeig=2)
    exact = np.linalg.eigvalsh(H)[:2]
    np.testing.assert_allclose([float(e) for e in evals], exact, rtol=1e-8)
    np.testing.assert_allclose([float(e) for e in evals],
                               [float(e) for e in je], rtol=1e-10)
    v = evecs[0].array.numpy()
    np.testing.assert_allclose(H @ v, exact[0] * v, atol=1e-7)
    with pytest.raises(ValueError, match="initial_state"):
        T.linalg.eigsh_lanczos(lambda x: x)
    # a start drawn by the port's randn on the CPU
    evals, _ = T.linalg.eigsh_lanczos(
        lambda x: T.Tensor(Ht @ x.array), shape=(n,), dtype=torch.float64,
        device="cpu", num_krylov_vecs=20)
    np.testing.assert_allclose(float(evals[0]), exact[0], rtol=1e-8)

    A = rng.standard_normal((n, n)) / np.sqrt(n) + np.diag(
        np.linspace(1, 3, n))
    At = torch.from_numpy(A)
    vals, vecs = T.linalg.eigs(lambda x: T.Tensor(At @ x.array),
                               initial_state=T.Tensor(torch.from_numpy(x0)),
                               num_krylov_vecs=n, numeig=1)
    dominant = max(np.linalg.eigvals(A), key=abs)
    assert abs(complex(vals[0]) - dominant) < 1e-8 * abs(dominant)
    b = rng.standard_normal(n)
    M = np.eye(n) * 3 + H * 0.1
    Mt = torch.from_numpy(M)
    x, info = T.linalg.gmres(lambda x: T.Tensor(Mt @ x.array),
                             T.Tensor(torch.from_numpy(b)),
                             num_krylov_vectors=20, maxiter=3)
    np.testing.assert_allclose(M @ x.array.numpy(), b, atol=1e-8)
    assert info == 0
