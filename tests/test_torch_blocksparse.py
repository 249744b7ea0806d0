"""The port's block-sparse tensors against the JAX package's, on the CPU.

Both packages get the same charges and the same seeded draws (their
initializers draw from one numpy generator, so the data bits agree); each
test compares what the two compute: charge algebra exactly, tensordot,
transpose/reshape and todense against the JAX numpy engine, the port's
bucketed executor against its own per-sector loop and against the JAX
``tensordot_device``, the linear algebra by reconstruction and spectra.
Tolerances: 1e-12 of the largest entry in float64, 1e-5 in float32.
"""
import numpy as np
import pytest
import torch

import tensornetwork_tpu.blocksparse as J
import tensornetwork_tpu_torch.blocksparse as T
from tensornetwork_tpu.blocksparse import jax_engine as JE
from tensornetwork_tpu.blocksparse import linalg as JL
from tensornetwork_tpu_torch.blocksparse import linalg as TL
from tensornetwork_tpu_torch.blocksparse import torch_engine as TE

TOL = {np.float64: 1e-12, np.float32: 1e-5, np.complex128: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _charges(rng, d, kind):
    if kind == "u1":
        return [rng.integers(-2, 3, d)]
    if kind == "z2":
        return [rng.integers(0, 2, d)]
    if kind == "z3":
        return [rng.integers(0, 3, d)]
    return [rng.integers(-1, 2, d), rng.integers(-1, 2, d)]  # u1 x u1


def _make(P, kind, raw):
    if kind == "u1":
        return P.U1Charge(raw[0])
    if kind == "z2":
        return P.Z2Charge(raw[0])
    if kind == "z3":
        return P.ZNCharge(3)(raw[0])
    return P.U1Charge(raw[0]) @ P.U1Charge(raw[1])


def _indices(P, kind, raws, flows):
    return [P.Index(_make(P, kind, r), f) for r, f in zip(raws, flows)]


def pair(seed, dims, flows, kind="u1", dtype=np.float64, raws=None):
    """The same random tensor in both packages: (JAX, port, raw charges)."""
    rng = np.random.default_rng(seed)
    raws = raws or [_charges(rng, d, kind) for d in dims]
    j = J.randn(_indices(J, kind, raws, flows), dtype=dtype, seed=seed)
    t = T.randn(_indices(T, kind, raws, flows), dtype=dtype, seed=seed,
                device="cpu")
    np.testing.assert_array_equal(j.data, t.data.numpy())
    return j, t, raws


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def close(got, want, dtype=np.float64):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


KINDS = ("u1", "z2", "z3", "u1xu1")


@pytest.mark.parametrize("kind", KINDS)
def test_charge_algebra_and_index_match(kind):
    rng = np.random.default_rng(1)
    raws = [_charges(rng, d, kind) for d in (5, 4, 3)]
    jc = [_make(J, kind, r) for r in raws]
    tc = [_make(T, kind, r) for r in raws]
    flows = [False, True, False]
    np.testing.assert_array_equal(J.fuse_charges(jc, flows).charges,
                                  T.fuse_charges(tc, flows).charges)
    ju, ji, jn = jc[0].unique(return_inverse=True, return_counts=True)
    tu, ti, tn_ = tc[0].unique(return_inverse=True, return_counts=True)
    np.testing.assert_array_equal(ju.charges, tu.charges)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jn, tn_)
    a, ia, ib = jc[0].intersect(jc[1], return_indices=True)
    b, ja, jb = tc[0].intersect(tc[1], return_indices=True)
    np.testing.assert_array_equal(a.charges, b.charges)
    np.testing.assert_array_equal(ia, ja)
    np.testing.assert_array_equal(ib, jb)
    ji2 = J.Index(jc[0], False) * J.Index(jc[1], True)
    ti2 = T.Index(tc[0], False) * T.Index(tc[1], True)
    assert ji2.dim == ti2.dim == 20
    np.testing.assert_array_equal(ji2.charges.charges, ti2.charges.charges)
    np.testing.assert_array_equal(ji2.flip_flow().charges.charges,
                                  ti2.flip_flow().charges.charges)
    np.testing.assert_array_equal(J.fuse_ndarrays([raws[0][0], raws[1][0]]),
                                  T.fuse_ndarrays([raws[0][0], raws[1][0]]))


@pytest.mark.parametrize("kind", KINDS)
def test_fromdense_todense_and_structure(kind):
    j, t, raws = pair(2, (6, 5, 4), (False, True, False), kind)
    close(t.todense(), j.todense())
    dense = np.random.default_rng(3).standard_normal((6, 5, 4))
    jf = J.BlockSparseTensor.fromdense(j.sparse_shape, dense)
    tf = T.BlockSparseTensor.fromdense(t.sparse_shape,
                                       torch.from_numpy(dense))
    np.testing.assert_array_equal(jf.data, tf.data.numpy())
    assert tf.shape == jf.shape and tf.size == jf.size
    assert T.tensor.compute_num_nonzero(t._charges, t._flows) == \
        t.data.shape[0]
    np.testing.assert_array_equal(
        J.tensor.nonzero_dense_coords(j._charges, j._flows),
        T.tensor.nonzero_dense_coords(t._charges, t._flows))


@pytest.mark.parametrize("perm", [(2, 0, 1), (1, 2, 0), (0, 2, 1)])
def test_transpose_reshape_bit_for_bit(perm):
    j, t, _ = pair(4, (5, 4, 6), (False, True, False))
    jt, tt = j.transpose(perm), t.transpose(perm)
    np.testing.assert_array_equal(jt.data, tt.data.numpy())
    assert jt.shape == tt.shape and tt.flat_flows == jt.flat_flows
    jr = j.reshape([20, 6]).transpose([1, 0])
    tr = t.reshape([20, 6]).transpose([1, 0])
    np.testing.assert_array_equal(jr.data, tr.data.numpy())
    close(tr.todense(), jr.todense())
    close(t.T.todense(), j.T.todense())
    with pytest.raises(ValueError):
        t.reshape([7, 17, 1])


def _contraction_cases(dtype):
    """(name, JAX operands, port operands, axes)."""
    cases = []
    a, ta, ra = pair(10, (8, 7, 6), (False, True, False), dtype=dtype)
    rng = np.random.default_rng(11)
    rb = [ra[2], _charges(rng, 9, "u1")]
    b, tb, _ = pair(12, (6, 9), (True, False), dtype=dtype, raws=rb)
    cases.append(("matrix", (a, b), (ta, tb), [[2], [0]]))
    rc = [ra[0], _charges(rng, 4, "u1"), ra[1]]
    c, tc, _ = pair(13, (8, 4, 7), (True, False, False), dtype=dtype,
                    raws=rc)
    cases.append(("two legs permuted", (a, c), (ta, tc), [[1, 0], [2, 0]]))
    cases.append(("gram", (a, a.conj()), (ta, ta.conj()),
                  [[0, 1], [0, 1]]))
    cases.append(("full", (a, a.conj()), (ta, ta.conj()),
                  [[0, 1, 2], [0, 1, 2]]))
    return cases


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tensordot_matches_numpy_engine(dtype):
    for name, (a, b), (ta, tb), axes in _contraction_cases(dtype):
        want = J.tensordot(a, b, axes)
        got = T.tensordot(ta, tb, axes)
        if name == "full":
            close(got, np.asarray(want), dtype)
            continue
        np.testing.assert_array_equal(got.shape, want.shape)
        assert got.dtype == T.tensor.torch_dtype(dtype)
        close(got.data, want.data, dtype)
        close(got.todense(), want.todense(), dtype)


def test_executor_matches_loop_and_jax_device_engine():
    for name, (a, b), (ta, tb), axes in _contraction_cases(np.float64):
        loop = T.tensordot(ta, tb, axes)
        got = TE.tensordot_device(ta, tb, axes)
        again = TE.tensordot_device(ta, tb, axes)
        want = JE.tensordot_device(a, b, axes)
        if name == "full":
            close(got, loop)
            close(got, np.asarray(want))
            continue
        close(got.data, loop.data)
        close(got.data, np.asarray(want.data))
        # the padded positions land in the dummy slot only: repeat runs
        # give the same bits
        assert torch.equal(got.data, again.data)


def test_executor_batch_axis_folds_into_the_gemm_batch():
    _, (a, b), (ta, tb), axes = _contraction_cases(np.float64)[1]
    rng = np.random.default_rng(14)
    B = 3
    d1 = torch.from_numpy(rng.standard_normal((B, ta.data.shape[0])))
    d2 = torch.from_numpy(rng.standard_normal((B, tb.data.shape[0])))
    plan = TE._get_plan(ta, tb, [1, 0], [2, 0])
    out = plan["run"](d1, d2)
    for i in range(B):
        want = T.tensordot(ta._like(d1[i]), tb._like(d2[i]), axes)
        close(out[i], want.data)
    # a shared second operand broadcasts over the batch
    close(plan["run"](d1, d2[0])[1], plan["run"](d1[1], d2[0]))
    true, padded = TE.plan_flops(plan)
    assert 0 < true <= padded


def test_tensordot_batched_matches_jax():
    rng = np.random.default_rng(15)
    rb = _charges(rng, 5, "u1")
    rk = _charges(rng, 4, "u1")
    a, ta, _ = pair(16, (5, 4, 3), (False, True, False),
                    raws=[rb, rk, _charges(rng, 3, "u1")])
    b, tb, _ = pair(17, (5, 4, 6), (True, False, True),
                    raws=[rb, rk, _charges(rng, 6, "u1")])
    want = J.tensor.tensordot_batched(a, b, ([1], [1]), ([0], [0]))
    got = T.tensor.tensordot_batched(ta, tb, ([1], [1]), ([0], [0]))
    assert got.shape == want.shape
    close(got.todense(), want.todense())


def _bond_pair(seed, kind="u1", d=8, dtype=np.float64):
    """A square block-sparse matrix (c[False], c[True]) in both packages:
    every sector populated."""
    rng = np.random.default_rng(seed)
    raw = _charges(rng, d, kind)
    return pair(seed, (d, d), (False, True), kind, dtype, raws=[raw, raw])


@pytest.mark.parametrize("kind", KINDS)
def test_svd_qr_reconstruct_and_spectra_match(kind):
    j, t, _ = pair(20, (5, 4, 6), (False, True, False), kind)
    jm, tm = j.reshape([20, 6]), t.reshape([20, 6])
    U, S, V = T.svd(tm)
    _, S0, _ = J.svd(jm)
    np.testing.assert_allclose(np.sort(S.data.numpy()), np.sort(S0.data),
                               atol=1e-12)
    rec = T.tensordot(T.tensordot(U, T.diag(S), [[1], [0]]), V, [[1], [0]])
    close(rec.todense(), tm.todense())
    Q, R = T.qr(tm)
    close(T.tensordot(Q, R, [[1], [0]]).todense(), tm.todense())
    q = Q.todense().numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-12)
    sv = T.svd(tm, compute_uv=False)
    np.testing.assert_allclose(np.sort(sv.data.numpy()), np.sort(S0.data),
                               atol=1e-12)


@pytest.mark.parametrize("cut", [dict(max_singular_values=5),
                                 dict(max_truncation_error=0.5),
                                 dict(max_truncation_error=0.2,
                                      relative=True)])
def test_truncated_svd_global_ranking_matches(cut):
    j, t, _ = pair(21, (6, 5, 8), (False, True, False))
    U, S, V, rest = TL.truncated_svd(t.reshape([30, 8]), **cut)
    U0, S0, V0, rest0 = JL.truncated_svd(j.reshape([30, 8]), **cut)
    np.testing.assert_allclose(S.data.numpy(), S0.data, atol=1e-12)
    np.testing.assert_allclose(rest.numpy(), rest0, atol=1e-12)
    np.testing.assert_array_equal(S.flat_charges[0].charges,
                                  S0.flat_charges[0].charges)
    rec = T.tensordot(T.tensordot(U, T.diag(S), [[1], [0]]), V, [[1], [0]])
    rec0 = J.tensordot(J.tensordot(U0, J.diag(S0), [[1], [0]]), V0,
                       [[1], [0]])
    close(rec.todense(), rec0.todense())


@pytest.mark.parametrize("kind", ("u1", "z2"))
def test_eigh_eig_inv_pinv_trace_match(kind):
    j, t, _ = _bond_pair(22, kind)
    # a symmetric matrix with legs (c[False], c[True]): A A^T
    jh = J.tensordot(j, j.conj(), [[1], [1]])
    th = T.tensordot(t, t.conj(), [[1], [1]])
    E, V = T.eigh(th)
    E0, _ = J.eigh(jh)
    np.testing.assert_allclose(np.sort(E.data.numpy()), np.sort(E0.data),
                               atol=1e-12)
    rec = T.tensordot(T.tensordot(V, T.diag(E), [[1], [0]]), V.conj(),
                      [[1], [1]])
    close(rec.todense(), th.todense())
    Ec, _ = T.eig(t)
    Ec0, _ = J.eig(j)
    np.testing.assert_allclose(np.sort_complex(Ec.data.numpy()),
                               np.sort_complex(Ec0.data), atol=1e-10)
    close(T.inv(t).todense(), J.inv(j).todense())
    eye = T.tensordot(T.inv(t), t, [[1], [0]]).todense().numpy()
    np.testing.assert_allclose(eye, np.eye(8), atol=1e-10)
    close(T.pinv(t).todense(), J.pinv(j).todense())
    close(T.trace(t), np.asarray(J.trace(j)))
    assert abs(T.norm(t) - J.norm(j)) < 1e-12
    close(T.diag(t).data, J.diag(j).data)
    close(T.eye(t.sparse_shape[0], device="cpu").todense(),
          J.eye(j.sparse_shape[0]).todense())


def test_partial_trace_and_elementwise_match():
    rng = np.random.default_rng(23)
    r = _charges(rng, 4, "u1")
    j, t, _ = pair(24, (5, 4, 4), (False, False, True),
                   raws=[_charges(rng, 5, "u1"), r, r])
    close(TL.trace(t, (1, 2)).todense(), JL.trace(j, (1, 2)).todense())
    close(T.sqrt(T.abs(t)).data, J.sqrt(J.abs(j)).data)
    close(T.sign(t).data, J.sign(j).data)
    close((2.0 * t - t / 4.0 + (-t)).data, (2.0 * j - j / 4.0 + (-j)).data)
    with pytest.raises(ValueError):
        t + t.transpose([0, 2, 1])
    with pytest.raises(ValueError):
        T.tensordot(t, t, [[0], [0]])     # flows do not match
    with pytest.raises(NotImplementedError):
        T.svd(t.reshape([20, 4]), full_matrices=True)


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_initializers_draw_the_jax_bits(dtype):
    rng = np.random.default_rng(25)
    raws = [_charges(rng, d, "u1") for d in (4, 5)]
    ji = _indices(J, "u1", raws, [False, True])
    ti = _indices(T, "u1", raws, [False, True])
    for name, kw in (("randn", {}), ("random", dict(boundaries=(-1, 2)))):
        j = getattr(J, name)(ji, dtype=dtype, seed=7, **kw)
        t = getattr(T, name)(ti, dtype=dtype, seed=7, device="cpu", **kw)
        np.testing.assert_array_equal(j.data, t.data.numpy())
    np.testing.assert_array_equal(J.randn_like(j, seed=3).data,
                                  T.randn_like(t, seed=3).data.numpy())
    assert T.ones(ti, dtype=dtype, device="cpu").data.sum() == \
        J.ones(ji, dtype=dtype).data.sum()
    assert not T.zeros(ti, device="cpu").data.any()
    assert T.empty_like(t).data.shape == t.data.shape


def test_matmul_item_copy_and_hermitian():
    j, t, _ = _bond_pair(26, dtype=np.complex128)
    close((t @ t).todense(), (j @ j).todense(), np.complex128)
    close(t.H.todense(), j.H.todense(), np.complex128)
    c = t.copy()
    c.data.zero_()
    assert t.data.abs().sum() > 0
    one = T.randn([T.Index(T.U1Charge(np.array([0])), False),
                   T.Index(T.U1Charge(np.array([0])), True)], seed=1,
                  device="cpu")
    assert one.item() == one.data.item()


def test_caching_memoizes_the_lookup():
    j, t, _ = pair(27, (5, 4, 6), (False, True, False))
    T.clear_cache()
    T.enable_caching()
    try:
        first = T.tensor.find_diagonal_blocks(t._charges, t._flows, 1)
        assert T.tensor.find_diagonal_blocks(t._charges, t._flows, 1) \
            is first
        assert not T.get_cacher().is_empty
    finally:
        T.disable_caching()
        T.clear_cache()
