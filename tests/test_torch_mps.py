"""The port's FiniteMPS against the JAX package's, on the CPU.

Both packages get the same site tensors, made with numpy from a seed.  The
gauge of a canonical form is compared only where the factorization is
unique; everything else is compared through gauge-invariant quantities:
the dense block state, norms and measurements.  The gates are in
tests/test_torch_mps_gates.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.models import mps as jmps
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.models import mps as tmps

# f64/complex128 against the same LAPACK factorizations: ~1e-14 seen;
# f32: the dtype's rounding over a few sweeps of chi=8 products
TOL = {"float64": 1e-10, "complex128": 1e-10, "float32": 1e-5,
       "complex64": 1e-5}
DTYPES = ["float64", "complex128", "float32"]
N, CHI, D = 6, 8, 2
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])
Y = np.array([[0.0, -1j], [1j, 0.0]])


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _stack(seed, dtype, n=N, chi=CHI):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, chi, D, chi))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, chi, D, chi))
    return (a / np.sqrt(chi * D)).astype(dtype)


def _pair(seed, dtype, canonicalize=True, **kw):
    a = _stack(seed, dtype, **kw)
    return (jmps.FiniteMPS(jnp.asarray(a), canonicalize=canonicalize),
            tmps.FiniteMPS(torch.from_numpy(a), canonicalize=canonicalize))


def _product_state(dtype, n=N, chi=CHI):
    v = np.array([1.0, 0.6 + 0.3j]) / np.hypot(np.hypot(1.0, 0.6), 0.3)
    a = np.zeros((n, chi, D, chi), dtype)
    a[:, 0, :, 0] = v.astype(dtype)
    return a


def _close(t, j, dtype, scale=1.0):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               atol=TOL[dtype] * scale,
                               rtol=TOL[dtype] * scale)


def _dense(m):
    return m.to_dense().numpy() if isinstance(m, tmps.FiniteMPS) else \
        np.asarray(m.to_dense())


@pytest.mark.parametrize("dtype", DTYPES)
def test_canonicalize_matches_jax(dtype):
    jm, tm = _pair(0, dtype, canonicalize=False)
    jn = jm.canonicalize(normalize=False)
    tn = tm.canonicalize(normalize=False)
    _close(tn, jn, dtype)
    assert tm.center_position == jm.center_position == 0
    # Householder QR through LAPACK on both sides: the same tensors
    _close(tm.As, jm.As, dtype, 10)
    _close(tm.check_canonical(), jm.check_canonical(), dtype, 10)
    assert float(tm.check_canonical()) < 10 * TOL[dtype]
    jn = jm.canonicalize()
    tn = tm.canonicalize()
    _close(tn, jn, dtype)
    _close(tm.norm(), 1.0, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_position_matches_jax(dtype, normalize):
    jm, tm = _pair(1, dtype)
    for site in (N - 1, 2, 0, 3):
        _close(tm.position(site, normalize), jm.position(site, normalize),
               dtype)
        assert tm.center_position == jm.center_position == site
        _close(tm.check_canonical(), jm.check_canonical(), dtype, 10)
        _close(tm.As, jm.As, dtype, 10)
    _close(_dense(tm), _dense(jm), dtype)
    with pytest.raises(ValueError, match="not between"):
        tm.position(N)


@pytest.mark.parametrize("dtype", ["complex64", "complex128", "float64"])
def test_position_on_a_product_state(dtype):
    # rank-deficient panels: complex64 Householder QR on the CPU returns
    # NaN there unless factored in complex128 (decompositions.lapack_factor)
    a = _product_state(dtype if np.dtype(dtype).kind == "c" else "complex128")
    a = a.real.astype(dtype) if dtype == "float64" else a
    jm = jmps.FiniteMPS(jnp.asarray(a), canonicalize=False, center_position=0)
    tm = tmps.FiniteMPS(torch.from_numpy(a), canonicalize=False,
                        center_position=0)
    for site in (N - 1, 1):
        _close(tm.position(site), jm.position(site), dtype)
        assert bool(torch.isfinite(torch.view_as_real(tm.As.to(
            torch.complex128))).all())
        _close(tm.check_canonical(), jm.check_canonical(), dtype, 10)
    _close(_dense(tm), _dense(jm), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_inner_and_dense(dtype):
    jm, tm = _pair(2, dtype, canonicalize=False)
    jo, to = _pair(3, dtype, canonicalize=False)
    _close(tm.norm(), jm.norm(), dtype)
    _close(tm.inner(to), jm.inner(jo), dtype)
    _close(tm.to_dense(), jm.to_dense(), dtype)
    dense = tm.to_dense().numpy()
    assert dense.shape == (CHI,) + (D,) * N + (CHI,)
    _close(torch.tensor(np.sqrt(np.sum(np.abs(dense) ** 2))), jm.norm(),
           dtype)
    with pytest.raises(ValueError, match="equal bond"):
        tm.inner(tmps.FiniteMPS(torch.from_numpy(_stack(0, dtype, chi=4))))


@pytest.mark.parametrize("dtype", DTYPES)
def test_envs_and_transfer_operator(dtype):
    jm, tm = _pair(4, dtype, canonicalize=False)
    sites = [0, 2, N - 1]
    for tfn, jfn in ((tm.left_envs, jm.left_envs),
                     (tm.right_envs, jm.right_envs)):
        te, je = tfn(sites), jfn(sites)
        assert sorted(te) == sorted(je) == sites
        for s in sites:
            _close(te[s], je[s], dtype)
    m = _stack(5, dtype)[0, :, 0, :]
    for direction in (1, "l", "left", -1, "r", "right"):
        _close(tm.apply_transfer_operator(2, direction, torch.from_numpy(m)),
               jm.apply_transfer_operator(2, direction, jnp.asarray(m)),
               dtype)
    with pytest.raises(ValueError, match="direction"):
        tm.apply_transfer_operator(2, "up", torch.from_numpy(m))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("canonical", [False, True])
def test_measure_local_operator(dtype, canonical):
    jm, tm = _pair(6, dtype, canonicalize=canonical)
    ops = [Z, X, Z @ X + X @ Z, np.eye(2)] + ([Y] if dtype != "float32"
                                             and "complex" in dtype else [])
    sites = [0, 3, N - 1, 2, 1][:len(ops)]
    for t, j in zip(tm.measure_local_operator(ops, sites),
                    jm.measure_local_operator(ops, sites)):
        _close(t, j, dtype)
    with pytest.raises(ValueError, match="len"):
        tm.measure_local_operator([Z], [0, 1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("site1", [0, 2, N - 1])
def test_measure_two_body_correlator(dtype, site1):
    jm, tm = _pair(7, dtype)
    sites2 = [N - 1, 0, site1, 3, 1]
    t = tm.measure_two_body_correlator(X, Z, site1, sites2)
    j = jm.measure_two_body_correlator(X, Z, site1, sites2)
    assert len(t) == len(sites2)
    for a, b in zip(t, j):
        _close(a, b, dtype)


def test_ragged_constructor():
    rng = np.random.default_rng(11)
    shapes = [(1, D, 2), (2, D, 4), (4, D, 3), (3, D, 1)]
    ts = [rng.standard_normal(s) for s in shapes]
    jm = jmps.FiniteMPS([jnp.asarray(t) for t in ts], canonicalize=False)
    tm = tmps.FiniteMPS([torch.from_numpy(t) for t in ts],
                        canonicalize=False)
    assert tm.As.shape == (4, 4, D, 4)
    np.testing.assert_array_equal(tm.As.numpy(), np.asarray(jm.As))
    assert tm.bond_dimensions == jm.bond_dimensions == [4] * 5
    assert tm.physical_dimensions == [D] * 4 and len(tm) == 4
    tc = tmps.FiniteMPS([torch.from_numpy(t) for t in ts])
    jc = jmps.FiniteMPS([jnp.asarray(t) for t in ts])
    _close(tc.to_dense(), jc.to_dense(), "float64")
    # numpy arrays and lists take device="cpu"
    tn = tmps.FiniteMPS(ts, canonicalize=False, device="cpu")
    np.testing.assert_array_equal(tn.As.numpy(), tm.As.numpy())
    with pytest.raises(ValueError, match="stacked"):
        tmps.FiniteMPS(torch.zeros(3, 2, 2), canonicalize=False)


@pytest.mark.parametrize("center", [None, 3])
def test_save_load_round_trip(tmp_path, center):
    _, tm = _pair(12, "complex128", canonicalize=False)
    tm.center_position = center
    path = str(tmp_path / "mps.pt")
    tm.save(path)
    back = tmps.FiniteMPS.load(path, device="cpu")
    assert back.center_position == center
    assert back.As.dtype == torch.complex128
    np.testing.assert_array_equal(back.As.numpy(), tm.As.numpy())


def test_interop_keeps_the_jax_state_as_it_is():
    jm, _ = _pair(13, "float64")
    jm.position(4)
    tm = interop.finite_mps_from_numpy(np.asarray(jm.As), jm.center_position,
                                       device="cpu")
    assert tm.center_position == 4
    np.testing.assert_array_equal(tm.As.numpy(), np.asarray(jm.As))
    _close(tm.check_canonical(), jm.check_canonical(), "float64")


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_random(dtype):
    m = tmps.FiniteMPS.random(5, 4, dtype=dtype, seed=3, device="cpu")
    assert m.As.shape == (5, 4, 2, 4) and m.dtype == dtype
    assert m.center_position == 0 and float(m.check_canonical()) < 1e-12
    assert abs(float(m.norm()) - 1) < 1e-12
    gen = torch.Generator(device="cpu").manual_seed(3)
    again = tmps.FiniteMPS.random(5, 4, dtype=dtype, seed=gen)
    np.testing.assert_array_equal(again.As.numpy(), m.As.numpy())
    m.from_stack(again.As)
    assert m.center_position is None and m.to_stack() is again.As
    with pytest.raises(ValueError, match="no orthogonality"):
        m.check_canonical()


def test_entry_points_run_with_tf32_off(monkeypatch):
    # the object layer's entry points run inside config.highest_precision,
    # whatever the caller set
    from tensornetwork_tpu_torch.models import infinite_mps as timps
    from tensornetwork_tpu_torch.models import mera as tmera
    from tensornetwork_tpu_torch.models import tebd as ttebd
    seen = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args):
            seen.append((name, torch.backends.cuda.matmul.allow_tf32,
                         torch.get_float32_matmul_precision()))
            return fn(*args)

        monkeypatch.setattr(module, name, wrapped)

    spy(tmps, "_norm_update_left")
    spy(ttebd, "_norm_update_left")
    spy(timps, "_carry_left")
    spy(tmera, "_ascend_L")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        _, tm = _pair(14, "float32")
        tm.norm()
        ttebd.measure_energy(tm, np.kron(X, X))
        timps.InfiniteMPS(tm.As[:1].clone()).check_right_canonical()
        state = tmera.initialize_mera(2, 1, dtype=torch.float32,
                                      device="cpu")
        tmera.ascend(torch.zeros((2,) * 6), state.us[0], state.ws[0])
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert {n for n, _, _ in seen} == {"_norm_update_left", "_carry_left",
                                       "_ascend_L"}
    assert {(a, b) for _, a, b in seen} == {(False, "highest")}
