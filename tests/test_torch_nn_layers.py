"""The port's tensor-network NN layers against the JAX package's Flax
layers, on the CPU.

Each case builds the JAX layer and the port's at the same fields and
gives both one Flax param tree (seeded numpy draws in the shapes Flax
checks on apply, carried into the port by ``interop.load_flax_params``)
and the same seeded input: the output, the gradient with respect to the
input and to every parameter (``jax.grad`` against autograd, of <y, t>
for a seeded cotangent t) agree within 1e-5 (float32) and 1e-12
(float64) of the largest entry.  The JAX side runs under ``jax.jit``: one
compile of the gradient takes 0.1-0.7 s, where eager dispatch compiled
every primitive apart (1-3 s a case).  Also: the same ``ValueError``\\ s,
and the init's statistics against Flax's ``lecun_normal``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu import nn as jnn
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch import nn as tnn

TOL = {"float32": 1e-5, "float64": 1e-12}

# (id, layer name, fields, port-only width keyword, input shape, relu)
CASES = [
    ("decomp", "DenseDecomp", dict(output_dim=16, decomp_size=4),
     "input_dim", (3, 32), True),
    ("decomp_3d", "DenseDecomp", dict(output_dim=8, decomp_size=3,
                                      use_bias=False),
     "input_dim", (2, 3, 16), False),
    ("mpo", "DenseMPO", dict(output_dim=27, num_nodes=3, bond_dim=4),
     "input_dim", (3, 8), False),
    ("mpo_4_nodes", "DenseMPO", dict(output_dim=81, num_nodes=4,
                                     bond_dim=3),
     "input_dim", (2, 3, 16), True),
    ("condenser", "DenseCondenser", dict(exp_base=2, num_nodes=3),
     "input_dim", (4, 64), False),
    ("expander", "DenseExpander", dict(exp_base=2, num_nodes=2),
     "input_dim", (4, 8), True),
    ("entangler", "DenseEntangler", dict(output_dim=81, num_legs=4,
                                         num_levels=2),
     "input_dim", (2, 16), False),
    ("entangler_3_levels", "DenseEntangler", dict(output_dim=8, num_legs=3,
                                                  num_levels=3),
     "input_dim", (2, 27), True),
    ("conv_same_s1", "Conv2DMPO", dict(filters=9, kernel_size=(3, 3),
                                       num_nodes=2, bond_dim=3),
     "in_channels", (2, 7, 7, 4), False),
    ("conv_same_s2", "Conv2DMPO", dict(filters=9, kernel_size=(3, 3),
                                       num_nodes=2, bond_dim=3,
                                       strides=(2, 2)),
     "in_channels", (2, 7, 8, 4), True),
    ("conv_valid_s2", "Conv2DMPO", dict(filters=9, kernel_size=(3, 3),
                                        num_nodes=2, bond_dim=3,
                                        strides=(2, 2), padding="VALID"),
     "in_channels", (2, 8, 7, 4), False),
    ("conv_even_same_s1", "Conv2DMPO", dict(filters=4, kernel_size=(2, 4),
                                            num_nodes=2, bond_dim=2),
     "in_channels", (2, 6, 6, 4), False),
    ("conv_even_same_s2", "Conv2DMPO", dict(filters=8, kernel_size=(4, 2),
                                            num_nodes=3, bond_dim=2,
                                            strides=(2, 3)),
     "in_channels", (2, 9, 8, 8), True),
    ("conv_even_valid_s2", "Conv2DMPO", dict(filters=4, kernel_size=(2, 2),
                                             num_nodes=2, bond_dim=2,
                                             strides=(2, 2), padding="VALID",
                                             use_bias=False),
     "in_channels", (1, 7, 7, 4), False),
]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _close(t, j, tol):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    err = np.abs(t - j).max() / np.abs(j).max()
    assert err <= tol, err


def _pair(name, fields, width_kw, shape, relu, dtype, seed=0):
    """(JAX layer, a Flax param tree in ``dtype``, port layer holding it,
    x): weights drawn at scale 1/sqrt(fan_in), biases nonzero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(dtype)
    jlayer = getattr(jnn, name)(**fields,
                                activation=fnn.relu if relu else None)
    tlayer = getattr(tnn, name)(**fields,
                                activation=torch.relu if relu else None,
                                **{width_kw: shape[-1]}, device="cpu",
                                dtype=getattr(torch, dtype))
    params = {"params": {
        n: (rng.standard_normal(p.shape) / np.sqrt(p.shape[0])).astype(dtype)
        for n, p in tlayer.named_parameters()}}
    interop.load_flax_params(tlayer, params)
    return jlayer, params, tlayer, x


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_gradients_match_jax(case, dtype):
    _, name, fields, width_kw, shape, relu = case
    jlayer, params, tlayer, x = _pair(name, fields, width_kw, shape, relu,
                                      dtype)
    tx = torch.from_numpy(x).requires_grad_()
    t = np.random.default_rng(1).standard_normal(
        tlayer(tx).shape).astype(dtype)

    def inner(p, xx):
        y = jlayer.apply(p, xx)
        return jnp.sum(y * t), y

    (_, jy), (jgrad_p, jgrad_x) = jax.jit(jax.value_and_grad(
        inner, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    ty = tlayer(tx)
    (ty * torch.from_numpy(t)).sum().backward()
    tol = TOL[dtype]
    assert ty.dtype == getattr(torch, dtype)
    _close(ty, jy, tol)
    _close(tx.grad, jgrad_x, tol)
    names = {n for n, _ in tlayer.named_parameters()}
    assert names == set(jgrad_p["params"])
    for n, p in tlayer.named_parameters():
        assert p.shape == jgrad_p["params"][n].shape, n
        _close(p.grad, jgrad_p["params"][n], tol)


BAD = [
    ("DenseMPO", dict(output_dim=27, num_nodes=3, bond_dim=2), "input_dim",
     10),
    ("DenseMPO", dict(output_dim=20, num_nodes=2, bond_dim=2), "input_dim",
     16),
    ("DenseMPO", dict(output_dim=4, num_nodes=1, bond_dim=2), "input_dim",
     4),
    ("DenseEntangler", dict(output_dim=81, num_legs=4, num_levels=1),
     "input_dim", 12),
    ("DenseEntangler", dict(output_dim=50, num_legs=2, num_levels=1),
     "input_dim", 16),
    ("DenseCondenser", dict(exp_base=3, num_nodes=2), "input_dim", 12),
    ("Conv2DMPO", dict(filters=9, kernel_size=(3, 3), num_nodes=2,
                       bond_dim=2), "in_channels", 5),
    ("Conv2DMPO", dict(filters=10, kernel_size=(3, 3), num_nodes=2,
                       bond_dim=2), "in_channels", 4),
]


@pytest.mark.parametrize("name,fields,width_kw,width", BAD,
                         ids=[f"{b[0]}_{i}" for i, b in enumerate(BAD)])
def test_bad_widths_raise_value_error_in_both(name, fields, width_kw, width):
    shape = (2, 5, 5, width) if name == "Conv2DMPO" else (2, width)
    with pytest.raises(ValueError) as jerr:
        getattr(jnn, name)(**fields).init(jax.random.PRNGKey(0),
                                          jnp.ones(shape))
    with pytest.raises(ValueError) as terr:
        getattr(tnn, name)(**fields, **{width_kw: width}, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_init_statistics_are_lecun_normal():
    """Mean 0, variance 1/fan_in, truncated at two standard deviations of
    the untruncated draw, zero biases; the same statistics as Flax's
    draw of the same shapes."""
    g = torch.Generator().manual_seed(3)
    layer = tnn.DenseDecomp(64, 48, input_dim=64, device="cpu",
                            dtype=torch.float64, generator=g)
    jparams = jnn.DenseDecomp(64, 48).init(jax.random.PRNGKey(3),
                                           jnp.ones((1, 64)))["params"]
    for name, fan_in in (("a_var", 64), ("b_var", 48)):
        w = getattr(layer, name).detach().numpy().ravel()
        jw = np.asarray(jparams[name]).ravel()
        std = np.sqrt(1.0 / fan_in)
        for sample in (w, jw):
            assert abs(sample.mean()) < 4 * std / np.sqrt(sample.size)
            assert abs(sample.std() / std - 1) < 0.05
            assert np.abs(sample).max() <= 2 * std / 0.87962566103423978
        assert abs(w.std() / jw.std() - 1) < 0.05
    assert not layer.bias.detach().any()


def test_generator_fixes_the_init():
    def build(seed):
        return tnn.Conv2DMPO(8, (3, 3), 3, 2, in_channels=8, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    a, b, c = build(5), build(5), build(6)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
        if n != "bias":
            assert not torch.equal(p, r), n
    assert a.node_0.dtype == torch.float64   # config.DEFAULT_DTYPE


def test_load_flax_params_refuses_a_wrong_shape():
    layer = tnn.DenseDecomp(8, 2, input_dim=4, device="cpu")
    with pytest.raises(ValueError, match="a_var"):
        interop.load_flax_params(layer, {"params": {
            "a_var": np.zeros((4, 3)), "b_var": np.zeros((2, 8)),
            "bias": np.zeros(8)}})
