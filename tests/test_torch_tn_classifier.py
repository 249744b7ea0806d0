"""The port's tn_keras classifier (``benchmarks/tn_classifier.py``) against
``examples/image_classifier.py``, on the CPU.

Both packages draw the same ``synthetic_mnist`` data, start from one
Flax init of the example's ``TNClassifier`` (carried into the port by
``interop.load_flax_params``) and take five Adam steps (lr 3e-3; optax's
``adam`` against ``torch.optim.Adam``) on the same batches: the losses
agree step by step within 1e-10 (float64) and 1e-5 (float32) relative,
and so do the parameters after the last step, within 1e-9 and 1e-4 of
each one's largest entry.  The JAX step runs under ``jax.jit`` (one
compile).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.benchmarks import tn_classifier as tc

REPO = Path(__file__).resolve().parent.parent
STEPS, BATCH = 5, 32
LOSS_TOL = {"float32": 1e-5, "float64": 1e-10}
PARAM_TOL = {"float32": 1e-4, "float64": 1e-9}


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "image_classifier", REPO / "examples" / "image_classifier.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def flax_init(example):
    """The example's init as numpy arrays (one jitted init, ~1.5 s)."""
    x = jnp.zeros((2, 28, 28), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        example.TNClassifier().init)(jax.random.PRNGKey(0), x))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_five_adam_steps_match_the_example(example, flax_init, dtype):
    x_train, y_train = tc.synthetic_mnist(256)
    jx, jy = example.synthetic_mnist(256)
    np.testing.assert_array_equal(x_train, np.asarray(jx))
    np.testing.assert_array_equal(y_train, np.asarray(jy))
    x_train = x_train.astype(dtype)
    model = example.TNClassifier()
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, dtype),
                                    flax_init)
    tmodel = tc.TNClassifier(device="cpu", dtype=getattr(torch, dtype))
    interop.load_flax_params(tmodel, flax_init)
    opt = optax.adam(tc.LEARNING_RATE)
    opt_state = opt.init(params)

    @jax.jit
    def jstep(params, opt_state, xb, yb):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                model.apply(p, xb), yb).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    tstep = tc.make_step(tmodel)
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        idx = rng.integers(0, x_train.shape[0], BATCH)
        params, opt_state, jloss = jstep(params, opt_state,
                                         jnp.asarray(x_train[idx]),
                                         jnp.asarray(y_train[idx]))
        tloss = tstep(torch.from_numpy(x_train[idx]),
                      torch.from_numpy(y_train[idx]))
        assert tloss.dtype == getattr(torch, dtype)
        assert abs(float(tloss) / float(jloss) - 1) <= LOSS_TOL[dtype]
    flat = {}
    for sub, leaves in params["params"].items():
        for name, leaf in leaves.items():
            key = "weight" if name == "kernel" else name
            flat[f"{tc.TNClassifier.flax_names[sub]}.{key}"] = (
                np.asarray(leaf).T if name == "kernel" else np.asarray(leaf))
    tparams = dict(tmodel.named_parameters())
    assert set(tparams) == set(flat)
    for name, ref in flat.items():
        err = np.abs(tparams[name].detach().numpy() - ref).max()
        assert err <= PARAM_TOL[dtype] * np.abs(ref).max(), (name, err)


def test_model_shapes_and_init():
    g = torch.Generator().manual_seed(0)
    model = tc.TNClassifier(device="cpu", generator=g)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {
        "mpo.node_0": (6, 4 * 8), "mpo.node_1": (8 * 6, 4 * 8),
        "mpo.node_2": (8 * 6, 4 * 8), "mpo.node_3": (8 * 6, 4),
        "mpo.bias": (256,), "decomp.a_var": (256, 16),
        "decomp.b_var": (16, 64), "decomp.bias": (64,),
        "head.weight": (10, 64), "head.bias": (10,)}
    assert model.head.weight.dtype == torch.float32
    assert not model.head.bias.detach().any()
    # the head as Flax's nn.Dense: lecun-normal, fan_in 64
    w = model.head.weight.detach().numpy()
    assert np.abs(w).max() <= 2 / 8 / 0.87962566103423978
    out = model(torch.zeros(3, 28, 28))
    assert out.shape == (3, 10)
