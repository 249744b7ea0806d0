"""``subspace_truncate``'s perturbed identity start (``key``) against the
JAX package, on the CPU.

A ``torch.Generator`` and a JAX key draw other numbers from one seed, so
the JAX function gets the port's perturbed start as its ``q0``: the noise
is drawn once from the generator, carried to numpy, and the identity plus
0.01 times it is built there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.ops import decompositions as JD
from tensornetwork_tpu_torch.ops import decompositions as TD

# f64, the same algorithm on the same start: the iterates agree to
# rounding of the 24 x 16 Gram products and the orthonormaliser.
TOL = 1e-12


def _panel(rng, shape=(24, 16)):
    m, n = shape
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * 0.7 ** np.arange(n)) @ v.T


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("orth", ["qr", "polar"])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_subspace_truncate_key_matches_jax_on_the_same_start(rng, orth,
                                                             batch):
    a = np.stack([_panel(rng) for _ in range(2)]) if batch else _panel(rng)
    k, m = 8, a.shape[-2]
    noise = torch.randn(batch + (m, k), generator=torch.Generator()
                        .manual_seed(5), dtype=torch.float64).numpy()
    q0 = np.eye(m, k) + 0.01 * noise
    t = TD.subspace_truncate(torch.from_numpy(a), k, iters=3, orth=orth,
                             key=torch.Generator().manual_seed(5))
    j = JD.subspace_truncate(jnp.asarray(a), k, q0=jnp.asarray(q0), iters=3,
                             orth=orth)
    assert t.q.shape == batch + (m, k)
    assert _rel(t.q.numpy(), j.q) < TOL
    assert _rel(t.rest.numpy(), j.rest) < TOL
    np.testing.assert_allclose(t.trunc_sq_norm.numpy(),
                               np.asarray(j.trunc_sq_norm), atol=TOL)
    # the perturbation moves the start: the result differs from the
    # identity start's in its gauge
    plain = TD.subspace_truncate(torch.from_numpy(a), k, iters=3, orth=orth)
    assert not torch.equal(plain.q, t.q)


def test_subspace_truncate_without_key_is_unchanged(rng):
    a = torch.from_numpy(_panel(rng))
    ref = TD.subspace_truncate(a, 8, iters=3)
    got = TD.subspace_truncate(a, 8, iters=3, key=None)
    assert torch.equal(got.q, ref.q) and torch.equal(got.rest, ref.rest)
    j = JD.subspace_truncate(jnp.asarray(a.numpy()), 8, iters=3)
    assert _rel(got.q.numpy(), j.q) < TOL
    # an explicit warm start ignores the key, as in the JAX function
    q0 = torch.from_numpy(rng.standard_normal((24, 8)))
    warm = TD.subspace_truncate(a, 8, q0=q0, iters=3)
    keyed = TD.subspace_truncate(a, 8, q0=q0, iters=3,
                                 key=torch.Generator().manual_seed(1))
    assert torch.equal(warm.q, keyed.q)
