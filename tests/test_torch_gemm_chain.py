"""The chained-GEMM probe (K9) against the JAX package's kernel body.

The repo's ``benchmarks/mxu_micro.py`` builds its ``pallas_call`` without an
interpret switch, and on the CPU backend that call raises "Only interpret
mode is supported on CPU backend".  So the reference here is the kernel
body of ``make_chain_kernel`` (its dot_general with f32 accumulation, the
bf16 cast between steps, the |out| sum after the call) written with
``jnp``; the benchmark itself is left as it is.  The port's probe gets CPU
tensors and so runs the kernel's plain twin.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.benchmarks import mxu_micro
from tensornetwork_tpu_torch.ops import kernels as TK

REPO = Path(__file__).resolve().parent.parent
# bf16 x bf16 products are exact in f32 on both sides and the f32 sums
# differ in order only, so a bf16 rounding between steps flips on a
# near-tie at most: one bf16 ulp (2^-8 = 3.9e-3 relative) on a few
# entries, which later steps carry along.  Measured 0 at these shapes.
BF16_TOL = 2e-2
SUM_RTOL = 1e-3


def _jnp_chain(x, b, c, reps):
    """The kernel body of benchmarks/mxu_micro.py make_chain_kernel."""
    dot = lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    xs = [x[p] for p in range(x.shape[0])]
    for _ in range(reps):
        ys = [dot(xp, b).astype(jnp.bfloat16) for xp in xs]
        xs = [dot(y, c).astype(jnp.bfloat16) for y in ys]
    out = jnp.stack(xs)
    return out, jnp.sum(jnp.abs(out.astype(jnp.float32)))


def _inputs(rng, M, K, N, P):
    x = jnp.asarray(rng.standard_normal((P, M, K)) / np.sqrt(K), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((K, N)) / np.sqrt(K), jnp.bfloat16)
    c = jnp.asarray(rng.standard_normal((N, K)) / np.sqrt(N), jnp.bfloat16)
    return (x, b, c), tuple(interop.mps_from_numpy(np.asarray(a), device="cpu")
                            for a in (x, b, c))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("M,K,N,P,reps", [(32, 16, 32, 2, 3),
                                          (64, 32, 16, 1, 2),
                                          (32, 48, 64, 3, 1)])
def test_chain_twin_matches_the_kernel_body(rng, M, K, N, P, reps):
    jin, tin = _inputs(rng, M, K, N, P)
    out_j, sum_j = _jnp_chain(*jin, reps)
    TK.reset_launch_counts()
    out_t = TK.gemm_chain(*tin, reps)
    assert TK.launch_counts["gemm_chain"] == 0  # CPU tensors: the twin
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (P, M, K)
    assert _rel(out_t.float().numpy(), np.asarray(out_j, np.float32)) < BF16_TOL
    s = mxu_micro.make_chain_kernel(M, K, N, reps, P=P)(*tin)
    assert s.dtype == torch.float32 and s.shape == ()
    np.testing.assert_allclose(float(s), float(sum_j), rtol=SUM_RTOL)


def test_chain_with_no_reps_returns_x(rng):
    _, (x, b, c) = _inputs(rng, 32, 16, 16, 2)
    assert torch.equal(TK.gemm_chain(x, b, c, 0), x)


def test_chain_validates_inputs(rng):
    _, (x, b, c) = _inputs(rng, 32, 16, 16, 2)
    with pytest.raises(TypeError):
        TK.gemm_chain(x.float(), b.float(), c.float(), 1)
    with pytest.raises(ValueError):
        TK.gemm_chain(x, b, c[:8], 1)
    with pytest.raises(ValueError):
        TK.gemm_chain(x, b, c, -1)
    with pytest.raises(ValueError):
        mxu_micro.make_chain_kernel(32, 16, 16, 1, P=3)(x, b, c)


def test_ladder_is_the_repos():
    # the (M, K, N, P, reps) tuple iterated in benchmarks/mxu_micro.py main()
    tree = ast.parse((REPO / "benchmarks" / "mxu_micro.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))
    assert tuple(ast.literal_eval(loop.iter)) == mxu_micro.LADDER
    M, K, N, P, reps = mxu_micro.LADDER[0]
    assert mxu_micro.chain_flops(M, K, N, P, reps) == P * reps * 4 * M * K * N
