"""The batched transfer chain (K6) against the JAX package, on the CPU.

The port's ``transfer_chain`` gets CPU tensors and so runs its plain twin;
the JAX package's runs its Pallas kernel in interpret mode (variants
``loop`` and ``rows``, which compute one function) and its XLA reference.
Inputs are made with numpy from a seed, with explicit dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.ops import kernels as JK
from tensornetwork_tpu_torch import interop
from tensornetwork_tpu_torch.ops import kernels as TK

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}
# Against the Pallas kernel: the twin rounds where the kernel rounds (E to
# the input type before stage 1, Y before stage 2), with exact products in
# f32; only the order of the f32 sums differs, so a bf16 rounding of Y
# flips on a near-tie at most (measured 1.4e-7 relative in bf16, 2.2e-7 in
# f32, N=4).
PALLAS_TOL = {"bf16": 1e-5, "f32": 1e-5}
# Against transfer_chain_xla, which carries E in bf16 and rounds each
# einsum's output: a few bf16 ulps (2^-8 each) over 4 sites (measured
# 2.2e-3); in f32 the same function as the kernel (2.2e-7).
XLA_TOL = {"bf16": 2e-2, "f32": 1e-5}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _inputs(rng, B, N, chi, d, kind):
    j_dt, _ = DTYPES[kind]
    As = (rng.standard_normal((B, N, chi, d, chi)) / np.sqrt(d * chi))
    E0 = np.broadcast_to(np.eye(chi), (B, chi, chi))
    Aj, Ej = jnp.asarray(As, j_dt), jnp.asarray(E0, j_dt)
    # the same rounded numbers on both sides
    At = interop.mps_from_numpy(np.asarray(Aj), device="cpu")
    Et = interop.mps_from_numpy(np.asarray(Ej), device="cpu")
    return Aj, Ej, At, Et


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_transfer_chain_twin_matches_pallas_and_xla(rng, kind):
    B, N, chi, d = 4, 4, 16, 2
    Aj, Ej, At, Et = _inputs(rng, B, N, chi, d, kind)
    assert At.dtype == DTYPES[kind][1]
    TK.reset_launch_counts()
    E = TK.transfer_chain(At, Et)
    assert TK.launch_counts["transfer_chain"] == 0  # CPU tensors: the twin
    assert E.dtype == torch.float32 and E.shape == (B, chi, chi)
    for variant in ("loop", "rows"):
        ref = JK.transfer_chain(Aj, Ej, impl="pallas", tile_b=2,
                                interpret=True, variant=variant,
                                precision=jax.lax.Precision.HIGHEST)
        assert _rel(E.numpy(), ref) < PALLAS_TOL[kind], variant
    ref = JK.transfer_chain_xla(Aj, Ej, precision=jax.lax.Precision.HIGHEST)
    assert _rel(E.numpy(), ref.astype(jnp.float32)) < XLA_TOL[kind]
    # impl="plain" is the same function as the twin
    assert torch.equal(TK.transfer_chain(At, Et, impl="plain"), E)


def test_transfer_chain_rounds_where_the_kernel_rounds(rng):
    # one site, bf16: Y = bf16(E^T A_s) before stage 2, f32 sums after
    B, chi, d = 2, 8, 2
    Aj, Ej, At, Et = _inputs(rng, B, 1, chi, d, "bf16")
    A = At[:, 0].float()
    Y = torch.einsum("Bac,Basb->Bscb", Et.float(), A).bfloat16().float()
    want = torch.einsum("Bscb,Bcsp->Bbp", Y, A)
    torch.testing.assert_close(TK.transfer_chain(At, Et), want, rtol=1e-6,
                               atol=1e-6)
    # E0 in f32 is cast to bf16 at the first site, as the kernel does
    torch.testing.assert_close(TK.transfer_chain(At, Et.float()),
                               TK.transfer_chain(At, Et), rtol=0, atol=0)


def test_transfer_chain_accum_dtype(rng):
    Aj, Ej, At, Et = _inputs(rng, 2, 3, 8, 2, "f32")
    E64 = TK.transfer_chain(At, Et, accum_dtype=torch.float64)
    assert E64.dtype == torch.float64
    ref = JK.transfer_chain(Aj, Ej, impl="pallas", interpret=True,
                            accum_dtype=jnp.float64,
                            precision=jax.lax.Precision.HIGHEST)
    assert _rel(E64.numpy(), ref) < 1e-6


def test_transfer_chain_validates_inputs():
    As = torch.zeros((2, 3, 4, 2, 4))
    E0 = torch.zeros((2, 4, 4))
    with pytest.raises(TypeError):
        TK.transfer_chain(As.double(), E0.double())   # the kernel's types only
    with pytest.raises(ValueError):
        TK.transfer_chain(As, torch.zeros((2, 4, 5)))
    with pytest.raises(ValueError):
        TK.transfer_chain(torch.zeros((2, 3, 4, 2, 5)), E0)
    with pytest.raises(ValueError):
        TK.transfer_chain(As, E0, impl="pallas")
    # the plain route takes any float type
    assert TK.transfer_chain(As.double(), E0.double(), impl="plain",
                             accum_dtype=torch.float64).dtype == torch.float64


def test_interop_round_trips_a_jax_bf16_stack_bit_for_bit(rng):
    a = jnp.asarray(rng.standard_normal((2, 3, 5, 2, 5)), jnp.bfloat16)
    t = interop.mps_from_numpy(np.asarray(a), device="cpu")
    assert t.dtype == torch.bfloat16 and t.shape == a.shape
    bits = np.asarray(a).view(np.uint16)
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  bits)
    back = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(back).view(np.uint16), bits)
    # an explicit dtype converts after the exact widening
    t32 = interop.mps_from_numpy(np.asarray(a), device="cpu",
                                 dtype=torch.float32)
    np.testing.assert_array_equal(t32.numpy(), np.asarray(a, np.float32))


@pytest.mark.parametrize("chi,d,kind,route", [
    (16, 2, "bf16", "resident"), (64, 2, "bf16", "resident"),
    (100, 2, "bf16", "resident"), (128, 2, "bf16", "resident"),
    (128, 2, "f32", "tiled"), (64, 2, "f32", "tiled"),
    (160, 2, "bf16", "tiled"), (160, 2, "f32", "tiled"),
    (256, 2, "bf16", "tiled"), (256, 2, "f32", "tiled"),
    (128, 3, "bf16", "tiled"), (64, 3, "bf16", "resident")])
def test_transfer_chain_route(chi, d, kind, route):
    # "resident" while T(E), two site tensors and Y -- (1 + 3d) chi^2 bf16
    # values at chi padded to a multiple of 16 -- fit one block's 227 KB;
    # f32 always takes the tiled route
    assert TK.transfer_chain_route(chi, d, DTYPES[kind][1]) == route


def test_transfer_chain_twin_at_chi_160_matches_xla(rng):
    # a shape the kernel's old single route refused on the card: f32,
    # chi=160.  The same function as transfer_chain_xla in f32 (2.2e-7
    # measured at N=4 above), 3 sites of 160 x 320-term sums.
    Aj, Ej, At, Et = _inputs(rng, 2, 3, 160, 2, "f32")
    E = TK.transfer_chain(At, Et)
    ref = JK.transfer_chain_xla(Aj, Ej, precision=jax.lax.Precision.HIGHEST)
    assert _rel(E.numpy(), ref) < XLA_TOL["f32"]
