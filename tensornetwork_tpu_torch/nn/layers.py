"""Tensor-network neural-network layers as ``torch.nn.Module``\\ s.

Counterpart of :mod:`tensornetwork_tpu.nn.layers` (Flax; reference
``tn_keras/dense.py:14``, ``mpo.py:16``, ``condenser.py:16``,
``expander.py:16``, ``entangler.py:16``, ``conv2d_mpo.py:15``): each layer
factorizes a dense weight into a small tensor network, and the forward
pass contracts it with the input by the JAX layer's very einsums.

Where Flax infers the input width from the first call, a PyTorch module
makes its parameters when it is built: each layer takes the JAX layer's
fields plus a keyword-only ``input_dim`` (``in_channels`` for
:class:`Conv2DMPO`), and ``device``, ``dtype`` and ``generator``.  The
parameters keep the Flax names and storage shapes (``a_var``, ``b_var``,
``node_{k}`` stored 2-D and reshaped in ``forward``,
``level_{l}_core_{k}``, ``bias``), so Flax weights carry across as copies
(:func:`tensornetwork_tpu_torch.interop.load_flax_params`).  Weights are
drawn as Flax's ``lecun_normal`` (a normal truncated at two standard
deviations, scaled to variance 1/fan_in, fan_in the stored shape's first
axis) from ``generator``, biases start at zero.  Parameters go on
:func:`config.default_device` unless ``device`` is given, in ``dtype``
(default :data:`config.DEFAULT_DTYPE`, as the JAX layers resolve under
x64).

The forward passes run in full fp32 (:func:`config.highest_precision`).
The dense layers' backward matmuls run under the caller's settings, whose
PyTorch default is full fp32; the convolution, whose cuDNN default is
TF32, holds full fp32 in its backward as well.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device,
                                            default_device,
                                            highest_precision)

# standard deviation of the unit normal truncated to [-2, 2]: Flax
# divides by it so that the truncated draw keeps the variance asked for
_TRUNCATED_STD = 0.87962566103423978


def _int_root(value: int, k: int, what: str) -> int:
    root = round(value ** (1.0 / k))
    for cand in (root - 1, root, root + 1):
        if cand > 0 and cand ** k == value:
            return cand
    raise ValueError(
        f"{what} = {value} must be a perfect {k}-th power for this layer")


def lecun_normal(shape: Tuple[int, int], device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax's ``lecun_normal`` for a 2-D (fan_in, fan_out) shape, drawn on
    the generator's device and moved to ``device``."""
    where = device if generator is None else generator.device
    t = torch.empty(shape, dtype=dtype, device=where)
    nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
    return (t * (math.sqrt(1.0 / shape[0]) / _TRUNCATED_STD)).to(device)


class _TNLayer(nn.Module):
    """Parameter making, bias and activation shared by the layers."""

    def __init__(self, use_bias: bool, activation: Optional[Callable],
                 device: Optional[Device], dtype: Optional[torch.dtype],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.use_bias = use_bias
        self.activation = activation
        self._init = (default_device(device),
                      DEFAULT_DTYPE if dtype is None else dtype, generator)

    def _weight(self, name: str, shape: Tuple[int, int]) -> None:
        self.register_parameter(name, nn.Parameter(lecun_normal(shape,
                                                                *self._init)))

    def _bias(self, n: int) -> None:
        device, dtype, _ = self._init
        self.register_parameter("bias", nn.Parameter(
            torch.zeros(n, device=device, dtype=dtype))
            if self.use_bias else None)
        del self._init   # the module keeps no generator (deepcopy, pickle)

    def _finish(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return y


def _common(x: torch.Tensor, *params: torch.Tensor):
    """``x`` and ``params`` in their promoted dtype, as jnp.einsum
    promotes."""
    dtype = x.dtype
    for p in params:
        dtype = torch.promote_types(dtype, p.dtype)
    return [t.to(dtype) for t in (x,) + params]


class DenseDecomp(_TNLayer):
    """Rank-decomposed dense layer: W ≈ A·B through a ``decomp_size``
    bottleneck (reference ``tn_keras/dense.py:14``)."""

    def __init__(self, output_dim: int, decomp_size: int,
                 use_bias: bool = True,
                 activation: Optional[Callable] = None, *, input_dim: int,
                 device: Optional[Device] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_bias, activation, device, dtype, generator)
        self.output_dim, self.decomp_size = output_dim, decomp_size
        self._weight("a_var", (input_dim, decomp_size))
        self._weight("b_var", (decomp_size, output_dim))
        self._bias(output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, a, b = _common(x, self.a_var, self.b_var)
        with highest_precision():
            y = torch.einsum("...r,ro->...o",
                             torch.einsum("...i,ir->...r", x, a), b)
        return self._finish(y)


class DenseMPO(_TNLayer):
    """MPO-factorized dense layer (reference ``tn_keras/mpo.py:16``): the
    input is reshaped to ``num_nodes`` legs and contracted through an MPO
    chain of ``num_nodes`` cores with bond dimension ``bond_dim``."""

    def __init__(self, output_dim: int, num_nodes: int, bond_dim: int,
                 use_bias: bool = True,
                 activation: Optional[Callable] = None, *, input_dim: int,
                 device: Optional[Device] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_bias, activation, device, dtype, generator)
        if num_nodes < 2:
            raise ValueError("DenseMPO requires num_nodes >= 2")
        self.output_dim, self.num_nodes, self.bond_dim = (output_dim,
                                                          num_nodes, bond_dim)
        self.in_leg = _int_root(input_dim, num_nodes, "input dimension")
        self.out_leg = _int_root(output_dim, num_nodes, "output_dim")
        i, o, D = self.in_leg, self.out_leg, bond_dim
        self._weight("node_0", (i, o * D))
        for k in range(1, num_nodes - 1):
            self._weight(f"node_{k}", (D * i, o * D))
        self._weight(f"node_{num_nodes - 1}", (D * i, o))
        self._bias(output_dim)

    def cores(self):
        i, o, D, n = self.in_leg, self.out_leg, self.bond_dim, self.num_nodes
        return ([self.node_0.reshape(i, o, D)]
                + [getattr(self, f"node_{k}").reshape(D, i, o, D)
                   for k in range(1, n - 1)]
                + [getattr(self, f"node_{n - 1}").reshape(D, i, o)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, *cores = _common(x, *self.cores())
        batch_shape = x.shape[:-1]
        # contract the chain leg by leg; output legs accumulate at the end
        flat = x.reshape((-1,) + (self.in_leg,) * self.num_nodes)
        with highest_precision():
            acc = torch.einsum("bi...,iod->b...od", flat, cores[0])
            for core in cores[1:-1]:
                acc = torch.einsum("bi...pd,diqe->b...pqe", acc, core)
            acc = torch.einsum("bi...pd,diq->b...pq", acc, cores[-1])
        return self._finish(acc.reshape(batch_shape + (self.output_dim,)))


class DenseCondenser(_TNLayer):
    """Contracts an exponentially wide input down:
    output_dim = input_dim / exp_base**num_nodes (reference
    ``tn_keras/condenser.py:16``)."""

    def __init__(self, exp_base: int, num_nodes: int, use_bias: bool = True,
                 activation: Optional[Callable] = None, *, input_dim: int,
                 device: Optional[Device] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_bias, activation, device, dtype, generator)
        self.exp_base, self.num_nodes = exp_base, num_nodes
        cur = input_dim
        for k in range(num_nodes):
            if cur % exp_base != 0:
                raise ValueError(
                    f"input dimension {input_dim} is not divisible by "
                    f"exp_base**num_nodes")
            cur //= exp_base
            self._weight(f"node_{k}", (exp_base * cur, cur))
        self.input_dim, self.output_dim = input_dim, cur
        self._bias(cur)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.exp_base
        batch_shape = x.shape[:-1]
        y = x.reshape((-1, self.input_dim))
        for k in range(self.num_nodes):
            rest = y.shape[-1] // e
            y, w = _common(y, getattr(self, f"node_{k}"))
            # contract one exp_base-sized leg (plus the backbone) per node
            with highest_precision():
                y = torch.einsum("bre,erp->bp", y.reshape(-1, rest, e),
                                 w.reshape(e, rest, rest))
        return self._finish(y.reshape(batch_shape + (self.output_dim,)))


class DenseExpander(_TNLayer):
    """Expands the input exponentially:
    output_dim = input_dim * exp_base**num_nodes (reference
    ``tn_keras/expander.py:16``)."""

    def __init__(self, exp_base: int, num_nodes: int, use_bias: bool = True,
                 activation: Optional[Callable] = None, *, input_dim: int,
                 device: Optional[Device] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_bias, activation, device, dtype, generator)
        self.exp_base, self.num_nodes = exp_base, num_nodes
        cur = input_dim
        for k in range(num_nodes):
            self._weight(f"node_{k}", (cur, cur * exp_base))
            cur *= exp_base
        self.input_dim, self.output_dim = input_dim, cur
        self._bias(cur)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.exp_base
        batch_shape = x.shape[:-1]
        y = x.reshape((-1, self.input_dim))
        for k in range(self.num_nodes):
            cur = y.shape[-1]
            y, w = _common(y, getattr(self, f"node_{k}"))
            with highest_precision():
                y = torch.einsum("bc,cpe->bpe", y, w.reshape(cur, cur, e))
            y = y.reshape(-1, cur * e)
        return self._finish(y.reshape(batch_shape + (self.output_dim,)))


class DenseEntangler(_TNLayer):
    """Staircase of two-leg cores over ``num_legs`` input legs
    (reference ``tn_keras/entangler.py:16``).  input and output dims must
    both be perfect ``num_legs``-th powers."""

    def __init__(self, output_dim: int, num_legs: int, num_levels: int,
                 use_bias: bool = True,
                 activation: Optional[Callable] = None, *, input_dim: int,
                 device: Optional[Device] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_bias, activation, device, dtype, generator)
        self.output_dim, self.num_legs, self.num_levels = (output_dim,
                                                           num_legs,
                                                           num_levels)
        n = num_legs
        self.leg_in = _int_root(input_dim, n, "input dimension")
        leg_out = _int_root(output_dim, n, "output_dim")
        legs = [self.leg_in] * n
        self.shapes = []   # (level, k) -> the core's 4-D shape
        for level in range(num_levels):
            # at the last level, the staircase maps leg_in -> leg_out
            new = leg_out if level == num_levels - 1 else legs[-1]
            for k in range(n - 1):
                shape = (legs[k], legs[k + 1], new, new)
                self._weight(f"level_{level}_core_{k}",
                             (shape[0] * shape[1], new * new))
                self.shapes.append(shape)
                legs[k] = legs[k + 1] = new
        self._bias(output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.num_legs
        batch_shape = x.shape[:-1]
        y = x.reshape((-1,) + (self.leg_in,) * n)
        shapes = iter(self.shapes)
        for level in range(self.num_levels):
            for k in range(n - 1):
                y, w = _common(y, getattr(self, f"level_{level}_core_{k}"))
                y = _apply_two_leg(y, w.reshape(next(shapes)), k)
        return self._finish(y.reshape(batch_shape + (self.output_dim,)))


def _apply_two_leg(y: torch.Tensor, w4: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """Contract core ``w4[i,j,p,q]`` with legs (k, k+1) of ``y`` (leg axes
    start at 1; axis 0 is batch)."""
    legs = (1 + k, 2 + k)
    y = torch.movedim(y, legs, (y.ndim - 2, y.ndim - 1))
    with highest_precision():
        y = torch.einsum("...ij,ijpq->...pq", y, w4)
    return torch.movedim(y, (y.ndim - 2, y.ndim - 1), legs)


class _Conv2dFull(torch.autograd.Function):
    """``F.conv2d`` with TF32 off in the forward and in the backward:
    cuDNN allows TF32 by default, and autograd runs the backward after the
    forward's precision context has closed."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with highest_precision():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        with highest_precision():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, gy,
                                                stride=ctx.stride)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, gy,
                                                 stride=ctx.stride)
        return gx, gw, None


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis, (low, high): the
    output has ceil(size / s) entries, and an odd total pads one more at
    the high end."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2DMPO(_TNLayer):
    """2D convolution whose kernel is MPO-factorized (reference
    ``tn_keras/conv2d_mpo.py:15``).  Input and output are NHWC, as the
    JAX layer's; the (kh, kw, in_ch, out_ch) kernel is built from
    ``num_nodes`` cores and fed to ``F.conv2d`` as OIHW.  ``padding`` is
    ``"SAME"`` (XLA's rule, :func:`same_padding`) or ``"VALID"``."""

    def __init__(self, filters: int, kernel_size: Tuple[int, int],
                 num_nodes: int, bond_dim: int,
                 strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
                 use_bias: bool = True,
                 activation: Optional[Callable] = None, *, in_channels: int,
                 device: Optional[Device] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_bias, activation, device, dtype, generator)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', not "
                             f"{padding!r}")
        self.filters, self.kernel_size = filters, tuple(kernel_size)
        self.num_nodes, self.bond_dim = num_nodes, bond_dim
        self.strides, self.padding = tuple(strides), padding
        self.in_channels = in_channels
        self.in_leg = _int_root(in_channels, num_nodes, "in_channels")
        self.out_leg = _int_root(filters, num_nodes, "filters")
        (kh, kw), i, o, D = self.kernel_size, self.in_leg, self.out_leg, bond_dim
        self._weight("node_0", (kh * kw * i, o * D))
        for k in range(1, num_nodes - 1):
            self._weight(f"node_{k}", (D * i, o * D))
        self._weight(f"node_{num_nodes - 1}", (D * i, o))
        self._bias(filters)

    def kernel(self) -> torch.Tensor:
        """The materialized (kh, kw, in_channels, filters) kernel."""
        (kh, kw), i, o, D = self.kernel_size, self.in_leg, self.out_leg, \
            self.bond_dim
        n = self.num_nodes
        with highest_precision():
            acc = self.node_0.reshape(kh, kw, i, o, D)
            for k in range(1, n - 1):
                acc = torch.einsum("hw...d,diqe->hw...iqe", acc,
                                   getattr(self, f"node_{k}").reshape(
                                       D, i, o, D))
            acc = torch.einsum("hw...d,diq->hw...iq", acc,
                               getattr(self, f"node_{n - 1}").reshape(D, i, o))
        # acc axes: kh, kw, i0, o0, i1, o1, ..., separate and merge
        perm = ([0, 1] + [2 + 2 * k for k in range(n)]
                + [3 + 2 * k for k in range(n)])
        return acc.permute(perm).reshape(kh, kw, self.in_channels,
                                         self.filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (batch, h, w, in_channels)
        w = self.kernel().to(x.dtype).permute(3, 2, 0, 1)   # OIHW
        xc = x.permute(0, 3, 1, 2)                           # NCHW
        if self.padding == "SAME":
            (kh, kw), (sh, sw) = self.kernel_size, self.strides
            top, bottom = same_padding(xc.shape[2], kh, sh)
            left, right = same_padding(xc.shape[3], kw, sw)
            xc = F.pad(xc, (left, right, top, bottom))
        y = _Conv2dFull.apply(xc, w, self.strides)
        return self._finish(y.permute(0, 2, 3, 1))
