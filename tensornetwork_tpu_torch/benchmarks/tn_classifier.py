"""Train a tensor-network classifier (DenseMPO backbone) on an MNIST-like
task: the repo's ``tn_keras`` configuration, with synthetic data.

    python -m tensornetwork_tpu_torch.benchmarks.tn_classifier [--cpu]

Port of ``examples/image_classifier.py``: 784 inputs padded to 1296 =
6^4, ``DenseMPO(256, num_nodes=4, bond_dim=8, relu)``,
``DenseDecomp(64, decomp_size=16, relu)`` and a 10-way linear head
initialised as Flax's ``nn.Dense`` (lecun-normal kernel, zero bias);
``torch.optim.Adam(lr=3e-3)``, whose update is optax's ``adam`` at equal
betas and eps, on ``F.cross_entropy``; batches drawn from
``np.random.default_rng(0)`` as the example draws them.  Runs on the card
unless ``device="cpu"``; each training step runs in full fp32
(:func:`config.highest_precision`).
"""
from __future__ import annotations

import argparse
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensornetwork_tpu_torch.config import (Device, default_device,
                                            highest_precision)
from tensornetwork_tpu_torch.interop import load_flax_params
from tensornetwork_tpu_torch.nn import DenseDecomp, DenseMPO
from tensornetwork_tpu_torch.nn.layers import lecun_normal

PADDED = 1296   # 784 pixels padded to 6^4
LEARNING_RATE = 3e-3


class TNClassifier(nn.Module):
    """784 -> MPO(256) -> decomp(64) -> 10 logits."""

    # Flax's auto-names of the example's submodules, for
    # interop.load_flax_params
    flax_names = {"DenseMPO_0": "mpo", "DenseDecomp_0": "decomp",
                  "Dense_0": "head"}

    def __init__(self, device: Optional[Device] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.mpo = DenseMPO(256, num_nodes=4, bond_dim=8,
                            activation=torch.relu, input_dim=PADDED, **kw)
        self.decomp = DenseDecomp(64, decomp_size=16, activation=torch.relu,
                                  input_dim=256, **kw)
        self.head = nn.Linear(64, 10, device=device, dtype=dtype)
        with torch.no_grad():
            self.head.weight.copy_(lecun_normal((64, 10), device, dtype,
                                                generator).T)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        # pad 784 -> 1296 = 6^4 so the MPO legs factorize
        x = F.pad(x, (0, PADDED - x.shape[1]))
        return self.head(self.decomp(self.mpo(x)))


def synthetic_mnist(n: int, seed: int = 0):
    """28x28 images labeled by decile of a fixed random projection --
    learnable, nontrivial, dataset-free (numpy float32 images, int64
    labels)."""
    import scipy.stats as st
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 28, 28)).astype(np.float32)
    w = np.random.default_rng(123).standard_normal(784) / 28.0
    proj = x.reshape(n, -1) @ w
    # decile edges from the standard normal of the projection
    edges = st.norm.ppf(np.linspace(0.1, 0.9, 9), scale=np.linalg.norm(w))
    return x, np.digitize(proj, edges)


def make_step(model: nn.Module) -> Callable:
    """A training step ``step(xb, yb) -> loss`` with its own Adam state;
    the loss stays on the device."""
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)

    def step(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        with highest_precision():
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            opt.step()
        return loss.detach()

    return step


def main(steps: int = 300, batch: int = 128,
         device: Optional[Device] = None,
         on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
         params: Optional[Mapping] = None):
    """Train ``steps`` Adam steps at ``batch``; returns (test accuracy,
    model).  ``on_step(k, loss)`` is called after step ``k`` is enqueued
    (the loss a device tensor).  ``params``: a Flax param tree of the JAX
    example's model to start from (:func:`interop.load_flax_params`)."""
    device = default_device(device)
    x_train, y_train = (torch.as_tensor(a, device=device)
                        for a in synthetic_mnist(4096))
    x_test, y_test = (torch.as_tensor(a, device=device)
                      for a in synthetic_mnist(1024, seed=1))
    model = TNClassifier(device, generator=torch.Generator(
        device=device).manual_seed(0))
    if params is not None:
        load_flax_params(model, params)
    step = make_step(model)
    rng = np.random.default_rng(0)
    for k in range(steps):
        idx = torch.as_tensor(rng.integers(0, x_train.shape[0], batch),
                              device=device)
        loss = step(x_train[idx], y_train[idx])
        if on_step is not None:
            on_step(k, loss)
        if k % 50 == 0:
            print(f"step {k}: loss {float(loss):.4f}")
    with torch.no_grad(), highest_precision():
        acc = float((model(x_test).argmax(-1) == y_test).double().mean())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"test accuracy: {acc:.3f} ({n_params} params; a dense "
          f"1296x256 layer alone would use {1296 * 256})")
    return acc, model


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    main(args.steps, args.batch, "cpu" if args.cpu else None)
