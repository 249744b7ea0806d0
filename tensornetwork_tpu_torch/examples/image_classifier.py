"""Train a tensor-network classifier (DenseMPO backbone) on an MNIST-like
task, on the port (counterpart of ``examples/image_classifier.py``): the
``tn_keras`` configuration with synthetic data, trained by
:mod:`tensornetwork_tpu_torch.benchmarks.tn_classifier`.  The parameters
checkpoint through the generic saver
(:func:`~tensornetwork_tpu_torch.utils.checkpoint.save_pytree`).

    python -m tensornetwork_tpu_torch.examples.image_classifier [--cpu]
"""
import argparse
from typing import Mapping, Optional

from tensornetwork_tpu_torch.benchmarks import tn_classifier
from tensornetwork_tpu_torch.benchmarks.tn_classifier import (  # noqa: F401
    TNClassifier, synthetic_mnist)
from tensornetwork_tpu_torch.config import Device


def main(steps=300, batch=128, device: Optional[Device] = None,
         params: Optional[Mapping] = None):
    """Train ``steps`` Adam steps at ``batch``; returns (test accuracy,
    the trained parameters by name).  ``params``: a Flax param tree of
    the JAX example's model (numpy leaves) to start from instead of the
    seeded initialisation (:func:`~tensornetwork_tpu_torch.interop.
    load_flax_params`)."""
    acc, model = tn_classifier.main(steps, batch, device, params=params)
    return acc, {k: v.detach() for k, v in model.state_dict().items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    main(device="cpu" if ap.parse_args().cpu else None)
