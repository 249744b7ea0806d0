"""Device, dtype and precision settings of the PyTorch port.

Counterpart of :mod:`tensornetwork_tpu.config`.  The port runs on the CUDA
card unless the caller hands it CPU tensors or asks for ``device="cpu"``;
it never drops to the CPU on its own.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

# Constructor dtype when none is given: the widest float, as the JAX
# package resolves it under x64.  The main path passes float32 explicitly.
DEFAULT_DTYPE = torch.float64

Device = Union[str, torch.device]


def default_device(device: Optional[Device] = None) -> torch.device:
    """``device`` if given, else the CUDA card; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tensornetwork_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' (or CPU tensors) to run "
            "on the CPU")
    return torch.device("cuda")


def as_tensor(x, device: Optional[Device] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; anything
    else (numpy arrays, lists) goes to :func:`default_device`."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    if isinstance(x, np.ndarray) and dtype is None:
        return torch.as_tensor(x, device=default_device(device))
    return torch.as_tensor(x, dtype=dtype, device=default_device(device))


@contextlib.contextmanager
def highest_precision():
    """Full fp32 in every matmul and convolution: TF32 off for cuBLAS and
    cuDNN, float32 matmul precision "highest".  Restores the caller's
    settings on exit.  Counterpart of the JAX sweeps'
    ``jax.default_matmul_precision("highest")``: reduced-precision products
    make the Lanczos projection non-variational."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
