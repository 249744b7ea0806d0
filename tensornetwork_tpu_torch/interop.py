"""Carry state from the JAX package into the port.

Both take numpy arrays (``np.asarray`` of the JAX package's arrays) and
return the port's tensors (copies, never views of the arrays), so that the two packages compute the same thing
from the same numbers.  ``dtype=None`` keeps the arrays' dtype.  A
bfloat16 array (``np.asarray`` of a JAX bfloat16 array has the
``ml_dtypes`` type, which torch does not read) is widened to float32 and
cast back to ``torch.bfloat16``, which is exact both ways.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, as_tensor
from tensornetwork_tpu_torch.models.mpo import MPO


def _tensor(a, device: Optional[Device], dtype: Optional[torch.dtype]):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = as_tensor(a.astype(np.float32), device).to(torch.bfloat16)
        return t if dtype is None else t.to(dtype)
    return as_tensor(a, device, dtype)


def mpo_from_numpy(Ws, vL, vR, *, device: Optional[Device] = None,
                   dtype: Optional[torch.dtype] = None) -> MPO:
    """An :class:`MPO` from (N, M, M, d, d), (M,), (M,) arrays."""
    return MPO(*(_tensor(a, device, dtype) for a in (Ws, vL, vR)))


def mps_from_numpy(As, *, device: Optional[Device] = None,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An MPS stack (N, chi, d, chi), or a batch of them, as a tensor."""
    return _tensor(As, device, dtype)
