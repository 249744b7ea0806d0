"""Carry state from the JAX package into the port.

Each takes numpy arrays (``np.asarray`` of the JAX package's arrays) and
return the port's tensors (copies, never views of the arrays), so that the two packages compute the same thing
from the same numbers.  ``dtype=None`` keeps the arrays' dtype.  A
bfloat16 array (``np.asarray`` of a JAX bfloat16 array has the
``ml_dtypes`` type, which torch does not read) is widened to float32 and
cast back to ``torch.bfloat16``, which is exact both ways.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import List, Optional, Sequence

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, as_tensor
from tensornetwork_tpu_torch.core.network import Node
from tensornetwork_tpu_torch.models.mera import MERAState
from tensornetwork_tpu_torch.models.mpo import MPO
from tensornetwork_tpu_torch.models.mps import FiniteMPS
from tensornetwork_tpu_torch.models.vumps import VUMPSState


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


def mps_from_split_complex(re, im, *, device: Optional[Device] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """A complex MPS stack (or batch) from the real and imaginary parts of
    the JAX package's split-complex state (``np.asarray`` of its ``SC``'s
    ``re`` and ``im``): complex128 from float64 parts, complex64 from
    float32 ones, unless ``dtype`` is given."""
    re, im = np.asarray(re), np.asarray(im)
    return _tensor(re + 1j * im.astype(re.dtype), device, dtype)


def vumps_state_from_numpy(AL, AR, C, AC, *, device: Optional[Device] = None,
                           dtype: Optional[torch.dtype] = None) -> VUMPSState:
    """A :class:`VUMPSState` from the four arrays of the JAX package's
    ``VUMPSState`` (``np.asarray`` of each), so that both packages iterate
    from the same uniform MPS."""
    return VUMPSState(*(_tensor(a, device, dtype) for a in (AL, AR, C, AC)))


def finite_mps_from_numpy(As, center_position: Optional[int] = None, *,
                          device: Optional[Device] = None,
                          dtype: Optional[torch.dtype] = None) -> FiniteMPS:
    """A :class:`FiniteMPS` holding the JAX package's ``FiniteMPS`` state
    (``np.asarray`` of its ``As`` and its ``center_position``) as it is,
    not canonicalised again.  An ``InfiniteMPS`` takes
    :func:`mps_from_numpy`'s tensor directly."""
    return FiniteMPS(_tensor(As, device, dtype),
                     center_position=center_position, canonicalize=False)


def mera_state_from_numpy(us, ws, *, device: Optional[Device] = None,
                          dtype: Optional[torch.dtype] = None) -> MERAState:
    """A :class:`MERAState` from the JAX package's ``MERAState`` lists
    (``np.asarray`` of each u and w)."""
    return MERAState([_tensor(u, device, dtype) for u in us],
                     [_tensor(w, device, dtype) for w in ws])


def nodes_from_numpy(arrays, names: Optional[Sequence[str]] = None, *,
                     device: Optional[Device] = None,
                     dtype: Optional[torch.dtype] = None) -> List[Node]:
    """Unconnected :class:`Node`\\ s holding copies of ``arrays``, named
    ``names`` if given, so that a network built from the same numpy
    arrays in both packages starts from the same numbers."""
    names = [None] * len(arrays) if names is None else list(names)
    return [Node(_tensor(a, device, dtype), name=n)
            for a, n in zip(arrays, names)]


def load_flax_params(module: torch.nn.Module, params: Mapping
                     ) -> torch.nn.Module:
    """Copy a Flax param tree (numpy arrays, ``np.asarray`` of each leaf)
    into ``module``'s parameters, in place, and return ``module``.

    A top-level ``"params"`` collection is unwrapped.  A nested mapping
    fills a submodule: Flax's auto-names (``DenseMPO_0``, ``Dense_0``)
    map to attribute names through the module's ``flax_names`` mapping,
    if it has one (a key it lacks is the attribute's own name).
    A leaf fills the parameter of its name, of the same shape; a Flax
    ``nn.Dense`` kernel (in, out) fills a ``torch.nn.Linear`` weight (out,
    in).  Each parameter keeps its device and dtype."""
    if set(params) == {"params"}:
        params = params["params"]
    names = getattr(module, "flax_names", {})
    for key, value in params.items():
        if isinstance(value, Mapping):
            load_flax_params(getattr(module, names.get(key, key)), value)
            continue
        arr = np.asarray(value)
        if isinstance(module, torch.nn.Linear) and key == "kernel":
            key, arr = "weight", arr.T
        target = getattr(module, key)
        if tuple(target.shape) != arr.shape:
            raise ValueError(f"{key}: Flax shape {arr.shape} against "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(_tensor(arr, target.device, target.dtype))
    return module
