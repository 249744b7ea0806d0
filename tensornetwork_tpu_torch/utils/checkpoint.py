"""Checkpoint / resume for solver state.

Counterpart of :mod:`tensornetwork_tpu.utils.checkpoint`.  The JAX
package writes its pytrees with orbax; the port writes the same state
dict (``As``, ``Ws``, ``vL``, ``vR``, ``energies``, ``sweep``, and
``rng_state`` where a generator is given) with ``torch.save`` and reads
it with ``torch.load(weights_only=True)``.  The two on-disk formats
differ, so neither package reads the other's files; the dict of numpy
arrays that the JAX package's ``load_dmrg_state`` returns restores into
the port through :func:`restore_dmrg`.  Tensors are saved from the CPU,
so a checkpoint written on the card loads anywhere.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, as_tensor, default_device


def _to_cpu(tree: Any) -> Any:
    """Tensors (and numpy arrays, as tensors) on the CPU, through dicts,
    lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().resolve_conj().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_dmrg_state(path: str, dmrg, sweep: int = 0,
                    generator: Optional[torch.Generator] = None) -> None:
    """Persist a ``FiniteDMRG`` (or ``BatchedDMRG``) solver state, with
    ``generator``'s state if given."""
    state = {
        "As": dmrg.As, "Ws": dmrg.mpo.Ws, "vL": dmrg.mpo.vL,
        "vR": dmrg.mpo.vR,
        "energies": torch.tensor(dmrg.energies or [0.0],
                                 dtype=torch.float64),
        "sweep": torch.tensor(sweep),
    }
    if generator is not None:
        state["rng_state"] = generator.get_state()
    save_pytree(path, state)


def load_dmrg_state(path: str) -> Dict[str, Any]:
    """Load the raw state dict (CPU tensors); reconstruct a solver with
    :func:`restore_dmrg`."""
    return load_pytree(path)


def restore_dmrg(state: Union[str, Mapping[str, Any]],
                 device: Optional[Device] = None):
    """Rebuild a ``FiniteDMRG`` on ``device`` (default: the card) from a
    checkpoint path or a state dict, of tensors or numpy arrays (as the
    JAX package's ``load_dmrg_state`` returns); returns (solver,
    sweep)."""
    from tensornetwork_tpu_torch.models.dmrg import FiniteDMRG
    from tensornetwork_tpu_torch.models.mpo import MPO
    if isinstance(state, (str, os.PathLike)):
        state = load_dmrg_state(state)
    device = default_device(device)
    mpo = MPO(*(as_tensor(np.asarray(state[k]), device)
                for k in ("Ws", "vL", "vR")))
    dmrg = FiniteDMRG(as_tensor(np.asarray(state["As"]), device), mpo)
    dmrg.energies = [float(e) for e in np.asarray(state["energies"]).ravel()]
    return dmrg, int(np.asarray(state["sweep"]))


def save_pytree(path: str, tree: Any) -> None:
    """Save nested dicts, lists and tuples of tensors, numpy arrays (saved
    as tensors) and python scalars with ``torch.save``."""
    torch.save(_to_cpu(tree), os.path.abspath(path))


def load_pytree(path: str) -> Any:
    """Load what :func:`save_pytree` wrote (CPU tensors), without
    unpickling arbitrary objects (``weights_only=True``)."""
    return torch.load(os.path.abspath(path), weights_only=True)
