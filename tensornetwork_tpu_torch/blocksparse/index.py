"""Index = (charges, flow) pair labeling a tensor leg
(reference ``block_sparse/index.py:20-155``).

A copy of :mod:`tensornetwork_tpu.blocksparse.index` (pure numpy)."""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from tensornetwork_tpu_torch.blocksparse.charge import BaseCharge, fuse_charges


class Index:
    """One tensor leg: possibly-nested charges with flow directions."""

    def __init__(self, charges: Union[BaseCharge, Sequence[BaseCharge]],
                 flow: Union[bool, Sequence[bool]]):
        if isinstance(charges, BaseCharge):
            charges = [charges]
        self._charges = list(charges)
        if np.isscalar(flow):
            flow = [bool(flow)]
        self._flows = [bool(f) for f in flow]
        if len(self._flows) != len(self._charges):
            raise ValueError("number of flows must match number of charges")

    @property
    def dim(self) -> int:
        return int(np.prod([c.dim for c in self._charges], dtype=np.int64))

    @property
    def flat_charges(self) -> List[BaseCharge]:
        return list(self._charges)

    @property
    def flat_flows(self) -> List[bool]:
        return list(self._flows)

    @property
    def charges(self) -> BaseCharge:
        """The fused charges of this (possibly composite) leg."""
        return fuse_charges(self._charges, self._flows)

    @property
    def flow(self) -> bool:
        # composite indices have their flow absorbed into `charges`
        return False if len(self._flows) > 1 else self._flows[0]

    def copy(self) -> "Index":
        return Index([c.copy() for c in self._charges], list(self._flows))

    def flip_flow(self) -> "Index":
        return Index([c.copy() for c in self._charges],
                     [not f for f in self._flows])

    def __mul__(self, other: "Index") -> "Index":
        return fuse_index_pair(self, other)

    def __repr__(self):
        return f"Index(dim={self.dim}, flows={self._flows})"


def fuse_index_pair(left: Index, right: Index) -> Index:
    """(reference ``index.py:126``)"""
    return Index(left.flat_charges + right.flat_charges,
                 left.flat_flows + right.flat_flows)


def fuse_indices(indices: Sequence[Index]) -> Index:
    out = indices[0]
    for i in indices[1:]:
        out = fuse_index_pair(out, i)
    return out
