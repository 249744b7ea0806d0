"""Batched-realization execution for block-sparse U(1) tensors.

Counterpart of :mod:`tensornetwork_tpu.blocksparse.batched`.  Disorder
realizations share one charge *skeleton* (identical charges/flows/layout
per tensor), so their data vectors stack on a leading batch axis and every
sector operation becomes a batched device op:

* contractions: the bucketed executor of
  :mod:`tensornetwork_tpu_torch.blocksparse.torch_engine`, which takes the
  batch axis natively (the JAX package ``vmap``\\ s its plan);
* gauge shifts: per-sector completed-polar factorizations
  (:func:`tensornetwork_tpu_torch.ops.decompositions.polar_complete`) on
  gathered ``(B, nr, nc)`` sector stacks;
* two-site splits: per-sector batched SVDs
  (:func:`~tensornetwork_tpu_torch.ops.decompositions.thin_svd`) that keep
  the bond's static multiplicity m(q) and sum the discarded weight.

Static shapes everywhere: the skeleton's bond-charge multiplicities are
constructed (:func:`canonical_bond_charges`, a copy of the JAX package's
host function) so that every matricization sector satisfies rows >= cols
in the shift direction, making exact isometric gauge fixing possible
without dynamic bond shrinking (the reference's block-sparse QR shrinks
bonds per sector, reference ``block_sparse/linalg.py:300``).

The capacity-EP environment helpers and the chain executor of the JAX
package (``env_*``, ``chain_contraction_plan``) wait for the multi-device
slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
from tensornetwork_tpu_torch.blocksparse.charge import BaseCharge, U1Charge
from tensornetwork_tpu_torch.blocksparse.index import Index
from tensornetwork_tpu_torch.blocksparse.initialization import zeros
from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, _expand_indices, find_diagonal_blocks, normalize_axes)
from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.ops.decompositions import (polar_complete,
                                                        thin_svd)


def canonical_bond_charges(N: int, chi: int, n_total: Optional[int] = None,
                           width: int = 2) -> List[np.ndarray]:
    """Bond-charge multiplicity profile admitting exact static-shape
    canonicalization in BOTH sweep directions.

    Returns ``N+1`` sorted charge vectors (bond 0..N), bond k holding at
    most ``chi`` charges near ``n_total*k/N``, satisfying for every
    charge q and physical charges {0, 1}:

      (R)  m_k(q) + m_k(q-1) >= m_{k+1}(q)   (right-shift sectors tall)
      (L)  m_{k+1}(q) + m_{k+1}(q+1) >= m_k(q)  (left-shift sectors wide)

    enforced by alternating forward/backward capping passes (monotone,
    converges).  Boundary bonds are {0} and {n_total}.
    """
    if n_total is None:
        n_total = N // 2
    # target multiplicity tables: window around the mean filling
    mult: List[Dict[int, int]] = [{0: 1}]
    for k in range(1, N):
        mean = n_total * k / N
        lo = max(int(np.floor(mean)) - width, max(0, n_total - (N - k)))
        hi = min(int(np.ceil(mean)) + width, min(k, n_total))
        qs = list(range(lo, hi + 1))
        if not qs:
            qs = [max(0, min(int(round(mean)), n_total))]
        base = max(chi // len(qs), 1)
        tab = {q: base for q in qs}
        # distribute the remainder to the central charges
        rem = chi - base * len(qs)
        center = sorted(qs, key=lambda q: abs(q - mean))
        for q in center[:max(rem, 0)]:
            tab[q] += 1
        mult.append(tab)
    mult.append({n_total: 1})

    def cap_forward():
        changed = False
        for k in range(N):
            for q in list(mult[k + 1]):
                limit = mult[k].get(q, 0) + mult[k].get(q - 1, 0)
                if mult[k + 1][q] > limit:
                    mult[k + 1][q] = limit
                    changed = True
            mult[k + 1] = {q: m for q, m in mult[k + 1].items() if m > 0}
        return changed

    def cap_backward():
        changed = False
        for k in range(N - 1, -1, -1):
            for q in list(mult[k]):
                limit = mult[k + 1].get(q, 0) + mult[k + 1].get(q + 1, 0)
                if mult[k][q] > limit:
                    mult[k][q] = limit
                    changed = True
            mult[k] = {q: m for q, m in mult[k].items() if m > 0}
        return changed

    for _ in range(4 * N):
        c1 = cap_forward()
        c2 = cap_backward()
        if not (c1 or c2):
            break
    for k, tab in enumerate(mult):
        if not tab:
            raise ValueError(
                f"bond {k} has no admissible charges for chi={chi}, "
                f"N={N}, n_total={n_total}")
    return [np.sort(np.concatenate([[q] * m for q, m in sorted(t.items())])
                    ).astype(np.int64) for t in mult]


def uniform_skeleton_mps(N: int, chi: int, n_total: Optional[int] = None,
                         dtype=torch.float32,
                         device: Optional[Device] = None
                         ) -> List[BlockSparseTensor]:
    """Zero-data skeleton MPS with :func:`canonical_bond_charges` bonds,
    on ``device`` (default: the card).  Legs (l[False], s[False],
    r[True]); physical charge n in {0, 1}."""
    bonds = canonical_bond_charges(N, chi, n_total)
    phys = U1Charge(np.array([0, 1]))
    out = []
    for k in range(N):
        idx = [Index(U1Charge(bonds[k]), False), Index(phys, False),
               Index(U1Charge(bonds[k + 1]), True)]
        out.append(zeros(idx, dtype=dtype, device=device))
    return out


def random_data_batch(skeleton: Sequence[BlockSparseTensor], B: int,
                      seed: int = 0, device: Optional[Device] = None
                      ) -> List[torch.Tensor]:
    """(B, nnz_i) random normal data stacks for each skeleton tensor, in
    its dtype: the JAX package's draws (``numpy.random.default_rng(seed)``,
    scaled by 1/sqrt(nnz_i)), on ``device`` (default: the card)."""
    rng = np.random.default_rng(seed)
    dev = default_device(device)
    out = []
    for t in skeleton:
        n = t.data.shape[0]
        host = rng.standard_normal((B, n)) / np.sqrt(max(n, 1))
        out.append(torch.from_numpy(host).to(t.dtype).to(dev))
    return out


# ---------------------------------------------------------------------------
# Batched sector gauge shifts
# ---------------------------------------------------------------------------


def _matricization_meta(t: BlockSparseTensor, partition: int):
    """(sector charges, block position maps, block shapes) of the
    (rows=[:p], cols=[p:]) matricization of a natural-order skeleton."""
    if [list(g) for g in t._order] != [[i] for i in range(t.ndim)]:
        raise ValueError("skeleton must be in natural order")
    return find_diagonal_blocks(list(t.flat_charges), list(t.flat_flows),
                                partition)


def _bond_matrix_skeleton(bond: BaseCharge, dtype) -> BlockSparseTensor:
    """Square bond matrix skeleton with legs (bond[False], bond[True])."""
    charges, flows, order = _expand_indices(
        [Index(bond.copy(), False), Index(bond.copy(), True)])
    return TE.skeleton(charges, flows, order, dtype)


def _sector_label_map(charges: BaseCharge) -> Dict[Tuple, int]:
    arr = np.asarray(charges.charges).reshape(len(charges), -1)
    return {tuple(int(v) for v in arr[i]): i for i in range(len(charges))}


class ShiftPlan:
    """Host-compiled plan for a batched sector polar shift of one site.

    Each sector block is factored as a tall matrix: the block itself for
    a right shift, its transpose for a left one.  Blocks with the same
    width (the bond multiplicity k) share one ``polar_complete`` call on a
    ``(..., G, n, k)`` stack, the shorter ones padded with zero rows, which
    leave the polar factors of the real rows as they are (the Newton-Schulz
    iterates keep zero rows at zero, and the completion draws its
    directions from the first k rows)."""

    def __init__(self, skel: BlockSparseTensor, direction: str):
        if direction not in ("right", "left"):
            raise ValueError(direction)
        self.direction = direction
        partition = 2 if direction == "right" else 1
        sec, maps, shapes = _matricization_meta(skel, partition)
        bond_leg = 2 if direction == "right" else 0
        bond = skel.flat_charges[bond_leg]
        self.bond_skel = _bond_matrix_skeleton(bond, skel.dtype)
        bsec, bmaps, bshapes = _matricization_meta(self.bond_skel, 1)
        bmap_by_charge = _sector_label_map(bsec)
        self.nnz = skel.data.shape[0]
        self.bond_nnz = self.bond_skel.data.shape[0]
        tall, seen_bond = {}, set()
        for i in range(len(sec)):
            q = tuple(int(v) for v in
                      np.asarray(sec.charges).reshape(len(sec), -1)[i])
            j = bmap_by_charge.get(q)
            if j is None:
                raise ValueError(
                    f"matricization sector {q} missing on the bond -- "
                    "skeleton violates the canonical profile")
            nr, nc = shapes[i]
            bnr, bnc = bshapes[j]
            k = nc if direction == "right" else nr
            if bnr != k or bnc != k:
                raise ValueError("bond sector shape mismatch")
            if direction == "right" and nr < nc:
                raise ValueError(
                    f"sector {q}: rows {nr} < cols {nc} -- right shift "
                    "not isometric; use canonical_bond_charges")
            if direction == "left" and nc < nr:
                raise ValueError(
                    f"sector {q}: cols {nc} < rows {nr} -- left shift "
                    "not isometric; use canonical_bond_charges")
            if direction == "right":
                tall.setdefault(k, []).append((maps[i], bmaps[j]))
            else:
                tall.setdefault(k, []).append((maps[i].T, bmaps[j].T))
            seen_bond.add(j)
        self.maps = TE.DeviceMaps()
        self.groups = []
        for k, members in tall.items():
            n = max(m.shape[0] for m, _ in members)
            gather = np.full((len(members), n, k), self.nnz, dtype=np.int64)
            for g, (m, _) in enumerate(members):
                gather[g, :m.shape[0]] = m
            self.groups.append(dict(
                k=k, gather=self.maps.add(gather),
                bond=self.maps.add(np.stack([b for _, b in members]))))
        # bond sectors never produced (no matching matricization sector)
        # keep identity so absorbing the factor is well-defined
        self.identity_bond = [
            (self.maps.add(bmaps[j]), bshapes[j])
            for j in range(len(bsec)) if j not in seen_bond]

    def __call__(self, data: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """data (..., nnz) -> (Q data (..., nnz), bond data (..., bond_nnz)).

        right: A = Q·P (Q col-isometric);  left: A = P·Q (Q row-isometric).
        """
        batch_shape = data.shape[:-1]
        dev = data.device
        maps = self.maps.on(dev)
        # a zero slot for the padded rows; the same slot absorbs their
        # scatter, and is cut off
        zero = data.new_zeros(batch_shape + (1,))
        dx = torch.cat([data, zero], dim=-1)
        qx = data.new_zeros(batch_shape + (self.nnz + 1,))
        pd = data.new_zeros(batch_shape + (self.bond_nnz,))
        for grp in self.groups:
            gather = maps[grp["gather"]]
            Q, P = polar_complete(dx[..., gather])    # (..., G, n, k)
            qx[..., gather] = Q
            pd[..., maps[grp["bond"]]] = P
        for bmap, (k, _) in self.identity_bond:
            eye = torch.eye(k, dtype=data.dtype, device=dev)
            pd[..., maps[bmap]] = eye.expand(batch_shape + (k, k))
        return qx[..., :self.nnz], pd


# ---------------------------------------------------------------------------
# Batched contraction on a shared skeleton
# ---------------------------------------------------------------------------


def contraction_plan(skel1: BlockSparseTensor, skel2: BlockSparseTensor,
                     axes, precision: str = "highest", ep=None):
    """(run fn, output skeleton) for a fixed structure.  The run fn maps
    data ``(..., nnz1)``, ``(..., nnz2)`` to ``(..., nnz_out)`` on the
    operands' device (a leading instance axis runs in the same batched
    GEMMs); the skeleton's data is storage-free (``meta``).  ``ep=``, the
    sector-sharded executor, waits for the multi-device slice."""
    if ep is not None:
        raise NotImplementedError(
            "the sector-sharded executor (ep=) waits for the multi-device "
            "slice: ROADMAP.md Queue 1 item 10")
    axes1, axes2 = normalize_axes(skel1, skel2, axes)
    plan = TE._get_plan(skel1, skel2, axes1, axes2, precision)
    return plan["run"], (None if plan["scalar"] else TE.out_skeleton(plan))


class TwoSiteSplitPlan:
    """Batched sector-SVD split of a two-site block back onto the fixed
    bond profile.

    theta legs (l, s, t, r) with the new bond between (l,s) and (t,r);
    for each bond sector q the kept rank is exactly the bond's
    multiplicity m(q) (static) -- per-sector truncation instead of the
    reference's global cross-sector singular-value sort (reference
    ``symmetric/decompositions.py:70-120``); with the canonical profile
    both row and column multiplicities dominate m(q), so shapes never
    shrink.  Returns left data (A_i layout), right data (A_{i+1} layout)
    and the summed squared discarded weight.
    """

    def __init__(self, theta_skel: BlockSparseTensor,
                 left_skel: BlockSparseTensor,
                 right_skel: BlockSparseTensor):
        sec, maps, shapes = _matricization_meta(theta_skel, 2)
        lsec, lmaps, lshapes = _matricization_meta(left_skel, 2)
        rsec, rmaps, rshapes = _matricization_meta(right_skel, 1)
        lmap_q = _sector_label_map(lsec)
        rmap_q = _sector_label_map(rsec)
        qarr = np.asarray(sec.charges).reshape(len(sec), -1)
        self.maps = TE.DeviceMaps()
        self.blocks = []
        for i in range(len(sec)):
            q = tuple(int(v) for v in qarr[i])
            li, ri = lmap_q.get(q), rmap_q.get(q)
            if li is None or ri is None:
                # bond does not carry this fused charge: the whole sector
                # is discarded weight
                self.blocks.append(dict(map=self.maps.add(maps[i]),
                                        shape=shapes[i], keep=0))
                continue
            nr, nc = shapes[i]
            k = lshapes[li][1]
            if lshapes[li][0] != nr or rshapes[ri][1] != nc \
                    or rshapes[ri][0] != k:
                raise ValueError(f"sector {q}: inconsistent block shapes")
            if k > min(nr, nc):
                raise ValueError(
                    f"sector {q}: bond multiplicity {k} exceeds "
                    f"min(rows, cols) = {min(nr, nc)}")
            self.blocks.append(dict(
                map=self.maps.add(maps[i]), shape=(nr, nc), keep=k,
                lmap=self.maps.add(lmaps[li]),
                rmap=self.maps.add(rmaps[ri])))
        self.left_nnz = left_skel.data.shape[0]
        self.right_nnz = right_skel.data.shape[0]

    def __call__(self, theta: torch.Tensor, absorb: str, ep=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """theta (..., nnz) -> (left data, right data, trunc_sq).

        ``absorb='right'``: left factor U isometric, right = S·Vh
        (left-to-right sweep); ``absorb='left'``: right factor Vh
        isometric, left = U·S.  ``ep=`` waits for the multi-device
        slice."""
        if ep is not None:
            raise NotImplementedError(
                "the distributed split (ep=) waits for the multi-device "
                "slice: ROADMAP.md Queue 1 item 10")
        batch_shape = theta.shape[:-1]
        maps = self.maps.on(theta.device)
        ld = theta.new_zeros(batch_shape + (self.left_nnz,))
        rd = theta.new_zeros(batch_shape + (self.right_nnz,))
        terr = theta.new_zeros(batch_shape)
        for b in self.blocks:
            blk = theta[..., maps[b["map"]]]
            if b["keep"] == 0:
                terr = terr + torch.sum(blk * blk, dim=(-2, -1))
                continue
            k = b["keep"]
            U, S, Vh = thin_svd(blk)
            Uk = U[..., :, :k]
            Sk = S[..., :k].to(theta.dtype)
            Vk = Vh[..., :k, :]
            terr = terr + torch.sum(S[..., k:] ** 2, dim=-1).to(theta.dtype)
            if absorb == "right":
                lblk, rblk = Uk, Sk[..., :, None] * Vk
            else:
                lblk, rblk = Uk * Sk[..., None, :], Vk
            ld[..., maps[b["lmap"]]] = lblk
            rd[..., maps[b["rmap"]]] = rblk
        return ld, rd, terr
