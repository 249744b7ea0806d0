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

The sector-sharded (EP) forms run over ``torch.distributed`` with
``ep=(ndev, group)``: :func:`contraction_plan` (one all_reduce a
contraction), :func:`chain_contraction_plan` (one a chain, or none),
:meth:`TwoSiteSplitPlan.__call__` (each rank's share of the sector SVDs),
and the capacity layout's environment storage (``env_*``: each rank
stores a 1/ndev block of every environment).
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
from tensornetwork_tpu_torch.utils import tracing


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


def _bond_matrix_skeleton(bond: BaseCharge, dtype,
                          nnz: Optional[int] = None) -> BlockSparseTensor:
    """Square bond matrix skeleton with legs (bond[False], bond[True])."""
    charges, flows, order = _expand_indices(
        [Index(bond.copy(), False), Index(bond.copy(), True)])
    return TE.skeleton(charges, flows, order, dtype, nnz)


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
        TE.build_counts["shift_plans"] += 1
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

    def to_record(self) -> Tuple[dict, List[np.ndarray]]:
        """``(meta, arrays)``: JSON-able metadata and the host index maps."""
        return (dict(direction=self.direction, nnz=int(self.nnz),
                     bond_nnz=int(self.bond_nnz),
                     groups=[[int(g["k"]), g["gather"], g["bond"]]
                             for g in self.groups],
                     identity=[[slot, [int(n) for n in shape]]
                               for slot, shape in self.identity_bond]),
                list(self.maps.host))

    @classmethod
    def from_record(cls, skel: BlockSparseTensor, meta: dict,
                    arrays: Sequence[np.ndarray]) -> "ShiftPlan":
        """The plan of :meth:`to_record`'s record for the site skeleton
        ``skel``, without the host build."""
        if meta["nnz"] != skel.data.shape[0]:
            raise ValueError(f"shift plan of {meta['nnz']} values for a "
                             f"site of {skel.data.shape[0]}")
        self = cls.__new__(cls)
        self.direction = meta["direction"]
        bond = skel.flat_charges[2 if self.direction == "right" else 0]
        self.bond_skel = _bond_matrix_skeleton(bond, skel.dtype,
                                               meta["bond_nnz"])
        self.nnz, self.bond_nnz = meta["nnz"], meta["bond_nnz"]
        self.maps = TE.DeviceMaps()
        self.maps.host = list(arrays)
        self.groups = [dict(k=k, gather=gather, bond=bond_slot)
                       for k, gather, bond_slot in meta["groups"]]
        self.identity_bond = [(slot, tuple(shape))
                              for slot, shape in meta["identity"]]
        return self

    @tracing.spanned("shift")
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
    GEMMs); the skeleton's data is storage-free (``meta``).

    ``ep=(ndev, group)`` returns the sector-sharded executor of this rank
    of ``group`` instead: its G/ndev slice of every bucket and one
    ``all_reduce`` a contraction (see ``torch_engine._get_plan``); every
    rank of the group calls it on the same operands."""
    axes1, axes2 = normalize_axes(skel1, skel2, axes)
    plan = TE._get_plan(skel1, skel2, axes1, axes2, precision, ep=ep)
    return plan["run"], (None if plan["scalar"] else TE.out_skeleton(plan))


# ---------------------------------------------------------------------------
# Capacity-EP sharded environment storage.
#
# Environments dominate the symmetric sweep's memory (at chi=1024 an env
# is ~27x the MPS site it grows from), and the per-contraction EP
# executor keeps every env whole on every rank.  The capacity layout
# stores each env between steps as one (B, L) block a rank, L =
# ceil(nnz/ndev): the env-growth chains run with ``reduce="none"`` and
# reduce-scatter their disjoint-support partials straight into the blocks
# (half an all_reduce's bytes), and consumers all-gather the current
# bond's env for the step (the other half).  Exact by construction:
# reduce-scatter then all-gather is the sum the all_reduce produced.
# ---------------------------------------------------------------------------


def env_block_len(nnz: int, ndev: int) -> int:
    """Per-rank block length of the stored env layout (ceil div)."""
    return -(-nnz // ndev)


def env_scatter_stored(partial: torch.Tensor, ndev: int, group
                       ) -> torch.Tensor:
    """(B, nnz) disjoint-support partial of this rank -> this rank's (B,
    L) block of the summed env (one reduce-scatter over ``group``)."""
    from tensornetwork_tpu_torch.parallel import collectives
    B, nnz = partial.shape
    L = env_block_len(nnz, ndev)
    p = torch.nn.functional.pad(partial, (0, ndev * L - nnz))
    return collectives.reduce_scatter(p, 1, group)


def env_gather_full(stored: torch.Tensor, nnz: int, group) -> torch.Tensor:
    """This rank's (B, L) stored block -> the whole (B, nnz) env (one
    all-gather over ``group``)."""
    from tensornetwork_tpu_torch.parallel import collectives
    return collectives.all_gather(stored, 1, group)[:, :nnz]


def env_to_stored(full: torch.Tensor, ndev: int) -> torch.Tensor:
    """(B, nnz) whole env -> the (B, ndev, L) stored layout, rank d's
    block at [:, d] (for boundary envs)."""
    B, nnz = full.shape
    L = env_block_len(nnz, ndev)
    p = torch.nn.functional.pad(full, (0, ndev * L - nnz))
    return p.reshape(B, ndev, L)


def env_from_stored(stored: torch.Tensor, nnz: int) -> torch.Tensor:
    """(B, ndev, L) stored layout -> the (B, nnz) whole env."""
    B = stored.shape[0]
    return stored.reshape(B, -1)[:, :nnz]


def chain_contraction_plan(stages, ep, precision: str = "highest",
                           reduce: str = "psum"):
    """Fused EP executor of a chain of contractions.

    ``stages``: list of ``(skel1, skel2, axes)``, ``skel1`` None after the
    first stage (the through-operand, the previous output).
    ``ep=(ndev, group)``.  Returns ``(run, out_skel)``; ``run(d1_0, d2_0,
    d2_1, ..., d2_{n-1})`` runs on every rank of ``group`` with the same
    operands and issues ONE ``all_reduce`` (of the final output) for the
    whole chain, against one a contraction for the per-contraction EP
    executor; ``reduce="none"``: none, each rank keeps its partial.
    Equal to the single-device chain: whole dependency components are
    assigned to ranks, so the partials have disjoint support
    (:func:`~tensornetwork_tpu_torch.blocksparse.torch_engine.
    make_chain_executor`)."""
    specs = []
    for (s1, s2, axes) in stages:
        if isinstance(axes, int):
            raise ValueError("chain stages need explicit axes lists")
        axes1, axes2 = [list(a) for a in axes]
        specs.append((s1, s2, axes1, axes2))
    return TE.make_chain_executor(specs, ep[0], ep[1], precision,
                                  reduce=reduce)


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

    def _apply_blocks(self, blocks, theta: torch.Tensor, absorb: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        batch_shape = theta.shape[:-1]
        maps = self.maps.on(theta.device)
        ld = theta.new_zeros(batch_shape + (self.left_nnz,))
        rd = theta.new_zeros(batch_shape + (self.right_nnz,))
        terr = theta.new_zeros(batch_shape)
        for b in blocks:
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

    def __call__(self, theta: torch.Tensor, absorb: str, ep=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """theta (..., nnz) -> (left data, right data, trunc_sq).

        ``absorb='right'``: left factor U isometric, right = S·Vh
        (left-to-right sweep); ``absorb='left'``: right factor Vh
        isometric, left = U·S.

        ``ep=(ndev, group)`` distributes the per-sector SVDs over the
        ranks of ``group``: rank ``d`` factors only blocks ``d::ndev``, and
        their disjoint scatter regions and discarded weights are summed in
        one ``all_reduce`` (the kept ranks are the static bond profile,
        so no global ranking is needed)."""
        if ep is None:
            return self._apply_blocks(self.blocks, theta, absorb)
        from tensornetwork_tpu_torch.parallel import collectives
        ndev, group = ep
        rank = collectives.group_rank(group)
        ld, rd, terr = self._apply_blocks(self.blocks[rank::ndev], theta,
                                          absorb)
        packed = collectives.all_reduce(
            torch.cat([ld, rd, terr[..., None]], dim=-1), group)
        return (packed[..., :self.left_nnz],
                packed[..., self.left_nnz:self.left_nnz + self.right_nnz],
                packed[..., -1])
