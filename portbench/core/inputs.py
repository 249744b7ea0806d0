"""The inputs of every run, made from ``--seed`` on the card in a few large
calls: the same seed gives the same inputs, to the program and to the
reference alike."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

SEED_MOD = 2 ** 63


def generator(seed: int, device, stream: int = 0):
    """A ``torch.Generator`` on ``device`` for stream ``stream`` of
    ``seed`` (any whole number)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + stream) % SEED_MOD)
    return g


def random_stack(seed: int, B: int, N: int, chi: int, d: int, dtype,
                 device):
    """(B, N, chi, d, chi) normal entries over sqrt(chi d): a uniform MPS
    stack of each of B instances."""
    import torch
    g = generator(seed, device)
    x = torch.randn((B, N, chi, d, chi), generator=g, dtype=dtype,
                    device=device)
    return x.mul_(1.0 / float(np.sqrt(chi * d)))


def random_flat(seed: int, B: int, sizes: Sequence[int], dtype, device
                ) -> List:
    """One (B, sum(sizes)) normal draw split into (B, n_i) blocks, each
    over sqrt(n_i)."""
    import torch
    g = generator(seed, device)
    x = torch.randn((B, int(sum(sizes))), generator=g, dtype=dtype,
                    device=device)
    out = []
    for blk, n in zip(torch.split(x, list(sizes), dim=1), sizes):
        out.append(blk.mul_(1.0 / float(np.sqrt(max(n, 1)))))
    return out


def couplings(seed: int, B: int, lo: float, hi: float,
              clean: float) -> np.ndarray:
    """(B,) couplings ~ U(lo, hi), realization 0 the clean value."""
    rng = np.random.default_rng([int(seed) % SEED_MOD, 1])
    c = rng.uniform(lo, hi, B)
    c[0] = clean
    return c
