"""Discrete Fourier transform as a tensor network, on the port's graph
core (counterpart of ``examples/fft.py``; reference
``examples/fft/fft.py:8-60``).

The size-2^n DFT is the QFT circuit: a chain of Hadamard and
controlled-phase two-bit gates plus a bit reversal -- O(n^2) two-bit
tensors instead of one 2^n x 2^n matrix.

    python -m tensornetwork_tpu_torch.examples.fft [--cpu]
"""
import argparse
from typing import Optional

import numpy as np
import torch

import tensornetwork_tpu_torch as tn
from tensornetwork_tpu_torch.config import Device, default_device


def add_fft(input_edges, inverse: bool = False):
    """Append a DFT network to ``input_edges`` (list of dim-2 dangling
    edges, most-significant bit first), its gates on the device of the
    first edge's node.  Returns (nodes, output_edges, scale) with output
    bits most-significant first, satisfying out[k] = scale * sum_x
    exp(-2 pi i k x / N) in[x] (numpy convention)."""
    n = len(input_edges)
    device = input_edges[0].node1.tensor.device
    sign = 1.0 if inverse else -1.0
    H = np.array([[1.0, 1.0], [1.0, -1.0]], dtype=complex) / np.sqrt(2)
    nodes = []
    edges = list(input_edges)
    for j in range(n):
        # Hadamard on bit j
        h = tn.Node(torch.as_tensor(H, device=device), name=f"H_{j}")
        edges[j] ^ h[1]
        edges[j] = h[0]
        nodes.append(h)
        # controlled phases from bits j+1..n-1
        for k in range(j + 1, n):
            phi = sign * 2.0 * np.pi / (2 ** (k - j + 1))
            cp = np.eye(4, dtype=complex)
            cp[3, 3] = np.exp(1j * phi)
            g = tn.Node(torch.as_tensor(cp.reshape(2, 2, 2, 2),
                                        device=device), name=f"CP_{j}_{k}")
            edges[j] ^ g[2]
            edges[k] ^ g[3]
            edges[j] = g[0]
            edges[k] = g[1]
            nodes.append(g)
    # QFT outputs bits in reversed order; the unitary QFT carries a
    # 1/sqrt(N) normalization relative to the numpy DFT convention
    scale = 2 ** (n / 2.0)
    out_edges = list(reversed(edges))
    return nodes, out_edges, scale


def fft_via_network(x: np.ndarray, device: Optional[Device] = None
                    ) -> np.ndarray:
    """DFT of a length-2^n vector through the network, complex128 on
    ``device``; returns a numpy array."""
    n = int(np.log2(x.shape[0]))
    assert 2 ** n == x.shape[0]
    inp = tn.Node(torch.as_tensor(x.reshape((2,) * n).astype(complex),
                                  device=default_device(device)),
                  name="input")
    nodes, out_edges, scale = add_fft([inp[i] for i in range(n)])
    result = tn.contractors.auto([inp] + nodes,
                                 output_edge_order=out_edges)
    out = result.tensor.cpu().numpy() * scale
    return out.reshape(-1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    dev = "cpu" if ap.parse_args().cpu else None
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    np.testing.assert_allclose(fft_via_network(x, dev), np.fft.fft(x),
                               atol=1e-10)
    print("fft network matches np.fft.fft for N=16")
