"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name`` gives: NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the full 700 W power limit.

The f32 work of the port runs as 3xTF32 on the tensor cores, whose useful
rate can pass the 67 TFLOP/s of f32 outside them; no f32-accurate
implementation passes the TF32 peak, so shares of a peak are taken
against it."""
from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"tf32_flops": 495e12, "hbm_bytes": 3.35e12},
}
