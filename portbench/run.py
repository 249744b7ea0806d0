#!/usr/bin/env python3
"""The benchmark's command.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for; exits non-zero, printing no result, without them.  See README.md.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, ".portbench_cache")
# every kernel cache inside the checkout, at a fixed path (the port builds
# its own CUDA libraries under tensornetwork_tpu_torch/build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [CHECKOUT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE,
                                                                 CHECKOUT)]

from portbench.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(T_START))
