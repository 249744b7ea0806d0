"""The benchmark of the PyTorch/CUDA port (``tensornetwork_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; see ``portbench/README.md``.  Nothing here imports JAX
or the JAX package.
"""
