from tensornetwork_tpu_torch.nn.layers import (
    DenseDecomp, DenseMPO, DenseCondenser, DenseExpander, DenseEntangler,
    Conv2DMPO)
