from tensornetwork_tpu_torch.models.mpo import MPO, FiniteTFI, mpo_to_dense
