from tensornetwork_tpu_torch.models.mpo import MPO, FiniteTFI, mpo_to_dense
from tensornetwork_tpu_torch.models.dmrg import FiniteDMRG
from tensornetwork_tpu_torch.models.mps import FiniteMPS
from tensornetwork_tpu_torch.models.infinite_mps import InfiniteMPS
from tensornetwork_tpu_torch.models import mera, tebd
from tensornetwork_tpu_torch.models.tdvp import TDVP
from tensornetwork_tpu_torch.models.symmetric_dmrg import (
    SymmetricFiniteDMRG, u1_xxz_mpo, half_filled_mps)
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)
