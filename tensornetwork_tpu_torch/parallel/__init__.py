from tensornetwork_tpu_torch.parallel.mesh import (
    make_mesh, shard_array, replicate, batch_spec)
from tensornetwork_tpu_torch.parallel.batch import (
    batched_one_site_sweep, batched_two_site_sweep,
    batched_one_site_sweep_paired, batched_two_site_sweep_paired,
    BatchedDMRG)
from tensornetwork_tpu_torch.parallel.sweep import DistributedDMRG
from tensornetwork_tpu_torch.parallel.tp import TPShardedDMRG
