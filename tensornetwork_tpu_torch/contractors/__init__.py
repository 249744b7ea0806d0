from tensornetwork_tpu_torch.contractors.path_contractors import (
    auto, greedy, optimal, branch, custom, base, path_solver, contract_path)
from tensornetwork_tpu_torch.contractors.bucket import bucket
from tensornetwork_tpu_torch.contractors import custom_path_solvers
