from tensornetwork_tpu_torch.quantum.quantum import (
    QuOperator, QuVector, QuAdjointVector, QuScalar, identity,
    quantum_constructor, check_spaces, eliminate_identities)
