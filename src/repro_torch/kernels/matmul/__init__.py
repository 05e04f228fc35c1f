from repro_torch.kernels.matmul.matmul import (  # noqa: F401
    ACT_CODES,
    ACTIVATIONS,
    matmul_tiled,
    matmul_tiled_plain,
)
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: F401
