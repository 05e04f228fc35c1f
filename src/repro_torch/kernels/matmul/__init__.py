from repro_torch.kernels.matmul.matmul import (  # noqa: F401
    ACT_CODES,
    ACTIVATIONS,
    hbm_traffic_model,
    kernel_blocks,
    matmul_mcast,
    matmul_mcast_plain,
    matmul_tiled,
    matmul_tiled_plain,
    matmul_unicast,
    matmul_unicast_plain,
    mcast_cluster,
)
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: F401
