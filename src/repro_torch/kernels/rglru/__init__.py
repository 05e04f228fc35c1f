from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: F401
from repro_torch.kernels.rglru.rglru import (  # noqa: F401
    RGLRU_CHUNK,
    rglru_scan,
    rglru_scan_bwd,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
)
