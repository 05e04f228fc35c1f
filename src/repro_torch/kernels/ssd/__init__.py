from repro_torch.kernels.ssd.ref import ssd_scan_ref  # noqa: F401
from repro_torch.kernels.ssd.ssd import (  # noqa: F401
    SSD_CHUNK,
    ssd_lcum,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
)
