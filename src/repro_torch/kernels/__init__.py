"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it, behind a schedule registry (see ``api.py``)."""
from repro_torch.kernels.api import (  # noqa: F401
    ACTIVATIONS,
    KERNELS,
    NON_FINITE,
    DispatchPolicy,
    FallbackStats,
    KernelUnavailable,
    all_finite,
    call_with_fallback,
    count_guarded_call,
    device_lost,
    fallback_stats,
    get_policy,
    grouped_linear,
    launch_counts,
    linear,
    op,
    reset_fallback_stats,
    reset_launch_counts,
    resolve,
    set_policy,
    use_policy,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    attention_ref,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_plain,
)
from repro_torch.kernels.rglru import (  # noqa: F401
    rglru_scan,
    rglru_scan_bwd,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
    rglru_scan_ref,
)
from repro_torch.kernels.ssd import (  # noqa: F401
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
    ssd_scan_ref,
)
