from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    NEG_INF,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
