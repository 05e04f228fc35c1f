from repro_torch.kernels.paged_attention.paged_attention import (  # noqa: F401
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_prefill,
    paged_attention_prefill_plain,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    gather_pages,
    paged_attention_ref,
)
