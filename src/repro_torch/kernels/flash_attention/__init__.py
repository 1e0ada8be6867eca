from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_plain)
