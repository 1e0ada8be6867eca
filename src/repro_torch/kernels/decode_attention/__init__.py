from repro_torch.kernels.decode_attention.multiquery import (  # noqa: F401
    mq_decode_attention, mq_decode_attention_plain)
from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention, decode_attention_plain)
