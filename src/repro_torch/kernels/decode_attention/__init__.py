from repro_torch.kernels.decode_attention.kernel import (
    decode_scores, decode_values)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention.ops import attention
