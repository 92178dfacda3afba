from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.paged_attention.ops import attention
