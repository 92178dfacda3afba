from repro_torch.kernels.chunked_copy.kernel import (
    gather_chunks,
    scatter_chunks,
)
from repro_torch.kernels.chunked_copy.ref import gather_chunks_ref, scatter_chunks_ref
from repro_torch.kernels.chunked_copy.ops import gather, scatter
from repro_torch.kernels.chunked_copy.pipeline import (
    BATCH_CHUNKS,
    copy_slabs_pipelined,
    copy_slabs_sequential,
    host_to_pool,
    pool_to_host,
)
