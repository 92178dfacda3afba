// Slab-row gather/scatter for the chunked-copy data plane, sm_90a.
//
// gather_chunks  replaces src/repro/kernels/chunked_copy/kernel.py:gather_chunks
//                (Pallas, one row DMA per grid step):  out[i] = src[ids[i]]
// scatter_chunks replaces src/repro/kernels/chunked_copy/kernel.py:scatter_chunks
//                (Pallas, a full N-row take-or-keep pass):  dst[ids[i]] = src[i],
//                written in place, touching only the M target rows.
//
// Bound.  Both kernels are pure copies: they read M rows and write M rows,
// 2*M*C bytes, and do no arithmetic.  The least time is therefore bytes over
// the card's HBM rate: 2 * 5 * 2 MiB = 21 MB for one trigger batch of 2 MB
// slabs, about 6.3 us at the H100 SXM's 3.35 TB/s (NVIDIA's data sheet).
// At that size a launch costs about as much as the copy, so the design
// aims only to keep every SM streaming.
//
// Tiling.  A trigger batch is 5 rows; one block per row would keep 5 of the
// 132 SMs busy.  The grid is (column tiles) x (rows): each block copies one
// tile of up to TILE_BYTES of one row, so a 5-row batch of 2 MiB rows is
// 5 * 32 = 160 blocks.  Each thread moves 16-byte vectors (uint4), neighbours
// on neighbouring addresses; a byte loop takes over when the row's byte count
// or a base pointer is not 16-byte aligned.
//
// Ids.  They come from the host (the slab rows of an object), are checked
// there for range and, for the scatter, uniqueness, and reach the kernel by
// value in the launch parameters, MAX_IDS at a time: no host-to-device copy
// and no allocation per launch.  Every launch goes on the caller's stream,
// and each entry point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_IDS = 512;             // 2 KB of ids per launch
constexpr int64_t TILE_BYTES = 64 * 1024;
constexpr int THREADS = 256;

struct Ids {
  int32_t v[MAX_IDS];
};

// One tile of one row: dst_row <- src_row, bytes [start, end).
template <bool VEC>
__device__ __forceinline__ void copy_tile(const uint8_t* __restrict__ s,
                                          uint8_t* __restrict__ d,
                                          int64_t start, int64_t end) {
  if (VEC) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const int64_t e4 = end >> 4;
#pragma unroll 4
    for (int64_t i = (start >> 4) + threadIdx.x; i < e4; i += THREADS) {
      d4[i] = __ldg(s4 + i);
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += THREADS) {
      d[i] = s[i];
    }
  }
}

// SCATTER=false: out[base + r] = src[ids[r]];  SCATTER=true: dst[ids[r]] = src[base + r].
template <bool VEC, bool SCATTER>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            const Ids ids, int base, int64_t row_bytes) {
  const int r = blockIdx.y;
  const int64_t id = ids.v[r];
  const int64_t srow = SCATTER ? base + r : id;
  const int64_t drow = SCATTER ? id : base + r;
  const int64_t start = blockIdx.x * TILE_BYTES;
  const int64_t end = start + TILE_BYTES < row_bytes ? start + TILE_BYTES : row_bytes;
  copy_tile<VEC>(src + srow * row_bytes, dst + drow * row_bytes, start, end);
}

template <bool SCATTER>
int launch_rows(const void* src, void* dst, const int32_t* ids_host, int m,
                int64_t row_bytes, void* stream) {
  const bool vec = (row_bytes % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  const unsigned tiles = (unsigned)((row_bytes + TILE_BYTES - 1) / TILE_BYTES);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  for (int base = 0; base < m; base += MAX_IDS) {
    const int n = m - base < MAX_IDS ? m - base : MAX_IDS;
    Ids ids;
    for (int i = 0; i < n; ++i) ids.v[i] = ids_host[base + i];
    dim3 grid(tiles, (unsigned)n);
    const uint8_t* s = static_cast<const uint8_t*>(src);
    uint8_t* d = static_cast<uint8_t*>(dst);
    if (vec) {
      rows_kernel<true, SCATTER><<<grid, THREADS, 0, st>>>(s, d, ids, base, row_bytes);
    } else {
      rows_kernel<false, SCATTER><<<grid, THREADS, 0, st>>>(s, d, ids, base, row_bytes);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (m, row_bytes) <- src rows ids_host[0..m).  m >= 1, ids in range.
int cc_gather_chunks(const void* src, void* out, const int32_t* ids_host,
                     int m, long long row_bytes, void* stream) {
  return launch_rows<false>(src, out, ids_host, m, (int64_t)row_bytes, stream);
}

// dst rows ids_host[0..m) <- src (m, row_bytes), in place.  Ids unique.
int cc_scatter_chunks(void* dst, const void* src, const int32_t* ids_host,
                      int m, long long row_bytes, void* stream) {
  return launch_rows<true>(src, dst, ids_host, m, (int64_t)row_bytes, stream);
}

}  // extern "C"
