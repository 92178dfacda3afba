// Paged decode attention for Hopper (sm_90a), written by hand: one query
// token per sequence over a KV cache cut into pages, f32 or bf16, GQA.
//
// Replaces src/repro/kernels/paged_attention/kernel.py:paged_attention and
// _paged_kernel (Pallas, TPU): grid (B, Hkv, NP) with the page table and
// the sequence lengths as scalar prefetch, each grid step DMAs one physical
// page, and the online softmax crosses the page dimension in VMEM scratch.
//
//   o[b, h] = softmax_s(q[b, h] . K[b, s, h/G] / sqrt(D)) V[b, s, h/G]
//   K[b, s] = k_pages[page_table[b, s / page], s % page], positions
//   s >= seq_lens[b] masked with -1e30; G = Hq / Hkv.
//
// Bound.  Decoding reads every live K/V byte once and does 4 flops per
// byte-pair at most: at MiniCPM-2B's shape (B=8, Hkv=36, D=64, 8 pages of
// 128 tokens, bf16) that is 2 * 8*36*1024*64 * 2 B = 75.5 MB, 22.5 us at
// 3.35 TB/s, against 0.04 GFLOP.  Memory bound by far: the design aims to
// read each K/V row once, in 16-byte vectors, and nothing else.
//
// Design.  One block per (kv head, sequence); it reads its own page ids
// from the page table in device memory, which takes the place of the TPU's
// scalar prefetch.  Four warps split the sequence's positions in chunks of
// 32 (one position per lane, a chunk may cross a page boundary); a lane
// loads its position's K row with 16-byte loads and scores it against the
// G query heads of this kv head, held in shared memory.  Each warp keeps
// its own online softmax (m, l, acc) per query head in f32 in shared
// memory, and the warps' states are merged at the end (m* = max m_w, the
// rest rescaled by exp(m_w - m*)).  V rows are read across lanes, each
// lane owning D/32 dims.  Pages wholly past seq_len are not read; a
// sequence with no live position (seq_len <= 0) reads every page, so the
// -1e30 fill gives the plain version's uniform average, never NaN.  Page
// ids may repeat; an id outside [0, P) reads the page that JAX's indexing
// reads in the reference: a negative id counts from the end, then every
// id is clamped into range.  Split-K across blocks (for few kv heads) and TMA
// page loads are later work.
//
// The launch goes on the caller's stream; the entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// q (shared memory, f32) . row (device memory), D elements, 16-byte loads.
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = __ldg(r4 + i);
    s = fmaf(q[4 * i], x.x, s);
    s = fmaf(q[4 * i + 1], x.y, s);
    s = fmaf(q[4 * i + 2], x.z, s);
    s = fmaf(q[4 * i + 3], x.w, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ float dot_row(const float* q,
                                         const __nv_bfloat16* row) {
  const uint4* r8 = reinterpret_cast<const uint4*>(row);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint4 u = __ldg(r8 + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      s = fmaf(q[8 * i + 2 * t], f.x, s);
      s = fmaf(q[8 * i + 2 * t + 1], f.y, s);
    }
  }
  return s;
}

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int32_t* page_table;
  const int32_t* seq_lens;
  void* o;
  int Hq, Hkv, P, page, NP;
  float scale;
};

inline size_t smem_bytes(int G, int D) {
  // Qs [G][D], Acc [NWARPS][G][D], Ms and Ls [NWARPS][G], Ps [NWARPS][G][32]
  return sizeof(float) *
         (size_t)(G * D + NWARPS * G * D + 2 * NWARPS * G + NWARPS * G * 32);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_fwd(const Params p) {
  constexpr int DPL = (D + 31) / 32;
  const int G = p.Hq / p.Hkv;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Acc = Qs + G * D;
  float* Ms = Acc + NWARPS * G * D;
  float* Ls = Ms + NWARPS * G;
  float* Ps = Ls + NWARPS * G;

  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int64_t q_base = ((int64_t)b * p.Hq + (int64_t)hkv * G) * D;
  const T* q = static_cast<const T*>(p.q) + q_base;
  for (int i = threadIdx.x; i < G * D; i += THREADS) Qs[i] = to_f32(q[i]);
  for (int i = threadIdx.x; i < NWARPS * G * D; i += THREADS) Acc[i] = 0.f;
  for (int i = threadIdx.x; i < NWARPS * G; i += THREADS) {
    Ms[i] = NEG_INF;
    Ls[i] = 0.f;
  }
  __syncthreads();

  const int seq_len = p.seq_lens[b];
  const int64_t cap = (int64_t)p.NP * p.page;
  const int64_t live = ((int64_t)seq_len + p.page - 1) / p.page * p.page;
  const int64_t n_pos = (seq_len <= 0 || live > cap) ? cap : live;
  const int64_t n_chunks = (n_pos + 31) / 32;
  const int32_t* table = p.page_table + (int64_t)b * p.NP;
  const T* kp = static_cast<const T*>(p.k_pages);
  const T* vp = static_cast<const T*>(p.v_pages);
  const int64_t tok_stride = (int64_t)p.Hkv * D;

  for (int64_t c = warp; c < n_chunks; c += NWARPS) {
    const int64_t pos = c * 32 + lane;
    const bool exists = pos < n_pos;
    int64_t off = 0;                   // element offset of this lane's row
    if (exists) {
      int pid = table[pos / p.page];
      if (pid < 0) pid += p.P;         // JAX's indexing: from the end,
      pid = min(max(pid, 0), p.P - 1); // then clamped
      off = ((int64_t)pid * p.page + pos % p.page) * tok_stride +
            (int64_t)hkv * D;
    }
    for (int g = 0; g < G; ++g) {
      float s = -INFINITY;             // a position past n_pos weighs 0
      if (exists) {
        const float dot = dot_row<D>(Qs + g * D, kp + off);
        s = pos < seq_len ? dot * p.scale : NEG_INF;
      }
      const int wg = warp * G + g;
      const float m_prev = Ms[wg];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float e = expf(s - m_new);
      const float alpha = expf(m_prev - m_new);
      const float esum = warp_sum(e);
      Ps[wg * 32 + lane] = e;
      float* acc = Acc + (int64_t)wg * D;
#pragma unroll
      for (int x = 0; x < DPL; ++x) {
        const int d = lane + 32 * x;
        if (d < D) acc[d] *= alpha;
      }
      __syncwarp();
      if (lane == 0) {
        Ms[wg] = m_new;
        Ls[wg] = Ls[wg] * alpha + esum;
      }
    }
    __syncwarp();
    const int n_here = n_pos - c * 32 < 32 ? (int)(n_pos - c * 32) : 32;
    for (int j = 0; j < n_here; ++j) {
      const int64_t oj = __shfl_sync(0xffffffffu, (long long)off, j);
      float vv[DPL];
#pragma unroll
      for (int x = 0; x < DPL; ++x) {
        const int d = lane + 32 * x;
        vv[x] = d < D ? to_f32(vp[oj + d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        const int wg = warp * G + g;
        const float pj = Ps[wg * 32 + j];
        float* acc = Acc + (int64_t)wg * D;
#pragma unroll
        for (int x = 0; x < DPL; ++x) {
          const int d = lane + 32 * x;
          if (d < D) acc[d] = fmaf(pj, vv[x], acc[d]);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  T* o = static_cast<T*>(p.o) + q_base;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D;
    const int d = i % D;
    float m_star = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) m_star = fmaxf(m_star, Ms[w * G + g]);
    float l_sum = 0.f, a_sum = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float sc = expf(Ms[w * G + g] - m_star);
      l_sum += Ls[w * G + g] * sc;
      a_sum += Acc[(int64_t)(w * G + g) * D + d] * sc;
    }
    store(o + i, a_sum / fmaxf(l_sum, 1e-30f));
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Hq / p.Hkv, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)p.Hkv, (unsigned)B);
  paged_fwd<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, D); k_pages, v_pages (P, page, Hkv, D); o like q; one dtype
// (is_bf16: bf16, else f32), contiguous, 16-byte aligned.  page_table
// (B, NP) and seq_lens (B,) int32 on the device.  D in {16, 32, 64, 128};
// Hq % Hkv == 0; B < 65536.
int pa_forward(const void* q, const void* k_pages, const void* v_pages,
               const int32_t* page_table, const int32_t* seq_lens, void* o,
               int B, int Hq, int Hkv, int D, int P, int page, int NP,
               int is_bf16, void* stream) {
  Params p{q, k_pages, v_pages, page_table, seq_lens, o, Hq, Hkv, P, page, NP,
           1.0f / sqrtf((float)D)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, B, D, st)
                 : dispatch<float>(p, B, D, st);
}

}  // extern "C"
