// Decode attention over the serving engine's contiguous KV cache, for Hopper
// (sm_90a), written by hand: one query token per sequence, the cache in the
// engine's layout (B, Hkv, S, D), f32 or bf16, GQA.
//
// Replaces no Pallas kernel: the JAX package computes single-token attention
// in plain jnp (src/repro/models/attention.py:decode_attention), which XLA
// fuses on the TPU.  The port's plain version upcast the whole padded cache
// to f32 every layer and step, then masked the positions past `pos` after
// reading them.  These kernels read the cache's own storage instead, in its
// stored dtype, once, over the live positions [lo, hi] only:
//
//   s[b, h, i] = q[b, h] . K[b, h/G, lo + i] / sqrt(D)         (f32)
//   p = softmax_i(s)  (outside the kernels, over the live scores only)
//   o[b, h]    = sum_i round(p[b, h, i]) V[b, h/G, lo + i]     (f32 sums)
//
// with round() the cache dtype's rounding (bf16, as the reference rounds the
// probabilities before its f32 value sum), o written in q's dtype.  That is
// the reference's arithmetic up to the order of summation.
//
// Bound.  A step reads each live K and V row once and does 4 flops per
// (query head, position, dim): at the decode cell's shape (B = 32, 36/36
// heads of 64, bf16) a live position costs 294,912 bytes a layer, 11.8 MB
// over 40 layers, ~3.5 us at 3.35 TB/s, against 0.3 MFLOP: bound by the
// bytes at every group size the models use (at G = 8, D = 128, 8 flops a
// byte).  The scores (3% of K's bytes at G = 1, D = 64) are written once
// and read twice more, by the softmax and the value pass.
//
// Design: split-K over spans of the live range, two kernels and a merge.
// - decode_scores and decode_values, grid (span, kv head x head group,
//   sequence), 128 threads.  A block takes one kv head of one sequence over
//   a span of `span` live positions (kernel.py's split_plan: whole tiles of
//   64, from the shapes, the live length and the card's resident blocks),
//   and GB of the kv head's query heads (1, 2, 4 or 8: the least power of
//   two that holds G, at most 8; a larger G takes more head groups, each
//   reading the span again).
// - Thread t owns 16-byte chunk c = t % LPR of a row (LPR = D / 8 in bf16,
//   D / 4 in f32) and rows r, r + RG, ... (r = t / LPR, RG = 128 / LPR).
//   Each thread issues UNROLL independent 16-byte loads (ld.global.nc)
//   before it uses any, so a block keeps 8 KB in flight and the loads
//   stream whole 128-byte lines with no shared memory and no barrier.
// - decode_scores keeps its slice of the GB query rows in registers, in
//   f32.  The LPR lanes of a row sum their partial dots by a butterfly that
//   halves the heads at each step; one lane per head writes the f32 score.
// - decode_values reads each row's GB probabilities (f32, L1-cached: the
//   LPR lanes of a row read the same word), rounds them to the cache dtype
//   and accumulates round(p) x V in f32 registers.  The row groups of a
//   warp sum by shuffles, the warps through shared memory in warp order.
//   With one span the block writes o itself in q's dtype; otherwise its
//   f32 partial goes to the workspace (B, Hq, n_spans, D) and decode_merge
//   (one thread per output element) sums the spans in span order.
// - Every sum runs in a fixed order: two calls give the same bits, and a
//   caller that wants the f32 sum (the sequence-sharded form, before its
//   all-reduce) gets the bits that the bf16 output is rounded from.
//
// The launches go on the caller's stream; the entry points return
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int UNROLL = 4;           // 16-byte loads a thread keeps in flight
constexpr int MAX_GB = 8;           // query heads a block, at most

// Thread t owns chunk t % LPR of rows t / LPR + RG * k.
template <typename T, int D>
struct Rows {
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int LPR = D / EPC;               // lanes a row
  static constexpr int RG = THREADS / LPR;          // rows a block step
  static constexpr int STEP = RG * UNROLL;          // rows an iteration
  static_assert(LPR >= 2 && LPR <= 32 && 32 % LPR == 0, "row layout");
};

struct Params {
  const void* q;        // scores: (B, Hq, D), bf16 when q_bf16, else f32
  const void* kv;       // K (scores) or V (values): (B, Hkv, S, D)
  const float* p;       // values: (B, Hq, n) probabilities
  float* scores;        // scores: (B, Hq, n)
  void* o;              // values: (B, Hq, D), bf16 when o_bf16, else f32
  float* ws;            // values: (B, Hq, n_spans, D), when n_spans > 1
  int Hq, Hkv, G, n_hg, S, lo, n, span, n_spans, D;
  int q_bf16, o_bf16;
  float scale;          // 1 / sqrt(D)
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

// bf16 element 2j is the low half of word j (little-endian)
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// p as the value sum takes it: rounded to the cache dtype
__device__ __forceinline__ float as_cache(float x, const float*) { return x; }
__device__ __forceinline__ float as_cache(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_out(const Params& p, int64_t i,
                                          float x) {
  if (p.o_bf16) {
    static_cast<__nv_bfloat16*>(p.o)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(p.o)[i] = x;
  }
}

// The lanes that differ in the bits below 2*O hold partial sums of the
// same N heads in v[0..N).  Each step halves the heads a lane keeps and
// adds its partner's partials of them: after the step at O = 1 the lane
// holds full sums of max(N / LPR, 1) heads, from head `head` on.
template <int GB, int N, int O>
__device__ __forceinline__ void butterfly(float (&v)[GB], int lane,
                                          int& head) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float send = up ? v[k] : v[k + N / 2];
        const float keep = up ? v[k + N / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) head += N / 2;
      butterfly<GB, N / 2, O / 2>(v, lane, head);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      butterfly<GB, 1, O / 2>(v, lane, head);
    }
  }
}

// What a block works on: live positions [s0, s1) of its span (counted from
// lo), kv head hkv of sequence b, query heads g0 .. g0 + n_g of that kv
// head; bh0 is the (b, first query head) row of q, the scores and o.
struct Block {
  int split, hkv, b, n_g, s0, s1;
  int64_t bh0;
};

template <int GB>
__device__ __forceinline__ Block block_of(const Params& p) {
  Block k;
  k.split = blockIdx.x;
  k.hkv = blockIdx.y / p.n_hg;
  const int g0 = (blockIdx.y % p.n_hg) * GB;
  k.b = blockIdx.z;
  k.n_g = min(GB, p.G - g0);
  k.bh0 = (int64_t)k.b * p.Hq + (int64_t)k.hkv * p.G + g0;
  k.s0 = k.split * p.span;
  k.s1 = min(k.s0 + p.span, p.n);
  return k;
}

// Row lo + i of this block's kv head, at this thread's chunk.
template <typename T, int D>
__device__ __forceinline__ const T* rows_of(const Params& p, const Block& k,
                                            int c) {
  return static_cast<const T*>(p.kv) +
         (((int64_t)k.b * p.Hkv + k.hkv) * p.S + p.lo) * D +
         c * Rows<T, D>::EPC;
}

// ------------------------------------------------------------- scores ---

template <typename T, int D, int GB>
__global__ void __launch_bounds__(THREADS) decode_scores(const Params p) {
  using L = Rows<T, D>;
  constexpr int EPC = L::EPC, LPR = L::LPR, RG = L::RG;
  constexpr int NV = GB > LPR ? GB / LPR : 1;     // heads a lane writes
  constexpr int WD = LPR > GB ? LPR / GB : 1;     // lanes that hold a head
  const Block k = block_of<GB>(p);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int c = t % LPR;
  const int r = t / LPR;

  float qr[GB][EPC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const int64_t at = (k.bh0 + g) * D + c * EPC;
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      float x = 0.f;
      if (g < k.n_g) {
        x = p.q_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(p.q)[at + e])
                     : static_cast<const float*>(p.q)[at + e];
      }
      qr[g][e] = x;
    }
  }
  const T* kb = rows_of<T, D>(p, k, c);
  float* out = p.scores + k.bh0 * p.n;
  // the loop bound is the block's, so every lane takes each shuffle
  for (int base = k.s0; base < k.s1; base += L::STEP) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + r + RG * u;
      raw[u] = i < k.s1 ? load16(kb + (int64_t)i * D) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float x[EPC];
      unpack(raw[u], x);
      float v[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; ++e) a = fmaf(qr[g][e], x[e], a);
        v[g] = a;
      }
      int head = 0;
      butterfly<GB, GB, LPR / 2>(v, lane, head);
      const int i = base + r + RG * u;
      if (i < k.s1 && c % WD == 0) {
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          if (head + e < k.n_g) out[(int64_t)(head + e) * p.n + i] =
              v[e] * p.scale;
        }
      }
    }
  }
}

// ------------------------------------------------------------- values ---

template <typename T, int D, int GB>
__global__ void __launch_bounds__(THREADS) decode_values(const Params p) {
  using L = Rows<T, D>;
  constexpr int EPC = L::EPC, LPR = L::LPR, RG = L::RG;
  __shared__ float red[NWARPS][GB][D];
  const Block k = block_of<GB>(p);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int c = t % LPR;
  const int r = t / LPR;

  float acc[GB][EPC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[g][e] = 0.f;
  }
  const T* vb = rows_of<T, D>(p, k, c);
  const float* pb = p.p + k.bh0 * p.n;
  for (int base = k.s0; base < k.s1; base += L::STEP) {
    uint4 raw[UNROLL];
    float pr[UNROLL][GB];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + r + RG * u;
      const bool live = i < k.s1;
      raw[u] = live ? load16(vb + (int64_t)i * D) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        pr[u][g] = live && g < k.n_g
            ? as_cache(__ldg(pb + (int64_t)g * p.n + i), vb) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float x[EPC];
      unpack(raw[u], x);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[g][e] = fmaf(pr[u][g], x[e], acc[g][e]);
      }
    }
  }
  // the warp's row groups, then the warps in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) red[warp][g][c * EPC + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = t; i < k.n_g * D; i += THREADS) {
    const int g = i / D;
    const int d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += red[w][g][d];
    const int64_t bh = k.bh0 + g;
    if (p.n_spans == 1) {
      store_out(p, bh * D + d, a);
    } else {
      p.ws[(bh * p.n_spans + k.split) * D + d] = a;
    }
  }
}

// o[i] = sum over the spans, in span order, of the partials.
__global__ void __launch_bounds__(256) decode_merge(const Params p,
                                                    int64_t n_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const float* w = p.ws + (i / p.D) * p.n_spans * p.D + i % p.D;
  float a = 0.f;
  for (int s = 0; s < p.n_spans; ++s) a += w[(int64_t)s * p.D];
  store_out(p, i, a);
}

// ------------------------------------------------------------- launch ---

template <typename T_, int D_, int GB_>
struct Inst {
  using T = T_;
  static constexpr int D = D_;
  static constexpr int GB = GB_;
};

template <typename T, int D, typename F>
int by_group(int GB, F f) {
  switch (GB) {
    case 1: return f(Inst<T, D, 1>{});
    case 2: return f(Inst<T, D, 2>{});
    case 4: return f(Inst<T, D, 4>{});
    case 8: return f(Inst<T, D, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(Inst<T, D, GB>) for the cache dtype (kv_bf16), D and GB.
template <typename F>
int instance(int kv_bf16, int D, int GB, F f) {
#define DA_CASE(d)                                                          \
  case d:                                                                   \
    return kv_bf16 ? by_group<__nv_bfloat16, d>(GB, f)                      \
                   : by_group<float, d>(GB, f);
  switch (D) {
    DA_CASE(16) DA_CASE(32) DA_CASE(64) DA_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DA_CASE
}

template <typename K>
int launch(K kernel, const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((unsigned)p.n_spans, (unsigned)(p.Hkv * p.n_hg),
                  (unsigned)B);
  kernel<<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

bool plan_ok(int B, int Hq, int Hkv, int GB, int S, int lo, int n, int span,
             int n_spans) {
  return B > 0 && Hkv > 0 && Hq % Hkv == 0 && GB >= 1 && GB <= MAX_GB &&
         lo >= 0 && n > 0 && (int64_t)lo + n <= S && span > 0 &&
         n_spans > 0 && (int64_t)(n_spans - 1) * span < n &&
         (int64_t)n_spans * span >= n;
}

template <typename K>
int describe(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = THREADS;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = blocks;
  return 0;
}

}  // namespace

extern "C" {

// q (B, Hq, D) in f32 or bf16 (q_bf16); k (B, Hkv, S, D) in f32 or bf16
// (kv_bf16); scores (B, Hq, n) f32; all contiguous on one device, k 16-byte
// aligned.  Writes the scores of live positions [lo, lo + n), the span plan
// (span, n_spans) covering them, GB query heads a block.  D in {16, 32, 64,
// 128}; Hq % Hkv == 0; B < 65536; Hkv * ceil(G / GB) < 65536.
int da_scores(const void* q, const void* k, float* scores, int B, int Hq,
              int Hkv, int D, int S, int lo, int n, int span, int n_spans,
              int GB, int q_bf16, int kv_bf16, float scale, void* stream) {
  if (!plan_ok(B, Hq, Hkv, GB, S, lo, n, span, n_spans)) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = Hq / Hkv;
  const Params p{q, k, nullptr, scores, nullptr, nullptr, Hq, Hkv, G,
                 (G + GB - 1) / GB, S, lo, n, span, n_spans, D, q_bf16, 0,
                 scale};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return instance(kv_bf16, D, GB, [&](auto inst) {
    using I = decltype(inst);
    return launch(decode_scores<typename I::T, I::D, I::GB>, p, B, st);
  });
}

// probs (B, Hq, n) f32; v (B, Hkv, S, D) in f32 or bf16 (kv_bf16); o
// (B, Hq, D) in f32 or bf16 (o_bf16); ws f32 (B, Hq, n_spans, D), unused
// when n_spans == 1.  o = sum over live positions [lo, lo + n) of the
// probabilities rounded to the cache dtype times V, summed in f32.
int da_values(const float* probs, const void* v, void* o, float* ws, int B,
              int Hq, int Hkv, int D, int S, int lo, int n, int span,
              int n_spans, int GB, int o_bf16, int kv_bf16, void* stream) {
  if (!plan_ok(B, Hq, Hkv, GB, S, lo, n, span, n_spans)) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = Hq / Hkv;
  const Params p{nullptr, v, probs, nullptr, o, ws, Hq, Hkv, G,
                 (G + GB - 1) / GB, S, lo, n, span, n_spans, D, 0, o_bf16,
                 0.f};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int err = instance(kv_bf16, D, GB, [&](auto inst) {
    using I = decltype(inst);
    return launch(decode_values<typename I::T, I::D, I::GB>, p, B, st);
  });
  if (err != 0 || n_spans == 1) return err;
  const int64_t n_out = (int64_t)B * Hq * D;
  decode_merge<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(p, n_out);
  return (int)cudaGetLastError();
}

// The instance of `which` (0: decode_scores, 1: decode_values) for (D,
// cache dtype, GB): out = threads, static shared memory, registers and
// local (spill) bytes a thread, resident blocks per SM.
int da_describe(int which, int D, int kv_bf16, int GB, int* out) {
  return instance(kv_bf16, D, GB, [&](auto inst) {
    using I = decltype(inst);
    return which == 0
        ? describe(decode_scores<typename I::T, I::D, I::GB>, out)
        : describe(decode_values<typename I::T, I::D, I::GB>, out);
  });
}

}  // extern "C"
