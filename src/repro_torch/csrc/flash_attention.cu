// Prefill attention for Hopper (sm_90a), written by hand: f32 or bf16,
// causal and sliding-window masks, GQA, any sequence lengths.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention and
// _attn_kernel (Pallas, TPU): grid (B*Hq, Lq/128, Lkv/128) whose third,
// sequential dimension carries the online softmax (m, l, acc) in VMEM
// scratch from one kv block to the next.
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h/G, j] / sqrt(D)) v[b, h/G, j]
//   over keys j with  k_pos <= q_pos (causal)  and  k_pos > q_pos - window,
//   q_pos = q_offset + i, k_pos = kv_offset + j; G = Hq / Hkv.
//
// Bound.  At MiniCPM-2B's prefill (B=8, H=36, L=1024, D=64, causal) the
// function reads q, k, v and writes o: 4 * 8*36*1024*64 * 2 B = 151 MB in
// bf16, 45 us at 3.35 TB/s; it does 2 * 2 * B*H*L*L*D / 2 = 38.7 GFLOP,
// 39 us at the bf16 tensor-core peak (989 TFLOP/s).  So the bound is the
// bytes, only just.  This first kernel is simple on purpose: it runs on the
// CUDA cores in f32 (f32 inputs never drop to TF32: their tolerance is 2e-5),
// so it sits far above that bound.  Tensor cores (mma / wgmma on bf16
// tiles), TMA loads and a pipelined kv loop are later work.
//
// Design.  Blocks on Hopper run in no order and carry nothing from one to
// the next, so the TPU's sequential kv grid dimension becomes a loop inside
// the block.  One block per (b*Hq + h, tile of BQ query rows); 8 warps, each
// owning BQ/8 rows and their f32 (m, l, acc) in registers.  Per kv tile of
// BK keys the block stages K (rows padded to D+1 floats, so 32 lanes reading
// 32 rows hit 32 banks) and V in shared memory as f32; a lane scores BK/32
// keys of a row, the warp reduces the row's max and sum with shuffles, and
// each lane accumulates D/32 output dims.  Tiles that every row of the block
// masks (above the causal diagonal, before the window) are skipped: each
// row still sees at least one key, and the reference's alpha = exp(m_prev -
// m_new) = 0 then erases whatever a fully masked tile put in acc.  A block
// holding a row that sees no key at all keeps every tile, so that row gets
// the plain version's uniform average (every score -1e30) and never NaN.
// Keys past Lkv are absent, not masked: their weight is exactly 0.  Ragged
// edges of Lq and Lkv are masked in the kernel; there is no multiple-of-128
// requirement (that was the TPU's tiling).
//
// The launch goes on the caller's stream; the entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per kv tile
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;   // query rows per warp
constexpr int KPL = BK / 32;        // keys per lane in a tile

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Lq, Lkv;
  int causal, window, q_offset, kv_offset;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BK * (D + 1) + BK * D + BQ * D + NWARPS * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(const Params p) {
  constexpr int DPL = (D + 31) / 32;   // output dims per lane
  constexpr int KS = D + 1;            // padded K row stride
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][D+1]
  float* Vs = Ks + BK * KS;            // [BK][D]
  float* Qs = Vs + BK * D;             // [BQ][D]
  float* Ps = Qs + BQ * D;             // [NWARPS][BK]

  const int bh = blockIdx.x;           // b * Hq + hq
  const int b = bh / p.Hq;
  const int hkv = (bh % p.Hq) / (p.Hq / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, p.Lq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* q = static_cast<const T*>(p.q) + ((int64_t)bh * p.Lq + q0) * D;
  const int64_t kv_base = (int64_t)(b * p.Hkv + hkv) * p.Lkv * D;
  const T* k = static_cast<const T*>(p.k) + kv_base;
  const T* v = static_cast<const T*>(p.v) + kv_base;
  T* o = static_cast<T*>(p.o) + ((int64_t)bh * p.Lq + q0) * D;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    Qs[i] = i / D < nq ? to_f32(q[i]) : 0.f;
  }

  // Keys [j_lo, j_hi) hold every key that some row of the block sees.
  const int qp_first = p.q_offset + q0;
  const int qp_last = qp_first + nq - 1;
  int j_lo = 0, j_hi = p.Lkv;
  const bool blind_row =
      (p.causal && qp_first < p.kv_offset) ||
      (p.window && qp_last - p.window + 1 - p.kv_offset > p.Lkv - 1);
  if (!blind_row) {
    if (p.causal) j_hi = min(j_hi, qp_last - p.kv_offset + 1);
    if (p.window) j_lo = max(j_lo, qp_first - p.window + 1 - p.kv_offset);
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[r][x] = 0.f;
  }

  for (int k0 = (j_lo / BK) * BK; k0 < j_hi; k0 += BK) {
    const int nk = min(BK, p.Lkv - k0);
    __syncthreads();                   // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int j = i / D;
      const bool in = j < nk;
      Ks[j * KS + i % D] = in ? to_f32(k[(int64_t)k0 * D + i]) : 0.f;
      Vs[i] = in ? to_f32(v[(int64_t)k0 * D + i]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      const int qpos = qp_first + r;
      const float* qr = Qs + r * D;
      float s[KPL];
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[c] = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d];
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          s[c] = fmaf(qd, Ks[(lane + 32 * c) * KS + d], s[c]);
        }
      }
      float tmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int j = lane + 32 * c;
        const int kpos = p.kv_offset + k0 + j;
        bool seen = true;
        if (p.causal) seen = seen && kpos <= qpos;
        if (p.window) seen = seen && kpos > qpos - p.window;
        s[c] = j < nk ? (seen ? s[c] * p.scale : NEG_INF) : -INFINITY;
        tmax = fmaxf(tmax, s[c]);
      }
      const float m_new = fmaxf(m[rr], warp_max(tmax));
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float e = expf(s[c] - m_new);
        Ps[warp * BK + lane + 32 * c] = e;
        psum += e;
      }
      l[rr] = l[rr] * alpha + warp_sum(psum);
      m[rr] = m_new;
      __syncwarp();
#pragma unroll
      for (int x = 0; x < DPL; ++x) acc[rr][x] *= alpha;
      for (int j = 0; j < nk; ++j) {
        const float pj = Ps[warp * BK + j];
#pragma unroll
        for (int x = 0; x < DPL; ++x) {
          const int d = lane + 32 * x;
          if (d < D) acc[rr][x] = fmaf(pj, Vs[j * D + d], acc[rr][x]);
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    if (r < nq) {
      const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int x = 0; x < DPL; ++x) {
        const int d = lane + 32 * x;
        if (d < D) store(o + (int64_t)r * D + d, acc[rr][x] / den);
      }
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)(B * p.Hq), (unsigned)((p.Lq + BQ - 1) / BQ));
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(p);
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

// q (B, Hq, Lq, D), k and v (B, Hkv, Lkv, D), o like q; contiguous, one
// dtype (is_bf16: bf16, else f32).  D in {16, 32, 64, 128}; Hq % Hkv == 0;
// Lq, Lkv >= 1; B * Hq < 2^31 and ceil(Lq / 64) < 65536.
int fa_forward(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Lq, int Lkv, int D, int is_bf16,
               int causal, int window, int q_offset, int kv_offset,
               void* stream) {
  Params p{q, k, v, o, Hq, Hkv, Lq, Lkv, causal, window, q_offset, kv_offset,
           1.0f / sqrtf((float)D)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, B, D, st)
                 : dispatch<float>(p, B, D, st);
}

}  // extern "C"
