// The gradient of prefill attention for Hopper (sm_90a), written by hand:
// bf16 on the tensor cores, f32 on the CUDA cores; causal and
// sliding-window masks, GQA, query and key position offsets, any sequence
// lengths, rows that see no key.
//
// Replaces the gradient of src/repro/models/attention.py:blockwise_attention
// (:92), which XLA derives from its jnp online-softmax scan when
// training/train_step.py takes jax.value_and_grad: the JAX package has no
// Pallas backward.  For the output gradient dO of
//
//   O = softmax(Q K^T * scale) V       (the mask as in flash_attention.cu)
//
// it computes, with P the softmax and delta = rowsum(P o dP):
//
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
//
// P rebuilt from the forward's per-row statistics (stats = log-sum-exp of
// the scaled, masked scores; NEG_INF marks a row that sees no key).  Such
// a row averages every value uniformly in the forward (every score is the
// mask value), so its P is 1/Lkv over all Lkv keys and its dS is 0: the
// mask cuts the scores' gradient.  A row that sees one key has P = 1
// whatever its score, so its dS is 0 too, exactly, where dP - delta would
// leave roundoff.  Rows and keys past Lq and Lkv are absent.
//
// Why delta = rowsum(P o dP) and not FlashAttention-2's rowsum(dO o O):
// equal in exact arithmetic, but the bf16 forward rounds P to bf16 in
// O += P V, and that error in O reaches dS wherever a row's gradient
// cancels: on an H100, 6 of the card tests' 80 bf16 cases then missed the
// limit against autograd (each row within 2^-6 of its largest value), by
// up to 0.154.  From P and dP in f32, as autograd takes it, they pass.  It
// costs the dq kernel a first pass over its key tiles (S and dP again:
// nine products, not seven) and leaves O out of the backward's inputs.
//
// Bound.  MiniCPM-2B's training microbatch (B=2, H=36, L=4096, D=64,
// causal, bf16) needs five products over the causal pairs, 2.5 x the
// forward's 154.7 GFLOP: 387 GFLOP, 0.391 ms at the bf16 tensor-core peak
// (989 TFLOP/s), against ~265 MB of q, k, v, dO, the statistics, dq, dk
// and dv (0.08 ms at 3.35 TB/s): bound by the operations.  DBRX's (48/8 heads of 128) is
// 1031 GFLOP, 1.04 ms.  The design takes S and dP three times (nine
// products, not five), the price of exact delta and of having no atomics.
//
// Design: FlashAttention-2's deterministic backward in two kernels on one
// stream; nothing is summed with atomics, so two runs are bit-equal.
// (1) dq: one block per (b*Hq + h, 64 query rows), heaviest causal tiles
//     first.  It walks the key tiles its rows see by the forward's
//     key_range rule twice: first S = Q K^T, P and dP = dO V^T for delta,
//     which it keeps and writes to an f32 scratch; then S, P, dP, dS and
//     dQ += dS K.
// (2) dkdv: one block per (b*Hkv + g, 64 keys), launched after (1), which
//     it reads delta from.  It walks the G query heads of its kv head and,
//     for each, the query tiles that see its keys: the inverse of the same
//     rule (a query tile is visited iff its key_range holds this key tile;
//     a tile with a row that sees nothing holds every key tile), so both
//     kernels visit one set of (query tile, key tile) pairs.  Per pair:
//     S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
//     The GQA sum over the G heads stays in the block's registers.
// bf16: four warps, each owning 16 rows (query rows in dq, keys in dkdv);
// every product is mma.sync.m16n8k16 with f32 accumulators, operands
// from shared memory by ldmatrix (.trans for K in dQ, for dO in dV and Q
// in dK), P and dS passed from the accumulators as A fragments in
// registers (rounded to bf16 there).  The tiles streamed through the loop
// (K and V in dq, Q and dO in dkdv) sit in a 2-stage ring of 16-byte
// cp.async copies, rows padded by 16 bytes so that ldmatrix reads no bank
// twice.  dkdv takes each 64-query tile as two chunks of 32 columns, so
// that S^T and dP^T fit beside the dK and dV accumulators: at D=128
// without spilling, at D=64 in 168 registers, three blocks an SM (whole
// 64-column chunks took 244 and two blocks, and were slower).  Only tiles that cross the causal diagonal, the window
// edge, a row that sees nothing or the end of Lkv apply a mask.  (wgmma
// and TMA are later work: the forward's mma.sync design was 1.3-1.4x off
// its wgmma one.)
// f32: on the CUDA cores in full f32 (training in f32 is held to 1e-5), as
// flash_f32: 8 warps, each owning 8 rows; a lane scores two columns of a
// row against the tile in shared memory (rows padded to D+1 floats), the
// warp shares P or dS through shared memory and each lane accumulates D/32
// outputs.
//
// The launches go on the caller's stream; the entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;              // query rows per tile, every kernel
constexpr int BK = 64;              // keys per tile, every kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* stats;               // (B, Hq, Lq) from the forward
  float* delta;                     // (B, Hq, Lq) scratch
  void* dq;
  void* dk;
  void* dv;
  int Hq, Hkv, Lq, Lkv;
  int causal, window, q_offset, kv_offset;
  float scale;
};

__device__ __forceinline__ bool no_key(float lse) { return lse < 0.5f * NEG_INF; }

// The forward's rule (flash_attention.cu): keys [lo, hi) hold every key
// that some row in [qp_first, qp_last] sees; `blind` says that some row of
// them sees none, and then the range is every key.
struct KeyRange {
  int lo, hi;
  bool blind;
};

__device__ __forceinline__ KeyRange key_range(const Params& p, int qp_first,
                                              int qp_last) {
  KeyRange r{0, p.Lkv, false};
  r.blind = (p.causal && qp_first < p.kv_offset) ||
            (p.window && qp_last - p.window + 1 - p.kv_offset > p.Lkv - 1);
  if (!r.blind) {
    if (p.causal) r.hi = min(r.hi, qp_last - p.kv_offset + 1);
    if (p.window) r.lo = max(r.lo, qp_first - p.window + 1 - p.kv_offset);
  }
  return r;
}

// The key range of query tile qt.
__device__ __forceinline__ KeyRange tile_keys(const Params& p, int qt) {
  const int q0 = qt * BQ;
  const int qp = p.q_offset + q0;
  return key_range(p, qp, qp + min(BQ, p.Lq - q0) - 1);
}

// Whether query tile qt visits key tile kt, in both kernels.
__device__ __forceinline__ bool visits(const Params& p, int qt, int kt) {
  const KeyRange r = tile_keys(p, qt);
  return r.lo / BK <= kt && kt < (r.hi + BK - 1) / BK;
}

// Whether the scores of the row at position qpos carry no gradient: it
// sees one key (P = 1) or none (the uniform average).
__device__ __forceinline__ bool scores_free(const Params& p, int qpos) {
  int lo = 0, hi = p.Lkv;
  if (p.causal) hi = min(hi, qpos - p.kv_offset + 1);
  if (p.window) lo = max(lo, qpos - p.window + 1 - p.kv_offset);
  return hi - lo <= 1;
}

__device__ __forceinline__ bool seen(const Params& p, int qpos, int j) {
  const int kpos = p.kv_offset + j;
  return j < p.Lkv && (!p.causal || kpos <= qpos) &&
         (!p.window || kpos > qpos - p.window);
}

// ------------------------------------------------- f32: the CUDA cores ---
namespace f32k {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int ROWS = 64 / NWARPS;   // rows a warp owns
constexpr int CPL = 64 / 32;        // columns a lane scores

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(2 * BK * (D + 1) + 2 * BQ * D +
                                  NWARPS * BK + 2 * BQ);
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (size_t)(2 * BK * D + 2 * BQ * (D + 1) +
                                  2 * NWARPS * BQ + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_f32(const Params p) {
  constexpr int DPL = (D + 31) / 32;   // output dims per lane
  constexpr int KS = D + 1;            // padded K and V row stride
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][D+1]
  float* Vs = Ks + BK * KS;            // [BK][D+1]
  float* Qs = Vs + BK * KS;            // [BQ][D]
  float* dOs = Qs + BQ * D;            // [BQ][D]
  float* Ds = dOs + BQ * D;            // [NWARPS][BK]: a row's dS
  float* lse_s = Ds + NWARPS * BK;     // [BQ]
  float* dl_s = lse_s + BQ;            // [BQ]

  const int bh = blockIdx.x;           // b * Hq + hq
  const int b = bh / p.Hq;
  const int hkv = (bh % p.Hq) / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int nq = min(BQ, p.Lq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int64_t row0 = (int64_t)bh * p.Lq + q0;
  const float* q = static_cast<const float*>(p.q) + row0 * D;
  const float* dout = static_cast<const float*>(p.dout) + row0 * D;
  const int64_t kv_base = (int64_t)(b * p.Hkv + hkv) * p.Lkv * D;
  const float* k = static_cast<const float*>(p.k) + kv_base;
  const float* v = static_cast<const float*>(p.v) + kv_base;
  float* dq = static_cast<float*>(p.dq) + row0 * D;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const bool in = i / D < nq;
    Qs[i] = in ? q[i] : 0.f;
    dOs[i] = in ? dout[i] : 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    lse_s[r] = r < nq ? p.stats[row0 + r] : INFINITY;   // past Lq: P = 0
    dl_s[r] = 0.f;
  }

  const int qp_first = p.q_offset + q0;
  const KeyRange keys = key_range(p, qp_first, qp_first + nq - 1);

  float acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[r][x] = 0.f;
  }

  // pass 0: delta = rowsum(P o dP); pass 1: dS and dQ
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = (keys.lo / BK) * BK; k0 < keys.hi; k0 += BK) {
      const int nk = min(BK, p.Lkv - k0);
      __syncthreads();                 // the previous tile is consumed
      for (int i = threadIdx.x; i < BK * D; i += THREADS) {
        const int j = i / D;
        const bool in = j < nk;
        Ks[j * KS + i % D] = in ? k[(int64_t)k0 * D + i] : 0.f;
        Vs[j * KS + i % D] = in ? v[(int64_t)k0 * D + i] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const int r = warp * ROWS + rr;
        if (r >= nq) continue;         // warp-uniform
        const int qpos = qp_first + r;
        const float lse = lse_s[r];
        float s[CPL], dp[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          const float qd = Qs[r * D + d], od = dOs[r * D + d];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            s[c] = fmaf(qd, Ks[(lane + 32 * c) * KS + d], s[c]);
            dp[c] = fmaf(od, Vs[(lane + 32 * c) * KS + d], dp[c]);
          }
        }
        float pr[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          pr[c] = seen(p, qpos, k0 + lane + 32 * c)
                      ? expf(s[c] * p.scale - lse) : 0.f;
        }
        if (pass == 0) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) part = fmaf(pr[c], dp[c], part);
          part = warp_sum(part);
          if (lane == 0) dl_s[r] += part;    // this warp's row alone
          continue;
        }
        const float dl = dl_s[r];
        const bool keep = !scores_free(p, qpos);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          Ds[warp * BK + lane + 32 * c] = keep ? pr[c] * (dp[c] - dl) : 0.f;
        }
        __syncwarp();
        for (int j = 0; j < nk; ++j) {
          const float dsj = Ds[warp * BK + j];
#pragma unroll
          for (int x = 0; x < DPL; ++x) {
            const int d = lane + 32 * x;
            if (d < D) acc[rr][x] = fmaf(dsj, Ks[j * KS + d], acc[rr][x]);
          }
        }
        __syncwarp();
      }
    }
    if (pass == 0) {
      __syncwarp();
      for (int rr = 0; rr < ROWS; ++rr) {
        const int r = warp * ROWS + rr;
        if (lane == 0 && r < nq) p.delta[row0 + r] = dl_s[r];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    if (r < nq) {
#pragma unroll
      for (int x = 0; x < DPL; ++x) {
        const int d = lane + 32 * x;
        if (d < D) dq[(int64_t)r * D + d] = acc[rr][x] * p.scale;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_f32(const Params p) {
  constexpr int DPL = (D + 31) / 32;
  constexpr int QS = D + 1;            // padded Q and dO row stride
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][D]
  float* Vs = Ks + BK * D;             // [BK][D]
  float* Qs = Vs + BK * D;             // [BQ][D+1]
  float* dOs = Qs + BQ * QS;           // [BQ][D+1]
  float* Ps = dOs + BQ * QS;           // [NWARPS][BQ]: a key's P^T
  float* Ds = Ps + NWARPS * BQ;        // [NWARPS][BQ]: a key's dS^T
  float* lse_s = Ds + NWARPS * BQ;     // [BQ]
  float* dl_s = lse_s + BQ;            // [BQ]
  float* keep_s = dl_s + BQ;           // [BQ]: 0 where dS is 0

  const int bkv = blockIdx.x;          // b * Hkv + hkv
  const int b = bkv / p.Hkv;
  const int hkv = bkv % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int kt = blockIdx.y;           // the first keys see the most rows
  const int k0 = kt * BK;
  const int nk = min(BK, p.Lkv - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nqt = (p.Lq + BQ - 1) / BQ;
  const float inv_lkv = 1.f / (float)p.Lkv;

  const int64_t kv_off = ((int64_t)bkv * p.Lkv + k0) * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;
  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const bool in = i / D < nk;
    Ks[i] = in ? k[i] : 0.f;
    Vs[i] = in ? v[i] : 0.f;
  }

  float dka[ROWS][DPL], dva[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int x = 0; x < DPL; ++x) dka[r][x] = dva[r][x] = 0.f;
  }

  for (int h = 0; h < G; ++h) {
    const int bh = b * p.Hq + hkv * G + h;
    for (int qt = 0; qt < nqt; ++qt) {
      if (!visits(p, qt, kt)) continue;   // block-uniform
      const int q0 = qt * BQ;
      const int nq = min(BQ, p.Lq - q0);
      const int qp_first = p.q_offset + q0;
      const int64_t row0 = (int64_t)bh * p.Lq + q0;
      const float* q = static_cast<const float*>(p.q) + row0 * D;
      const float* dout = static_cast<const float*>(p.dout) + row0 * D;
      __syncthreads();                 // the previous tile is consumed
      for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
        const int r = i / D;
        const bool in = r < nq;
        Qs[r * QS + i % D] = in ? q[i] : 0.f;
        dOs[r * QS + i % D] = in ? dout[i] : 0.f;
      }
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        lse_s[r] = r < nq ? p.stats[row0 + r] : INFINITY;
        dl_s[r] = r < nq ? p.delta[row0 + r] : 0.f;
        keep_s[r] = r < nq && !scores_free(p, qp_first + r) ? 1.f : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const int jl = warp * ROWS + rr;   // the key in the tile
        if (jl >= nk) continue;            // warp-uniform
        float s[CPL], dp[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          const float kd = Ks[jl * D + d], vd = Vs[jl * D + d];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            s[c] = fmaf(kd, Qs[(lane + 32 * c) * QS + d], s[c]);
            dp[c] = fmaf(vd, dOs[(lane + 32 * c) * QS + d], dp[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int i = lane + 32 * c;
          const float lse = lse_s[i];
          float pr, ds;
          if (no_key(lse)) {               // the uniform average
            pr = inv_lkv;
            ds = 0.f;
          } else {                         // rows past Lq: lse = +inf
            pr = seen(p, qp_first + i, k0 + jl) ? expf(s[c] * p.scale - lse)
                                                : 0.f;
            ds = keep_s[i] != 0.f ? pr * (dp[c] - dl_s[i]) : 0.f;
          }
          Ps[warp * BQ + i] = pr;
          Ds[warp * BQ + i] = ds;
        }
        __syncwarp();
        for (int i = 0; i < nq; ++i) {
          const float pi = Ps[warp * BQ + i], dsi = Ds[warp * BQ + i];
#pragma unroll
          for (int x = 0; x < DPL; ++x) {
            const int d = lane + 32 * x;
            if (d < D) {
              dva[rr][x] = fmaf(pi, dOs[i * QS + d], dva[rr][x]);
              dka[rr][x] = fmaf(dsi, Qs[i * QS + d], dka[rr][x]);
            }
          }
        }
        __syncwarp();
      }
    }
  }

  float* dk = static_cast<float*>(p.dk) + kv_off;
  float* dv = static_cast<float*>(p.dv) + kv_off;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int jl = warp * ROWS + rr;
    if (jl < nk) {
#pragma unroll
      for (int x = 0; x < DPL; ++x) {
        const int d = lane + 32 * x;
        if (d < D) {
          dk[(int64_t)jl * D + d] = dka[rr][x] * p.scale;
          dv[(int64_t)jl * D + d] = dva[rr][x];
        }
      }
    }
  }
}

}  // namespace f32k

// ---------------------------------------------- bf16: the tensor cores ---
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;               // warps per block, 16 rows each
constexpr int THREADS = NW * 32;

// A row of a tile in shared memory: D bf16 values and 16 bytes of padding,
// so that the 8 rows one ldmatrix phase reads fall in 8 different groups
// of 4 banks.
template <int D>
__host__ __device__ constexpr int stride() { return D + 8; }

// dq: Q and dO tiles, then a 2-stage ring of K and V tiles.
template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * stride<D>();
}

// dkdv: K and V tiles, then a 2-stage ring of Q and dO tiles and of the
// rows' lse, delta and keep (0 where dS is 0).
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (size_t)(2 * BK + 4 * BQ) * stride<D>() +
         sizeof(float) * 6 * BQ;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !in.
__device__ __forceinline__ void cp_async16(const void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.  Without .trans lane l receives, of each matrix, row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1; with .trans, column l / 4, rows
// 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)) : "memory");
}

// d (16 x 8, f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).  With
// g = lane / 4 and t = lane % 4: d[0..1] row g, columns 2t, 2t+1; d[2..3]
// row g+8; a[0..3] rows g, g+8, g, g+8 at columns 2t, 2t, 8+2t, 8+2t (and
// +1); b[0..1] rows 2t, 2t+1 and 8+2t, 9+2t of column g.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of k-step kt from accumulators of 8-column blocks 2kt
// and 2kt+1 (the S-to-P identity of the forward).
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], float (&c)[NT][4],
                                     int kt) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float* e = &c[2 * kt + (x >> 1)][2 * (x & 1)];
    a[x] = pack_bf16(e[0], e[1]);
  }
}

// acc (16 x D) += A (16 x 16k, fragments a[KT]) * X[rows r0 .., all D]
// with X a [row][dim] tile in shared memory read transposed (rows are the
// product's k dimension).
template <int D, int KT>
__device__ __forceinline__ void mma_a_xt(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[KT][4],
                                         const bf16* X, int r0, int lane) {
  constexpr int S = stride<D>();
  const int mi = lane >> 3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, X + (r0 + kt * 16 + (mi & 1) * 8 + (lane & 7)) * S +
                       nd * 8 + (mi >> 1) * 8);
      mma(acc[nd], a[kt], b[0], b[1]);
      mma(acc[nd + 1], a[kt], b[2], b[3]);
    }
  }
}

// s (16 x 8NT) = A1 B^T and dp = A2 C^T, A1 and A2 the 16 rows from w0 of
// [row][dim] tiles, B and C the 8NT rows from c0 of [row][dim] tiles: the
// two score-like products of a step, which share their B-side addresses.
template <int D, int NT>
__device__ __forceinline__ void two_scores(float (&s)[NT][4],
                                           float (&dp)[NT][4], const bf16* A1,
                                           const bf16* A2, int w0,
                                           const bf16* B, const bf16* C,
                                           int c0, int lane) {
  constexpr int S = stride<D>();
  const int mi = lane >> 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a1[4], a2[4];
    const int ao = (w0 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(a1, A1 + ao);
    ldsm_x4(a2, A2 + ao);
#pragma unroll
    for (int nb = 0; nb < NT; nb += 2) {
      uint32_t b[4], c[4];
      const int bo = (c0 + nb * 8 + (mi >> 1) * 8 + (lane & 7)) * S +
                     kk * 16 + (mi & 1) * 8;
      ldsm_x4(b, B + bo);
      ldsm_x4(c, C + bo);
      mma(s[nb], a1, b[0], b[1]);
      mma(s[nb + 1], a1, b[2], b[3]);
      mma(dp[nb], a2, c[0], c[1]);
      mma(dp[nb + 1], a2, c[2], c[3]);
    }
  }
}

// rows [0, n) of a [row][D] global tile into a [row][stride] shared tile,
// zero-filled past n.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int n,
                                          int tid) {
  constexpr int CPR = D / 8;           // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < (ROWS * CPR + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (ROWS * CPR % THREADS && c >= ROWS * CPR) break;
    const int row = c / CPR, col = (c % CPR) * 8;
    const bool in = row < n;
    cp_async16(dst + row * stride<D>() + col,
               src + (int64_t)(in ? row : 0) * D + col, in);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_bf16(const Params p) {
  constexpr int S = stride<D>();
  constexpr int NT = BK / 8;           // 8-key column blocks of S and dP
  constexpr int KT = BK / 16;          // k-steps of dQ += dS K
  constexpr int ND = D / 8;            // 8-dim column blocks of dQ
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);   // [BQ][S]
  bf16* dOs = Qs + BQ * S;                       // [BQ][S]
  bf16* Ks = dOs + BQ * S;                       // [2][BK][S]
  bf16* Vs = Ks + 2 * BK * S;                    // [2][BK][S]

  const int bh = blockIdx.x;           // b * Hq + hq
  const int b = bh / p.Hq;
  const int hkv = (bh % p.Hq) / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int nq = min(BQ, p.Lq - q0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int64_t row0 = (int64_t)bh * p.Lq + q0;
  const bf16* q = static_cast<const bf16*>(p.q) + row0 * D;
  const bf16* dout = static_cast<const bf16*>(p.dout) + row0 * D;
  const int64_t kv_base = (int64_t)(b * p.Hkv + hkv) * p.Lkv * D;
  const bf16* k = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* v = static_cast<const bf16*>(p.v) + kv_base;
  bf16* dq = static_cast<bf16*>(p.dq) + row0 * D;

  const int qp_first = p.q_offset + q0;
  const KeyRange keys = key_range(p, qp_first, qp_first + nq - 1);
  const int t_lo = keys.lo / BK;
  const int n_tiles = (keys.hi + BK - 1) / BK - t_lo;

  // the key tiles twice: items [0, n_tiles) take delta, the rest dS, dQ
  auto load_kv = [&](int item, int buf) {
    const int k0 = (t_lo + item % n_tiles) * BK;
    load_tile<D, BK>(Ks + buf * BK * S, k + (int64_t)k0 * D, p.Lkv - k0, tid);
    load_tile<D, BK>(Vs + buf * BK * S, v + (int64_t)k0 * D, p.Lkv - k0, tid);
  };
  load_tile<D, BQ>(Qs, q, nq, tid);
  load_tile<D, BQ>(dOs, dout, nq, tid);
  if (n_tiles > 0) load_kv(0, 0);
  cp_commit();

  const int w0 = warp * 16;            // the warp's first row in the block
  const int wq_first = qp_first + w0;
  const int wq_last = wq_first + 15;
  const float scale_log2 = p.scale * LOG2E;
  // this thread's rows g and g+8: lse in the log2 domain (+inf past Lq:
  // P = 0), whether their scores carry gradient, delta
  float lse[2], dl[2] = {0.f, 0.f};
  bool keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    lse[r] = INFINITY;
    if (row < nq) {
      const float st = p.stats[row0 + row];
      lse[r] = no_key(st) ? NEG_INF : st * LOG2E;
    }
    keep[r] = row < nq && !scores_free(p, wq_first + g + 8 * r);
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int it = 0; it < 2 * n_tiles; ++it) {
    cp_wait_all();                     // item it has landed ...
    __syncthreads();                   // ... for every thread, and item
                                       // it-1 is consumed: refill its buffer
    if (it + 1 < 2 * n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_commit();

    const int k0 = (t_lo + it % n_tiles) * BK;
    const bf16* Kt = Ks + (it & 1) * BK * S;
    const bf16* Vt = Vs + (it & 1) * BK * S;
    float s[NT][4], dp[NT][4];
    two_scores<D, NT>(s, dp, Qs, dOs, w0, Kt, Vt, 0, lane);

    // P = exp2(S scale log2 e - lse) on the keys a row sees; a row that
    // sees no key has none in view
    const bool masked =
        k0 + BK > p.Lkv ||
        (p.causal && p.kv_offset + k0 + BK - 1 > wq_first) ||
        (p.window && p.kv_offset + k0 <= wq_last - p.window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = exp2_approx(s[n][e] * scale_log2 - lse[r]);
        if (masked && !seen(p, wq_first + g + 8 * r, k0 + n * 8 + 2 * t4 + (e & 1))) {
          pr = 0.f;
        }
        s[n][e] = pr;
      }
    }
    if (it < n_tiles) {                // delta += rowsum(P o dP)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dl[e >> 1] = fmaf(s[n][e], dp[n][e], dl[e >> 1]);
      }
      if (it == n_tiles - 1) {         // the row's four lanes hold its sum
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dl[r] = quad_sum(dl[r]);
          const int row = w0 + g + 8 * r;
          if (t4 == 0 && row < nq) p.delta[row0 + row] = dl[r];
        }
      }
      continue;
    }
    // dS = P o (dP - delta), 0 in a row whose scores carry no gradient
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = keep[r] ? s[n][e] * (dp[n][e] - dl[r]) : 0.f;
      }
    }
    uint32_t dsa[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) to_a<NT>(dsa[kt], s, kt);
    mma_a_xt<D, KT>(acc, dsa, Kt, 0, lane);
  }
  cp_wait_all();

  // dQ * scale, rounded to bf16, stored a row's 4 bytes per lane
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < nq) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(dq + (int64_t)row * D + n * 8 + 2 * t4) =
            pack_bf16(acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_bf16(const Params p) {
  constexpr int S = stride<D>();
  constexpr int QC = 32;                  // query columns a chunk of S^T
  constexpr int NT = QC / 8;              // 8-query column blocks
  constexpr int KT = QC / 16;             // k-steps of dV and dK
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);   // [BK][S]
  bf16* Vs = Ks + BK * S;                        // [BK][S]
  bf16* Qs = Vs + BK * S;                        // [2][BQ][S]
  bf16* dOs = Qs + 2 * BQ * S;                   // [2][BQ][S]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * S);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                               // [2][BQ]
  float* keep_s = dl_s + 2 * BQ;                              // [2][BQ]

  const int bkv = blockIdx.x;          // b * Hkv + hkv
  const int b = bkv / p.Hkv;
  const int hkv = bkv % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int kt = blockIdx.y;           // the first keys see the most rows
  const int k0 = kt * BK;
  const int nk = min(BK, p.Lkv - k0);
  const int nqt = (p.Lq + BQ - 1) / BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = warp * 16;            // the warp's first key in the block
  const float scale_log2 = p.scale * LOG2E;
  const float inv_lkv = 1.f / (float)p.Lkv;

  const int64_t kv_off = ((int64_t)bkv * p.Lkv + k0) * D;
  load_tile<D, BK>(Ks, static_cast<const bf16*>(p.k) + kv_off, nk, tid);
  load_tile<D, BK>(Vs, static_cast<const bf16*>(p.v) + kv_off, nk, tid);
  cp_commit();

  // the (head, query tile) items, heads outermost; every head visits the
  // same tiles
  auto next_tile = [&](int qt) {
    while (qt < nqt && !visits(p, qt, kt)) ++qt;
    return qt;
  };
  auto load_q = [&](int h, int qt, int buf) {
    const int q0 = qt * BQ;
    const int nq = min(BQ, p.Lq - q0);
    const int64_t row0 = (int64_t)(b * p.Hq + hkv * G + h) * p.Lq + q0;
    load_tile<D, BQ>(Qs + buf * BQ * S, static_cast<const bf16*>(p.q) + row0 * D,
                     nq, tid);
    load_tile<D, BQ>(dOs + buf * BQ * S,
                     static_cast<const bf16*>(p.dout) + row0 * D, nq, tid);
    for (int r = tid; r < BQ; r += THREADS) {
      float lse = INFINITY, dl = 0.f, keep = 0.f;  // rows past Lq weigh nothing
      if (r < nq) {
        const float st = p.stats[row0 + r];
        lse = no_key(st) ? NEG_INF : st * LOG2E;
        dl = p.delta[row0 + r];
        keep = scores_free(p, p.q_offset + q0 + r) ? 0.f : 1.f;
      }
      lse_s[buf * BQ + r] = lse;
      dl_s[buf * BQ + r] = dl;
      keep_s[buf * BQ + r] = keep;
    }
  };

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }

  const int first = next_tile(0);
  int h = 0, qt = first;
  if (first < nqt) load_q(0, first, 0);
  cp_commit();
  for (int it = 0; first < nqt && h < G; ++it) {
    int h1 = h, qt1 = next_tile(qt + 1);
    if (qt1 >= nqt) {
      ++h1;
      qt1 = first;
    }
    cp_wait_all();                     // item it has landed ...
    __syncthreads();                   // ... for every thread, and item
                                       // it-1 is consumed: refill its buffer
    if (h1 < G) load_q(h1, qt1, (it + 1) & 1);
    cp_commit();

    const int buf = it & 1;
    const bf16* Qt = Qs + buf * BQ * S;
    const bf16* dOt = dOs + buf * BQ * S;
    const float* lse_t = lse_s + buf * BQ;
    const float* dl_t = dl_s + buf * BQ;
    const float* keep_t = keep_s + buf * BQ;
    const int q0 = qt * BQ;
    const int qp_first = p.q_offset + q0;
    const KeyRange kr = tile_keys(p, qt);
    // every (query, key) pair of the tile is seen unless one of these holds
    const bool masked =
        kr.blind || k0 + BK > p.Lkv ||
        (p.causal && p.kv_offset + k0 + BK - 1 > qp_first) ||
        (p.window && p.kv_offset + k0 <= qp_first + BQ - 1 - p.window);

#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += QC) {
      float st[NT][4], dpt[NT][4];
      two_scores<D, NT>(st, dpt, Ks, Vs, w0, Qt, dOt, c0, lane);
      // P^T and dS^T: rows are keys, columns queries
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c0 + n * 8 + 2 * t4 + (e & 1);   // query in the tile
          const float lse = lse_t[i];
          float pr = exp2_approx(st[n][e] * scale_log2 - lse);
          float ds = keep_t[i] != 0.f ? pr * (dpt[n][e] - dl_t[i]) : 0.f;
          if (masked) {
            const int j = k0 + w0 + g + 8 * (e >> 1);     // key index
            if (no_key(lse)) {         // the uniform average, no gradient
              pr = j < p.Lkv ? inv_lkv : 0.f;
              ds = 0.f;
            } else if (!seen(p, qp_first + i, j)) {
              pr = ds = 0.f;
            }
          }
          st[n][e] = pr;
          dpt[n][e] = ds;
        }
      }
      uint32_t pa[KT][4], dsa[KT][4];
#pragma unroll
      for (int k2 = 0; k2 < KT; ++k2) {
        to_a<NT>(pa[k2], st, k2);
        to_a<NT>(dsa[k2], dpt, k2);
      }
      mma_a_xt<D, KT>(dva, pa, dOt, c0, lane);
      mma_a_xt<D, KT>(dka, dsa, Qt, c0, lane);
    }
    h = h1;
    qt = qt1;
  }
  cp_wait_all();

  bf16* dk = static_cast<bf16*>(p.dk) + kv_off;
  bf16* dv = static_cast<bf16*>(p.dv) + kv_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < nk) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int64_t at = (int64_t)row * D + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(dka[n][2 * r] * p.scale, dka[n][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

}  // namespace tc

// One instance per (dtype, D): its two kernels, threads and dynamic shared
// memory.
template <int D, bool BF16>
struct Instance {
  static constexpr int threads = BF16 ? tc::THREADS : f32k::THREADS;
  static constexpr size_t smem(int which) {
    return BF16 ? (which ? tc::dkdv_smem<D>() : tc::dq_smem<D>())
                : (which ? f32k::dkdv_smem<D>() : f32k::dq_smem<D>());
  }
  static void (*kernel(int which))(Params) {
    if constexpr (BF16) {
      return which ? tc::bwd_dkdv_bf16<D> : tc::bwd_dq_bf16<D>;
    } else {
      return which ? f32k::bwd_dkdv_f32<D> : f32k::bwd_dq_f32<D>;
    }
  }
};

template <int D, bool BF16>
int set_smem() {
  using I = Instance<D, BF16>;
  static bool done = false;
  if (!done) {
    for (int which = 0; which < 2; ++which) {
      const cudaError_t err = cudaFuncSetAttribute(
          I::kernel(which), cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)I::smem(which));
      if (err != cudaSuccess) return (int)err;
    }
    done = true;
  }
  return 0;
}

template <int D, bool BF16>
int launch(const Params& p, int B, cudaStream_t stream) {
  using I = Instance<D, BF16>;
  int err = set_smem<D, BF16>();
  if (err) return err;
  const dim3 dq_grid((unsigned)(B * p.Hq), (unsigned)((p.Lq + BQ - 1) / BQ));
  I::kernel(0)<<<dq_grid, I::threads, I::smem(0), stream>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 kv_grid((unsigned)(B * p.Hkv), (unsigned)((p.Lkv + BK - 1) / BK));
  I::kernel(1)<<<kv_grid, I::threads, I::smem(1), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, bool BF16>
int describe(int which, int* out) {
  using I = Instance<D, BF16>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, I::kernel(which));
  if (err != cudaSuccess) return (int)err;
  const int set = set_smem<D, BF16>();
  if (set) return set;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, I::kernel(which), I::threads, I::smem(which));
  if (err != cudaSuccess) return (int)err;
  out[0] = which ? BK : BQ;
  out[1] = I::threads;
  out[2] = (int)I::smem(which);
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = blocks;
  return 0;
}

template <bool BF16>
int dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, BF16>(p, B, stream);
    case 32: return launch<32, BF16>(p, B, stream);
    case 64: return launch<64, BF16>(p, B, stream);
    case 128: return launch<128, BF16>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout, dq (B, Hq, Lq, D); k, v, dk, dv (B, Hkv, Lkv, D), one dtype
// (is_bf16: bf16, else f32); stats and delta f32 (B, Hq, Lq): stats from
// fa_forward, delta scratch.  Contiguous, bf16 pointers 16-byte aligned.
// D in {16, 32, 64, 128}; Hq % Hkv == 0; Lq, Lkv >= 1; B * Hq < 2^31 and
// ceil(Lq / 64), ceil(Lkv / 64) < 65536.  Two launches: dq, then dk and dv.
int fa_backward(const void* q, const void* k, const void* v,
                const void* dout, const float* stats, float* delta, void* dq,
                void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lkv,
                int D, int is_bf16, int causal, int window, int q_offset,
                int kv_offset, void* stream) {
  Params p{q, k, v, dout, stats, delta, dq, dk, dv, Hq, Hkv, Lq, Lkv,
           causal, window, q_offset, kv_offset, 1.0f / sqrtf((float)D)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<true>(p, B, D, st) : dispatch<false>(p, B, D, st);
}

// One kernel of the instance for (D, dtype), which = 0 (dq) or 1 (dk, dv):
// out[0..5] = tile rows, threads, dynamic shared memory bytes, registers
// per thread, local (spill) bytes per thread, resident blocks per SM.
int fa_bwd_describe(int D, int is_bf16, int which, int* out) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 32: return describe<16, false>(which, out);
    case 33: return describe<16, true>(which, out);
    case 64: return describe<32, false>(which, out);
    case 65: return describe<32, true>(which, out);
    case 128: return describe<64, false>(which, out);
    case 129: return describe<64, true>(which, out);
    case 256: return describe<128, false>(which, out);
    case 257: return describe<128, true>(which, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
