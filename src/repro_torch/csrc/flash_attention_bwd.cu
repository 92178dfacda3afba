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
// costs a first kernel that takes S and dP once more (seven products, not
// five) and leaves O out of the backward's inputs.
//
// Bound.  MiniCPM-2B's training microbatch (B=2, H=36, L=4096, D=64,
// causal, bf16) needs five products over the causal pairs, 2.5 x the
// forward's 154.7 GFLOP: 387 GFLOP, 0.391 ms at the bf16 tensor-core peak
// (989 TFLOP/s), against ~265 MB of q, k, v, dO, the statistics, dq, dk
// and dv (0.08 ms at 3.35 TB/s): bound by the operations.  DBRX's (48/8
// heads of 128) is 1031 GFLOP, 1.04 ms.  Besides, dQ's f32 partial sums
// pass through the L2 once per (query tile, key tile) pair they meet:
// 76032 pairs of 16 KB for MiniCPM's microbatch, 1.25 GB, in a 75.5 MB
// scratch (DBRX: 101376 of 32 KB, 3.32 GB, in 201 MB).  On an H100 they
// cost the key-major kernel 0.65 ms of 2.21 at MiniCPM's microbatch and
// 2.23 of 4.44 at DBRX's (1.5-1.9 TB/s; PERF.md §6).  A two-pass dq
// kernel that takes S and dP again instead (nine products, no scratch)
// timed 25% slower at MiniCPM's microbatch and 6% faster at DBRX's, so
// the sums stay (PERF.md §6).
//
// bf16 design: two kernels on one stream, every product a wgmma with f32
// accumulators, every tile a TMA load into the 128-byte swizzled layout
// the descriptors read (hopper.cuh).  A block is two warpgroups; one
// thread of each issues the copies of a ring of tiles guarded by
// mbarriers.  No producer warp: a ninth warp, or a producer warpgroup
// whose registers setmaxnreg moves to the consumers, left ptxas capping
// every thread at 168 registers (three warps on an SM sub-partition) and
// spilling the key-major kernel at D >= 32; eight warps leave 255.
// (1) bwd_delta_bf16: one block per (b*Hq + h, 128 query rows), 64 a
//     warpgroup, heaviest causal tiles first, two blocks an SM below
//     D = 128.  Q and dO are loaded once; K and V tiles of 64 keys stream
//     through a 3-4 stage ring by the forward's key_range rule.  S = Q K^T
//     and dP = dO V^T (shared-memory operands, two products), P from the
//     statistics, delta = rowsum(P o dP) in f32.
// (2) bwd_keymajor_bf16: a persistent grid, one block an SM, whose blocks
//     claim work items from a global counter in a fixed order: item
//     (kt, b, g), key tile kt of 128 keys of kv head g, key tiles
//     outermost (key tile 0 is the heaviest under a causal mask).  A
//     warpgroup owns 64 of the item's keys.  The item walks the G query
//     heads of its kv head and, for each, the query tiles of 64 rows that
//     see its keys (the inverse of key_range: a query tile is visited iff
//     its key range holds this key tile; a tile with a row that sees
//     nothing holds every key tile), Q, dO and the rows' lse and delta
//     streaming through a 2-4 stage ring.  Per query tile, five products:
//     S^T = K Q^T and dP^T = V dO^T (shared-memory operands), P^T and
//     dS^T in registers, dV += P^T dO and dK += dS^T Q (P^T and dS^T as
//     register A fragments; dK and dV stay in registers across the walk,
//     so the GQA sum stays in the block), dS^T stored to a ring of three
//     shared tiles, and dQ_part = dS K over the item's 128 keys, each
//     warpgroup taking half of the head dim (A = dS^T read transposed),
//     one tile late so that neither warpgroup waits on the other's half.
// dQ is summed in a fixed order, with no atomics whose order varies.  The
// key tiles that visit query tile qt form one range [t_lo, t_hi); each
// (b*Hq + h, qt, half) has an f32 block in a scratch and a counter, a
// chain that the warpgroups owning that half walk in key-tile order.  Key
// tile t_lo stores its part; a later one waits until the counter reads
// kt - t_lo (acquire), then adds its part in the L2; both by a bulk copy
// from a shared staging tile, whose completion it waits for early in its
// next step before it releases kt - t_lo + 1 (st.release.gpu).  Key tile
// t_hi - 1 adds the chain's sum in registers, scales, rounds to bf16 and
// writes dq itself, so the scratch needs no zeroing and dq no convert
// pass.  Two runs sum in one order: bit-equal.  No deadlock: an item's
// predecessors (key tile kt - 1 of its kv head) sit earlier in the claim
// order, so a running block has claimed each of them, and a block claims
// its next item only when it has finished its last.
// f32: on the CUDA cores in full f32 (training in f32 is held to 1e-5), as
// flash_f32: a dq kernel (one block per 64 query rows, a first pass over
// its key tiles for delta, a second for dS and dQ) and a dk/dv kernel
// (one block per 64 keys, the same walk as (2)); 8 warps, each owning 8
// rows; a lane scores two columns of a row against the tile in shared
// memory (rows padded to D+1 floats), the warp shares P or dS through
// shared memory and each lane accumulates D/32 outputs.
//
// The launches go on the caller's stream; the entry point returns
// cudaGetLastError().
#include <cuda.h>            // CUtensorMap; the encoder is reached through
                             // the runtime, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;              // the f32 kernels: query rows a tile
constexpr int BK = 64;              // the f32 kernels: keys a tile

struct Params {                     // the f32 kernels
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

template <class P>
__device__ __forceinline__ KeyRange key_range(const P& p, int qp_first,
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

// The key range of query tile qt of TQ rows.
template <int TQ, class P>
__device__ __forceinline__ KeyRange tile_keys(const P& p, int qt) {
  const int q0 = qt * TQ;
  const int qp = p.q_offset + q0;
  return key_range(p, qp, qp + min(TQ, p.Lq - q0) - 1);
}

// Whether query tile qt of TQ rows visits key tile kt of TK keys: the
// query-major and the key-major walks visit one set of pairs.
template <int TQ, int TK, class P>
__device__ __forceinline__ bool visits(const P& p, int qt, int kt) {
  const KeyRange r = tile_keys<TQ>(p, qt);
  return r.lo / TK <= kt && kt < (r.hi + TK - 1) / TK;
}

// Whether the scores of the row at position qpos carry no gradient: it
// sees one key (P = 1) or none (the uniform average).
template <class P>
__device__ __forceinline__ bool scores_free(const P& p, int qpos) {
  int lo = 0, hi = p.Lkv;
  if (p.causal) hi = min(hi, qpos - p.kv_offset + 1);
  if (p.window) lo = max(lo, qpos - p.window + 1 - p.kv_offset);
  return hi - lo <= 1;
}

template <class P>
__device__ __forceinline__ bool seen(const P& p, int qpos, int j) {
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
      if (!visits<BQ, BK>(p, qt, kt)) continue;   // block-uniform
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
using namespace hopper;

constexpr int WG = 128;             // threads a warpgroup
constexpr int THREADS = 2 * WG;     // two warpgroups
constexpr int QT = 64;              // key-major kernel: query rows a tile
constexpr int KT = 128;             // key-major kernel: keys an item
constexpr int DQT = 128;            // delta kernel: query rows a block
constexpr int DKT = 64;             // delta kernel: keys a streamed tile
constexpr int RBOX = QT + 4;        // the rows' statistics a box: QT from a
                                    // 16-byte aligned start
constexpr uint32_t RWB = 384;       // bytes a box takes in shared memory

// Ring depths: the deepest that keeps the key-major kernel within the
// 227 KB a block may hold, and the delta kernel at two blocks an SM below
// D = 128.
template <int D>
__host__ __device__ constexpr int stages() { return D == 128 ? 2 : 4; }
template <int D>
__host__ __device__ constexpr int delta_stages() { return D == 128 ? 3 : 4; }

// The parameters of both kernels: 3-D tensor maps (D, L, B x heads) with
// boxes 64 values wide (zero past D) and as many rows as the kernel's
// tile (zero past L), 1-D maps of the rows' statistics and delta (boxes
// of RBOX), and what the f32 kernels take.
struct TcParams {
  CUtensorMap tq, tdo, tk, tv, tstats, tdelta;
  const float* stats;               // (B, Hq, Lq) from the forward
  float* delta;                     // (B, Hq, Lq), written by (1)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dq_acc;                    // (B*Hq, ceil(Lq/QT), 2, QT * D/2) f32
  int* counters;                    // [0] the claim, then 2 a query tile
  int B, Hq, Hkv, Lq, Lkv;
  int causal, window, q_offset, kv_offset;
  float scale;
};

template <int D>
__host__ __device__ constexpr int atoms() { return (D + 63) / 64; }

// A swizzled tile of R rows: R * 128 bytes an atom column.
template <int D, int R>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (uint32_t)R * 128 * atoms<D>();
}

// Shared memory, after up to 1024 bytes to align the tiles.  delta: Q and
// dO, the K and V rings, the barriers (Q's, full, empty).
template <int D>
constexpr size_t delta_smem() {
  return 1024 + 2 * (size_t)tile_bytes<D, DQT>() +
         2 * delta_stages<D>() * (size_t)tile_bytes<D, DKT>() +
         8 * (1 + 2 * delta_stages<D>());
}

// key-major: K and V; the rings of Q, dO and the rows' lse and delta; a
// ring of three dS^T tiles (128 keys of 64 queries); each warpgroup's dQ
// part (f32); the barriers (K/V's, the two rings' full and empty) and the
// claimed item.
template <int D>
constexpr size_t main_smem() {
  return 1024 + 2 * (size_t)tile_bytes<D, KT>() +
         stages<D>() * (2 * (size_t)tile_bytes<D, QT>() + 2 * RWB) +
         3 * KT * 128 + (size_t)QT * D * 4 + 8 * (1 + 2 * stages<D>() + 6) +
         16;
}

// Rows [row, row + R) of head bh into a swizzled tile, one box an atom
// column.
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int row, int bh, uint32_t bar) {
#pragma unroll
  for (int a = 0; a < atoms<D>(); ++a) {
    tma_load_3d(dst + a * R * 128, map, a * 64, row, bh, bar);
  }
}

// A K-major operand of R rows from row r0, k-step kk (16 of the head dim).
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int r0, int kk) {
  return desc(tile + r0 * 128 + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16,
              1024);
}

// A shared address the compiler must not treat as loop-invariant: the
// descriptors built from it are rebuilt where they are used instead of
// held in registers across the loop.
__device__ __forceinline__ uint32_t fresh(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_delta_bf16(__grid_constant__ const TcParams p) {
  constexpr int S = delta_stages<D>();
  constexpr uint32_t QB = tile_bytes<D, DQT>(), KB = tile_bytes<D, DKT>();
  constexpr int KD = D / 16;           // k-steps of S and dP
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t qs = (smem_addr(tc_smem) + 1023) & ~1023u;
  const uint32_t dos = qs + QB, ks = dos + QB, vs = ks + S * KB;
  const uint32_t q_full = vs + S * KB;
  const uint32_t full = q_full + 8, empty = full + 8 * S;

  const int bh = blockIdx.x;           // b * Hq + hq
  const int b = bh / p.Hq;
  const int bkv = b * p.Hkv + (bh % p.Hq) / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQT;   // heaviest tiles first
  const int nq = min(DQT, p.Lq - q0);
  const int qp_first = p.q_offset + q0;
  const KeyRange keys = key_range(p, qp_first, qp_first + nq - 1);
  const int t_lo = keys.lo / DKT;
  const int n_tiles = (keys.hi + DKT - 1) / DKT - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0 issues the copies: key tile it into stage it % S once every
  // thread has released the tile that stage held
  auto issue = [&](int it) {
    const int s = it % S;
    mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
    mbar_expect(full + 8 * s, 2 * KB);
    const int k0 = (t_lo + it) * DKT;
    tma_tile<D, DKT>(ks + s * KB, &p.tk, k0, bkv, full + 8 * s);
    tma_tile<D, DKT>(vs + s * KB, &p.tv, k0, bkv, full + 8 * s);
  };
  if (threadIdx.x == 0) {
    mbar_expect(q_full, 2 * QB);
    tma_tile<D, DQT>(qs, &p.tq, q0, bh, q_full);
    tma_tile<D, DQT>(dos, &p.tdo, q0, bh, q_full);
    for (int it = 0; it < min(S - 1, n_tiles); ++it) issue(it);
  }

  // warpgroup cw owns rows [64 cw, 64 cw + 64) of the block
  const int cw = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = cw * 64;
  const int w0 = r0 + warp * 16;       // the warp's first row in the block
  const int wq_first = qp_first + w0;
  const int wq_last = wq_first + 15;
  int lo_t = 0, hi_t = 0;              // this warpgroup's key tiles
  if (r0 < nq) {
    const KeyRange r = key_range(p, qp_first + r0,
                                 qp_first + min(r0 + 64, nq) - 1);
    lo_t = r.lo / DKT;
    hi_t = (r.hi + DKT - 1) / DKT;
  }
  const float scale_log2 = p.scale * LOG2E;
  const int64_t row0 = (int64_t)bh * p.Lq + q0;
  // this thread's rows g and g+8: lse in the log2 domain (+inf past Lq:
  // P = 0), their sums of P o dP
  float lse[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    lse[r] = INFINITY;
    if (row < nq) {
      const float st = p.stats[row0 + row];
      lse[r] = no_key(st) ? NEG_INF : st * LOG2E;
    }
  }

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (threadIdx.x == 0 && it + S - 1 < n_tiles) issue(it + S - 1);
    const int s = it % S;
    mbar_wait(full + 8 * s, (it / S) & 1);
    const int kt = t_lo + it;
    if (lo_t <= kt && kt < hi_t) {     // warpgroup-uniform
      const uint32_t kb = fresh(ks) + s * KB, vb = fresh(vs) + s * KB;
      const uint32_t qa = fresh(qs), oa = fresh(dos);
      float sc[32], dp[32];
      own(sc);
      own(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_ss<64, 0, 0>(sc, kmajor<DQT>(qa, r0, kk), kmajor<DKT>(kb, 0, kk),
                           kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_ss<64, 0, 0>(dp, kmajor<DQT>(oa, r0, kk),
                           kmajor<DKT>(vb, 0, kk), kk > 0);
      }
      wg_commit();
      wg_wait0();
      own(sc);
      own(dp);
      // P = exp2(S scale log2 e - lse) on the keys a row sees; a row that
      // sees no key has none in view
      const int k0 = kt * DKT;
      const bool masked =
          k0 + DKT > p.Lkv ||
          (p.causal && p.kv_offset + k0 + DKT - 1 > wq_first) ||
          (p.window && p.kv_offset + k0 <= wq_last - p.window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float pr = exp2_approx(sc[i] * scale_log2 - lse[r]);
        if (masked &&
            !seen(p, wq_first + g + 8 * r, k0 + (i >> 2) * 8 + 2 * t4 + (i & 1))) {
          pr = 0.f;
        }
        dl[r] = fmaf(pr, dp[i], dl[r]);
      }
    }
    mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {        // the row's four lanes hold its sum
    dl[r] = quad_sum(dl[r]);
    const int row = w0 + g + 8 * r;
    if (t4 == 0 && row < nq) p.delta[row0 + row] = dl[r];
  }
}

// Wait until the chain at `ctr` has counted `rank` parts; `peek`, read
// earlier, spares a load when it already has.
__device__ __forceinline__ void wait_rank(const int* ctr, int rank, int peek) {
  if (peek >= rank) {
    fence_acq_rel();
    return;
  }
  const long long t0 = clock64();
  while (ld_acquire(ctr) < rank) {
    __nanosleep(32);
    watchdog(t0);
  }
}

// The query tiles key tile kt visits: the range [first, last] (first < 0:
// none); `gaps` says that some tiles inside it are not visited (a tile
// with a row that sees nothing lies apart from the others), and then each
// tile is tested.
struct Walk {
  int first, last;
  bool gaps;
};

__device__ Walk walk_of(const TcParams& p, int kt, int nqt) {
  Walk w{-1, -1, false};
  for (int qt = 0; qt < nqt; ++qt) {
    if (!visits<QT, KT>(p, qt, kt)) continue;
    if (w.first < 0) w.first = qt;
    else if (w.last != qt - 1) w.gaps = true;
    w.last = qt;
  }
  return w;
}

// The next (query head h, query tile qt) that key tile kt visits, after
// the current one (start from h = 0, qt = -1): heads outermost, each
// head's tiles ascending; false past the last.  (Tiles outermost, each
// tile's heads in turn, kept the next key tile's item further behind but
// timed slower with G = 6 on an H100.)
__device__ __forceinline__ bool next_tile(const TcParams& p, const Walk& w,
                                          int kt, int G, int& h, int& qt) {
  if (w.first < 0) return false;       // keys no row sees
  if (qt < 0) {
    qt = w.first;
    return true;
  }
  do {
    if (++qt > w.last) {
      qt = w.first;
      if (++h == G) return false;
      return true;
    }
  } while (w.gaps && !visits<QT, KT>(p, qt, kt));
  return true;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_keymajor_bf16(__grid_constant__ const TcParams p) {
  constexpr int S = stages<D>();
  constexpr int NB = 3;                // dS^T tiles in their ring
  // tid 0 of each warpgroup fills a Q/dO stage LAG steps after it was
  // consumed: the other warpgroup may be that far behind
  constexpr int LAG = S >= 4 ? 2 : 1;
  constexpr uint32_t KB = tile_bytes<D, KT>(), QB = tile_bytes<D, QT>();
  constexpr uint32_t RB = 2 * RWB;     // a stage's rows: lse, delta
  constexpr uint32_t DSB = KT * 128;   // dS^T: 128 keys of 64 queries
  constexpr int NH = D / 2;            // dQ columns a warpgroup
  constexpr uint32_t GB = QT * NH * 4; // a warpgroup's dQ part, f32
  constexpr int KD = D / 16;           // k-steps over the head dim
  constexpr int KQ = QT / 16;          // k-steps over a query tile
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t base = smem_addr(tc_smem);
  const uint32_t ks = (base + 1023) & ~1023u;
  const uint32_t vs = ks + KB, qs = vs + KB, dos = qs + S * QB;
  const uint32_t dss = dos + S * QB, stg = dss + NB * DSB;
  const uint32_t rws = stg + 2 * GB;   // (the swizzled tiles 1024-aligned)
  const uint32_t kv_full = rws + S * RB;
  const uint32_t full = kv_full + 8, empty = full + 8 * S;
  const uint32_t ds_full = empty + 8 * S, ds_empty = ds_full + 8 * NB;
  volatile int* item_s = reinterpret_cast<volatile int*>(
      tc_smem + (ds_empty + 8 * NB - base));

  const int G = p.Hq / p.Hkv;
  const int nqt = (p.Lq + QT - 1) / QT;
  const int n_bg = p.B * p.Hkv;
  const int n_items = n_bg * ((p.Lkv + KT - 1) / KT);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 2);
      mbar_init(empty + 8 * s, THREADS);
    }
    for (int b = 0; b < NB; ++b) {
      mbar_init(ds_full + 8 * b, THREADS);
      mbar_init(ds_empty + 8 * b, THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int cw = threadIdx.x / WG;     // keys [64 cw, 64 cw + 64) of an item
  const int tid = threadIdx.x % WG;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = p.scale * LOG2E;
  const float inv_lkv = 1.f / (float)p.Lkv;
  const uint32_t my_stg = stg + cw * GB;
  int s = 0;                           // the Q/dO ring, as consumed
  uint32_t ph = 0, kv_ph = 0;
  int si = 0;                          // the Q/dO ring, as issued (tid 0)
  uint32_t phi = 0;
  uint32_t nds = 0;                    // dS^T tiles written so far
  int pend = -1, pend_rank = 0;        // a bulk copy to release (tid 0)
  int* const ctr = p.counters + 1;     // 2 a query tile: its halves' chains

  // tid 0 of each warpgroup: once the last bulk copy has completed, tell
  // the next key tile of that chain that it may add
  auto flush = [&]() {
    if (pend >= 0) {
      bulk_wait_all();
      st_release(ctr + 2 * pend + cw, pend_rank);
      pend = -1;
    }
  };

  // dQ_part = dS K for the tile written at step j (both halves of its dS^T
  // in), this warpgroup's half of the head dim, over the item's 128 keys
  // (A = dS^T and B = K, both read transposed); then its place in the
  // fixed order: the chain of this warpgroup's half of query tile qt over
  // the key tiles that see it, key tile kt - 1's part first.  Before the
  // last, the part goes through the L2 (the chain's first stores it, the
  // others add it there: one bulk copy from the staging tile each,
  // released early in the next step); the last adds the chain's sum in
  // registers and writes its half of dq, times scale, rounded to bf16.
  // (peek: the chain's count, read earlier: if it already allows this key
  // tile, a fence makes that read an acquire instead of a new load)
  auto dq_step = [&](uint32_t j, int kt, int bh, int qt, int peek) {
    const uint32_t b = j % NB, use = j / NB;
    const KeyRange kr = tile_keys<QT>(p, qt);
    const int rank = kt - kr.lo / KT;
    const int last = (kr.hi + KT - 1) / KT - 1 - kr.lo / KT;
    const int64_t slot = (int64_t)bh * nqt + qt;
    if (tid == 0 && rank > 0 && peek < rank) {
      peek = ld_relaxed(ctr + 2 * slot + cw);   // again, over the product
    }
    mbar_wait(ds_full + 8 * b, use & 1);
    const uint32_t db = dss + b * DSB;
    const uint32_t kh = fresh(ks) + (cw * NH / 64) * (KT * 128) +
                        (cw * NH % 64) * 2;
    float dqa[NH / 2];
    own(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wgmma_ss<NH, 1, 1>(dqa, desc(db + kk * 2048, KT * 128, 1024),
                         desc(kh + kk * 2048, KT * 128, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    own(dqa);
    mbar_arrive(ds_empty + 8 * b);     // this dS^T tile is read

    float* part = p.dq_acc + (slot * 2 + cw) * (QT * NH);
    if (rank < last) {
      if (tid == 0) flush();           // (when no step came between)
      bar_sync(2 + cw, WG);            // the staging tile has been read
#pragma unroll
      for (int v = 0; v < NH / 8; ++v) {
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(my_stg + (tid * (NH / 2) + 4 * v) * 4),
                        "f"(dqa[4 * v]), "f"(dqa[4 * v + 1]),
                        "f"(dqa[4 * v + 2]), "f"(dqa[4 * v + 3])
                     : "memory");
      }
      fence_async_smem();
      bar_sync(2 + cw, WG);
      if (tid == 0) {
        if (rank > 0) {                // key tile kt - 1 has added
          wait_rank(ctr + 2 * slot + cw, rank, peek);
          fence_async_global();
          bulk_add_f32(part, my_stg, GB);
        } else {
          bulk_store(part, my_stg, GB);
        }
        bulk_commit();
        pend = (int)slot;
        pend_rank = rank + 1;
      }
      return;
    }
    if (tid == 0) flush();
    if (rank > 0) {
      if (tid == 0) wait_rank(ctr + 2 * slot + cw, rank, peek);
      bar_sync(2 + cw, WG);
      const float4* sum = reinterpret_cast<const float4*>(
          part + tid * (NH / 2));
#pragma unroll
      for (int v = 0; v < NH / 8; ++v) {
        const float4 x = __ldcg(sum + v);
        dqa[4 * v] += x.x;
        dqa[4 * v + 1] += x.y;
        dqa[4 * v + 2] += x.z;
        dqa[4 * v + 3] += x.w;
      }
    }
    const int q0 = qt * QT;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      if (q0 + row < p.Lq) {
        bf16* out = p.dq + ((int64_t)bh * p.Lq + q0 + row) * D + cw * NH;
#pragma unroll
        for (int i = 0; i < NH / 8; ++i) {
          *reinterpret_cast<uint32_t*>(out + 8 * i + 2 * t4) =
              pack_bf16(dqa[4 * i + 2 * r] * p.scale,
                        dqa[4 * i + 2 * r + 1] * p.scale);
        }
      }
    }
  };

  for (;;) {
    bar_sync(1, THREADS);              // the last item is done with K and V
    int kt = 0, bh0 = 0;
    Walk walk{-1, -1, false};
    int ih = 0, iq = -1;               // the walk, as issued (tid 0)
    bool more = false;
    // tid 0 of each warpgroup: the walk's next (head, query tile) into the
    // ring, once the stage it takes is released: warpgroup 0 loads Q and
    // dO, warpgroup 1 the rows' statistics and delta
    auto issue_next = [&]() {
      more = next_tile(p, walk, kt, G, ih, iq);
      if (!more) return;
      mbar_wait(empty + 8 * si, phi ^ 1);
      const int q0 = iq * QT, bh = bh0 + ih;
      const uint32_t bar = full + 8 * si;
      if (cw == 0) {
        mbar_expect(bar, 2 * QB);
        tma_tile<D, QT>(qs + si * QB, &p.tq, q0, bh, bar);
        tma_tile<D, QT>(dos + si * QB, &p.tdo, q0, bh, bar);
      } else {
        const int row = (bh * p.Lq + q0) & ~3;   // 16-byte aligned boxes
        mbar_expect(bar, 2 * RBOX * 4);
        tma_load_1d(rws + si * RB, &p.tstats, row, bar);
        tma_load_1d(rws + si * RB + RWB, &p.tdelta, row, bar);
      }
      if (++si == S) {
        si = 0;
        phi ^= 1;
      }
    };
    if (threadIdx.x == 0) {
      const int item = atomicAdd(p.counters, 1);
      *item_s = item;
      if (item < n_items) {
        mbar_expect(kv_full, 2 * KB);
        tma_tile<D, KT>(ks, &p.tk, item / n_bg * KT, item % n_bg, kv_full);
        tma_tile<D, KT>(vs, &p.tv, item / n_bg * KT, item % n_bg, kv_full);
      }
    }
    bar_sync(1, THREADS);
    const int item = *item_s;
    if (item >= n_items) break;
    kt = item / n_bg;
    const int bg = item % n_bg;
    bh0 = (bg / p.Hkv) * p.Hq + (bg % p.Hkv) * G;
    walk = walk_of(p, kt, nqt);
    if (tid == 0) {
      more = true;
      for (int i = 0; i < S - LAG && more; ++i) issue_next();
    }
    const int k0w = kt * KT + cw * 64;   // this warpgroup's first key
    const int kw = k0w + warp * 16;      // the warp's first key
    mbar_wait(kv_full, kv_ph);
    kv_ph ^= 1;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    int h = 0, qt = -1;
    int prev_bh = -1, prev_qt = 0;       // the step whose dQ is pending
    while (next_tile(p, walk, kt, G, h, qt)) {
      if (tid == 0 && more) issue_next();
      const int q0 = qt * QT, qp_first = p.q_offset + q0;
      const KeyRange kr = tile_keys<QT>(p, qt);
      // every (query, key) pair of the tile is seen, and every row valid,
      // unless one of these holds
      const bool masked =
          kr.blind || k0w + 64 > p.Lkv || q0 + QT > p.Lq ||
          (p.causal && p.kv_offset + k0w + 63 > qp_first) ||
          (p.window && p.kv_offset + k0w <= qp_first + QT - 1 - p.window);

      int peek = 0;
      if (tid == 0 && prev_bh >= 0) {
        peek = ld_relaxed(ctr + 2 * ((int64_t)prev_bh * nqt + prev_qt) + cw);
      }
      mbar_wait(full + 8 * s, ph);
      const uint32_t qb = fresh(qs) + s * QB, ob = fresh(dos) + s * QB;
      const uint32_t kb = fresh(ks), vb = fresh(vs);
      const float* rs = reinterpret_cast<const float*>(
          tc_smem + (rws + s * RB - base)) + ((bh0 + h) * p.Lq + q0) % 4;

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float st[32], dpt[32];
      own(st);
      own(dpt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_ss<64, 0, 0>(st, kmajor<KT>(kb, cw * 64, kk),
                           kmajor<QT>(qb, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_ss<64, 0, 0>(dpt, kmajor<KT>(vb, cw * 64, kk),
                           kmajor<QT>(ob, 0, kk), kk > 0);
      }
      wg_commit();
      wg_wait0();
      own(st);
      own(dpt);

      // P^T and dS^T = P^T o (dP^T - delta), 0 in a row whose scores carry
      // no gradient.  The rows' lse (log2 domain) and delta, this thread's
      // 16 queries; in an unmasked tile every row is valid and sees 64
      // keys or more, so only a masked tile takes the per-element rules.
      float lq[16], dq_[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          lq[2 * i + x] = rs[8 * i + 2 * t4 + x] * LOG2E;
          dq_[2 * i + x] = rs[RWB / 4 + 8 * i + 2 * t4 + x];
        }
      }
      if (!masked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int x = 2 * (i >> 2) + (i & 1);
          const float pr = exp2_approx(st[i] * scale_log2 - lq[x]);
          dpt[i] = pr * (dpt[i] - dq_[x]);
          st[i] = pr;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + 2 * t4;  // the queries of elements e & 1
          bool keep[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {  // rows past Lq weigh nothing
            const float r = rs[c + x];
            const bool valid = q0 + c + x < p.Lq;
            lq[2 * i + x] = !valid ? INFINITY : no_key(r) ? NEG_INF : r * LOG2E;
            keep[x] = valid && !scores_free(p, qp_first + c + x);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = e & 1;
            const float l = lq[2 * i + x];
            float pr = exp2_approx(st[4 * i + e] * scale_log2 - l);
            float ds = keep[x] ? pr * (dpt[4 * i + e] - dq_[2 * i + x]) : 0.f;
            const int j = kw + g + 8 * (e >> 1);   // the key
            if (no_key(l)) {           // the uniform average, no gradient
              pr = j < p.Lkv ? inv_lkv : 0.f;
              ds = 0.f;
            } else if (!seen(p, qp_first + c + x, j)) {
              pr = ds = 0.f;
            }
            st[4 * i + e] = pr;
            dpt[4 * i + e] = ds;
          }
        }
      }

      if (tid == 0) flush();           // the last step's bulk copy is done

      // dS^T (rounded to bf16) into this warpgroup's 64 rows of the ring's
      // next tile, once both warpgroups have read what it held
      const uint32_t b = nds % NB, use = nds / NB;
      ++nds;
      mbar_wait(ds_empty + 8 * b, (use & 1) ^ 1);
      const uint32_t db = dss + b * DSB;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = cw * 64 + warp * 16 + g + 8 * r;
          asm volatile("st.shared.b32 [%0], %1;\n"
                       :: "r"(db + swz<KT>(row, i) + 4 * t4),
                          "r"(pack_bf16(dpt[4 * i + 2 * r],
                                        dpt[4 * i + 2 * r + 1]))
                       : "memory");
        }
      }
      fence_async_smem();
      mbar_arrive(ds_full + 8 * b);

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T from the accumulators
      // as A fragments (the S-to-P identity of the forward); dO and Q
      // read transposed
      uint32_t pa[KQ][4], da[KQ][4];
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[kq][x] = pack_bf16(st[8 * kq + 2 * x], st[8 * kq + 2 * x + 1]);
          da[kq][x] = pack_bf16(dpt[8 * kq + 2 * x], dpt[8 * kq + 2 * x + 1]);
        }
      }
      own(dv);
      own(dk);
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        wgmma_rs<D, 1>(dv, pa[kq], desc(ob + kq * 2048, QT * 128, 1024), 1);
      }
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        wgmma_rs<D, 1>(dk, da[kq], desc(qb + kq * 2048, QT * 128, 1024), 1);
      }
      wg_commit();
      wg_wait0();
      own(dv);
      own(dk);
      own(pa);
      own(da);
      mbar_arrive(empty + 8 * s);      // Q, dO and the rows are consumed
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
      // the last step's dQ, whose other half of dS^T has had a step to
      // come in
      if (prev_bh >= 0) dq_step(nds - 2, kt, prev_bh, prev_qt, peek);
      prev_bh = bh0 + h;
      prev_qt = qt;
    }
    if (prev_bh >= 0) dq_step(nds - 1, kt, prev_bh, prev_qt, 0);
    if (tid == 0) flush();

    // dK * scale and dV, rounded to bf16, a row's 4 bytes a lane
    const int64_t kv_row0 = (int64_t)bg * p.Lkv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + g + 8 * r;
      if (key < p.Lkv) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const int64_t at = (kv_row0 + key) * D + 8 * i + 2 * t4;
          *reinterpret_cast<uint32_t*>(p.dk + at) =
              pack_bf16(dk[4 * i + 2 * r] * p.scale,
                        dk[4 * i + 2 * r + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(p.dv + at) =
              pack_bf16(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------ the host ---

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// n f32 values as a 1-D map with boxes of tc::RBOX values.
int vector_map(CUtensorMap* map, const float* ptr, int64_t n) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};   // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)tc::RBOX};
  const cuuint32_t steps[1] = {1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A bf16 (BH, L, D) tensor as a 3-D map with boxes of 64 values by `rows`
// rows, 128-byte swizzle; what lies past D or L reads as zero.
int tensor_map(CUtensorMap* map, const void* ptr, int D, int L, int BH,
               int rows) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One instance per (dtype, D): its two kernels, threads and dynamic shared
// memory.  bf16: (0) bwd_delta_bf16, (1) bwd_keymajor_bf16; f32: (0)
// bwd_dq_f32, (1) bwd_dkdv_f32.
template <int D, bool BF16>
struct Instance {
  static constexpr int threads = BF16 ? tc::THREADS : f32k::THREADS;
  static constexpr int rows(int which) {
    return BF16 ? (which ? tc::KT : tc::DQT) : (which ? BK : BQ);
  }
  static constexpr size_t smem(int which) {
    return BF16 ? (which ? tc::main_smem<D>() : tc::delta_smem<D>())
                : (which ? f32k::dkdv_smem<D>() : f32k::dq_smem<D>());
  }
  static const void* kernel(int which) {
    if constexpr (BF16) {
      return which ? (const void*)tc::bwd_keymajor_bf16<D>
                   : (const void*)tc::bwd_delta_bf16<D>;
    } else {
      return which ? (const void*)f32k::bwd_dkdv_f32<D>
                   : (const void*)f32k::bwd_dq_f32<D>;
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

// The key-major kernel's persistent grid: its resident blocks on this
// device.
template <int D>
int resident_blocks(int* out) {
  using I = Instance<D, true>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, I::kernel(1), I::threads, I::smem(1));
  }
  *out = sms * per_sm;
  return (int)err;
}

struct Call {
  const void *q, *k, *v, *dout;
  const float* stats;
  float* delta;
  void *dq, *dk, *dv;
  float* dq_acc;
  int* counters;
  int B, Hq, Hkv, Lq, Lkv;
  int causal, window, q_offset, kv_offset;
  float scale;
};

template <int D>
int launch_f32(const Call& c, cudaStream_t stream) {
  using I = Instance<D, false>;
  int err = set_smem<D, false>();
  if (err) return err;
  const Params p{c.q, c.k, c.v, c.dout, c.stats, c.delta, c.dq, c.dk, c.dv,
                 c.Hq, c.Hkv, c.Lq, c.Lkv, c.causal, c.window, c.q_offset,
                 c.kv_offset, c.scale};
  const dim3 grid_q((unsigned)(c.B * c.Hq), (unsigned)((c.Lq + BQ - 1) / BQ));
  f32k::bwd_dq_f32<D><<<grid_q, I::threads, I::smem(0), stream>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid_k((unsigned)(c.B * c.Hkv), (unsigned)((c.Lkv + BK - 1) / BK));
  f32k::bwd_dkdv_f32<D><<<grid_k, I::threads, I::smem(1), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Call& c, cudaStream_t stream) {
  using I = Instance<D, true>;
  int err = set_smem<D, true>();
  if (err) return err;
  tc::TcParams p{};
  p.stats = c.stats;
  p.delta = c.delta;
  p.dq = static_cast<tc::bf16*>(c.dq);
  p.dk = static_cast<tc::bf16*>(c.dk);
  p.dv = static_cast<tc::bf16*>(c.dv);
  p.dq_acc = c.dq_acc;
  p.counters = c.counters;
  p.B = c.B;
  p.Hq = c.Hq;
  p.Hkv = c.Hkv;
  p.Lq = c.Lq;
  p.Lkv = c.Lkv;
  p.causal = c.causal;
  p.window = c.window;
  p.q_offset = c.q_offset;
  p.kv_offset = c.kv_offset;
  p.scale = c.scale;
  // each kernel's maps: the rows of its query and key tiles
  auto maps = [&](int q_rows, int k_rows) {
    int e = tensor_map(&p.tq, c.q, D, c.Lq, c.B * c.Hq, q_rows);
    if (!e) e = tensor_map(&p.tdo, c.dout, D, c.Lq, c.B * c.Hq, q_rows);
    if (!e) e = tensor_map(&p.tk, c.k, D, c.Lkv, c.B * c.Hkv, k_rows);
    if (!e) e = tensor_map(&p.tv, c.v, D, c.Lkv, c.B * c.Hkv, k_rows);
    return e;
  };
  err = maps(tc::DQT, tc::DKT);
  if (err) return err;
  const dim3 grid((unsigned)(c.B * c.Hq),
                  (unsigned)((c.Lq + tc::DQT - 1) / tc::DQT));
  tc::bwd_delta_bf16<D><<<grid, I::threads, I::smem(0), stream>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = maps(tc::QT, tc::KT);
  const int64_t rows = (int64_t)c.B * c.Hq * c.Lq;
  if (!err) err = vector_map(&p.tstats, c.stats, rows);
  if (!err) err = vector_map(&p.tdelta, c.delta, rows);
  if (err) return err;
  int slots = 0;
  err = resident_blocks<D>(&slots);
  if (err) return err;
  const int items = c.B * c.Hkv * ((c.Lkv + tc::KT - 1) / tc::KT);
  tc::bwd_keymajor_bf16<D><<<(unsigned)min(items, slots), I::threads,
                             I::smem(1), stream>>>(p);
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
  out[0] = I::rows(which);
  out[1] = I::threads;
  out[2] = (int)I::smem(which);
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = blocks;
  return 0;
}

template <bool BF16>
int dispatch(const Call& c, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return BF16 ? launch_bf16<16>(c, stream) : launch_f32<16>(c, stream);
    case 32: return BF16 ? launch_bf16<32>(c, stream) : launch_f32<32>(c, stream);
    case 64: return BF16 ? launch_bf16<64>(c, stream) : launch_f32<64>(c, stream);
    case 128: return BF16 ? launch_bf16<128>(c, stream) : launch_f32<128>(c, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout, dq (B, Hq, Lq, D); k, v, dk, dv (B, Hkv, Lkv, D), one dtype
// (is_bf16: bf16, else f32); stats and delta f32 (B, Hq, Lq): stats from
// fa_forward, delta written by the first kernel.  bf16 only: dq_acc, f32
// scratch of B * Hq * ceil(Lq / 64) * 64 * D values (no zeroing needed),
// and counters, 1 + 2 * B * Hq * ceil(Lq / 64) int32 zeros.
// Contiguous, 16-byte aligned.  D in {16, 32, 64, 128}; Hq % Hkv == 0;
// Lq, Lkv >= 1; B * Hq * Lq < 2^31 and ceil(Lq / 64), ceil(Lkv / 64) <
// 65536.  Two launches: bf16, delta, then the key-major dq, dk and dv;
// f32, dq, then dk and dv.
int fa_backward(const void* q, const void* k, const void* v,
                const void* dout, const float* stats, float* delta, void* dq,
                void* dk, void* dv, float* dq_acc, int* counters, int B,
                int Hq, int Hkv, int Lq, int Lkv, int D, int is_bf16,
                int causal, int window, int q_offset, int kv_offset,
                void* stream) {
  const Call c{q, k, v, dout, stats, delta, dq, dk, dv, dq_acc, counters,
               B, Hq, Hkv, Lq, Lkv, causal, window, q_offset, kv_offset,
               1.0f / sqrtf((float)D)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<true>(c, D, st) : dispatch<false>(c, D, st);
}

// One kernel of the instance for (D, dtype), which = 0 (bf16: delta, f32:
// dq) or 1 (bf16: key-major, f32: dk, dv): out[0..5] = tile rows (query
// rows or keys), threads, dynamic shared memory bytes, registers per
// thread, local (spill) bytes per thread, resident blocks per SM.
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
