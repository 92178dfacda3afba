// Prefill attention for Hopper (sm_90a), written by hand: bf16 on the
// tensor cores, f32 on the CUDA cores; causal and sliding-window masks,
// GQA, query and key position offsets, any sequence lengths.
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
// Bound.  MiniCPM-2B's prefill (B=8, H=36, L=1024, D=64, causal, bf16)
// reads q, k, v and writes o once: 151 MB, 45 us at 3.35 TB/s; its causal
// pairs need 38.7 GFLOP, 39 us at the bf16 tensor-core peak (989 TFLOP/s):
// bound by the bytes, only just.  Qwen2-72B's heads (B=2, Hq=64, Hkv=8,
// L=2048, D=128, causal) move 151 MB (45 us) for 137 GFLOP (139 us): bound
// by the operations.  Both sit near the ridge, so the design has to keep
// the tensor cores fed and read each byte from memory once per block.
//
// Design of the bf16 kernel (FlashAttention-2's loop on Hopper's warpgroup
// mma).  Blocks on Hopper run in no order and carry nothing from one to
// the next, so the TPU's sequential kv grid dimension becomes a loop inside
// the block.  One block per (b*Hq + h, tile of 64 query rows), heaviest
// causal tiles first; one warpgroup, each warp owning 16 rows.  K and V
// tiles of 64 keys stream through a 2-stage ring in shared memory, filled
// by 16-byte cp.async copies, so tile j+1 loads while tile j is computed.
// Both products are wgmma.mma_async m64nNk16 bf16 products with f32
// accumulators in registers: S = Q K^T takes Q as A fragments held in
// registers (loaded once by ldmatrix) and K from shared memory through a
// matrix descriptor; O += P V takes P straight from the S accumulators as
// A fragments, never through shared memory, and V through a descriptor as
// a transposed (dims-contiguous) operand.  K and V are written in the
// 128-byte swizzled layout the descriptors read, which also keeps the
// tensor cores' shared-memory reads free of bank conflicts.  The online
// softmax (m, l) stays in f32 registers; a row's max is reduced over the
// four lanes that hold it.  Only tiles that cross the causal diagonal, the
// window edge or the end of Lkv apply a mask.  The epilogue divides by l in
// f32, rounds to bf16 and stores 16-byte rows through shared memory.
// (An mma.sync m16n8k16 design with ldmatrix fragments was 1.3-1.4x slower
// on the same card; PERF.md has the times.)
//
// The f32 kernel runs on the CUDA cores in full f32 (its tolerance, 2e-5,
// rules out TF32 and bf16 tensor cores).  One block per (b*Hq + h, 64 query
// rows); 8 warps, each owning 8 rows and their (m, l, acc) in registers.
// Per kv tile of 64 keys the block stages K (rows padded to D+1 floats) and
// V in shared memory; a lane scores 2 keys of a row, the warp reduces the
// row's max and sum with shuffles, and each lane accumulates D/32 outputs.
//
// Both kernels keep the reference's semantics at the edges.  Tiles that
// every row of a block masks are skipped: each row still sees at least one
// key, and alpha = exp(m_prev - m_new) = 0 then erases whatever a fully
// masked tile put in acc.  A block holding a row that sees
// no key at all keeps every tile, so that row gets the plain version's
// uniform average (every score -1e30) and never NaN.  Keys past Lkv are
// absent, not masked: their weight is exactly 0.  Ragged edges of Lq and
// Lkv are handled in the kernel; there is no multiple-of-128 requirement
// (that was the TPU's tiling).
//
// Statistics for the backward.  Given a pointer, each kernel also writes
// every row's log-sum-exp of its scaled, masked scores in f32, natural log,
// (B, Hq, Lq): stats = m + log(l), from the bf16 kernel's log2-domain m and
// l as (m + log2 l) ln 2.  A row that sees no key gets exactly NEG_INF
// instead: there m = NEG_INF absorbs log l in f32, so a single log-sum-exp
// could not say that its l counts Lkv uniform weights; the backward reads
// the marker as that uniform average (csrc/flash_attention_bwd.cu).  With a
// null pointer (serving) nothing else changes: the output is the same bits.
//
// The launch goes on the caller's stream; the entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;   // the reference's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* stats;                     // (B, Hq, Lq) or null
  int Hq, Hkv, Lq, Lkv;
  int causal, window, q_offset, kv_offset;
  float scale;
};

// Keys [j_lo, j_hi) hold every key that some row in [qp_first, qp_last]
// sees; `blind` says that some row of them sees none, and then the range is
// every key.
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

// ------------------------------------------------- f32: the CUDA cores ---
namespace f32k {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per kv tile
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;   // query rows per warp
constexpr int KPL = BK / 32;        // keys per lane in a tile

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BK * (D + 1) + BK * D + BQ * D + NWARPS * BK);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_f32(const Params p) {
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

  const float* q = static_cast<const float*>(p.q) + ((int64_t)bh * p.Lq + q0) * D;
  const int64_t kv_base = (int64_t)(b * p.Hkv + hkv) * p.Lkv * D;
  const float* k = static_cast<const float*>(p.k) + kv_base;
  const float* v = static_cast<const float*>(p.v) + kv_base;
  float* o = static_cast<float*>(p.o) + ((int64_t)bh * p.Lq + q0) * D;
  float* stats = p.stats ? p.stats + (int64_t)bh * p.Lq + q0 : nullptr;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    Qs[i] = i / D < nq ? q[i] : 0.f;
  }

  const int qp_first = p.q_offset + q0;
  const KeyRange keys = key_range(p, qp_first, qp_first + nq - 1);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[r][x] = 0.f;
  }

  for (int k0 = (keys.lo / BK) * BK; k0 < keys.hi; k0 += BK) {
    const int nk = min(BK, p.Lkv - k0);
    __syncthreads();                   // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int j = i / D;
      const bool in = j < nk;
      Ks[j * KS + i % D] = in ? k[(int64_t)k0 * D + i] : 0.f;
      Vs[i] = in ? v[(int64_t)k0 * D + i] : 0.f;
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
        if (d < D) o[(int64_t)r * D + d] = acc[rr][x] / den;
      }
      if (stats && lane == 0) {
        stats[r] = m[rr] <= 0.5f * NEG_INF ? NEG_INF : m[rr] + logf(l[rr]);
      }
    }
  }
}

}  // namespace f32k

// ---------------------------------------------- bf16: the tensor cores ---
namespace tc {

using namespace hopper;

// Tile shape: one warpgroup, a 2-stage ring (timed faster on the H100 than
// two warpgroups or three stages; PERF.md has the times).
constexpr int NW = 4;               // warps per block: one warpgroup
constexpr int STAGES = 2;           // K/V tiles in the shared-memory ring
constexpr int BK = 64;              // keys per kv tile
constexpr int THREADS = NW * 32;
constexpr int BQ = NW * 16;         // query rows per block

// Q's shared-memory row: D bf16 values plus 16 bytes of padding, so the 8
// rows one ldmatrix phase reads fall in 8 different groups of 4 banks.
template <int D>
__host__ __device__ constexpr int q_stride() { return D + 8; }

// K and V tiles sit in shared memory in the 128-byte swizzled layout that
// wgmma's matrix descriptors read: per 64-column slab of the head dim (an
// "atom column"), BK rows of 128 bytes, row r's 16-byte chunk c stored at
// chunk c ^ (r % 8); every 8 rows start on a 1024-byte boundary.  D < 64
// fills the first 2D bytes of each row.
template <int D>
__host__ __device__ constexpr int atom_cols() { return (D + 63) / 64; }

template <int D>
__host__ __device__ constexpr int tile_bytes() { return BK * 128 * atom_cols<D>(); }

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)2 * STAGES * tile_bytes<D>() +
         sizeof(__nv_bfloat16) * (size_t)BQ * q_stride<D>();
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bf16(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int SD = q_stride<D>();
  constexpr int KD = D / 16;           // k-steps of S = Q K^T
  constexpr int NT = BK / 8;           // 8-key column blocks of S
  constexpr int KT = BK / 16;          // k-steps of O += P V
  constexpr int CPR = D / 8;           // 16-byte chunks per row
  constexpr int NB = D == 64 ? 32 : D; // dims per P V wgmma (see below)
  constexpr int TB = tile_bytes<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t base = smem_addr(tc_smem);
  const uint32_t ring = (base + 1023) & ~1023u;   // K [STAGES][TB], then V
  const uint32_t kring = ring, vring = ring + STAGES * TB;
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem + (ring - base) + 2 * STAGES * TB);

  const int bh = blockIdx.x;           // b * Hq + hq
  const int b = bh / p.Hq;
  const int hkv = (bh % p.Hq) / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int nq = min(BQ, p.Lq - q0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const bf16* q = static_cast<const bf16*>(p.q) + ((int64_t)bh * p.Lq + q0) * D;
  const int64_t kv_base = (int64_t)(b * p.Hkv + hkv) * p.Lkv * D;
  const bf16* k = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* v = static_cast<const bf16*>(p.v) + kv_base;
  bf16* o = static_cast<bf16*>(p.o) + ((int64_t)bh * p.Lq + q0) * D;
  float* stats = p.stats ? p.stats + (int64_t)bh * p.Lq + q0 : nullptr;

  // The kv tiles the block visits; every warp of a warpgroup takes part in
  // each wgmma, so a warp's 16 rows are masked per element, not skipped.
  const int qp_first = p.q_offset + q0;
  const KeyRange keys = key_range(p, qp_first, qp_first + nq - 1);
  const int w0 = warp * 16;            // the warp's first row in the block
  const int wq_first = qp_first + w0;
  const int wq_last = wq_first + 15;
  const int t_lo = keys.lo / BK;
  const int n_tiles = (keys.hi + BK - 1) / BK - t_lo;

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    const int nk = min(BK, p.Lkv - k0);
#pragma unroll
    for (int i = 0; i < (BK * CPR + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (BK * CPR % THREADS && c >= BK * CPR) break;
      const int row = c / CPR, chunk = c % CPR;
      const bool in = row < nk;
      const int64_t src = (int64_t)(k0 + (in ? row : 0)) * D + chunk * 8;
      const uint32_t dst = buf * TB + swz<BK>(row, chunk);
      cp_async16(kring + dst, k + src, in);
      cp_async16(vring + dst, v + src, in);
    }
  };

  // Prologue: Q, then the first STAGES-1 kv tiles, one commit group each.
#pragma unroll
  for (int i = 0; i < (BQ * CPR + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (BQ * CPR % THREADS && c >= BQ * CPR) break;
    const int row = c / CPR, col = (c % CPR) * 8;
    const bool in = row < nq;
    cp_async16(smem_addr(Qs + row * SD + col),
               q + (int64_t)(in ? row : 0) * D + col, in);
  }
  cp_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(t_lo + st, st);
    cp_commit();
  }
  cp_wait<STAGES - 1>();               // Q has landed
  __syncthreads();

  uint32_t qf[KD][4];                  // Q as wgmma A fragments
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qf[kk], smem_addr(Qs + (w0 + (lane & 15)) * SD + kk * 16 +
                              (lane >> 4) * 8));
  }

  float acc[D / 2];
  float m[2] = {NEG_INF, NEG_INF};     // rows g and g+8
  float l[2] = {0.f, 0.f};             // this lane's columns only
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = p.scale * 1.4426950408889634f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();             // tile it has landed ...
    // ... through the generic proxy; wgmma reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                   // ... for every thread, and tile it-1
                                       // is consumed: refill its buffer
    if (it + STAGES - 1 < n_tiles) {
      load_kv(t_lo + it + STAGES - 1, (it + STAGES - 1) % STAGES);
    }
    cp_commit();

    const int k0 = (t_lo + it) * BK;
    const uint32_t kt_addr = kring + (it % STAGES) * TB;
    const uint32_t vt_addr = vring + (it % STAGES) * TB;

    // S = Q K^T.  K is K-major: a k-step of 16 dims is 32 bytes along the
    // swizzled rows, a new atom column every 4 steps; 8-row groups 1024
    // bytes apart.
    float s[NT * 4];
    own(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_rs<BK, 0>(s, qf[kk],
                      desc(kt_addr + (kk >> 2) * (BK * 128) + (kk & 3) * 32,
                           16, 1024),
                      kk > 0);
    }
    wg_commit();
    wg_wait0();
    own(s);
    own(qf);

    // Scale into the log2 domain, mask only a tile that needs it, and
    // update the online softmax.
    const bool masked =
        k0 + BK > p.Lkv ||
        (p.causal && p.kv_offset + k0 + BK - 1 > wq_first) ||
        (p.window && p.kv_offset + k0 <= wq_last - p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      const int r = (i >> 1) & 1;
      float x = s[i] * scale_log2;
      if (masked) {
        const int j = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
        const int qpos = wq_first + g + 8 * r;
        const int kpos = p.kv_offset + j;
        bool seen = true;
        if (p.causal) seen = seen && kpos <= qpos;
        if (p.window) seen = seen && kpos > qpos - p.window;
        x = j < p.Lkv ? (seen ? x : NEG_INF) : -INFINITY;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      s[i] = exp2_approx(s[i] - mx[(i >> 1) & 1]);
      rsum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V, P in registers: the S accumulator of key blocks 2kt and
    // 2kt+1 is the A fragment of keys 16kt .. 16kt+15.  V is MN-major (dims
    // contiguous, transposed by the instruction): a k-step of 16 keys is two
    // 1024-byte row groups, atom columns BK * 128 bytes apart.  At D = 64 the
    // product goes in two n32 column blocks.  Issued as one m64n64k16, ptxas
    // (-O1 and -O3, not -O0) packed P into the registers that hold Q's
    // fragments, which the next tile's S still reads, so S went wrong from
    // the second kv tile on.  A register-allocation fault, not a rule of the
    // instructions: the same two products alone in a small kernel are right,
    // and so is this kernel when Q's fragments are reloaded every tile.  The
    // n32 halves keep P in S's own accumulator registers (SASS read on the
    // H100; PERF.md).
    uint32_t pa[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kt][x] = pack_bf16(s[8 * kt + 2 * x], s[8 * kt + 2 * x + 1]);
      }
    }
    own(acc);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int nb = 0; nb < D / NB; ++nb) {
        wgmma_rs<NB, 1>(*reinterpret_cast<float(*)[NB / 2]>(&acc[nb * NB / 2]),
                        pa[kt],
                        desc(vt_addr + kt * 2048 + nb * NB * 2, BK * 128, 1024), 1);
      }
    }
    wg_commit();
    wg_wait0();
    own(acc);
    own(pa);
  }
  cp_wait<0>();

  // Epilogue: O / l in f32, rounded to bf16, staged through the warp's own
  // rows of Qs (only this warp read them), stored as 16-byte rows.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(lsum, 1e-30f);
    const int row = w0 + g + 8 * r;
    if (stats && t4 == 0 && row < nq) {
      stats[row] = m[r] <= 0.5f * NEG_INF
                       ? NEG_INF
                       : (m[r] + log2f(lsum)) * 0.6931471805599453f;
    }
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(Qs + (w0 + g + 8 * r) * SD + col) =
          pack_bf16(acc[4 * dt + 2 * r] * inv[r], acc[4 * dt + 2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int c = lane + 32 * i;
    const int row = w0 + c / CPR, col = (c % CPR) * 8;
    if (row < nq) {
      *reinterpret_cast<uint4*>(o + (int64_t)row * D + col) =
          *reinterpret_cast<const uint4*>(Qs + row * SD + col);
    }
  }
}

}  // namespace tc

// One instance per (dtype, D): its kernel, block rows, threads and dynamic
// shared memory.
template <int D, bool BF16>
struct Instance {
  static constexpr int bq = BF16 ? tc::BQ : f32k::BQ;
  static constexpr int threads = BF16 ? tc::THREADS : f32k::THREADS;
  static constexpr size_t smem = BF16 ? tc::smem_bytes<D>() : f32k::smem_bytes<D>();
  static void (*kernel())(Params) {
    if constexpr (BF16) return tc::flash_bf16<D>;
    else return f32k::flash_f32<D>;
  }
};

template <int D, bool BF16>
int launch(const Params& p, int B, cudaStream_t stream) {
  using I = Instance<D, BF16>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        I::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)I::smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)(B * p.Hq), (unsigned)((p.Lq + I::bq - 1) / I::bq));
  I::kernel()<<<grid, I::threads, I::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, bool BF16>
int describe(int* out) {
  using I = Instance<D, BF16>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, I::kernel());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(I::kernel(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)I::smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, I::kernel(),
                                                      I::threads, I::smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = I::bq;
  out[1] = I::threads;
  out[2] = (int)I::smem;
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

// q (B, Hq, Lq, D), k and v (B, Hkv, Lkv, D), o like q; contiguous, one
// dtype (is_bf16: bf16, else f32), bf16 pointers 16-byte aligned.  D in
// {16, 32, 64, 128}; Hq % Hkv == 0; Lq, Lkv >= 1; B * Hq < 2^31 and
// ceil(Lq / 64) < 65536.  stats: null, or f32 (B, Hq, Lq) for the rows'
// log-sum-exp (see the note above).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               float* stats, int B, int Hq, int Hkv, int Lq, int Lkv, int D,
               int is_bf16, int causal, int window, int q_offset,
               int kv_offset, void* stream) {
  Params p{q, k, v, o, stats, Hq, Hkv, Lq, Lkv, causal, window, q_offset,
           kv_offset, 1.0f / sqrtf((float)D)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<true>(p, B, D, st) : dispatch<false>(p, B, D, st);
}

// The instance for (D, dtype): out[0..5] = block rows, threads, dynamic
// shared memory bytes, registers per thread, local (spill) bytes per
// thread, resident blocks per SM.
int fa_describe(int D, int is_bf16, int* out) {
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 32: return describe<16, false>(out);
    case 33: return describe<16, true>(out);
    case 64: return describe<32, false>(out);
    case 65: return describe<32, true>(out);
    case 128: return describe<64, false>(out);
    case 129: return describe<64, true>(out);
    case 256: return describe<128, false>(out);
    case 257: return describe<128, true>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
