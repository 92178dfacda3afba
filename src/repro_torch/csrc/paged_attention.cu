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
// (query head, position, dim): at MiniCPM-2B's shape (B=8, Hkv=36, D=64,
// 8 pages of 128 tokens, bf16) 75.6 MB, 22.6 us at 3.35 TB/s, against
// 0.076 GFLOP; at Qwen2-72B's heads (B=8, Hkv=8, G=8, D=128, 32 pages)
// 134.2 MB, 40 us, against 1.07 GFLOP.  Bound by the bytes: the design
// keeps enough 16-byte loads in flight on every SM to stream each K/V row
// once, and keeps the arithmetic off the issue slots that the loads need.
//
// Design: split-K ("flash-decoding"), two kernels.
// - paged_split_*, grid (split, kv head x head group, sequence).  A block
//   takes one kv head of one sequence over a span of split_len positions
//   (a multiple of the 64-position tile, chosen by kernel.py's split_plan
//   from the static shapes alone), and a group of the kv head's query
//   heads: 16 in bf16, 8 in f32 (a larger G takes more head groups, each
//   reading the span again; a smaller one leaves rows idle).  It walks its span in tiles of 64
//   positions; 16-byte cp.async copies bring each tile's K and V rows
//   into a ring of STAGES tiles in shared memory, so two tiles load while
//   one is computed.  Each thread copies one 16-byte chunk of a few rows
//   and reads a row's page id from the table in device memory when its
//   page changes (an id outside [0, P) reads what JAX's indexing reads: a
//   negative id counts from the end, then every id is clamped).  Every K
//   and V row loaded serves all the block's query heads.
// - bf16, paged_split_bf16: the tensor cores, mma.sync m16n8k16 with the
//   query heads as the 16 rows of A (padded with zero rows below G).  Each
//   of the 4 warps takes 16 positions of every tile and keeps its own
//   online softmax: S = Q K^T (K fragments by ldmatrix), the row max over
//   the quad, P = 2^(S - m) kept in registers as the A fragment of P V (V
//   fragments by ldmatrix.trans), the f32 accumulator 16 x D in
//   registers.  So a tile costs one block barrier, and at G = 8, D = 128
//   the 1.07 GFLOP take 64 mma a warp a tile instead of the issue slots of
//   some 3,000 FMAs and shuffles (the CUDA-core form of this design,
//   measured first, reached 0.38 of the bound there and 0.55 at
//   MiniCPM-2B).  The tile is stored with its 16-byte chunks XOR-swizzled
//   within each 128-byte line, so the 8 rows an ldmatrix reads fall in 8
//   different bank quads.
// - f32, paged_split_f32: the CUDA cores (an mma on f32 inputs would round
//   them to TF32).  Thread t owns 16-byte chunk c = t % LPR of every row
//   (LPR = D / 4) and rows r, r + RG, ... of the tile (r = t / LPR, RG =
//   128 / LPR), its slice of the query heads (pre-scaled by log2(e) /
//   sqrt(D)) and of the accumulator in registers.  The LPR lanes of a row
//   sum their partial dots by a butterfly that halves the heads at each
//   step; the scores go to shared memory, one warp per head takes the
//   tile's max and exponentials, and P V accumulates into the registers.
//   Each lane reads whole consecutive rows, one chunk a lane: no bank
//   conflicts without a swizzle.
// - At the end a block merges its warps' or row groups' states and writes
//   its partial (acc, m, l) in f32 to the workspace (B, Hq, n_splits,
//   D + 2), or o itself when there is one split.  Positions past the live
//   length are not read; a span wholly past it writes the empty partial
//   (m = -1e30, l = 0, acc = 0) and exits.  A sequence with seq_len <= 0
//   scores every one of its NP * page positions -1e30, so it takes their
//   uniform average as the reference does, never NaN.
// - paged_merge, one thread per (b, h, d): m* = max_s m_s over the splits
//   in split order, o = sum_s acc_s 2^(m_s - m*) / sum_s l_s 2^(m_s - m*)
//   in q's dtype.  It is launched as a programmatic dependent of the
//   split kernel, so its launch overlaps the split kernel's last blocks.
//   Both kernels sum in a fixed order: two calls give the same bits.
//
// What this does about the single-pass kernel it replaces (one block of 4
// warps per (kv head, sequence), 288 blocks at MiniCPM-2B's decode and 64
// at Qwen2-72B's): the split multiplies the blocks; the ring keeps two
// 64-row tiles a block in flight instead of one dependent load; V is read
// 16 bytes a lane across whole rows, not 2 bytes a lane a position; the
// accumulator lives in registers, not shared memory; and K is read
// coalesced and once for all heads of its kv head.
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
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 64;            // positions a tile; split_len is a multiple
constexpr int BF16_HEADS = 16;      // query heads a bf16 block: mma's M
constexpr int F32_HEADS = 8;        // query heads an f32 block

// The copy layout of a tile, shared by both kernels: LPR 16-byte chunks a
// row; thread t copies chunk t % LPR of rows t / LPR + RG * k.  A ring of
// STAGES tiles of K and V: 3, or 2 where a stage would pass 32 KB.
template <typename T, int D>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int LPR = D / EPC;
  static constexpr int RG = THREADS / LPR;
  static constexpr int ROWS = TILE / RG;             // rows a thread copies
  static constexpr int ELEMS = TILE * D;
  static constexpr int STAGES = 2 * ELEMS * (int)sizeof(T) <= 32768 ? 3 : 2;
  static constexpr size_t RING_BYTES =
      (size_t)STAGES * 2 * ELEMS * sizeof(T);
  static_assert(LPR >= 2 && LPR <= 32 && 32 % LPR == 0, "row layout");
};

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of each matrix, row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 (.trans: rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Programmatic dependent launch: the split kernel lets paged_merge be
// scheduled early; paged_merge waits for the split kernel's memory.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int32_t* page_table;
  const int32_t* seq_lens;
  void* o;
  float* ws;
  int Hq, Hkv, G, GB, n_hg, P, page, NP, split_len, n_splits;
  float qscale;   // log2(e) / sqrt(D): scores in base 2
};

// What a block of paged_split_* works on.
struct Span {
  int split, hkv, b, n_g;      // n_g: live query heads of the block
  int64_t bh0;                 // (b, first query head) row of q and o
  int64_t s0, s1;              // positions [s0, s1) are read
  int n_tiles;
  bool blind;                  // seq_len <= 0: every position scores -1e30
};

__device__ __forceinline__ Span span_of(const Params& p) {
  Span s;
  s.split = blockIdx.x;
  s.hkv = blockIdx.y / p.n_hg;
  const int g0 = (blockIdx.y % p.n_hg) * p.GB;
  s.b = blockIdx.z;
  s.n_g = min(p.GB, p.G - g0);
  s.bh0 = (int64_t)s.b * p.Hq + (int64_t)s.hkv * p.G + g0;
  const int seq_len = p.seq_lens[s.b];
  const int64_t cap = (int64_t)p.NP * p.page;
  s.blind = seq_len <= 0;
  const int64_t n_read = s.blind ? cap : min((int64_t)seq_len, cap);
  s.s0 = (int64_t)s.split * p.split_len;
  s.s1 = min(s.s0 + p.split_len, n_read);
  s.n_tiles = s.s1 > s.s0 ? (int)((s.s1 - s.s0 + TILE - 1) / TILE) : 0;
  return s;
}

// Element d of head g's result of the block: o = acc / l when the plan
// has one split, else the partial (acc, m, l) in the workspace.
template <typename T, int D>
__device__ __forceinline__ void write_head(const Params& p, const Span& s,
                                           int g, int d, float m, float l,
                                           float acc) {
  const int64_t bh = s.bh0 + g;
  if (p.n_splits == 1) {
    store(static_cast<T*>(p.o) + bh * D + d, acc / fmaxf(l, 1e-30f));
  } else {
    float* w = p.ws + (bh * p.n_splits + s.split) * (D + 2);
    w[d] = acc;
    if (d == 0) {
      w[D] = m;
      w[D + 1] = l;
    }
  }
}

// Copy chunk c of rows r, r + RG, ... of tile i into the ring; one commit
// group a call, empty past the last tile, so the waits count evenly.
// Swz(row, chunk) gives the chunk's element offset within the tile.
template <typename T, int D, typename Swz>
__device__ __forceinline__ void issue_tile(const Params& p, const Span& s,
                                           T* ring, int i, Swz swz) {
  using L = Tile<T, D>;
  if (i < s.n_tiles) {
    const int t = threadIdx.x;
    const int c = t % L::LPR;
    const int r = t / L::LPR;
    T* ks = ring + (i % L::STAGES) * 2 * L::ELEMS;
    T* vs = ks + L::ELEMS;
    const T* kp = static_cast<const T*>(p.k_pages);
    const T* vp = static_cast<const T*>(p.v_pages);
    const int32_t* table = p.page_table + (int64_t)s.b * p.NP;
    const int64_t row_stride = (int64_t)p.Hkv * D;
    const int pos0 = (int)(s.s0 + (int64_t)i * TILE) + r;
    int pg = pos0 / p.page;                    // one division a tile; the
    int rem = pos0 - pg * p.page;              // next rows step by RG
    int last = -1, pid = 0;
#pragma unroll
    for (int k = 0; k < L::ROWS; ++k) {
      if (k > 0) {
        rem += L::RG;
        while (rem >= p.page) {
          rem -= p.page;
          ++pg;
        }
      }
      const bool live = pos0 + L::RG * k < s.s1;
      int64_t off = c * L::EPC;
      if (live) {
        if (pg != last) {
          pid = __ldg(table + pg);
          if (pid < 0) pid += p.P;             // JAX's indexing: from the
          pid = min(max(pid, 0), p.P - 1);     // end, then clamped
          last = pg;
        }
        off += ((int64_t)pid * p.page + rem) * row_stride +
               (int64_t)s.hkv * D;
      }
      const int so = swz(r + L::RG * k, c);
      cp_async16(smem_addr(ks + so), kp + off, live);
      cp_async16(smem_addr(vs + so), vp + off, live);
    }
  }
  cp_commit();
}

// The empty partial of a span wholly past the live length.
template <typename T, int D>
__device__ void write_empty(const Params& p, const Span& s) {
  for (int i = threadIdx.x; i < s.n_g * D; i += THREADS) {
    write_head<T, D>(p, s, i / D, i % D, NEG_INF, 0.f, 0.f);
  }
}

// ------------------------------------------------------ bf16: mma.sync ---

// Element offset of chunk c of a row of D bf16: the chunk index XORed
// with the row's place among the rows that share its 128-byte line's
// neighbours, so the 8 consecutive rows an ldmatrix reads hit 8 quads.
template <int D>
__device__ __forceinline__ int swz_bf16(int row, int c) {
  constexpr int LPR = D / 8;
  constexpr int SH = LPR >= 8 ? 0 : LPR == 4 ? 1 : 2;
  constexpr int MASK = (LPR >= 8 ? 8 : LPR) - 1;
  return row * D + ((c ^ ((row >> SH) & MASK)) << 3);
}

template <int D>
constexpr size_t smem_bf16() {
  return Tile<__nv_bfloat16, D>::RING_BYTES;
}

template <int D>
__global__ void __launch_bounds__(THREADS) paged_split_bf16(const Params p) {
  using L = Tile<__nv_bfloat16, D>;
  constexpr int KT = D / 16;       // k-steps of Q K^T
  constexpr int NT = D / 8;        // n-tiles of P V
  constexpr int RS = D + 2;        // a row of the merge buffer
  static_assert(NWARPS * BF16_HEADS * RS * sizeof(float) <= L::RING_BYTES,
                "merge buffer");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  launch_dependents();
  const Span s = span_of(p);
  if (s.n_tiles == 0) {
    write_empty<__nv_bfloat16, D>(p, s);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;         // fragment rows g and g + 8
  const int tq = lane & 3;         // fragment columns 2 tq, 2 tq + 1
  const auto swz = [](int row, int c) { return swz_bf16<D>(row, c); };

  // Q as A fragments, 16 rows (heads past n_g are zero), unscaled
  uint32_t qa[KT][4];
  {
    const __nv_bfloat16* q =
        static_cast<const __nv_bfloat16*>(p.q) + s.bh0 * D;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = g + 8 * (x & 1);
        const int col = 16 * kk + 8 * (x >> 1) + 2 * tq;
        qa[kk][x] = row < s.n_g
            ? *reinterpret_cast<const uint32_t*>(q + row * D + col) : 0u;
      }
    }
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  }
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};       // this thread's columns; summed at the end

#pragma unroll
  for (int i = 0; i < L::STAGES - 1; ++i) {
    issue_tile<__nv_bfloat16, D>(p, s, ring, i, swz);
  }
  for (int i = 0; i < s.n_tiles; ++i) {
    cp_wait<L::STAGES - 2>();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    issue_tile<__nv_bfloat16, D>(p, s, ring, i + L::STAGES - 1, swz);
    const __nv_bfloat16* ks = ring + (i % L::STAGES) * 2 * L::ELEMS;
    const __nv_bfloat16* vs = ks + L::ELEMS;
    const int row0 = 16 * warp;    // this warp's 16 positions of the tile
    const int mat = lane >> 3;

    // S = Q K^T over the warp's positions: two n-tiles of 8
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, smem_addr(ks + swz_bf16<D>(row0 + 8 * (mat >> 1) +
                                                 (lane & 7),
                                             2 * kk + (mat & 1))));
      mma(sc[0], qa[kk], kb[0], kb[1]);
      mma(sc[1], qa[kk], kb[2], kb[3]);
    }
    // base 2; -inf past the live length, -1e30 for a blind sequence
    const int64_t base = s.s0 + (int64_t)i * TILE + row0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool live = base + 8 * nt + (x & 1) < s.s1;
        sc[nt][x] = live ? (s.blind ? NEG_INF : sc[nt][x] * p.qscale)
                         : -INFINITY;
      }
    }
    // the warp's online softmax, row g (x = 0, 1) and row g + 8 (x = 2, 3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = quad_max(fmaxf(fmaxf(sc[0][2 * h], sc[0][2 * h + 1]),
                                      fmaxf(sc[1][2 * h], sc[1][2 * h + 1])));
      const float m_new = fmaxf(m_r[h], mx);
      const float alpha = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int x = 2 * h; x < 2 * h + 2; ++x) {
          sc[nt][x] = exp2f(sc[nt][x] - m_new);
          sum += sc[nt][x];
        }
      }
      l_r[h] = l_r[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    // P as the A fragment over the warp's 16 positions, then O += P V
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t vb[4];
      ldsm_x4_t(vb, smem_addr(vs + swz_bf16<D>(row0 + 8 * (mat & 1) +
                                                   (lane & 7),
                                               2 * nd + (mat >> 1))));
      mma(o[2 * nd], pa, vb[0], vb[1]);
      mma(o[2 * nd + 1], pa, vb[2], vb[3]);
    }
  }
  cp_wait<0>();
  __syncthreads();     // the ring is free for the merge of the warps

  float* red = reinterpret_cast<float*>(smem);   // [NWARPS][16][RS]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(l_r[h]);
    float* w = red + (warp * BF16_HEADS + g + 8 * h) * RS;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      w[8 * n + 2 * tq] = o[n][2 * h];
      w[8 * n + 2 * tq + 1] = o[n][2 * h + 1];
    }
    if (tq == 0) {
      w[D] = m_r[h];
      w[D + 1] = l;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s.n_g * D; i += THREADS) {
    const int hd = i / D;
    const int d = i % D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      m = fmaxf(m, red[(w * BF16_HEADS + hd) * RS + D]);
    }
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* r = red + (w * BF16_HEADS + hd) * RS;
      const float sc = exp2f(r[D] - m);
      l = fmaf(r[D + 1], sc, l);
      a = fmaf(r[d], sc, a);
    }
    write_head<__nv_bfloat16, D>(p, s, hd, d, m, l, a);
  }
}

// ------------------------------------------------------- f32: CUDA cores ---

template <int D>
constexpr size_t smem_f32() {
  // the K/V ring, then the scores [heads][TILE] and m, l, alpha [heads]
  return Tile<float, D>::RING_BYTES +
         sizeof(float) * (F32_HEADS * TILE + 3 * F32_HEADS);
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

template <int D>
__global__ void __launch_bounds__(THREADS) paged_split_f32(const Params p) {
  using L = Tile<float, D>;
  constexpr int GB = F32_HEADS;
  constexpr int LPR = L::LPR, RG = L::RG;
  constexpr int NV = GB / LPR > 1 ? GB / LPR : 1;   // heads a lane sums
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* Sc = reinterpret_cast<float*>(smem + L::RING_BYTES);  // [GB][TILE]
  float* Ms = Sc + GB * TILE;
  float* Ls = Ms + GB;
  float* Al = Ls + GB;
  launch_dependents();
  const Span s = span_of(p);
  if (s.n_tiles == 0) {
    write_empty<float, D>(p, s);
    return;
  }
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int c = t % LPR;           // this thread's chunk of a row
  const int r = t / LPR;           // and its row group
  const auto swz = [](int row, int ch) { return row * D + ch * 4; };

  float qr[GB][4];
  float acc[GB][4];
  {
    const float* q = static_cast<const float*>(p.q) + s.bh0 * D + c * 4;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < s.n_g) x = __ldg(reinterpret_cast<const float4*>(q + g * D));
      qr[g][0] = x.x * p.qscale;
      qr[g][1] = x.y * p.qscale;
      qr[g][2] = x.z * p.qscale;
      qr[g][3] = x.w * p.qscale;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
    }
  }
  if (t < GB) {
    Ms[t] = NEG_INF;
    Ls[t] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < L::STAGES - 1; ++i) {
    issue_tile<float, D>(p, s, ring, i, swz);
  }
  for (int i = 0; i < s.n_tiles; ++i) {
    cp_wait<L::STAGES - 2>();
    __syncthreads();   // tile i landed; tile i - 1's P V is done everywhere
    issue_tile<float, D>(p, s, ring, i + L::STAGES - 1, swz);
    const float* ks = ring + (i % L::STAGES) * 2 * L::ELEMS;
    const float* vs = ks + L::ELEMS;
    const int64_t base = s.s0 + (int64_t)i * TILE;

    // scores, base 2: -inf past the live length, -1e30 for a blind sequence
#pragma unroll
    for (int k = 0; k < L::ROWS; ++k) {
      const int row = r + RG * k;
      const float4 x = *reinterpret_cast<const float4*>(ks + row * D + c * 4);
      float v[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        v[g] = fmaf(qr[g][0], x.x, fmaf(qr[g][1], x.y,
               fmaf(qr[g][2], x.z, qr[g][3] * x.w)));
      }
      int head = 0;
      butterfly<GB, GB, LPR / 2>(v, lane, head);
      const bool live = base + row < s.s1;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        Sc[(head + e) * TILE + row] =
            live ? (s.blind ? NEG_INF : v[e]) : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w takes heads w, w + NWARPS, ...
    for (int g = warp; g < GB; g += NWARPS) {
      float* sg = Sc + g * TILE;
      const float a0 = sg[lane];
      const float a1 = sg[lane + 32];
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a0, a1)));
      const float e0 = exp2f(a0 - m_new);
      const float e1 = exp2f(a1 - m_new);
      sg[lane] = e0;
      sg[lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      __syncwarp();                            // every lane has read Ms[g]
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        Al[g] = alpha;
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + sum;
      }
    }
    __syncthreads();

    // P V into the registers
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float alpha = Al[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int k = 0; k < L::ROWS; ++k) {
      const int row = r + RG * k;
      const float4 x = *reinterpret_cast<const float4*>(vs + row * D + c * 4);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float pj = Sc[g * TILE + row];
        acc[g][0] = fmaf(pj, x.x, acc[g][0]);
        acc[g][1] = fmaf(pj, x.y, acc[g][1]);
        acc[g][2] = fmaf(pj, x.z, acc[g][2]);
        acc[g][3] = fmaf(pj, x.w, acc[g][3]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();     // the ring is free for the reduction

  // the row groups of a warp, then the warps through shared memory
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem);   // [NWARPS][GB][D]
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(warp * GB + g) * D + c * 4 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = t; i < s.n_g * D; i += THREADS) {
    const int g = i / D;
    const int d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += red[(w * GB + g) * D + d];
    write_head<float, D>(p, s, g, d, Ms[g], Ls[g], a);
  }
}

// --------------------------------------------------------------- merge ---

template <typename T>
__global__ void __launch_bounds__(256) paged_merge(const float* ws, T* o,
                                                   int64_t n, int D,
                                                   int n_splits) {
  wait_prerequisites();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* w = ws + (i / D) * n_splits * (D + 2);
  const int d = (int)(i % D);
  float m = NEG_INF;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, w[s * (D + 2) + D]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* ws_s = w + s * (D + 2);
    const float sc = exp2f(ws_s[D] - m);
    l = fmaf(ws_s[D + 1], sc, l);
    a = fmaf(ws_s[d], sc, a);
  }
  store(o + i, a / fmaxf(l, 1e-30f));
}

// ------------------------------------------------------------- launch ---

template <typename T, typename K>
int launch(K kernel, size_t smem, const Params& p, int B, int D,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)p.n_splits, (unsigned)(p.Hkv * p.n_hg),
                  (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return (int)err;
  const int64_t n = (int64_t)B * p.Hq * D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_merge<T>, (const float*)p.ws,
                           static_cast<T*>(p.o), n, D, p.n_splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename K>
int describe(K kernel, size_t smem, int stages, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = THREADS;
  out[1] = stages;
  out[2] = (int)smem;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = blocks;
  return 0;
}

// F(kernel, shared memory, ring stages) for the split kernel of (is_bf16,
// D).
template <typename F>
int instance(int is_bf16, int D, F f) {
#define PA_CASE(d)                                                        \
  case d:                                                                 \
    return is_bf16 ? f(paged_split_bf16<d>, smem_bf16<d>(),               \
                       Tile<__nv_bfloat16, d>::STAGES)                    \
                   : f(paged_split_f32<d>, smem_f32<d>(),                 \
                       Tile<float, d>::STAGES);
  switch (D) {
    PA_CASE(16) PA_CASE(32) PA_CASE(64) PA_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

extern "C" {

// q (B, Hq, D); k_pages, v_pages (P, page, Hkv, D); o like q; one dtype
// (is_bf16: bf16, else f32), contiguous, 16-byte aligned.  page_table
// (B, NP) and seq_lens (B,) int32 on the device.  ws: f32 (B, Hq,
// n_splits, D + 2), unused when n_splits == 1.  The span split_len is a
// multiple of 64 and n_splits * split_len covers NP * page.  D in {16,
// 32, 64, 128}; Hq % Hkv == 0; B < 65536; Hkv * ceil(G / 8) < 65536;
// NP * page < 2^30.
int pa_forward(const void* q, const void* k_pages, const void* v_pages,
               const int32_t* page_table, const int32_t* seq_lens, void* o,
               float* ws, int B, int Hq, int Hkv, int D, int P, int page,
               int NP, int split_len, int n_splits, int is_bf16,
               void* stream) {
  if (split_len <= 0 || split_len % TILE || n_splits <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = Hq / Hkv;
  const int GB = is_bf16 ? BF16_HEADS : F32_HEADS;
  const Params p{q, k_pages, v_pages, page_table, seq_lens, o, ws,
                 Hq, Hkv, G, GB, (G + GB - 1) / GB, P, page, NP, split_len,
                 n_splits, LOG2E / sqrtf((float)D)};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return instance(is_bf16, D, [&](auto kernel, size_t smem, int) {
    return is_bf16 ? launch<__nv_bfloat16>(kernel, smem, p, B, D, st)
                   : launch<float>(kernel, smem, p, B, D, st);
  });
}

// The split kernel's instance for (D, dtype): out = threads, ring stages,
// dynamic shared memory, registers and local (spill) bytes a thread,
// resident blocks per SM.
int pa_describe(int D, int is_bf16, int* out) {
  return instance(is_bf16, D, [&](auto kernel, size_t smem, int stages) {
    return describe(kernel, smem, stages, out);
  });
}

}  // extern "C"
