// The body of K1, cvla_shared_prefix_gqa (attention.cu): decode attention of
// the pi0 action expert on Hopper, with warpgroup products (wgmma) fed
// through a TMA ring, and the prefix keys split over the blocks of a
// thread-block cluster.
//
// Replaces cover_vla_tpu/ops/pallas_attention.py pallas_shared_prefix_gqa
// (_shared_prefix_kernel). The rows of a (batch, kv-head) pair are its
// N*S*G suffix query rows, candidate-major (row = (n * S + s) * G + g).
// Each attends the shared prefix (the prefill's KV cache: P keys, padded
// keys masked) and its own candidate's S suffix keys under the S x S
// suffix mask, in one softmax. The prefix is never replicated over
// candidates, and no score or mask tensor reaches device memory.
//
// Bound on the H100 at the E=16 x N=16 step (B=16, N=16, S=5, G=8, Hkv=1,
// D=256, P=328): q 5.2 MB, prefix K/V 5.4 MB, suffix K/V 1.3 MB, output
// 5.2 MB, 3.5 GFLOP: ~5 us of memory traffic against ~3.5 us of bf16
// tensor-core time, memory bound. What held the earlier mma.sync body
// back (0.053 ms in a graph on the H100) was too little in flight (160
// blocks of 4 warps), the prefix crossing from L2 into shared memory once
// per 64 rows, and synchronous glue around small tiles.
//
// Design. A block is two warpgroups of 64 query rows each (128 rows of one
// pair). K and V arrive as 64-key tiles through TMA into a ring of stages
// guarded by mbarriers (tma.cuh): "full" completes when a tile's bytes
// have landed, "empty" when all 8 warps are done with it, and then warp 0
// loads the tile that reuses the stage; no __syncthreads in the key loop.
// Both warpgroups read every stage, so the prefix crosses from L2 once per
// 128 rows. A warpgroup issues S = Q K^T with both operands in shared
// memory (its Q tile, copied once with cp.async), an fp32 online softmax
// in the base-2 domain (scores pre-scaled by D^-0.5 log2 e, ex2.approx),
// and O += P V with P as the register A operand and V read through the
// transposed-B descriptor, in score fragments of 32 keys (two a stage):
// beside O's 128 fp32 registers at D = 256 a 32-key fragment keeps the
// warpgroup inside its 255 registers without spills or serialised
// products (a 64-key one, or a separate producer warpgroup under
// setmaxnreg, did not). The fragments are pipelined as in flash_wgmma.cuh:
// the scores of the next and P V of this one are issued back to back, and
// the next softmax runs under P V. Tiles use wgmma's 128-byte swizzle
// (wgmma.cuh):
// 64-column slabs of 64 rows, 8 KB each, which is what TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B; head dims pad to 64, 128, 192 or 256 (TMA
// zero-fills columns past D and keys past P). Ring: 4 stages up to D = 128,
// 2 at 192 and 256 (Q 64 KB + ring 128 KB at 256).
//
// Key split. The prefix's 64-key tiles are cut into `split` parts of
// `tiles_per_part` tiles; the blocks of one 128-row tile and its parts
// form a cluster of `split` blocks, each running the loop over its own
// part. The last part also takes the suffix: per warpgroup, the
// candidates its 64 rows span (at most ceil(64 / (S G)) + 1) have
// (n_last - n_first + 1) * S keys, loaded 32 a round into one half of a
// ring stage (warpgroup 0 the first half, 1 the second) and multiplied with
// m64n32 products; a key is attended only by rows of its own candidate, and
// the suffix mask (S x S, in shared memory once a block) is looked up by
// position; the block-diagonal structure comes from indices. After the
// loop a block that ran the whole prefix (split 1) normalises its rows in
// registers, stages them as bf16 over its dead Q and stores 16 bytes a
// thread. With several parts each block writes its partial (m, l, O) in
// fp32 over its dead Q and ring, the cluster synchronises, and every block
// combines all parts for its own slice of the columns (its own partial
// read locally, the others' through distributed shared memory) and stores
// the bf16 result 16 bytes a thread. No second kernel and no device
// scratch.
//
// The split (cuda_attention.decode_plan, passed in by the wrapper): from
// the 128-row blocks R = B * Hkv * ceil(N S G / 128) and the prefix tiles
// T = ceil(P / 64), the split s <= 8 (with no empty part) that minimises
// ceil(R s / 132) * (ceil(T / s) + 3) + (s > 1) * s / 2, ties to the
// smaller s: waves of blocks on 132 SMs times the tiles a block runs plus
// its fixed work (launch, Q copy, suffix round, epilogue: about 3 tiles'
// time), plus the combine, about half a tile a part. The constants come
// from probe builds on the H100 (PERF.md, section 6). At the main shapes
// (T = 6):
//   bench    160 row tiles of 64 -> R = 80, s = 1: 80 blocks, 0.61 waves;
//   protocol  32 row tiles (the last of each pair 8 of its 200 rows)
//            -> R = 16, s = 3: 48 blocks, 0.36 waves;
//   cohort   128 row tiles -> R = 64, s = 2: 128 blocks, 0.97 waves.
//
// Rounding points, those of the plain twin: bf16 inputs, fp32 scores, p
// rounded to bf16 (nearest even) before P V, the row sum adds the rounded
// values, one division at the end. Each part takes p relative to its own
// running maximum, raised only when a tile exceeds it by 2^8; the combine
// rescales the parts' sums by 2^(m_part - m) in fp32.
// Masked keys (prefix padding, the suffix mask) score the finite kBigNeg;
// keys that do not exist for a row (past P, other candidates' suffix keys,
// past a candidate range) score -inf. A row with no attended key is then
// the uniform softmax over its own P + S keys, as in the twin and the
// eager path: its p are 1 while the maximum is kBigNeg, the first real
// score wipes them (2^(kBigNeg - m) = 0), and so does the combine.

#pragma once

#include <math.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kBigNeg = -2.3819763e38f;  // masking constant of the reference
constexpr float kRaise = 8.f;   // see flash_wgmma.cuh: the maximum is raised
                                // only past 2^8
constexpr int kWgRows = 64;     // query rows per warpgroup
constexpr int kCtaRows = 128;   // two warpgroups
constexpr int kTileKeys = 64;   // prefix keys per ring stage
constexpr int kSubKeys = 32;    // keys of one score fragment
constexpr int kSufKeys = 32;    // suffix keys per warpgroup per round
constexpr int kMaxSplit = 8;    // blocks of a cluster (portable size)
constexpr int kSlabRows = 64;   // rows of one 64-column slab of a tile
constexpr uint32_t kSlabBytes = kSlabRows * 128;

// Probe builds (scripts/torch_kernel_probe.py) switch parts of K1 off to see
// what a launch's time is made of; their results are wrong by construction
// and no entry point of the package defines them:
//   CVLA_PROBE_DECODE_NO_KV_READS  no TMA load is issued
//   CVLA_PROBE_DECODE_NO_PRODUCTS  no wgmma is issued
//   CVLA_PROBE_DECODE_NO_SOFTMAX   the scores are packed as they are
//   CVLA_PROBE_DECODE_NO_COMBINE   no partials are written or read
//   CVLA_PROBE_DECODE_NO_STORE     nothing is stored
//   CVLA_PROBE_DECODE_EXIT_AT_START  every block returns at once
//   CVLA_PROBE_DECODE_EXIT_AFTER_Q   ... once its Q tile, masks and
//                                    barriers are set (with NO_KV_READS)

struct DecodeParams {
  CUtensorMap kp, vp;  // prefix K/V as (D, Hkv, P, B), box (64, 1, 64, 1)
  CUtensorMap ks, vs;  // suffix K/V as (D, Hkv, B*N*S), box (64, 1, 32)
  const __nv_bfloat16* q;       // [B, N, S, Hkv * G, D]
  const uint8_t* prefix_pad;    // [B, P]
  const uint8_t* suffix_mask;   // [B, S, S]
  __nv_bfloat16* out;           // same layout as q
  int hkv, groups, rows, d, n_keys, n_cand, s_len;
  int row_ctas;        // 128-row blocks per (batch, kv-head) pair
  int split;           // blocks of a cluster = parts of the prefix
  int tiles_per_part;  // 64-key prefix tiles per part
  float scale_log2;    // D^-0.5 * log2(e)
};

template <int DP>
struct DecodeLayout {
  static constexpr int kSlabs = DP / 64;
  static constexpr uint32_t kQBytes = kSlabs * kSlabBytes;   // one warpgroup
  static constexpr uint32_t kKvBytes = kSlabs * kSlabBytes;  // K or V tile
  static constexpr int kStages = DP <= 128 ? 4 : 2;
  static constexpr uint32_t kStageBytes = 2 * kKvBytes;
  static constexpr int kOStride = DP + 8;  // floats a row of partial O
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kRing = 2 * kQBytes;
  static constexpr uint32_t kML = kRing + kStages * kStageBytes;
  static constexpr uint32_t kSMask = kML + kCtaRows * 8;
  static constexpr uint32_t kBars = kSMask + 32 * 32;
  static constexpr uint32_t kPad = kBars + 2 * kStages * 8;
  static_assert(size_t(kCtaRows) * kOStride * 4 <= kML,
                "partial O fits over Q and the ring");
  // bytes of dynamic shared memory: the layout, the prefix validity words
  // of one part, and slack to align the base to 1024 bytes
  static constexpr size_t bytes(int tiles_per_part) {
    return 1024 + kPad + size_t(tiles_per_part) * (kTileKeys / 32) * 4;
  }
};

// the thread's and the block's index as the hardware has them, read where
// the call stands (the compiler neither hoists nor keeps them)
__device__ __forceinline__ int read_tid() {
  int r;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int read_ctaid() {
  int r;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one online-softmax step over a tile of NK keys whose scores are already
// in the base-2 domain with masked keys at kBigNeg and absent keys at -inf;
// s[4 j + 2 h + e] is row h, key 8 j + 2 t + e. Leaves fp32 p in s and
// updates the running maximum, the row sum's rescale and alpha.
template <int NK>
__device__ __forceinline__ void softmax_tile(float (&s)[NK / 2], float (&m_i)[2],
                                             float (&l_i)[2], float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const bool raise = mx > m_i[h] + kRaise;
    alpha[h] = raise ? ex2_approx(m_i[h] - mx) : 1.f;
    m_i[h] = raise ? mx : m_i[h];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      s[4 * j + 2 * h] = ex2_approx(s[4 * j + 2 * h] - m_i[h]);
      s[4 * j + 2 * h + 1] = ex2_approx(s[4 * j + 2 * h + 1] - m_i[h]);
    }
    l_i[h] *= alpha[h];
  }
}

// p as the register A operand of P V, rounded to bf16; the row sum adds
// the rounded values
template <int NK>
__device__ __forceinline__ void pack_probs(const float (&s)[NK / 2],
                                           uint32_t (&pa)[NK / 16][4],
                                           float (&l_i)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      const uint32_t hi = pack_bf16x2(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
      pa[j / 2][(j % 2) * 2 + h] = hi;
      l_i[h] += __uint_as_float(hi << 16) + __uint_as_float(hi & 0xffff0000u);
    }
  }
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2],
                                        const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 2 * h] *= alpha[h];
        o[4 * j + 2 * h + 1] *= alpha[h];
      }
  }
}

// S[64 x NK] = Q K^T over depth DP: Q and the NK key rows at `k_tile` in
// shared memory, both K-major in 64-column slabs 8 KB apart
template <int DP, int NK>
__device__ __forceinline__ void issue_scores(float (&s)[NK / 2], uint32_t q_tile,
                                             uint32_t k_tile) {
#ifdef CVLA_PROBE_DECODE_NO_PRODUCTS
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = float(i + int(k_tile & 7u));
#else
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSlabBytes + (kk % 4) * 32;
    static_assert(NK == 32, "score fragments of 32 keys");
    wgmma_ss_n32(s, wgmma_desc_sw128(q_tile + off, 16, 1024),
                 wgmma_desc_sw128(k_tile + off, 16, 1024), kk > 0);
  }
#endif
  wgmma_commit();
}

// O[64 x DP] += P[64 x NK] V[NK x DP], V's NK rows at `v_tile`, read
// through the transposed-B descriptor: 1024 bytes between groups of 8 keys,
// slabs of 64 columns 8 KB apart
template <int DP, int NK>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[NK / 16][4],
                                         uint32_t v_tile) {
#ifdef CVLA_PROBE_DECODE_NO_PRODUCTS
#pragma unroll
  for (int kc = 0; kc < NK / 16; ++kc)  // keeps P's packing alive
    o[kc] += __uint_as_float((pa[kc][0] ^ pa[kc][1] ^ pa[kc][2] ^ pa[kc][3]) &
                             0x3fffffffu) + float(v_tile & 1u);
#else
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < NK / 16; ++kc)
#pragma unroll
    for (int sl = 0; sl < DP / 64; ++sl)
      wgmma_rs_n64(o + 32 * sl, pa[kc],
                   wgmma_desc_sw128(v_tile + kc * 2048 + sl * kSlabBytes,
                                    kSlabBytes, 1024));
#endif
  wgmma_commit();
}

constexpr int kThreads = 256;  // two warpgroups of 64 query rows

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
decode_wgmma_kernel(const __grid_constant__ DecodeParams p) {
  using L = DecodeLayout<DP>;
  constexpr int CPR = DP / 8;  // 16-byte chunks of a padded row
#ifdef CVLA_PROBE_DECODE_EXIT_AT_START
  if (p.rows > 0) return;
#endif
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sRing = base + L::kRing;
  const uint32_t sFull = base + L::kBars;
  const uint32_t sEmpty = sFull + L::kStages * 8;
  uint8_t* gSMask = gbase + L::kSMask;
  uint32_t* gPad = reinterpret_cast<uint32_t*>(gbase + L::kPad);

  // block -> (pair, 128-row tile, part); the parts of one row tile are a
  // cluster, and the row tiles of a pair are neighbours in the grid, so
  // blocks that run together read the same prefix from L2
  const int part = blockIdx.x % p.split;  // == the rank in the cluster
  const int cta = blockIdx.x / p.split;
  const int bh = cta / p.row_ctas;
  const int b = bh / p.hkv, kvh = bh % p.hkv;
  const int r0 = (cta % p.row_ctas) * kCtaRows;
  const int n_tiles = (p.n_keys + kTileKeys - 1) / kTileKeys;
  const int t_first = part * p.tiles_per_part;
  const int n_pre = min(p.tiles_per_part, n_tiles - t_first);
  // each warpgroup's candidates and suffix keys; the last part runs the
  // suffix rounds, as many as the warpgroup with more keys needs
  const int per_cand = p.s_len * p.groups;
  int n_first[2], n_suf[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int lo = min(r0 + w * kWgRows, p.rows - 1);
    const int hi = min(r0 + w * kWgRows + kWgRows - 1, p.rows - 1);
    n_first[w] = lo / per_cand;
    n_suf[w] = (hi / per_cand - n_first[w] + 1) * p.s_len;
  }
  const int n_rounds = part == p.split - 1
                           ? (max(n_suf[0], n_suf[1]) + kSufKeys - 1) / kSufKeys
                           : 0;
  const int n_items = n_pre + n_rounds;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  // the loads of ring item i (a prefix tile or a suffix round) into its
  // stage, completing on the stage's "full" barrier; issued by one thread
  auto load_item = [&](int i) {
    const int stage = i % L::kStages;
    const uint32_t full = sFull + 8 * stage;
    const uint32_t sK = sRing + stage * L::kStageBytes;
    const uint32_t sV = sK + L::kKvBytes;
#ifdef CVLA_PROBE_DECODE_NO_KV_READS
    mbar_arrive(full);
#else
    mbar_arrive_expect_tx(full, L::kStageBytes);
    if (i < n_pre) {
      const int j0 = (t_first + i) * kTileKeys;
      for (int sl = 0; sl < L::kSlabs; ++sl) {
        tma_load_4d(sK + sl * kSlabBytes, &p.kp, full, sl * 64, kvh, j0, b);
        tma_load_4d(sV + sl * kSlabBytes, &p.vp, full, sl * 64, kvh, j0, b);
      }
    } else {
      const int rd = i - n_pre;
      for (int w = 0; w < 2; ++w) {
        const int key0 =
            (b * p.n_cand + (w ? n_first[1] : n_first[0])) * p.s_len +
            rd * kSufKeys;
        const uint32_t half = w * kSufKeys * 128;
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          tma_load_3d(sK + sl * kSlabBytes + half, &p.ks, full, sl * 64, kvh,
                      key0);
          tma_load_3d(sV + sl * kSlabBytes + half, &p.vs, full, sl * 64, kvh,
                      key0);
        }
      }
    }
#endif
  };
  // after item i: once every warp has released its stage, thread 0 loads
  // the item that reuses it (warp 0 waits as a whole)
  auto refill = [&](int i) {
    if (tid < 32 && i + L::kStages < n_items) {
      mbar_wait(sEmpty + 8 * (i % L::kStages), (i / L::kStages) & 1);
      if (tid == 0) load_item(i + L::kStages);
      __syncwarp();
    }
  };

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(sFull + 8 * s, 1);
      mbar_init(sEmpty + 8 * s, 8);  // one arrival per warp
    }
    mbar_fence_init();
    tma_prefetch_map(&p.kp);
    tma_prefetch_map(&p.vp);
    tma_prefetch_map(&p.ks);
    tma_prefetch_map(&p.vs);
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(L::kStages, n_items); ++i) load_item(i);

  const int wt = tid & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hq = p.hkv * p.groups;
  const int rows_per_b = p.rows / p.groups;
  auto q_offset = [&](int r) -> size_t {
    return ((size_t(b) * rows_per_b + r / p.groups) * hq + kvh * p.groups +
            r % p.groups) * size_t(p.d);
  };

  // this warpgroup's Q tile, swizzled as TMA would write it; zero past the
  // last row and past D
  const int wr0 = r0 + wg * kWgRows;
  const uint32_t sQw = base + L::kQ + wg * L::kQBytes;
  for (int i = wt; i < kWgRows * CPR; i += 128) {
    const int rr = i / CPR, c = i % CPR;
    const int r = wr0 + rr;
    const bool valid = r < p.rows && c * 8 < p.d;
    cp_async_16(sQw + (c >> 3) * kSlabBytes + rr * 128 +
                    (((c & 7) ^ (rr & 7)) << 4),
                valid ? p.q + q_offset(r) + c * 8 : p.q, valid);
  }
  cp_async_commit_group();
  // the suffix mask, and one validity bit per prefix key of this part
  const int ss = p.s_len * p.s_len;
  for (int i = tid; i < ss; i += 256)
    gSMask[i] = p.suffix_mask[size_t(b) * ss + i];
  for (int w = warp; w < n_pre * (kTileKeys / 32); w += 8) {
    const int j = t_first * kTileKeys + 32 * w + lane;
    const bool v = j < p.n_keys && p.prefix_pad[size_t(b) * p.n_keys + j] != 0;
    const uint32_t word = __ballot_sync(0xffffffffu, v);
    if (lane == 0) gPad[w] = word;
  }
  cp_async_wait_group<0>();
  fence_proxy_async();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#ifdef CVLA_PROBE_DECODE_EXIT_AFTER_Q
#ifndef CVLA_PROBE_DECODE_NO_KV_READS
#error "EXIT_AFTER_Q leaves no TMA load in flight only with NO_KV_READS"
#endif
  if (p.rows > 0) return;
#endif

  // the two rows this thread holds in the accumulator fragments
  const int frag_row = (warp & 3) * 16 + g;  // in the warpgroup's 64
  int row_n[2], row_s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(wr0 + frag_row + 8 * h, p.rows - 1);
    row_n[h] = r / per_cand;
    row_s[h] = (r / p.groups) % p.s_len;
  }
  const int my_first = wg ? n_first[1] : n_first[0];
  const int my_suf = wg ? n_suf[1] : n_suf[0];

  float m_i[2] = {kBigNeg, kBigNeg};  // running maximum, base-2 domain
  float l_i[2] = {0.f, 0.f};          // this thread's share of the row sum
  float alpha[2];
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  // The block's keys as fragments of 32: two a prefix tile of this part,
  // then one a suffix round (the last part). A score fragment of 16
  // registers beside O's 128 keeps the warpgroup inside its register
  // budget. Fragment f's ring item, and where its K rows lie (V follows
  // kKvBytes later): a prefix half, or this warpgroup's half of a suffix
  // round.
  const int n_frag = 2 * n_pre + n_rounds;
  auto frag_item = [&](int f) { return f < 2 * n_pre ? f >> 1 : f - n_pre; };
  auto frag_keys = [&](int f) -> uint32_t {
    const int sub = f < 2 * n_pre ? (f & 1) : wg;
    return sRing + (frag_item(f) % L::kStages) * L::kStageBytes +
           sub * kSubKeys * 128;
  };
  // scores of fragment f into the base-2 domain, masked (kBigNeg) and
  // absent (-inf) keys marked, then one online-softmax step
  auto softmax_frag = [&](float (&s)[kSubKeys / 2], int f) {
#ifndef CVLA_PROBE_DECODE_NO_SOFTMAX
    if (f < 2 * n_pre) {
      const int j0 = t_first * kTileKeys + f * kSubKeys;
      const uint32_t word = gPad[f];
#pragma unroll
      for (int j = 0; j < kSubKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * t + e;
          const bool attended = (word >> key) & 1u;
          const bool absent = j0 + key >= p.n_keys;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = s[4 * j + 2 * h + e];
            s[4 * j + 2 * h + e] = absent     ? -INFINITY
                                   : attended ? v * p.scale_log2
                                              : kBigNeg;
          }
        }
    } else {
      const int rd = f - 2 * n_pre;
#pragma unroll
      for (int j = 0; j < kSufKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jk = rd * kSufKeys + 8 * j + 2 * t + e;
          const int cand = my_first + jk / p.s_len, pos = jk % p.s_len;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = s[4 * j + 2 * h + e];
            s[4 * j + 2 * h + e] =
                jk >= my_suf || cand != row_n[h] ? -INFINITY
                : gSMask[row_s[h] * p.s_len + pos] ? v * p.scale_log2
                                                   : kBigNeg;
          }
        }
    }
    softmax_tile<kSubKeys>(s, m_i, l_i, alpha);
#else
    alpha[0] = alpha[1] = 1.f;
#endif
  };

  // Pipelined as in flash_wgmma.cuh: in iteration f the scores of fragment
  // f + 1 and then P V of fragment f are issued back to back; the softmax
  // of f + 1 runs under P V of f, and its probabilities are packed into
  // the A registers once that product has stopped reading them. The scores
  // past the last fragment are issued too (on its own keys), unread:
  // products under a condition make the compiler serialise them.
  static_assert(kSufKeys == kSubKeys, "one fragment width");
  float s[kSubKeys / 2];
  uint32_t pa[kSubKeys / 16][4];
  mbar_wait(sFull, 0);
  issue_scores<DP, kSubKeys>(s, sQw, frag_keys(0));
  wgmma_wait<0>();
  wgmma_pin(s);
  softmax_frag(s, 0);
  pack_probs<kSubKeys>(s, pa, l_i);
  for (int f = 0; f < n_frag; ++f) {
    const int nf = f + 1;
    const bool more = nf < n_frag;
    const int item = frag_item(f), next = frag_item(more ? nf : f);
    if (next != item)  // the next fragment opens a ring item: wait for it
      mbar_wait(sFull + 8 * (next % L::kStages), (next / L::kStages) & 1);
    rescale<DP>(o, alpha);  // by fragment f's softmax; nothing in flight
    wgmma_pin(o);
    issue_scores<DP, kSubKeys>(s, sQw, frag_keys(more ? nf : f));
    issue_pv<DP, kSubKeys>(o, pa, frag_keys(f) + L::kKvBytes);
    wgmma_wait<1>();  // the scores
    wgmma_pin(s);
    if (more) softmax_frag(s, nf);
    wgmma_wait<0>();  // P V
    wgmma_pin(o);
    if (more) pack_probs<kSubKeys>(s, pa, l_i);
    if (!more || next != item) {  // done with this ring item
      if (lane == 0) mbar_arrive(sEmpty + 8 * (item % L::kStages));
      refill(item);
    }
  }

  // ---------------- epilogue ----------------------------------------------
  float l_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[h] = l;
  }
  // the block's indices, read anew: none of them holds a register through
  // the key loop, where O takes 128 of the thread's
  const int e_tid = read_tid(), e_blk = read_ctaid();
  const int e_part = e_blk % p.split, e_cta = e_blk / p.split;
  const int e_b = e_cta / p.row_ctas / p.hkv, e_kvh = e_cta / p.row_ctas % p.hkv;
  const int e_r0 = (e_cta % p.row_ctas) * kCtaRows;
  const int e_t = e_tid & 3;
  const int crow = (e_tid >> 7) * kWgRows + ((e_tid >> 5) & 3) * 16 +
                   ((e_tid & 31) >> 2);  // row in the block
  const uint32_t e_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = e_base + L::kQ;
  const uint32_t sML = e_base + L::kML;
  // both warpgroups are done with Q and the ring, which the epilogue reuses
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int n_chunks = p.d / 8;  // 16-byte chunks of an output row
  auto out_offset = [&](int r) -> size_t {
    return ((size_t(e_b) * (p.rows / p.groups) + r / p.groups) * p.hkv *
                p.groups + e_kvh * p.groups + r % p.groups) * size_t(p.d);
  };

  if (p.split == 1) {
    // one part: the row sums are final. Normalise in registers, stage the
    // bf16 rows over the dead Q (a row DP * 2 + 16 bytes apart: the
    // fragment stores of a warp hit 32 banks), store 16 bytes a thread.
    constexpr uint32_t kRowBytes = DP * 2 + 16;
    const uint32_t b_row = sO + crow * kRowBytes + e_t * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / fmaxf(l_row[h], 1e-37f);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        st_shared_u32(b_row + 8 * h * kRowBytes + 16 * j,
                      pack_bf16x2(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv));
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int it = e_tid; it < kCtaRows * n_chunks; it += 256) {
      const int row = it / n_chunks, c = it % n_chunks;
      const int r = e_r0 + row;
      if (r >= p.rows) continue;
      const uint4 v = ld_shared_u4(sO + row * kRowBytes + 16 * c);
#ifdef CVLA_PROBE_DECODE_NO_STORE
      if (v.x != 0xffffffffu) continue;
#endif
      *reinterpret_cast<uint4*>(p.out + out_offset(r) + 8 * c) = v;
    }
    return;
  }

#ifdef CVLA_PROBE_DECODE_NO_COMBINE
  {  // keeps O, and so the key loop, alive
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) sum += o[i];
    if (sum == 1.2345e30f) p.out[0] = __float2bfloat16(sum);
  }
#else
  // several parts: each block writes its partial (m, l, O) in fp32. 32-bit
  // shared addresses, one base a thread and constant offsets: the 128
  // stores leave no address in a register while O is live.
  const uint32_t o_row = sO + (crow * L::kOStride + 2 * e_t) * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      st_shared_f2(o_row + (8 * h * L::kOStride + 8 * j) * 4,
                   o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    if (e_t == 0) st_shared_f2(sML + 8 * (crow + 8 * h), m_i[h], l_row[h]);
  }
#endif
  cluster_sync();

  // this block's columns: a contiguous run of 8-column chunks, combined
  // over every part (its own read locally, the others' through
  // distributed shared memory)
  const int per = (n_chunks + p.split - 1) / p.split;
  const int c_first = e_part * per;
  const int n_mine = min(per, n_chunks - c_first);
  for (int it = e_tid; n_mine > 0 && it < kCtaRows * n_mine; it += 256) {
    const int row = it / n_mine, c = c_first + it % n_mine;
    const int r = e_r0 + row;
    if (r >= p.rows) continue;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#ifndef CVLA_PROBE_DECODE_NO_COMBINE
    // every part's (m, l) and O chunk, loads issued together
    float2 ml[kMaxSplit];
    float4 oa[kMaxSplit], ob[kMaxSplit];
    const uint32_t ml_at = sML + 8 * row;
    const uint32_t o_at = sO + (row * L::kOStride + 8 * c) * 4;
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) {
      if (k == e_part) {
        ml[k] = ld_shared_f2(ml_at);
        oa[k] = ld_shared_f4(o_at);
        ob[k] = ld_shared_f4(o_at + 16);
      } else if (k < p.split) {
        ml[k] = ld_cluster_f2(cluster_map(ml_at, k));
        const uint32_t src = cluster_map(o_at, k);
        oa[k] = ld_cluster_f4(src);
        ob[k] = ld_cluster_f4(src + 16);
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k)
      if (k < p.split) m = fmaxf(m, ml[k].x);
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) {
      if (k < p.split) {
        const float w = ex2_approx(ml[k].x - m);
        l += w * ml[k].y;
        acc[0] += w * oa[k].x; acc[1] += w * oa[k].y;
        acc[2] += w * oa[k].z; acc[3] += w * oa[k].w;
        acc[4] += w * ob[k].x; acc[5] += w * ob[k].y;
        acc[6] += w * ob[k].z; acc[7] += w * ob[k].w;
      }
    }
    const float inv = 1.f / fmaxf(l, 1e-37f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= inv;
#endif
#ifdef CVLA_PROBE_DECODE_NO_STORE
    if (acc[0] != 1.2345e30f) continue;
#endif
    *reinterpret_cast<uint4*>(p.out + out_offset(r) + 8 * c) =
        make_uint4(pack_bf16x2(acc[0], acc[1]), pack_bf16x2(acc[2], acc[3]),
                   pack_bf16x2(acc[4], acc[5]), pack_bf16x2(acc[6], acc[7]));
  }
  cluster_sync();  // no block leaves while another reads its partials
}

template <int DP>
int decode_launch(const DecodeParams& p, int batch_heads, cudaStream_t stream) {
  using L = DecodeLayout<DP>;
  const size_t smem = L::bytes(p.tiles_per_part);
  if (smem > 227 * 1024) return int(cudaErrorInvalidValue);
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch_heads) * p.row_ctas * p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_wgmma_kernel<DP>, p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace
