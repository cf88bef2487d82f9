// The warpgroup flash-attention body of K2 (dense_wgmma.cu) and K3
// (prefix_attention.cu): Hopper's asynchronous warpgroup products
// (wgmma.mma_async) for both S = Q K^T and O += P V, over key/value tiles
// that arrive through a multi-stage cp.async ring. wgmma.cuh holds the
// instruction wrappers and describes the shared-memory layout.
//
// A block is two warpgroups (256 threads) and owns up to 128 query rows of
// one (batch, kv-head) pair, 64 rows a warpgroup (three or four warpgroups
// at the dense kernel's tower widths where that saves row tiles, see
// wg_launch_rows). All threads copy the 64-key K and V tiles (and, in K3,
// the tile's mask bytes) into the ring; one __syncthreads a tile hands the
// newest tile over and frees the oldest stage. A warpgroup issues Q K^T
// with both operands in shared memory (depth steps of 16 over the head
// dim), runs an fp32 online softmax in the base-2 domain on the
// accumulator fragment, packs the probabilities into the register A
// operand and issues P V against the V tile read through a transposed-B
// descriptor, so V is never transposed in shared memory. With three stages
// or more the loop is pipelined: the scores of the next tile and P V of
// this one are issued back to back and the next tile's softmax runs under
// P V. The running maximum is raised only when a tile exceeds it by 2^8,
// so the accumulators are rarely rescaled.
//
// Head dims: any multiple of 8 up to 256, zero-padded to the next of
// {16, 32, 64, 80, 128, 256} in shared memory only (Q, K and V alike, so
// padded columns add nothing to a score and produce zeros that are never
// stored). Ring depth by width: 4 stages up to 80, 3 at 128, 2 at 256.
//
// Rounding points, which are those of the kernels' plain PyTorch twins:
// scores in fp32, scaled by D^-0.5 (here folded with log2 e into one
// multiplier, 2^x in place of e^x), a running maximum per row, and
//   K2  p rounded to bf16 (nearest even) before P V, the row sum adds the
//       rounded values;
//   K3  p kept in fp32: hi = bf16(p) and lo = bf16(p - hi) are two
//       register-A products into one accumulator, the row sum adds the
//       unrounded p;
// one division by the row sum at the end.
//
// K3's mask is bool [B, Sq, Skv], one row per query position for all G
// heads: rows are position-major (row = position * G + head), so a block's
// 128 rows are 16 positions at G = 8 and their mask bytes for a key tile
// (1 KB) are copied once into shared memory beside the K/V stage, with
// 8-byte cp.async where Skv is a multiple of 8 and byte loads otherwise.
// Masked scores are the finite kBigNeg and keys past Skv are -inf, so a
// query row with no attended key (a padding position) is the uniform
// softmax over the Skv real keys, on every row, and the first real score of
// a row wipes what masked tiles before it collected (alpha = 2^(kBigNeg -
// m) = 0).

#pragma once

#include <math.h>

#include "wgmma.cuh"

namespace {

constexpr float kBigNeg = -2.3819763e38f;  // masking constant of the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgRows = 64;              // query rows per warpgroup
constexpr int kTileKeys = 64;            // keys per shared-memory tile
// bytes between the column chunks of a 64-row tile: 64 x 16 and 16 more, so
// that the 16-byte chunks of one row lie in different banks (see wgmma.cuh)
constexpr int kChunkBytes = 64 * 16 + 16;
// the running maximum (base-2 domain) is raised, and the accumulators are
// rescaled, only when a tile's maximum exceeds it by more than this; until
// then probabilities are taken relative to the older maximum and can reach
// 2^kRaise, which cancels in the final division
constexpr float kRaise = 8.f;

// Probe builds (scripts/torch_kernel_probe.py) switch parts of the kernel
// off with -D flags to see what a launch's time is made of; their results
// are wrong by construction and no entry point of the package defines them:
//   CVLA_PROBE_NO_KV_READS  K/V tiles are zero-filled, not read
//   CVLA_PROBE_NO_PRODUCTS  no wgmma is issued
//   CVLA_PROBE_NO_SOFTMAX   the scores are packed as they are
//   CVLA_PROBE_NO_STORE     nothing is stored
//   CVLA_PROBE_WARPGROUPS   K2's tower widths take this many warpgroups

struct WgParams {
  const __nv_bfloat16* q;  // [B, rows / groups, hkv * groups, d]
  const __nv_bfloat16* k;  // [B, n_keys, hkv, d]
  const __nv_bfloat16* v;  // [B, n_keys, hkv, d]
  const uint8_t* mask;     // EXACT: [B, rows / groups, n_keys]
  __nv_bfloat16* out;      // same layout as q
  float* out_f32;          // EXACT: fp32 output instead of `out`, or null
  int hkv;      // key/value heads
  int groups;   // query heads per key/value head
  int rows;     // query rows per (batch, kv head)
  int d;        // head dim
  int n_keys;   // keys per batch row
  float scale_log2;  // score multiplier: D^-0.5 * log2(e)
};

__host__ __device__ constexpr int wg_stages(int dp) {
  return dp <= 80 ? 4 : dp <= 128 ? 3 : 2;
}

// NWG: warpgroups (64-row tiles) per block
template <int DP, int NWG, bool EXACT>
constexpr size_t wg_smem_bytes() {
  return size_t(NWG + 2 * wg_stages(DP)) * (DP / 8) * kChunkBytes +
         (EXACT ? size_t(wg_stages(DP)) * NWG * kWgRows * kTileKeys : 0);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DP: head dim padded in shared memory. NWG: warpgroups per block (two
// blocks share an SM at NWG = 2 and DP <= 80). EXACT: K3's per-(position,
// key) mask and fp32 probabilities.
template <int DP, int NWG, bool EXACT>
__global__ void __launch_bounds__(128 * NWG, (DP <= 80 && NWG == 2 && !EXACT) ? 2 : 1)
flash_wgmma_kernel(const WgParams p) {
  constexpr int kWarpgroups = NWG;
  constexpr int kBlockRows = kWgRows * NWG;  // query rows per block
  constexpr int kWgThreads = 128 * NWG;
  constexpr int STAGES = wg_stages(DP);
  constexpr bool PIPE = STAGES >= 3;  // the pipelined loop, see below
  constexpr int CPR = DP / 8;               // 16-byte chunks per row
  constexpr uint32_t Q_CHUNK = kChunkBytes;   // bytes between column chunks
  constexpr uint32_t KV_CHUNK = kChunkBytes;
  constexpr uint32_t Q_BYTES = CPR * Q_CHUNK;    // one warpgroup's Q tile
  constexpr uint32_t KV_BYTES = CPR * KV_CHUNK;  // one K or V tile
  constexpr int MASK_BYTES = kBlockRows * kTileKeys;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);          // [kWarpgroups] Q tiles
  const uint32_t sK = sQ + kWarpgroups * Q_BYTES;   // [STAGES] K tiles
  const uint32_t sV = sK + STAGES * KV_BYTES;       // [STAGES] V tiles
  uint8_t* sMask = smem + kWarpgroups * Q_BYTES + 2 * STAGES * KV_BYTES;

  // the row tiles of one (batch, kv-head) pair are neighbours in the grid:
  // blocks that run at the same time read the same K and V, which stay in
  // the L2 cache for them
  const int n_row_tiles = (p.rows + kBlockRows - 1) / kBlockRows;
  const int bh = blockIdx.x / n_row_tiles;
  const int b = bh / p.hkv;
  const int kvh = bh % p.hkv;
  const int r0 = (blockIdx.x % n_row_tiles) * kBlockRows;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hq = p.hkv * p.groups;
  const int rows_per_b = p.rows / p.groups;

  auto q_offset = [&](int r) -> size_t {
    return ((size_t(b) * rows_per_b + r / p.groups) * hq + kvh * p.groups +
            r % p.groups) * size_t(p.d);
  };
  // Tile copies: a thread keeps one column chunk for the whole kernel and
  // walks down the tile in passes of RP rows, so its source pointer
  // advances by a constant. Consecutive threads copy the consecutive
  // 16-byte chunks of one row: whole 128-byte lines of device memory, and
  // in shared memory (chunk stride 64 x 16 + 16 bytes) different banks.
  constexpr int RP = kWgThreads / CPR;  // rows per pass
  const int ld_c = tid % CPR;           // column chunk
  const int ld_r = tid / CPR;           // row in pass 0
  const bool ld_thread = tid < RP * CPR;
  const bool ld_on = ld_thread && ld_c * 8 < p.d;

  // the block's query rows, zero-filled past the last row and past d
  if (ld_thread) {
    for (int rr = ld_r; rr < kBlockRows; rr += RP) {
      const int r = r0 + rr;
      const bool valid = ld_on && r < p.rows;
      cp_async_16(sQ + (rr >> 6) * Q_BYTES + ld_c * Q_CHUNK + (rr & 63) * 16,
                  valid ? p.q + q_offset(r) + ld_c * 8 : p.q, valid);
    }
  }

  // EXACT: the query positions of this block and whether their mask rows
  // can be copied 8 bytes at a time
  const int pos_first = r0 / p.groups;
  const int n_pos = (min(r0 + kBlockRows, p.rows) - 1) / p.groups - pos_first + 1;
  const bool mask_vec8 =
      EXACT && p.n_keys % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(p.mask) & 7) == 0;

  const size_t kv_row = size_t(p.hkv) * p.d;  // elements between keys
  const size_t kv_off =
      ((size_t(b) * p.n_keys + ld_r) * p.hkv + kvh) * p.d + ld_c * 8;
  const uint32_t kv_dst = ld_c * KV_CHUNK + ld_r * 16;
  auto load_tile = [&](int tile, int stage) {
    const int j0 = tile * kTileKeys;
    if (ld_thread) {
      const __nv_bfloat16* ks = p.k + kv_off + size_t(j0) * kv_row;
      const __nv_bfloat16* vs = p.v + kv_off + size_t(j0) * kv_row;
#pragma unroll
      for (int n = 0; n * RP < kTileKeys; ++n) {
        const int jj = ld_r + n * RP;
        if (kTileKeys % RP != 0 && jj >= kTileKeys) break;
#ifdef CVLA_PROBE_NO_KV_READS
        const bool valid = false;
#else
        const bool valid = ld_on && j0 + jj < p.n_keys;
#endif
        const uint32_t dst = stage * KV_BYTES + kv_dst + n * RP * 16;
        const size_t step = size_t(n * RP) * kv_row;
        cp_async_16(sK + dst, valid ? ks + step : p.k, valid);
        cp_async_16(sV + dst, valid ? vs + step : p.v, valid);
      }
    }
    if constexpr (EXACT) {
      uint8_t* dm = sMask + stage * MASK_BYTES;
      const uint8_t* src =
          p.mask + (size_t(b) * rows_per_b + pos_first) * size_t(p.n_keys);
      if (mask_vec8) {
        for (int i = tid; i < n_pos * (kTileKeys / 8); i += kWgThreads) {
          const int pl = i / (kTileKeys / 8), jj = (i % (kTileKeys / 8)) * 8;
          const bool valid = j0 + jj < p.n_keys;
          cp_async_8(smem_u32(dm + pl * kTileKeys + jj),
                     valid ? src + size_t(pl) * p.n_keys + j0 + jj : src,
                     valid);
        }
      } else {
        for (int i = tid; i < n_pos * kTileKeys; i += kWgThreads) {
          const int pl = i / kTileKeys, jj = i % kTileKeys;
          dm[pl * kTileKeys + jj] =
              j0 + jj < p.n_keys ? src[size_t(pl) * p.n_keys + j0 + jj] : 0;
        }
      }
    }
  };

  const int n_tiles = (p.n_keys + kTileKeys - 1) / kTileKeys;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit_group();  // the first group also carries Q
  }

  // the two rows this thread holds in the accumulator fragments: local
  // rows warp * 16 + g and + 8 of the warpgroup's 64
  const int wg_r0 = r0 + wg * kWgRows;
  const bool wg_active = wg_r0 < p.rows;
  const int frag_r0 = wg_r0 + ((tid >> 5) & 3) * 16 + g;
  int mask_row[2] = {0, 0};  // EXACT: offset of the row's mask bytes
  if constexpr (EXACT) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mask_row[h] = (min(frag_r0 + 8 * h, p.rows - 1) / p.groups - pos_first) *
                    kTileKeys;
  }

  float m_i[2] = {kBigNeg, kBigNeg};  // running maximum, base-2 domain
  // this thread's share of the row sum: of the probabilities as they are
  // (EXACT) or as rounded to bf16 for P V (K2)
  float l_i[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  const uint32_t sQw = sQ + wg * Q_BYTES;
  uint32_t pa[kTileKeys / 16][4];  // P as A operand (EXACT: its hi half)
  uint32_t pb[EXACT ? kTileKeys / 16 : 1][4];  // EXACT: the lo half
  float alpha[2];

  // S = Q K^T of one tile: 64 rows x 64 keys, depth DP in steps of 16
  auto issue_scores = [&](float (&s)[kTileKeys / 2], int stage) {
    const uint32_t tk = sK + stage * KV_BYTES;
#ifdef CVLA_PROBE_NO_PRODUCTS
#pragma unroll
    for (int i = 0; i < kTileKeys / 2; ++i) s[i] = float(i + int(tk & 7u));
#else
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, wgmma_desc(sQw + kk * 2 * Q_CHUNK, Q_CHUNK, 128),
                   wgmma_desc(tk + kk * 2 * KV_CHUNK, KV_CHUNK, 128), kk > 0);
#endif
    wgmma_commit();
  };

  // online softmax of one tile: turns the scores in `s` into fp32
  // probabilities in place and updates alpha, m_i (and EXACT's l_i);
  // s[4 * j + 2 * h + e] is row h, key 8 * j + 2 * t + e
  auto softmax_tile = [&](float (&s)[kTileKeys / 2], int tile, int stage) {
#ifdef CVLA_PROBE_NO_SOFTMAX
    return;
#endif
    const int j0 = tile * kTileKeys;
    const bool ragged = j0 + kTileKeys > p.n_keys;
    const uint8_t* tm = sMask + stage * MASK_BYTES;
    if (ragged) {  // keys past the last: out of every row's softmax
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j0 + 8 * j + 2 * t + e >= p.n_keys)
            s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
      if constexpr (EXACT) {
        // attended: the scaled score; masked: kBigNeg; absent stays -inf
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j) {
          const uint32_t mb = *reinterpret_cast<const uint16_t*>(
              tm + mask_row[h] + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = s[4 * j + 2 * h + e];
            const float x = (mb >> (8 * e)) & 0xffu ? v * p.scale_log2
                                                    : fminf(v, kBigNeg);
            s[4 * j + 2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx *= p.scale_log2;
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // raise the maximum only past kRaise (always at a row's first real
      // score, which lies far above kBigNeg)
      const bool raise = mx > m_i[h] + kRaise;
      alpha[h] = raise ? ex2_approx(m_i[h] - mx) : 1.f;
      m_i[h] = raise ? mx : m_i[h];
      const float m_ref = m_i[h];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j) {
        float p0, p1;
        if constexpr (EXACT) {
          p0 = ex2_approx(s[4 * j + 2 * h] - m_ref);
          p1 = ex2_approx(s[4 * j + 2 * h + 1] - m_ref);
        } else {
          p0 = ex2_approx(fmaf(s[4 * j + 2 * h], p.scale_log2, -m_ref));
          p1 = ex2_approx(fmaf(s[4 * j + 2 * h + 1], p.scale_log2, -m_ref));
        }
        s[4 * j + 2 * h] = p0;
        s[4 * j + 2 * h + 1] = p1;
        rs += p0 + p1;
      }
      // K2's share is added in pack_probs, from the rounded values
      l_i[h] = l_i[h] * alpha[h] + (EXACT ? rs : 0.f);
    }
  };

  // the probabilities as the register A operand of P V: rounded to bf16
  // and added to the row sum (K2), or split into hi = bf16(p) and
  // lo = bf16(p - hi) (EXACT)
  auto pack_probs = [&](const float (&s)[kTileKeys / 2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j) {
        const float p0 = s[4 * j + 2 * h], p1 = s[4 * j + 2 * h + 1];
        const uint32_t hi = pack_bf16x2(p0, p1);
        pa[j / 2][(j % 2) * 2 + h] = hi;
        const float h0 = __uint_as_float(hi << 16);
        const float h1 = __uint_as_float(hi & 0xffff0000u);
        if constexpr (EXACT)
          pb[j / 2][(j % 2) * 2 + h] = pack_bf16x2(p0 - h0, p1 - h1);
        else
          l_i[h] += h0 + h1;
      }
    }
  };

  // rescales the accumulators where a row of this warp raised its maximum
  auto rescale = [&]() {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[4 * j + 2 * h] *= alpha[h];
          o[4 * j + 2 * h + 1] *= alpha[h];
        }
      }
    }
  };

  // O += P V: depth 64 keys in steps of 16, V through the transposed-B
  // descriptor
  auto issue_pv = [&](int stage) {
    const uint32_t tv = sV + stage * KV_BYTES;
#ifdef CVLA_PROBE_NO_PRODUCTS
#pragma unroll
    for (int kc = 0; kc < kTileKeys / 16; ++kc)  // keeps P's packing alive
      o[kc] += __uint_as_float((pa[kc][0] ^ pa[kc][1] ^ pa[kc][2] ^ pa[kc][3] ^
                                (EXACT ? pb[kc][0] ^ pb[kc][3] : 0u)) &
                               0x3fffffffu) + float(tv & 1u);
#else
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTileKeys / 16; ++kc) {
      wgmma_rs<DP>(o, pa[kc], tv + kc * 256, KV_CHUNK);
      if constexpr (EXACT) wgmma_rs<DP>(o, pb[kc], tv + kc * 256, KV_CHUNK);
    }
#endif
    wgmma_commit();
  };

  if constexpr (!PIPE) {
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int stage = tile % STAGES;
      // tile `tile` has landed; every warpgroup is done with tile - 1,
      // whose stage the next copy overwrites
      cp_async_wait_group<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();
      if (tile + STAGES - 1 < n_tiles)
        load_tile(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
      cp_async_commit_group();
      if (!wg_active) continue;

      float s[kTileKeys / 2];
      issue_scores(s, stage);
      wgmma_wait<0>();
      wgmma_pin(s);
      softmax_tile(s, tile, stage);
      pack_probs(s);
      rescale();
      wgmma_pin(o);
      issue_pv(stage);
      wgmma_wait<0>();
      wgmma_pin(o);
    }
  } else {
    // Pipelined: in iteration t the scores of tile t + 1 and then P V of
    // tile t are issued back to back; the softmax of tile t + 1 starts as
    // soon as its scores are there (wgmma_wait<1>: all but the newest
    // group) and runs under P V of tile t; the probabilities are packed
    // into the A registers only when that product has stopped reading
    // them (wgmma_wait<0>). Tiles t and t + 1 are resident, the copies run
    // STAGES - 2 tiles further ahead.
    // (Every warpgroup issues every product, also one whose rows lie past
    // the end, and the scores of a tile past the last, whose results
    // nobody reads: products under a condition make the compiler
    // serialise them.)
    float s[kTileKeys / 2];
    cp_async_wait_group<STAGES - 2>();  // tile 0 (and Q)
    fence_proxy_async();
    __syncthreads();
    issue_scores(s, 0);
    wgmma_wait<0>();
    wgmma_pin(s);
    softmax_tile(s, 0, 0);
    pack_probs(s);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int stage = tile % STAGES, next = (tile + 1) % STAGES;
      // tile + 1 has landed; every warpgroup is done with tile - 1, whose
      // stage the next copy overwrites
      cp_async_wait_group<STAGES - 3>();
      fence_proxy_async();
      __syncthreads();
      if (tile + STAGES - 1 < n_tiles)
        load_tile(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
      cp_async_commit_group();

      rescale();  // by the alpha of this tile's softmax; nothing in flight
      wgmma_pin(o);
      issue_scores(s, next);
      issue_pv(stage);
      wgmma_wait<1>();  // the scores
      wgmma_pin(s);
      if (tile + 1 < n_tiles) softmax_tile(s, tile + 1, next);
      wgmma_wait<0>();  // P V
      wgmma_pin(o);
      if (tile + 1 < n_tiles) pack_probs(s);
    }
  }
  cp_async_wait_group<0>();
  if (!wg_active) return;
#ifdef CVLA_PROBE_NO_STORE
  if (o[0] != 1.2345e30f) return;
#endif

  // epilogue: the quad's shares make the row sum; one division a row.
  // fp32 results (EXACT with out_f32) go straight to device memory, 32
  // bytes a quad. bf16 results go through the warpgroup's own Q tile (no
  // product reads it any more) in the tile layout and leave as 16-byte
  // stores, consecutive threads on the consecutive chunks of a row.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / fmaxf(l, 1e-37f);
  }
  if (EXACT && p.out_f32 != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_r0 + 8 * h;
      if (r >= p.rows) continue;
      const size_t off = q_offset(r);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < p.d)
          *reinterpret_cast<float2*>(p.out_f32 + off + c) = make_float2(
              o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
    return;
  }
  unsigned char* stage_out = smem + wg * Q_BYTES;
  const int frag_row = ((tid >> 5) & 3) * 16 + g;  // row in the warpgroup
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(stage_out + j * Q_CHUNK +
                                   (frag_row + 8 * h) * 16 + t * 4) =
          pack_bf16x2(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
  // the warpgroup's own barrier (0 is __syncthreads)
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else if (wg == 1)
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  else if (wg == 2)
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 4, 128;\n" ::: "memory");
  const int wt = tid & 127;
  for (int i = wt; i < kWgRows * CPR; i += 128) {
    // consecutive threads take the consecutive chunks of one row
    const int rr = i / CPR, c = i % CPR;
    const int r = wg_r0 + rr;
    if (r < p.rows && c * 8 < p.d)
      *reinterpret_cast<uint4*>(p.out + q_offset(r) + c * 8) =
          *reinterpret_cast<const uint4*>(stage_out + c * Q_CHUNK + rr * 16);
  }
}

template <int DP, int NWG, bool EXACT>
int wg_launch(const WgParams& p, int batch_heads, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<DP, NWG, EXACT>();
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DP, NWG, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  constexpr int block_rows = kWgRows * NWG;
  const unsigned grid = unsigned(batch_heads) *
                        unsigned((p.rows + block_rows - 1) / block_rows);
  flash_wgmma_kernel<DP, NWG, EXACT><<<grid, 128 * NWG, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// The tower widths (DP 64 and 80) of the dense kernel take wider blocks
// where that saves row tiles: every row tile of a (batch, head) pair reads
// all of its K and V again, and at these widths that traffic, not the
// products, is what a launch waits for.
template <int DP, bool EXACT>
int wg_launch_rows(const WgParams& p, int batch_heads, cudaStream_t stream) {
  if constexpr (!EXACT && (DP == 64 || DP == 80)) {
    auto tiles = [&](int nwg) {
      return (p.rows + kWgRows * nwg - 1) / (kWgRows * nwg);
    };
#ifdef CVLA_PROBE_WARPGROUPS
    return wg_launch<DP, CVLA_PROBE_WARPGROUPS, EXACT>(p, batch_heads, stream);
#endif
    if (tiles(3) < tiles(2) && tiles(4) >= tiles(3))
      return wg_launch<DP, 3, EXACT>(p, batch_heads, stream);
    if (tiles(4) < tiles(2))
      return wg_launch<DP, 4, EXACT>(p, batch_heads, stream);
  }
  return wg_launch<DP, 2, EXACT>(p, batch_heads, stream);
}

template <bool EXACT>
int wg_dispatch(const WgParams& p, int batch_heads, cudaStream_t stream) {
  if (p.d <= 0 || p.d % 8 != 0 || p.rows <= 0 || p.n_keys <= 0 ||
      batch_heads <= 0)
    return int(cudaErrorInvalidValue);
  if (p.d <= 16) return wg_launch_rows<16, EXACT>(p, batch_heads, stream);
  if (p.d <= 32) return wg_launch_rows<32, EXACT>(p, batch_heads, stream);
  if (p.d <= 64) return wg_launch_rows<64, EXACT>(p, batch_heads, stream);
  if (p.d <= 80) return wg_launch_rows<80, EXACT>(p, batch_heads, stream);
  if (p.d <= 128) return wg_launch_rows<128, EXACT>(p, batch_heads, stream);
  if (p.d <= 256) return wg_launch_rows<256, EXACT>(p, batch_heads, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace
